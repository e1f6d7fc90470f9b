"""Train-mode BatchNorm: the channel-sum kernels, their plain versions, and
the flax-exact normalisation around them.

Replaces mhentropy_tpu/models/bn_pallas.py: `stats_sums` :182 and
`grad_sums` :187 (the kernels, `csrc/bn_sums.cu`; its header says what bounds
them on the H100 and how its design answers that), the `train_bn` custom VJP
:195-242 (`TrainBN` here), `stats_sums_diff` :257-272 (`StatsSums`) and the
normalisation of `FusedTrainBN` :278-345 (`batch_norm_train`).

The math follows flax's BatchNorm exactly: f32 statistics from a bf16 input,
variance as E[x^2] - E[x]^2 clipped at 0, normalisation in f32 and then a
cast to the input's dtype, running mean and variance updated as
0.9 r + 0.1 batch with the biased batch variance. torch's own train-mode
BatchNorm stores the unbiased variance and sums its own way, so the port's
modules call `batch_norm_train` instead (models/resnet.py).

The wrappers `stats_sums` / `grad_sums` take a channels-last NCHW activation
(NHWC in memory) or a contiguous (M, C) tensor. CPU tensors take the plain
versions; CUDA tensors launch the kernel, and a tensor in another layout
raises: a hidden copy of every activation is what cost the TPU version its
A/B. Where autograd hands `TrainBN`'s backward a dy in another layout, the
backward converts it explicitly and counts the copy in `dy_copies`.
"""

from __future__ import annotations

import torch

from mhentropy_tpu_torch import ext

# Kernel launches since the counts were last reset; nothing else touches them.
stats_launches = 0
grad_launches = 0
# Explicit channels-last copies of a cotangent dy in TrainBN's backward.
dy_copies = 0

# Pass-1 blocks to aim for: four per SM of the H100's 132.
_TARGET_BLOCKS = 4 * 132
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bcast(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(C,) -> broadcastable against `like` (C on axis 1 of NCHW, last of (M, C))."""
    return t.view(1, -1, 1, 1) if like.dim() == 4 else t.view(1, -1)


def _sum_dims(x: torch.Tensor) -> tuple:
    return (0, 2, 3) if x.dim() == 4 else (0,)


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """The (M, C) row view of a channels-last NCHW or contiguous (M, C)
    tensor; raises rather than copy."""
    if x.dim() == 4:
        ext.require(x.is_contiguous(memory_format=torch.channels_last),
                    f"{name}: expected a channels_last activation, got strides {x.stride()} "
                    f"for shape {tuple(x.shape)}")
        return x.permute(0, 2, 3, 1).view(-1, x.shape[1])
    ext.require(x.dim() == 2 and x.is_contiguous(),
                f"{name}: expected a contiguous (M, C) tensor, got {tuple(x.shape)}")
    return x


def _splits(m: int, c: int, itemsize: int) -> int:
    """Row splits G of pass 1, from the kernel's block layout (csrc/bn_sums.cu)."""
    vec = 16 // itemsize if c % (16 // itemsize) == 0 else 1
    groups = -(-c // vec)
    gx = min(groups, 32)
    ry = 256 // gx
    cblocks = -(-groups // gx)
    return max(1, min(-(-_TARGET_BLOCKS // cblocks), -(-m // ry)))


def stats_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum x, sum x^2) per channel over all other axes, f32 (C,)."""
    if x.device.type == "cpu":
        return stats_sums_plain(x)
    return _sums_kernel(x, None)


def grad_sums(dy: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum dy, sum dy * x) per channel over all other axes, f32 (C,)."""
    if x.device.type == "cpu":
        return grad_sums_plain(dy, x)
    return _sums_kernel(dy, x)


def stats_sums_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    dims = _sum_dims(x)
    return xf.sum(dims), (xf * xf).sum(dims)


def grad_sums_plain(dy: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dyf = dy.float()
    dims = _sum_dims(x)
    return dyf.sum(dims), (dyf * x.float()).sum(dims)


def _sums_kernel(a: torch.Tensor, b: torch.Tensor | None):
    """Stats sums of a, or grad sums of (dy = a, x = b)."""
    global stats_launches, grad_launches
    grad = b is not None
    name = "bn grad_sums" if grad else "bn stats_sums"
    ext.require(a.is_cuda, f"{name}: unsupported device {a.device}")
    ext.require(a.dtype in _DTYPE_CODES, f"{name}: dtype {a.dtype} is not float32 or bfloat16")
    rows_a = _rows(a, name)
    rows_b = None
    if grad:
        ext.require(b.shape == a.shape and b.dtype == a.dtype and b.device == a.device,
                    f"{name}: dy {tuple(a.shape)} {a.dtype} and x {tuple(b.shape)} {b.dtype} "
                    f"differ")
        rows_b = _rows(b, name)
    m, c = rows_a.shape
    ext.require(0 < m < 2 ** 31 and c > 0, f"{name}: (M, C) = {(m, c)} out of range")
    g = _splits(m, c, a.element_size())
    partial = torch.empty((2, g, c), dtype=torch.float32, device=a.device)
    out1 = torch.empty(c, dtype=torch.float32, device=a.device)
    out2 = torch.empty(c, dtype=torch.float32, device=a.device)
    lib = ext.load()
    code = _DTYPE_CODES[a.dtype]
    if grad:
        err = lib.mhent_bn_grad_sums(rows_a.data_ptr(), rows_b.data_ptr(), partial.data_ptr(),
                                     out1.data_ptr(), out2.data_ptr(), m, c, g, code,
                                     ext.stream_of(a))
        ext.check(err, "mhent_bn_grad_sums")
        grad_launches += 1
    else:
        err = lib.mhent_bn_stats_sums(rows_a.data_ptr(), partial.data_ptr(), out1.data_ptr(),
                                      out2.data_ptr(), m, c, g, code, ext.stream_of(a))
        ext.check(err, "mhent_bn_stats_sums")
        stats_launches += 1
    return out1, out2


class StatsSums(torch.autograd.Function):
    """`stats_sums` under autograd (bn_pallas.stats_sums_diff): its backward
    is the broadcast d(xf) = ds + 2 x dss, left to PyTorch's elementwise ops.

    apply(xf, x): the kernel reads x (bf16 or f32); the gradient goes to its
    f32 copy xf = x.float(), which the normalisation reads too, so both
    contributions to x's gradient add in f32 and are rounded to x's dtype
    once, as autograd through flax's own statistics does (the JAX custom
    VJP's cotangent adds them in bf16)."""

    @staticmethod
    def forward(ctx, xf, x):
        ctx.save_for_backward(x)
        return stats_sums(x)

    @staticmethod
    def backward(ctx, ds, dss):
        (x,) = ctx.saved_tensors
        return _bcast(ds, x) + 2.0 * x.float() * _bcast(dss, x), None


class TrainBN(torch.autograd.Function):
    """Train-mode BN with both sums in the kernels (bn_pallas.train_bn).
    Returns (y, mean, var); mean and var are f32 (C,) for the running
    averages. The backward reduces (dy, x) with `grad_sums` and keeps the
    elementwise dx in PyTorch, including the mean / var cotangent terms."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        m = x.numel() // x.shape[1]
        s, ss = stats_sums(x)
        mean = s / m
        var = torch.clamp(ss / m - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((x.float() - _bcast(mean, x)) * _bcast(rstd * scale, x)
             + _bcast(bias, x)).to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        global dy_copies
        x, mean, rstd, scale = ctx.saved_tensors
        m = x.numel() // x.shape[1]
        xf = x.float()
        dx = torch.zeros_like(xf)
        s1 = s2 = torch.zeros_like(mean)
        if dy is not None:
            if dy.dim() == 4 and not dy.is_contiguous(memory_format=torch.channels_last):
                dy = dy.contiguous(memory_format=torch.channels_last)
                dy_copies += 1
            s1, sxy = grad_sums(dy, x)
            # sum(dy * xhat) from the raw sums: xhat = (x - mean) * rstd.
            s2 = (sxy - mean * s1) * rstd
            xhat = (xf - _bcast(mean, x)) * _bcast(rstd, x)
            dx = _bcast(rstd * scale, x) * (dy.float() - _bcast(s1 / m, x)
                                            - xhat * _bcast(s2 / m, x))
        if dmean is not None:
            dx = dx + _bcast(dmean / m, x)
        if dvar is not None:
            dx = dx + _bcast(dvar * (2.0 / m), x) * (xf - _bcast(mean, x))
        return dx.to(x.dtype), s2, s1, None


def normalize(xf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    """flax `_normalize` of xf = x.float(): (x - mean) * (rsqrt(var + eps) *
    scale) + bias in f32, cast to x's dtype."""
    mul = torch.rsqrt(var + eps) * scale
    return ((xf - _bcast(mean, xf)) * _bcast(mul, xf) + _bcast(bias, xf)).to(dtype)


def batch_norm_train(x: torch.Tensor, bn: torch.nn.BatchNorm2d, mode: str = "stats",
                     kernels: bool = True) -> torch.Tensor:
    """flax BatchNorm in train mode on x (channels-last NCHW or (M, C)), with
    `bn`'s weight, bias, eps and momentum; updates bn's running mean and
    variance in place (the JAX package returns them as new batch stats).

    kernels=False: flax's own statistics in plain PyTorch (the JAX package's
    path with `tpu.fused_train_bn` off). Otherwise mode "stats" computes the
    sums with `StatsSums` and leaves the backward to autograd; "full" runs
    `TrainBN`, whose backward reduces with `grad_sums`. Either way CPU
    tensors take the plain sums and CUDA tensors the kernels.
    """
    if mode not in ("stats", "full"):
        raise ValueError(f"train BN mode {mode!r}; expected 'stats' or 'full'")
    m = x.numel() // x.shape[1]
    if mode == "full" and kernels:
        y, mean, var = TrainBN.apply(x, bn.weight, bn.bias, bn.eps)
    else:
        xf = x.float()
        if kernels:
            s, ss = StatsSums.apply(xf, x)
            mean, mu2 = s / m, ss / m
        else:
            dims = _sum_dims(x)
            mean, mu2 = xf.mean(dims), (xf * xf).mean(dims)
        var = torch.clamp(mu2 - mean * mean, min=0.0)
        y = normalize(xf, mean, var, bn.weight, bn.bias, bn.eps, x.dtype)
    with torch.no_grad():
        keep = 1.0 - bn.momentum  # flax momentum 0.9 = 1 - torch momentum 0.1
        bn.running_mean.mul_(keep).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(keep).add_(var, alpha=bn.momentum)
    return y
