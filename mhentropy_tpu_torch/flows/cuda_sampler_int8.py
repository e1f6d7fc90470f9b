"""W8A8 fused RealNVP sampler: calibration, the CUDA kernel and its plain
version.

Port of mhentropy_tpu/flows/pallas_sampler_int8.py: `FlowQTree` :57,
`collect_act_maxabs` :86, `prepare_flow` :145, `scale_cond_cache` :199,
`_quant_layer` :211 with `xla_forward_q` :254 (the plain version),
`sample_fused_q` :381 (the kernel route for CUDA tensors),
`quantize_sampler` :445 and `shape_ok` :460. The kernel is
`csrc/realnvp_sampler_int8.cu` on the cluster skeleton of
`csrc/realnvp_cluster.cuh`; its header says what bounds it on the H100 and
how its design answers that. `launch_plan` sizes each launch's tiles with
`cuda_sampler.plan` on the int8 kernel's layout and the card's occupancy,
once a shape.

The scheme is the JAX package's static PTQ: per-output-column int8 weights
for the six GEMMs of a coupling layer, per-site activation scales from an
instrumented float forward, each requantise folded into the epilogue before
it, and the x-path biases and conditioning projections pre-scaled into the
cond cache once per image. D pads to a multiple of 32 here (the JAX tree
pads it to the TPU's 128 lanes; `convert.flowq_from_jax` drops the extra
padding, which holds no weights). torch cannot replay jax.random: the base
noise and the calibration noise come from the caller.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext
from mhentropy_tpu_torch.flows import cuda_sampler, realnvp
from mhentropy_tpu_torch.flows.priors import std_normal_logp

D_ALIGN = 32  # the kernel's K step (mma m16n8k32): Dp and each CTA's slice of H
_NAMES = ("s_w0", "s_e0", "s_w1", "s_e1", "s_w2", "s_e2", "s_b2",
          "t_w0", "t_e0", "t_w1", "t_e1", "t_w2", "t_e2", "t_b2")

# Kernel launches since the count was last reset; nothing else touches it.
launches = 0


class Kernel(NamedTuple):
    """The tree's weights in the kernel's layout ([out, in] int8)."""

    masks: torch.Tensor  # (L, Dp) f32
    qm: torch.Tensor  # (L, Dp) f32
    w0: torch.Tensor  # (L, 2, H, Dp) int8, net 0 = s, 1 = t
    w1: torch.Tensor  # (L, 2, H, H)
    w2: torch.Tensor  # (L, 2, Dp, H)
    e0: torch.Tensor  # (L, 2, H) f32
    e1: torch.Tensor  # (L, 2, H)
    e2: torch.Tensor  # (L, 2, Dp)
    b2: torch.Tensor  # (L, 2, Dp)


class FlowQTree(NamedTuple):
    masks: torch.Tensor  # (L, 1, Dp) f32 {0, 1} with 1s on the padding
    qm: torch.Tensor  # (L, 1, Dp) f32 = masks * inv_a0[l]
    s_w0: torch.Tensor  # (L, Dp, H) int8
    s_e0: torch.Tensor  # (L, 1, H) f32 epilogue scale (requant folded)
    s_w1: torch.Tensor  # (L, H, H) int8
    s_e1: torch.Tensor  # (L, 1, H)
    s_w2: torch.Tensor  # (L, H, Dp) int8
    s_e2: torch.Tensor  # (L, 1, Dp)
    s_b2: torch.Tensor  # (L, 1, Dp) f32
    t_w0: torch.Tensor
    t_e0: torch.Tensor
    t_w1: torch.Tensor
    t_e1: torch.Tensor
    t_w2: torch.Tensor
    t_e2: torch.Tensor
    t_b2: torch.Tensor
    cond_scale: torch.Tensor  # (L, 4) f32 per-slot cond-cache rescale
    cond_bias: torch.Tensor  # (L, 4, H) f32 folded x-path biases * inv
    kernel: Kernel | None = None  # set by `with_kernel_layout`


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@torch.no_grad()
def collect_act_maxabs(flow: realnvp.RealNVP, z: torch.Tensor, cproj: torch.Tensor) -> dict:
    """Float forward collecting max|input| at every quantised GEMM site.

    z: (R, D) base samples; cproj: (L, 4, R, H) cond rows aligned with z.
    Returns (L,) tensors: a0 (coupling input, shared by s and t) and the
    post-leaky-relu hidden amaxes s_h1, s_h2, t_h1, t_h2.
    """
    stats = {k: [] for k in ("a0", "s_h1", "s_h2", "t_h1", "t_h2")}
    x = z
    for layer, cp in zip(realnvp.layers(flow), cproj):
        mask = layer.mask
        x_masked = x * mask

        def mlp(w0, b0, w1, b1, w2, b2, c0, c1, squash):
            h1 = F.leaky_relu(x_masked @ w0 + b0 + c0, 0.01)
            h2 = F.leaky_relu(h1 @ w1 + b1 + c1, 0.01)
            out = h2 @ w2 + b2
            return (torch.tanh(out) if squash else out), h1.abs().max(), h2.abs().max()

        s, s_h1, s_h2 = mlp(layer.s_w0, layer.s_b0, layer.s_w1, layer.s_b1,
                            layer.s_w2, layer.s_b2, cp[0], cp[1], True)
        t, t_h1, t_h2 = mlp(layer.t_w0, layer.t_b0, layer.t_w1, layer.t_b1,
                            layer.t_w2, layer.t_b2, cp[2], cp[3], False)
        inv_mask = 1.0 - mask
        x = x_masked + inv_mask * (x * torch.exp(s * inv_mask) + t * inv_mask)
        for k, v in zip(stats, (x_masked.abs().max(), s_h1, s_h2, t_h1, t_h2)):
            stats[k].append(v)
    return {k: torch.stack(v) for k, v in stats.items()}


def _colscale(w: torch.Tensor) -> torch.Tensor:  # (L, K, N) -> (L, 1, N), zero-safe
    s = w.abs().amax(dim=1, keepdim=True) / 127.0
    return torch.where(s > 0, s, torch.ones_like(s))


def _q8(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)


@torch.no_grad()
def prepare_flow(flow: realnvp.RealNVP, act: dict) -> FlowQTree:
    """Quantise the coupling weights and fold the requant chain into
    epilogue vectors, from `collect_act_maxabs` amaxes."""
    d = flow.cfg.dim
    dp = _round_up(d, D_ALIGN)
    lays = realnvp.layers(flow)

    def stacked(name):
        return torch.stack([getattr(lay, name).float() for lay in lays])

    def safe(v):
        s = torch.as_tensor(v, dtype=torch.float32) / 127.0
        return torch.where(s > 0, s, torch.ones_like(s))

    a0 = safe(act["a0"])
    sh = {k: safe(act[k]) for k in ("s_h1", "s_h2", "t_h1", "t_h2")}

    def net(prefix):
        w0 = F.pad(stacked(f"{prefix}_w0"), (0, 0, 0, dp - d))
        w1 = stacked(f"{prefix}_w1")
        w2 = F.pad(stacked(f"{prefix}_w2"), (0, dp - d))
        c0, c1, c2 = _colscale(w0), _colscale(w1), _colscale(w2)
        h1, h2 = sh[f"{prefix}_h1"], sh[f"{prefix}_h2"]
        e0 = a0[:, None, None] * c0 / h1[:, None, None]
        e1 = h1[:, None, None] * c1 / h2[:, None, None]
        e2 = h2[:, None, None] * c2
        b2 = F.pad(stacked(f"{prefix}_b2"), (0, dp - d))[:, None, :]
        return _q8(w0, c0), e0, _q8(w1, c1), e1, _q8(w2, c2), e2, b2

    masks = F.pad(flow.mask.float(), (0, dp - d), value=1.0)
    cond_scale = torch.stack([1.0 / sh["s_h1"], 1.0 / sh["s_h2"],
                              1.0 / sh["t_h1"], 1.0 / sh["t_h2"]], dim=1)
    cond_bias = torch.stack([stacked("s_b0") / sh["s_h1"][:, None],
                             stacked("s_b1") / sh["s_h2"][:, None],
                             stacked("t_b0") / sh["t_h1"][:, None],
                             stacked("t_b1") / sh["t_h2"][:, None]], dim=1)
    return with_kernel_layout(FlowQTree(
        masks[:, None, :], (masks * (1.0 / a0)[:, None])[:, None, :],
        *net("s"), *net("t"), cond_scale, cond_bias))


def with_kernel_layout(tree: FlowQTree) -> FlowQTree:
    """The tree with its `kernel` field: the same weights transposed to
    [out, in] and the s and t nets stacked, contiguous."""
    def pair(name, transpose=False):
        s, t = getattr(tree, f"s_{name}"), getattr(tree, f"t_{name}")
        if transpose:
            s, t = s.transpose(1, 2), t.transpose(1, 2)
        return torch.stack([s, t], dim=1).contiguous()

    def vec(name):
        return pair(name)[:, :, 0].contiguous()

    return tree._replace(kernel=Kernel(
        masks=tree.masks[:, 0].contiguous(), qm=tree.qm[:, 0].contiguous(),
        w0=pair("w0", True), w1=pair("w1", True), w2=pair("w2", True),
        e0=vec("e0"), e1=vec("e1"), e2=vec("e2"), b2=vec("b2")))


def scale_cond_cache(tree: FlowQTree, cproj_layers: torch.Tensor) -> torch.Tensor:
    """(L, B, 4, H) cond cache -> the kernel's pre-scaled cond input."""
    return (cproj_layers * tree.cond_scale[:, None, :, None]
            + tree.cond_bias[:, None, :, :])


def _quant(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -127.0, 127.0)


def _quant_layer(x, mask, qm, cp, wq):
    """One quantised coupling layer on (..., Dp) rows, in f32: the integer
    products are products of integer-valued f32 (exact). cp[k] broadcasts to
    (..., H); wq is this layer's (s_w0, s_e0, ..., t_b2)."""
    s_w0, s_e0, s_w1, s_e1, s_w2, s_e2, s_b2, t_w0, t_e0, t_w1, t_e1, t_w2, t_e2, t_b2 = wq
    xq = _quant(x * qm)

    def mlp(w0, e0, c0, w1, e1, c1, w2, e2, b2, squash):
        h = (xq @ w0.float()) * e0 + c0
        h = torch.where(h > 0, h, 0.01 * h)
        h = (_quant(h) @ w1.float()) * e1 + c1
        h = torch.where(h > 0, h, 0.01 * h)
        out = (_quant(h) @ w2.float()) * e2 + b2
        return torch.tanh(out) if squash else out

    s = mlp(s_w0, s_e0, cp[0], s_w1, s_e1, cp[1], s_w2, s_e2, s_b2, True)
    t = mlp(t_w0, t_e0, cp[2], t_w1, t_e1, cp[3], t_w2, t_e2, t_b2, False)
    inv_mask = 1.0 - mask
    s = s * inv_mask
    t = t * inv_mask
    return x * mask + inv_mask * (x * torch.exp(s) + t), s


def xla_forward_q(tree: FlowQTree, z: torch.Tensor, cprojq: torch.Tensor):
    """The plain version: z (B, R, Dp) image-major padded rows, cprojq
    (L, B, 4, H) pre-scaled cond -> (x (B, R, Dp), logdet (B, R))."""
    x = z
    logdet = z.new_zeros(z.shape[:2])
    for l in range(tree.masks.shape[0]):
        wq = tuple(getattr(tree, nm)[l] for nm in _NAMES)
        cp = cprojq[l][:, :, None, :]  # (B, 4, 1, H)
        x, s = _quant_layer(x, tree.masks[l], tree.qm[l], tuple(cp[:, k] for k in range(4)), wq)
        logdet = logdet + s.sum(-1)
    return x, logdet


def transform_q(tree: FlowQTree, z0: torch.Tensor, cprojq: torch.Tensor):
    """(B, R, D) image-major base samples through the quantised coupling
    stack -> (x (B, R, D), logdet (B, R)). CPU tensors take `xla_forward_q`;
    CUDA tensors launch the kernel."""
    if z0.device.type == "cpu":
        d, dp = z0.shape[-1], tree.masks.shape[-1]
        x, logdet = xla_forward_q(tree, F.pad(z0, (0, dp - d)), cprojq)
        return x[..., :d], logdet
    return _transform_kernel(tree, z0, cprojq)


@functools.lru_cache(maxsize=256)
def launch_plan(device_index: int, rows: int, h: int, dp: int) -> cuda_sampler.Plan:
    """`cuda_sampler.plan` for the int8 kernel on the card, once a shape:
    its own shared-memory layout, and the clusters of its largest tile
    resident at once (CUDA's occupancy query)."""
    cluster = cuda_sampler.check_shape(h, dp, D_ALIGN)
    lib = ext.load()
    smem = lib.mhent_realnvp_sample_q_smem
    with torch.cuda.device(device_index):
        n = lib.mhent_realnvp_sample_q_clusters(cuda_sampler.max_tile_rows(dp, h, cluster, smem),
                                                dp, h, cluster)
    if n < 0:
        ext.check(-n, "int8 sampler cluster occupancy")
    ext.require(n > 0, f"int8 sampler: no cluster of {cluster} CTAs fits on the card")
    return cuda_sampler.plan(rows, h, dp, n, smem, D_ALIGN)


def _transform_kernel(tree: FlowQTree, z0: torch.Tensor, cprojq: torch.Tensor):
    global launches
    ext.require(z0.is_cuda, f"int8 sampler: unsupported device {z0.device}")
    ext.require(tree.kernel is not None,
                "int8 sampler: the tree has no kernel layout (with_kernel_layout)")
    k = tree.kernel
    b, r, d = z0.shape
    n_layers, dp = k.masks.shape
    h = k.w1.shape[-1]
    ext.require(z0.dtype == torch.float32 and z0.is_contiguous(),
                "int8 sampler: z0 must be contiguous float32 (B, R, D)")
    ext.require(cprojq.shape == (n_layers, b, 4, h) and cprojq.dtype == torch.float32
                and cprojq.is_contiguous(),
                f"int8 sampler: cprojq must be contiguous float32 {(n_layers, b, 4, h)}, "
                f"got {tuple(cprojq.shape)} {cprojq.dtype}")
    ext.require(d <= dp, f"int8 sampler: z0 has D={d}, the tree Dp={dp}")
    for name, t in k._asdict().items():
        ext.require(t.device == z0.device and t.is_contiguous() and t.data_ptr() % 16 == 0,
                    f"int8 sampler: kernel operand {name} must be contiguous 16-byte-aligned "
                    f"on {z0.device}")
    pl = launch_plan(z0.device.index, b * r, h, dp)
    x = torch.empty_like(z0)
    logdet = torch.empty((b, r), dtype=torch.float32, device=z0.device)
    lib = ext.load()
    err = lib.mhent_realnvp_sample_q(
        z0.data_ptr(), cprojq.data_ptr(), k.masks.data_ptr(), k.qm.data_ptr(),
        k.w0.data_ptr(), k.w1.data_ptr(), k.w2.data_ptr(), k.e0.data_ptr(),
        k.e1.data_ptr(), k.e2.data_ptr(), k.b2.data_ptr(), x.data_ptr(), logdet.data_ptr(),
        b, r, d, dp, h, n_layers, pl.tile_rows, pl.cluster, ext.stream_of(z0))
    ext.check(err, "mhent_realnvp_sample_q")
    launches += 1
    return x, logdet


def cond_q(flow: realnvp.RealNVP, tree: FlowQTree, feat: torch.Tensor) -> torch.Tensor:
    """(B, C) features -> the pre-scaled (L, B, 4, H) cond cache."""
    cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))  # (L, 4, B, H)
    return scale_cond_cache(tree, cproj.float().transpose(1, 2)).contiguous()


def sample_fused_q(flow: realnvp.RealNVP, tree: FlowQTree, feat: torch.Tensor, n: int,
                   z0_rows: torch.Tensor):
    """The int8 flow draw for n hypotheses of each of B images.

    z0_rows: (n * B, D) hypothesis-major base noise, already times temp.
    Returns x (n * B, D) hypothesis-major and the log density of the
    quantised transform (n * B,).
    """
    if flow.cfg.dim in (2, 3):
        raise NotImplementedError("the fused sampler does not take per-joint flows (dim 2/3)")
    b, d = feat.shape[0], flow.cfg.dim
    z0 = z0_rows.reshape(n, b, d).transpose(0, 1).float().contiguous()  # image-major
    x, logdet = transform_q(tree, z0, cond_q(flow, tree, feat))
    lp = std_normal_logp(z0) - logdet
    return x.transpose(0, 1).reshape(n * b, d), lp.transpose(0, 1).reshape(n * b)


@torch.no_grad()
def quantize_sampler(flow: realnvp.RealNVP, feat_calib: torch.Tensor,
                     z0_calib: torch.Tensor) -> FlowQTree:
    """Calibrate and quantise the sampler: a float trajectory from the
    caller's (n * B, D) hypothesis-major noise (already times temp) under
    representative features, its per-site amaxes, and the quantised tree."""
    b = feat_calib.shape[0]
    n = z0_calib.shape[0] // b
    cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat_calib))
    act = collect_act_maxabs(flow, z0_calib, cproj.repeat(1, 1, n, 1))
    return prepare_flow(flow, act)


def shape_ok(cfg: realnvp.RealNVPConfig) -> bool:
    """The flows the quantised sampler takes: not a per-joint flow (dim
    2/3), and a shape the kernel takes (`cuda_sampler.check_shape` with
    D_ALIGN: D <= 64, H split over a cluster in multiples of 32). The JAX
    package's gate is D <= 128; the bf16 kernel's D <= 64 bounds the float
    draw the same way."""
    return (cfg.dim <= cuda_sampler.MAX_DP and cfg.dim not in (2, 3)
            and cuda_sampler.cluster_size(cfg.h_dim, D_ALIGN) is not None)
