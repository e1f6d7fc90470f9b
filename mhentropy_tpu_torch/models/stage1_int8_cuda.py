"""W8A8 ResNet-50 stage 1: the CUDA kernel and its plain version.

Replaces mhentropy_tpu/models/stage1_int8.py::stage1_forward_q (:207;
Pallas `_kernel` :46). The kernel is `csrc/stage1_int8.cu`, one launch per
bottleneck; its header says what bounds it on the H100 and how its design
answers that. Blocks 0 and 1 write their f32 output and that output
quantised by the next block's input factor; the next block reads the s8
copy for its convolutions and the f32 one for its residual.

`pack` turns the calibrated stage-1 sites of `models/quant.prepare`
(`layer1_{j}/conv{1,2,3}` and `layer1_0/downsample_conv`: HWIO int8
weights, f32 `scale`, `bias`, `inv_sa`) into the kernel's operands, folding
each requantise into the epilogue before it as the TPU kernel does
(`_sb(site, fold=inv)` :190). `stage1_forward_q` runs the packed stage on
(B, H, W, 64) NHWC activations and returns (B, H, W, 256) bf16, through the
operator `mhent::stage1_int8` (mhentropy_tpu_torch/ops.py): CPU tensors take
`stage1_plain`; CUDA tensors launch the kernel, and anything it does not
take raises.

The plain version repeats the kernel's arithmetic in the same order: the
integer products as f32 products of integer-valued tensors (exact: K <= 576
and every partial sum is below 2^24), each epilogue multiply and add
rounded on its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext, ops

F1 = 64
FOUT = 256
TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
JAX_PAD = 128  # the TPU kernel's row margin (stage1_int8.py:41), which bounds W there

# Kernel launches since the count was last reset (one per bottleneck).
launches = 0


class Int8Block(NamedTuple):
    """One bottleneck's operands; the shapes are stage 1's (width W = 64,
    Cout = 256)."""

    inv_in: torch.Tensor  # (1,) f32 quantise factor of the block input (conv1's inv_sa)
    w1: torch.Tensor  # (W, cin) int8 [out, in]
    s1: torch.Tensor  # (W,) f32, conv2's inv_sa folded in
    b1: torch.Tensor
    w2: torch.Tensor  # (W, 9 W) int8 [out, tap * W + in], tap = (dy + 1) * 3 + dx + 1
    s2: torch.Tensor  # (W,) f32, conv3's inv_sa folded in
    b2: torch.Tensor
    w3: torch.Tensor  # (Cout, W) int8
    s3: torch.Tensor  # (Cout,) f32
    b3: torch.Tensor
    wd: torch.Tensor | None  # (Cout, Cin) int8 downsample on block 0
    sd: torch.Tensor | None
    bd: torch.Tensor | None


def sites_ok(sites: dict) -> bool:
    """All stage-1 conv sites present (calibrated with q_from == 0)."""
    need = [f"layer1_{j}/conv{k}" for j in range(3) for k in (1, 2, 3)]
    return all(k in sites for k in need + ["layer1_0/downsample_conv"])


def supported(shape, train: bool = False) -> bool:
    """The JAX package's geometry gate for the int8 stage-1 kernel
    (stage1_int8.py:328) on a post-stem shape (B, H, W, C), without its
    backend clause: C = 64, H and W multiples of 8, W <= PAD - 2 = 126,
    H * W % 128 in {0, 64} and H * W >= 3136. `models/quant.py`'s "auto"
    q_from reads it; the kernel itself takes any geometry."""
    return (not train and len(shape) == 4 and shape[3] == F1 and shape[1] % 8 == 0
            and shape[2] % 8 == 0 and shape[2] <= JAX_PAD - 2
            and (shape[1] * shape[2]) % 128 in (0, 64) and shape[1] * shape[2] >= 3136)


def pack(sites: dict) -> list[Int8Block]:
    return pack_stage(sites, 1, 3)


@torch.no_grad()
def pack_stage(sites: dict, stage: int, n_blocks: int) -> list[Int8Block]:
    """The bottlenecks `layer{stage}_{j}` of the sites as Int8Blocks (also
    the int8 stage 2/3 kernel's operands, models/stage2_int8_cuda.py)."""
    def site(j, name):
        return sites[f"layer{stage}_{j}/{name}"]

    def t1x1(w8):  # (1, 1, I, O) -> (O, I)
        return w8[0, 0].T.contiguous()

    def sb(s, fold=None):
        scale, bias = s["scale"].float(), s["bias"].float()
        if fold is not None:
            scale, bias = scale * fold, bias * fold
        return scale.contiguous(), bias.contiguous()

    out = []
    for j in range(n_blocks):
        c1, c2, c3 = site(j, "conv1"), site(j, "conv2"), site(j, "conv3")
        s1, b1 = sb(c1, c2["inv_sa"].float())
        s2, b2 = sb(c2, c3["inv_sa"].float())
        s3, b3 = sb(c3)
        w2 = torch.cat([c2["w8"][dy + 1, dx + 1].T for dy, dx in TAPS], dim=1)
        wd = sd = bd = None
        if j == 0:
            ds = site(0, "downsample_conv")
            wd = t1x1(ds["w8"])
            sd, bd = sb(ds)
        out.append(Int8Block(
            c1["inv_sa"].float().reshape(1).contiguous(), t1x1(c1["w8"]), s1, b1,
            w2.contiguous(), s2, b2, t1x1(c3["w8"]), s3, b3, wd, sd, bd))
    return out


def stage1_forward_q(x: torch.Tensor, packed: list[Int8Block]) -> torch.Tensor:
    """(B, H, W, 64) NHWC post-stem activations -> (B, H, W, 256) bf16."""
    return _op(x, ops.flatten(packed))


def _quant(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -127.0, 127.0)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) integer-valued f32 times (N, K) int8 -> (..., N), exact."""
    return a @ w.float().T


def stage1_plain(x: torch.Tensor, packed: list[Int8Block]) -> torch.Tensor:
    """The kernel's arithmetic on NHWC f32 tensors; returns f32."""
    b, h, w, _ = x.shape
    prev = x.float()
    for j, blk in enumerate(packed):
        xq = _quant(prev * blk.inv_in)
        h1 = _quant(torch.relu(_mm(xq, blk.w1) * blk.s1 + blk.b1))
        hp = F.pad(h1, (0, 0, 1, 1, 1, 1))
        acc2 = sum(_mm(hp[:, dy + 1:dy + 1 + h, dx + 1:dx + 1 + w],
                       blk.w2[:, 64 * t:64 * (t + 1)])
                   for t, (dy, dx) in enumerate(TAPS))
        h2 = _quant(torch.relu(acc2 * blk.s2 + blk.b2))
        y3 = _mm(h2, blk.w3) * blk.s3 + blk.b3
        res = _mm(xq, blk.wd) * blk.sd + blk.bd if j == 0 else prev
        prev = torch.relu(y3 + res)
    return prev


def check_shapes(x: torch.Tensor, packed: list[Int8Block]) -> None:
    """The kernel's shape, dtype and layout checks (the fake
    implementation's too)."""
    ext.require(x.dim() == 4 and x.shape[3] == F1,
                f"int8 stage 1: x must be (B, H, W, 64), got {tuple(x.shape)}")
    ext.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                f"int8 stage 1: x must be contiguous bfloat16 NHWC, got {x.dtype}")
    ext.require(len(packed) == 3 and packed[0].wd is not None,
                "int8 stage 1: needs the three packed blocks of `pack`")
    for j, blk in enumerate(packed):
        cin = F1 if j == 0 else FOUT
        ext.require(blk.w1.shape == (F1, cin) and blk.w2.shape == (F1, 9 * F1)
                    and blk.w3.shape == (FOUT, F1),
                    f"int8 stage 1: packed block {j} does not fit cin={cin}")
        for t in (blk.w1, blk.w2, blk.w3, *((blk.wd,) if j == 0 else ())):
            ext.require(t.dtype == torch.int8 and t.is_contiguous() and t.device == x.device,
                        "int8 stage 1: packed weights must be contiguous int8 on x's device")
        for t in (blk.inv_in, blk.s1, blk.b1, blk.s2, blk.b2, blk.s3, blk.b3,
                  *((blk.sd, blk.bd) if j == 0 else ())):
            ext.require(t.dtype == torch.float32 and t.is_contiguous() and t.device == x.device,
                        "int8 stage 1: packed scales must be contiguous float32 on x's device")


def _stage1_kernel(x: torch.Tensor, packed: list[Int8Block]) -> torch.Tensor:
    global launches
    ext.require(x.is_cuda, f"int8 stage 1: unsupported device {x.device}")
    check_shapes(x, packed)
    b, h, w, _ = x.shape
    lib = ext.load()
    stream = ext.stream_of(x)
    def ptr(t):
        return None if t is None else t.data_ptr()

    xq = None  # the block input quantised (blocks 1-2), written by the block before
    for j, blk in enumerate(packed):
        last = j == len(packed) - 1
        out = torch.empty((b, h, w, FOUT), device=x.device,
                          dtype=torch.bfloat16 if last else torch.float32)
        out_q = None if last else torch.empty((b, h, w, FOUT), device=x.device,
                                              dtype=torch.int8)
        inv_next = None if last else packed[j + 1].inv_in
        wd, sd, bd = (blk.wd, blk.sd, blk.bd) if j == 0 else (None, None, None)
        err = lib.mhent_stage1_int8_block(
            x.data_ptr(), ptr(xq), ptr(blk.inv_in) if j == 0 else None, blk.w1.data_ptr(),
            blk.s1.data_ptr(), blk.b1.data_ptr(), blk.w2.data_ptr(), blk.s2.data_ptr(),
            blk.b2.data_ptr(), blk.w3.data_ptr(), blk.s3.data_ptr(), blk.b3.data_ptr(),
            ptr(wd), ptr(sd), ptr(bd), ptr(inv_next), out.data_ptr(), ptr(out_q), b, h, w, j,
            stream)
        ext.check(err, "mhent_stage1_int8_block")
        launches += 1
        x, xq = out, out_q
    return x


def _stage1_fake(x: torch.Tensor, flat: list) -> torch.Tensor:
    ops.require_device(x, "int8 stage 1")
    if x.is_cuda:
        check_shapes(x, ops.unflatten(flat, Int8Block))
    return x.new_empty((*x.shape[:3], FOUT), dtype=torch.bfloat16)


_op = ops.define(
    "stage1_int8(Tensor x, Tensor?[] packed) -> Tensor",
    cpu=lambda x, flat: stage1_plain(x, ops.unflatten(flat, Int8Block)).to(torch.bfloat16)
    .contiguous(),
    cuda=lambda x, flat: _stage1_kernel(x, ops.unflatten(flat, Int8Block)), fake=_stage1_fake)
