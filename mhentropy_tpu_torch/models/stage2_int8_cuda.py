"""W8A8 ResNet-50 stages 2 and 3: the CUDA kernel and its plain version.

Replaces mhentropy_tpu/models/stage2_int8.py::stage_forward_q (:217; Pallas
`_kernel` :81) with `csrc/stage2_int8.cu`, one C call per bottleneck; its
header says what bounds it on the H100 and how its design answers that.

`pack` turns the calibrated sites of `models/quant.prepare`
(`layer{stage}_{j}/conv{1,2,3}`, `layer{stage}_0/downsample_conv`) into the
kernel's operands once per calibration, the int8 stage-1 kernel's
`Int8Block`s: conv2's `inv_sa` folded into conv1's scale and bias and
conv3's into conv2's, as the TPU kernel does (`_sb(site, fold=)` :203). `stage_forward_q` runs a packed stage on a
(B, H, W, Cin) float NHWC map and returns (B, H/2, W/2, Cout) through the
operator `mhent::stage2_int8` (mhentropy_tpu_torch/ops.py): CPU tensors take
`stage_plain`, CUDA tensors launch the kernel, and anything it does not take
raises. `supported` and `sites_ok` are the JAX gates (:327, :335),
without the backend clause.

The plain version repeats the kernel's arithmetic in the TPU kernel's
order: the block-0 input quantised with conv1's factor, the integer products
as f64 products of integer-valued tensors (exact; conv2's K = 9 W can pass
2^24, so f32 would not be), each converted to f32 as the kernel converts
its s32 sums, each epilogue multiply and add rounded on its own, the carry
between blocks in f32, each later block quantising that carry with its own
conv1 factor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext, ops
from mhentropy_tpu_torch.models import stage1_int8_cuda
from mhentropy_tpu_torch.models.stage1_int8_cuda import TAPS, Int8Block, _quant


class StageGeom(NamedTuple):
    width: int  # bottleneck width W (conv1 / conv2 output channels)
    cin: int  # stage input channels
    cout: int  # stage output channels (4 W)
    n_blocks: int
    w_in: int  # input image width (pixels); H == W


GEOMS = {2: StageGeom(128, 256, 512, 4, 64),
         3: StageGeom(256, 512, 1024, 6, 32)}

# Kernel launches since the count was last reset: one per bottleneck (each
# C call runs that bottleneck's convolutions).
launches = 0


def sites_ok(sites: dict, stage: int) -> bool:
    g = GEOMS[stage]
    need = [f"layer{stage}_{j}/conv{k}" for j in range(g.n_blocks) for k in (1, 2, 3)]
    need.append(f"layer{stage}_0/downsample_conv")
    return all(k in sites for k in need)


def supported(x: torch.Tensor, stage: int, train: bool = False) -> bool:
    if stage not in GEOMS:
        return False
    g = GEOMS[stage]
    # A float NHWC map: an int8 input would be scaled twice by the quantise.
    return (not train and x.dim() == 4 and x.dtype != torch.int8 and x.shape[3] == g.cin
            and x.shape[1] == x.shape[2] == g.w_in)


def pack(sites: dict, stage: int) -> list[Int8Block]:
    return stage1_int8_cuda.pack_stage(sites, stage, GEOMS[stage].n_blocks)


def stage_forward_q(x: torch.Tensor, packed: list[Int8Block], stage: int,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, Cin) float NHWC -> (B, H/2, W/2, Cout) in out_dtype
    (bfloat16 or float32)."""
    ext.require(out_dtype in (torch.bfloat16, torch.float32),
                f"int8 stage {stage}: out_dtype {out_dtype} is neither bfloat16 nor float32")
    return _op(x, ops.flatten(packed), stage, out_dtype == torch.bfloat16)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) integer-valued f32 times (N, K) int8 -> (..., N) f32: the
    exact integer sum, rounded to f32 once."""
    return (a.double() @ w.double().T).float()


def _conv3x3(h: torch.Tensor, w2: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3, pad 1, stride 1 or 2, on NHWC integer-valued h with the packed
    (W, 9 W) weights: the nine taps' products summed exactly in f64."""
    b, hh, ww, c = h.shape
    ho, wo = (hh - 1) // stride + 1, (ww - 1) // stride + 1
    hp = F.pad(h, (0, 0, 1, 1, 1, 1)).double()
    acc = sum(hp[:, dy + 1:dy + 2 + stride * (ho - 1):stride,
                 dx + 1:dx + 2 + stride * (wo - 1):stride]
              @ w2[:, c * t:c * (t + 1)].double().T
              for t, (dy, dx) in enumerate(TAPS))
    return acc.float()


def stage_plain(x: torch.Tensor, packed: list[Int8Block]) -> torch.Tensor:
    """The kernel's arithmetic on NHWC tensors; returns the f32 carry of the
    last block."""
    prev = None
    for j, blk in enumerate(packed):
        first = j == 0
        xq = _quant((x.float() if first else prev) * blk.inv_in)
        h1 = _quant(torch.relu(_mm(xq, blk.w1) * blk.s1 + blk.b1))
        h2 = _quant(torch.relu(_conv3x3(h1, blk.w2, 2 if first else 1) * blk.s2 + blk.b2))
        y3 = _mm(h2, blk.w3) * blk.s3 + blk.b3
        res = _mm(xq[:, ::2, ::2], blk.wd) * blk.sd + blk.bd if first else prev
        prev = torch.relu(y3 + res)
    return prev


def check_shapes(x: torch.Tensor, packed: list[Int8Block], stage: int, out_dtype) -> None:
    """The kernel's shape, dtype and layout checks (the fake
    implementation's too)."""
    ext.require(stage in GEOMS, f"int8 stage kernel: no stage {stage} (GEOMS has {list(GEOMS)})")
    g = GEOMS[stage]
    ext.require(x.dim() == 4 and x.shape[1:] == (g.w_in, g.w_in, g.cin),
                f"int8 stage {stage}: x must be (B, {g.w_in}, {g.w_in}, {g.cin}), "
                f"got {tuple(x.shape)}")
    ext.require(x.dtype in (torch.bfloat16, torch.float32) and x.is_contiguous(),
                f"int8 stage {stage}: x must be contiguous bfloat16 or float32 NHWC, "
                f"got {x.dtype}")
    ext.require(out_dtype in (torch.bfloat16, torch.float32),
                f"int8 stage {stage}: out_dtype {out_dtype} is neither bfloat16 nor float32")
    ext.require(len(packed) == g.n_blocks and packed[0].wd is not None,
                f"int8 stage {stage}: needs the {g.n_blocks} packed blocks of `pack`")
    for j, blk in enumerate(packed):
        cin = g.cin if j == 0 else g.cout
        ext.require(blk.w1.shape == (g.width, cin) and blk.w2.shape == (g.width, 9 * g.width)
                    and blk.w3.shape == (g.cout, g.width)
                    and (j > 0 or blk.wd.shape == (g.cout, g.cin)),
                    f"int8 stage {stage}: packed block {j} does not fit {g}")
        for t in (blk.w1, blk.w2, blk.w3, *((blk.wd,) if j == 0 else ())):
            ext.require(t.dtype == torch.int8 and t.is_contiguous() and t.device == x.device,
                        f"int8 stage {stage}: packed weights must be contiguous int8 on "
                        "x's device")
        for t in (blk.inv_in, blk.s1, blk.b1, blk.s2, blk.b2, blk.s3, blk.b3,
                  *((blk.sd, blk.bd) if j == 0 else ())):
            ext.require(t.dtype == torch.float32 and t.is_contiguous() and t.device == x.device,
                        f"int8 stage {stage}: packed scales must be contiguous float32 on "
                        "x's device")


def _stage_kernel(x: torch.Tensor, packed: list[Int8Block], stage: int,
                  out_dtype) -> torch.Tensor:
    global launches
    ext.require(x.is_cuda, f"int8 stage {stage}: unsupported device {x.device}")
    check_shapes(x, packed, stage, out_dtype)
    g = GEOMS[stage]
    b, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    dev = x.device
    xq0 = torch.empty((b, h, w, g.cin), dtype=torch.int8, device=dev)
    h1 = torch.empty((b, h, w, g.width), dtype=torch.int8, device=dev)  # later blocks: a prefix
    h2 = torch.empty((b, ho, wo, g.width), dtype=torch.int8, device=dev)
    carry = torch.empty((b, ho, wo, g.cout), dtype=torch.float32, device=dev)
    out = torch.empty((b, ho, wo, g.cout), dtype=out_dtype, device=dev)
    xqs = [torch.empty((b, ho, wo, g.cout), dtype=torch.int8, device=dev) for _ in range(2)]
    lib = ext.load()
    stream = ext.stream_of(x)
    xq = xq0
    for j, blk in enumerate(packed):
        first, last = j == 0, j == len(packed) - 1
        xq_next = None if last else xqs[j % 2]
        inv_next = None if last else packed[j + 1].inv_in
        err = lib.mhent_stage2_int8_block(
            x.data_ptr() if first else None, xq.data_ptr(), blk.inv_in.data_ptr(),
            blk.w1.data_ptr(), blk.s1.data_ptr(), blk.b1.data_ptr(),
            blk.w2.data_ptr(), blk.s2.data_ptr(), blk.b2.data_ptr(),
            blk.w3.data_ptr(), blk.s3.data_ptr(), blk.b3.data_ptr(),
            blk.wd.data_ptr() if first else None, blk.sd.data_ptr() if first else None,
            blk.bd.data_ptr() if first else None, h1.data_ptr(), h2.data_ptr(),
            carry.data_ptr(), (out if last else carry).data_ptr(),
            None if last else xq_next.data_ptr(), None if last else inv_next.data_ptr(),
            int(x.dtype == torch.bfloat16), int(last and out_dtype == torch.bfloat16),
            b, h if first else ho, w if first else wo, g.cin if first else g.cout,
            g.width, g.cout, int(first), stream)
        ext.check(err, "mhent_stage2_int8_block")
        launches += 1
        xq = xq_next
    return out


def _stage_fake(x, flat, stage: int, bf16_out: bool):
    ops.require_device(x, f"int8 stage {stage}")
    out_dtype = torch.bfloat16 if bf16_out else torch.float32
    packed = ops.unflatten(flat, Int8Block)
    if x.is_cuda:
        check_shapes(x, packed, stage, out_dtype)
    b, h, w, _ = x.shape
    return x.new_empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, packed[-1].w3.shape[0]),
                       dtype=out_dtype)


_op = ops.define(
    "stage2_int8(Tensor x, Tensor?[] packed, int stage, bool bf16_out) -> Tensor",
    cpu=lambda x, flat, stage, bf16_out: stage_plain(x, ops.unflatten(flat, Int8Block)).to(
        torch.bfloat16 if bf16_out else torch.float32).contiguous(),
    cuda=lambda x, flat, stage, bf16_out: _stage_kernel(
        x, ops.unflatten(flat, Int8Block), stage,
        torch.bfloat16 if bf16_out else torch.float32),
    fake=_stage_fake)
