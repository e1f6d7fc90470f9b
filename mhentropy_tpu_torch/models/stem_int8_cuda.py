"""W8A8 ResNet stem: the CUDA kernel and its plain version.

Replaces mhentropy_tpu/models/stem_int8.py::stem_forward_q (:122; Pallas
`_kernel` :58) with `csrc/stem_int8.cu`, whose header says what bounds it on
the H100 and how its design answers that. The arithmetic, for a normalised
f32 image:

    xq  = clip(rint(x * inv_a[c]), +-127)              per input channel
    acc = sum over the 147 taps of xq * w8              exact s32, pad 3, stride 2
    y   = relu(acc * scale[f] + bias[f])                each op rounded alone
    out = maxpool 3x3/2 pad 1 of y                      after the affine

`prepare_stem_site` :205 folds the per-input-channel activation scale into
the weights before their per-output-channel quantisation (the contraction
mixes channels of different scales), and eval BN into the epilogue affine;
the pool follows the affine because BN's gamma may be negative. `pack`
lays a site out for the kernel: `wq`, the weights as the K-major s8 operand
of its products. `stem_forward_q` runs it through the operator
`mhent::stem_int8` (mhentropy_tpu_torch/ops.py) on the kernel's operands:
CPU tensors take `stem_plain` (on `w8`, which `unpack` recovers from `wq`
exactly); CUDA tensors launch the kernel, and anything it does not take
raises. The
kernel gives each block a band of conv rows (`plan_band`) and takes the
bulk-copy path where the image's rows allow it. `supported` is the JAX
package's geometry gate (:255) without its backend clause: it decides
whether `models/quant.py` runs the stem in int8 at all, so it is kept
exactly.
"""

from __future__ import annotations

import functools

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext, ops
from mhentropy_tpu_torch.models.stem_cuda import F_OUT, TAPS, out_hw

EPS = 1e-5
ROW_TAPS = 32  # a kernel row's 21 (kx, c) taps padded to one 32-byte k-step
K_BYTES = 7 * ROW_TAPS  # the kernel's K: seven kernel rows' runs
CONV_COLS = 128  # conv columns a tile of the kernel: W <= 256 is one tile
BAND_OVERHEAD = 4  # a block's start, in conv rows: its first input rows and the straddling row

# Kernel launches since the count was last reset; nothing else touches it.
launches = 0


@torch.no_grad()
def prepare_stem_site(conv_w: torch.Tensor, bn, act_maxabs: torch.Tensor) -> dict:
    """(64, 3, 7, 7) conv weights, the eval BatchNorm2d after them and the
    image's (3,) per-channel max|x| -> {w8 (7, 7, 3, 64) int8 HWIO, inv_a (3,),
    scale (64,), bias (64,)}, the JAX site's keys and layout."""
    w = conv_w.float().permute(2, 3, 1, 0)  # HWIO
    s_a = torch.as_tensor(act_maxabs, dtype=torch.float32, device=w.device) / 127.0
    s_a = torch.where(s_a > 0, s_a, torch.ones_like(s_a))
    wf = w * s_a[None, None, :, None]
    s_w = wf.abs().amax(dim=(0, 1, 2)) / 127.0
    s_w = torch.where(s_w > 0, s_w, torch.ones_like(s_w))
    w8 = torch.clamp(torch.round(wf / s_w), -127, 127).to(torch.int8)
    g = bn.weight.float() / torch.sqrt(bn.running_var.float() + EPS)
    return {"w8": w8.contiguous(), "inv_a": (1.0 / s_a).float(), "scale": (s_w * g).float(),
            "bias": (bn.bias.float() - bn.running_mean.float() * g).float()}


@torch.no_grad()
def pack(site: dict) -> dict:
    """The site with the kernel's weight operand added: wq (64, 224) int8,
    K-major, [f][ky * 32 + kx * 3 + c] times the sign of scale[f]; taps 21-31
    of each kernel row's run are zero (the kernel's im2col holds other bytes
    there). The kernel takes |scale|: a filter's negated sums times |scale|
    are its sums times scale, exactly, and its affine is then non-decreasing
    in the sum, so the kernel pools the sums before it."""
    sign = torch.where(site["scale"] < 0, -1, 1).to(torch.int8)
    wq = site["w8"].permute(3, 0, 1, 2).reshape(F_OUT, 7, 21)  # HWIO -> [f][ky][kx * 3 + c]
    wq = F.pad(wq, (0, ROW_TAPS - 21)).reshape(F_OUT, K_BYTES) * sign[:, None]
    return {"w8": site["w8"], "wq": wq.contiguous(), "inv_a": site["inv_a"].float().contiguous(),
            "scale": site["scale"].float().contiguous(),
            "bias": site["bias"].float().contiguous()}


def supported(x: torch.Tensor, num_filters: int = F_OUT, train: bool = False) -> bool:
    return (not train and x.dim() == 4 and x.shape[1] % 4 == 0 and x.shape[1] >= 8
            and x.shape[2] == 256 and x.shape[3] == 3 and num_filters == F_OUT)


@functools.lru_cache(maxsize=None)
def plan_band(b: int, conv_rows: int, tiles: int, sms: int) -> int:
    """Conv rows a block (even): the band that minimises waves x tiles x
    (band + BAND_OVERHEAD) for b x ceil(conv_rows / band) blocks, one an SM
    on `sms` SMs (ties: the larger band). 32 at B = 32 and 8 at B = 8 for
    128 conv rows on 132 SMs (128 blocks). Cached: the launch path asks it
    every call."""
    def cost(band):
        waves = -(-b * -(-conv_rows // band) // sms)
        return waves * tiles * (band + BAND_OVERHEAD), -band

    return min(range(2, conv_rows + 2, 2), key=cost)


def col_tiles(wp: int) -> int:
    """The kernel's column tiles for wp pooled columns: 64 in the first, 63
    in each later one."""
    return 1 if wp <= 64 else 1 + -(-(wp - 64) // 63)


def stem_forward_q(image: torch.Tensor, packed: dict,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) normalised float image -> (B, Hp, Wp, 64) NHWC in out_dtype
    (bfloat16 or float32)."""
    ext.require(out_dtype in (torch.bfloat16, torch.float32),
                f"int8 stem: out_dtype {out_dtype} is neither bfloat16 nor float32")
    return _op(image, packed["wq"], packed["inv_a"], packed["scale"], packed["bias"],
               out_dtype == torch.bfloat16)


def unpack(wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """`pack`'s inverse on the weights: wq and the scale's signs -> w8
    (7, 7, 3, 64) int8 HWIO, exactly."""
    sign = torch.where(scale < 0, -1, 1).to(torch.int8)
    w = wq.view(F_OUT, 7, ROW_TAPS)[:, :, :21] * sign[:, None, None]
    return w.reshape(F_OUT, 7, 7, 3).permute(1, 2, 3, 0)


def stem_plain(image: torch.Tensor, site: dict) -> torch.Tensor:
    """The site's arithmetic in PyTorch ops, f32 out. The integer sum is an
    f64 product of the integer-valued im2col (exact), then rounded to f32 as
    the kernel converts its s32 sum."""
    xq = torch.clamp(torch.round(image.float() * site["inv_a"]), -127, 127)
    b, h, w, _ = xq.shape
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(xq, (0, 0, 3, 3, 3, 3))
    cols = torch.cat([xp[:, ky:ky + 2 * hc - 1:2, kx:kx + 2 * wc - 1:2]
                      for ky in range(7) for kx in range(7)], dim=-1)  # (ky, kx, c) order
    acc = (cols.double() @ site["w8"].reshape(TAPS, F_OUT).double()).float()
    y = torch.relu(acc * site["scale"] + site["bias"])
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


def check_shapes(image: torch.Tensor, packed: dict, out_dtype) -> None:
    """The kernel's shape, dtype and layout checks (the fake
    implementation's too); `_stem_kernel` adds those of its paths."""
    ext.require(image.dim() == 4 and image.shape[3] == 3,
                f"int8 stem: image must be (B, H, W, 3), got {tuple(image.shape)}")
    ext.require(image.dtype == torch.float32 and image.is_contiguous(),
                f"int8 stem: image must be contiguous float32 NHWC, got {image.dtype}")
    ext.require(out_dtype in (torch.bfloat16, torch.float32),
                f"int8 stem: out_dtype {out_dtype} is neither bfloat16 nor float32")
    wq, inv_a, scale, bias = packed["wq"], packed["inv_a"], packed["scale"], packed["bias"]
    ext.require(wq.shape == (F_OUT, K_BYTES) and wq.dtype == torch.int8
                and wq.is_contiguous(), "int8 stem: packed weights must be contiguous int8 "
                f"{(F_OUT, K_BYTES)} (stem_int8_cuda.pack)")
    for t, n in ((inv_a, 3), (scale, F_OUT), (bias, F_OUT)):
        ext.require(t.shape == (n,) and t.dtype == torch.float32 and t.is_contiguous(),
                    f"int8 stem: scales must be contiguous float32, got {tuple(t.shape)}")
    ext.require(all(t.device == image.device for t in (wq, inv_a, scale, bias)),
                "int8 stem: tensors on different devices")
    ext.require(image.shape[0] <= 65535,
                f"int8 stem: at most 65,535 images a call, got {image.shape[0]}")


def _stem_kernel(image: torch.Tensor, packed: dict, out_dtype,
                 bulk: bool | None = None) -> torch.Tensor:
    """The kernel launch. `bulk` picks its path: bulk copies of the input rows
    (W <= 256, W a multiple of 4, a 16-byte aligned image; the default where
    those hold) or loads by the quantising threads (any shape)."""
    global launches
    ext.require(image.is_cuda, f"int8 stem: unsupported device {image.device}")
    check_shapes(image, packed, out_dtype)
    wq, inv_a, scale, bias = packed["wq"], packed["inv_a"], packed["scale"], packed["bias"]
    b, h, w, _ = image.shape
    can_bulk = w % 4 == 0 and w <= 2 * CONV_COLS and image.data_ptr() % 16 == 0
    bulk = can_bulk if bulk is None else bulk
    ext.require(can_bulk or not bulk, f"int8 stem: the bulk path takes W <= {2 * CONV_COLS}, "
                f"a multiple of 4, on a 16-byte aligned image, got {tuple(image.shape)}")
    hp, wp = out_hw(h, w)
    band = plan_band(b, (h - 1) // 2 + 1, col_tiles(wp),
                     torch.cuda.get_device_properties(image.device).multi_processor_count)
    out = torch.empty((b, hp, wp, F_OUT), dtype=out_dtype, device=image.device)
    err = ext.load().mhent_stem_int8_forward(
        image.data_ptr(), wq.data_ptr(), inv_a.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, w, int(out_dtype == torch.bfloat16), band, int(bulk),
        ext.stream_of(image))
    ext.check(err, "mhent_stem_int8_forward")
    launches += 1
    return out


def _operands(wq, inv_a, scale, bias) -> dict:
    return {"wq": wq, "inv_a": inv_a, "scale": scale, "bias": bias}


def _stem_cpu(image, wq, inv_a, scale, bias, bf16_out: bool):
    site = {**_operands(wq, inv_a, scale, bias), "w8": unpack(wq, scale)}
    return stem_plain(image, site).to(torch.bfloat16 if bf16_out else torch.float32).contiguous()


def _stem_fake(image, wq, inv_a, scale, bias, bf16_out: bool):
    ops.require_device(image, "int8 stem")
    out_dtype = torch.bfloat16 if bf16_out else torch.float32
    if image.is_cuda:
        check_shapes(image, _operands(wq, inv_a, scale, bias), out_dtype)
    b, h, w, _ = image.shape
    hp, wp = out_hw(h, w)
    return image.new_empty((b, hp, wp, F_OUT), dtype=out_dtype)


_op = ops.define(
    "stem_int8(Tensor image, Tensor wq, Tensor inv_a, Tensor scale, Tensor bias, "
    "bool bf16_out) -> Tensor",
    cpu=_stem_cpu,
    cuda=lambda image, wq, inv_a, scale, bias, bf16_out: _stem_kernel(
        image, _operands(wq, inv_a, scale, bias),
        torch.bfloat16 if bf16_out else torch.float32),
    fake=_stem_fake)
