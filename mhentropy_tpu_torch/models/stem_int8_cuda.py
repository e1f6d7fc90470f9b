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
lays a site out for the kernel. `stem_forward_q` runs it: CPU tensors take
`stem_plain`; CUDA tensors launch the kernel, and anything it does not take
raises. `supported` is the JAX package's geometry gate (:255) without its
backend clause: it decides whether `models/quant.py` runs the stem in int8
at all, so it is kept exactly.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext
from mhentropy_tpu_torch.models.stem_cuda import F_OUT, TAPS, out_hw

EPS = 1e-5
ROW_TAPS = 24  # a kernel row's 21 (kx, c) taps padded to six 4-byte words

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
    """The site with the kernel's weight layout added: wk (7, 64, 24) int8,
    [ky][f][kx * 3 + c], the last three taps of each row zero."""
    wk = site["w8"].permute(0, 3, 1, 2).reshape(7, F_OUT, 21)
    wk = F.pad(wk, (0, ROW_TAPS - 21)).contiguous()
    return {"w8": site["w8"], "wk": wk, "inv_a": site["inv_a"].float().contiguous(),
            "scale": site["scale"].float().contiguous(),
            "bias": site["bias"].float().contiguous()}


def supported(x: torch.Tensor, num_filters: int = F_OUT, train: bool = False) -> bool:
    return (not train and x.dim() == 4 and x.shape[1] % 4 == 0 and x.shape[1] >= 8
            and x.shape[2] == 256 and x.shape[3] == 3 and num_filters == F_OUT)


def stem_forward_q(image: torch.Tensor, packed: dict,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) normalised float image -> (B, Hp, Wp, 64) NHWC in out_dtype
    (bfloat16 or float32)."""
    if image.device.type == "cpu":
        return stem_plain(image, packed).to(out_dtype)
    return _stem_kernel(image, packed, out_dtype)


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


def _stem_kernel(image: torch.Tensor, packed: dict, out_dtype) -> torch.Tensor:
    global launches
    ext.require(image.is_cuda, f"int8 stem: unsupported device {image.device}")
    ext.require(image.dim() == 4 and image.shape[3] == 3,
                f"int8 stem: image must be (B, H, W, 3), got {tuple(image.shape)}")
    ext.require(image.dtype == torch.float32 and image.is_contiguous(),
                f"int8 stem: image must be contiguous float32 NHWC, got {image.dtype}")
    ext.require(out_dtype in (torch.bfloat16, torch.float32),
                f"int8 stem: out_dtype {out_dtype} is neither bfloat16 nor float32")
    wk, inv_a, scale, bias = packed["wk"], packed["inv_a"], packed["scale"], packed["bias"]
    ext.require(wk.shape == (7, F_OUT, ROW_TAPS) and wk.dtype == torch.int8
                and wk.is_contiguous(), "int8 stem: packed weights must be contiguous int8 "
                f"{(7, F_OUT, ROW_TAPS)} (stem_int8_cuda.pack)")
    for t, n in ((inv_a, 3), (scale, F_OUT), (bias, F_OUT)):
        ext.require(t.shape == (n,) and t.dtype == torch.float32 and t.is_contiguous(),
                    f"int8 stem: scales must be contiguous float32, got {tuple(t.shape)}")
    ext.require(all(t.device == image.device for t in (wk, inv_a, scale, bias)),
                "int8 stem: tensors on different devices")
    b, h, w, _ = image.shape
    hp, wp = out_hw(h, w)
    out = torch.empty((b, hp, wp, F_OUT), dtype=out_dtype, device=image.device)
    err = ext.load().mhent_stem_int8_forward(
        image.data_ptr(), wk.data_ptr(), inv_a.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, w, int(out_dtype == torch.bfloat16), ext.stream_of(image))
    ext.check(err, "mhent_stem_int8_forward")
    launches += 1
    return out
