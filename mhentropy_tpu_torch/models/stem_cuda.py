"""Fused ResNet stem: the CUDA kernel and its plain version.

Replaces mhentropy_tpu/models/stem_pallas.py::stem_forward (:120; Pallas
`_kernel` :49): conv 7x7/2 (pad 3, 3 -> 64, no bias) + eval BN + ReLU +
maxpool 3x3/2 (pad 1). The kernel is `csrc/stem.cu`; its header says what
bounds it on the H100 and how its design answers that.

`fold` puts eval BN into the conv weights once (w' = w g, b' = beta - mean g,
g = gamma / sqrt(var + eps), as stem_pallas.py:162-166); `stem_forward` runs
the folded stem on an NHWC image through the operator `mhent::stem`
(mhentropy_tpu_torch/ops.py): CPU tensors take `stem_plain`; CUDA tensors
launch the kernel, and anything it does not take raises.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext, ops

F_OUT = 64  # stem filters
TAPS = 7 * 7 * 3
MAX_BATCH = 65535  # the kernel's grid has one z slice an image

# Kernel launches since the count was last reset; nothing else touches it.
launches = 0


@torch.no_grad()
def fold(conv_w: torch.Tensor, bn_w: torch.Tensor, bn_b: torch.Tensor,
         mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
         dtype=torch.bfloat16):
    """(64, 3, 7, 7) conv + eval BN -> (w (147, 64) in dtype, tap index
    (ky * 7 + kx) * 3 + c; bias (64,) f32)."""
    g = bn_w.float() * torch.rsqrt(var.float() + eps)
    w = (conv_w.float() * g[:, None, None, None]).permute(2, 3, 1, 0).reshape(TAPS, F_OUT)
    return w.to(dtype).contiguous(), (bn_b.float() - mean.float() * g).contiguous()


def out_hw(h: int, w: int) -> tuple[int, int]:
    """Pooled output size: conv 7x7/2 pad 3, then maxpool 3x3/2 pad 1."""
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def stem_forward(image: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC image, folded (w, bias) -> (B, Hp, Wp, 64) NHWC."""
    return _op(image, w, bias)


def stem_plain(image: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """F.conv2d + folded BN + ReLU + F.max_pool2d, in the image's dtype."""
    weight = w.reshape(7, 7, 3, F_OUT).permute(3, 2, 0, 1).to(image.dtype)
    x = image.permute(0, 3, 1, 2)
    y = F.relu(F.conv2d(x, weight, bias.to(image.dtype), stride=2, padding=3))
    return F.max_pool2d(y, 3, stride=2, padding=1).permute(0, 2, 3, 1)


def check_args(image: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these: a contiguous bf16
    (B, H, W, 3) image with B <= 65535 (the grid's z extent), fold's bf16
    (147, 64) weights (16-byte aligned: the kernel copies their rows 16
    bytes at a time) and f32 (64,) bias, contiguous, on the image's device."""
    check_shapes(image, w, bias)
    ext.require(w.data_ptr() % 16 == 0, "stem: folded weights must be 16-byte aligned")


def check_shapes(image: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> None:
    """`check_args` but the alignment: what the fake implementation checks."""
    ext.require(image.dim() == 4 and image.shape[3] == 3,
                f"stem: image must be (B, H, W, 3), got {tuple(image.shape)}")
    ext.require(image.dtype == torch.bfloat16 and image.is_contiguous(),
                f"stem: image must be contiguous bfloat16 NHWC, got {image.dtype}")
    ext.require(1 <= image.shape[0] <= MAX_BATCH and image.shape[1] >= 1 and image.shape[2] >= 1,
                f"stem: the kernel takes 1 to {MAX_BATCH} images, got {tuple(image.shape)}")
    ext.require(w.shape == (TAPS, F_OUT) and w.dtype == torch.bfloat16 and w.is_contiguous(),
                f"stem: folded weights must be contiguous bfloat16 {(TAPS, F_OUT)}")
    ext.require(bias.shape == (F_OUT,) and bias.dtype == torch.float32 and bias.is_contiguous(),
                "stem: bias must be contiguous float32 (64,)")
    ext.require(w.device == image.device and bias.device == image.device,
                "stem: tensors on different devices")


def _stem_kernel(image: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    global launches
    ext.require(image.is_cuda, f"stem: unsupported device {image.device}")
    check_args(image, w, bias)
    b, h, wd, _ = image.shape
    hp, wp = out_hw(h, wd)
    out = torch.empty((b, hp, wp, F_OUT), dtype=torch.bfloat16, device=image.device)
    lib = ext.load()
    err = lib.mhent_stem_forward(image.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), b, h, wd, ext.stream_of(image))
    ext.check(err, "mhent_stem_forward")
    launches += 1
    return out


def _stem_fake(image: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    ops.require_device(image, "stem")
    if image.is_cuda:
        check_shapes(image, w, bias)
    b, h, wd, _ = image.shape
    hp, wp = out_hw(h, wd)
    return image.new_empty((b, hp, wp, F_OUT))


_op = ops.define("stem(Tensor image, Tensor w, Tensor bias) -> Tensor",
                 cpu=lambda image, w, bias: stem_plain(image, w, bias).contiguous(),
                 cuda=_stem_kernel, fake=_stem_fake)
