"""ResNet-50 stage 1 (three bottlenecks, eval BN): the CUDA kernel and its
plain version.

Replaces mhentropy_tpu/models/stage1_pallas.py::stage1_forward (:160;
Pallas `_kernel` :64). The kernel is `csrc/stage1.cu`, one launch per
bottleneck; its header says what bounds it on the H100 and how its design
answers that.

`fold` puts each block's eval BN into its GEMM weights once (the JAX
`_fold` :152), and block 0's downsample bias into its conv3 bias, since the
kernel sums both products in one accumulator. `stage1_forward` runs the
folded stage on NHWC activations. CPU tensors take `stage1_plain`; CUDA
tensors launch the kernel, and anything it does not take raises. Unlike the
TPU gates (hw >= 3136, w <= 126), any H and W are accepted.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from mhentropy_tpu_torch import ext

F1 = 64  # bottleneck mid width
FOUT = 256  # block output channels

# Kernel launches since the count was last reset (one per bottleneck).
launches = 0


class FoldedBlock(NamedTuple):
    w1: torch.Tensor  # (cin, 64)        [in, out]
    b1: torch.Tensor  # (64,) f32
    w2: torch.Tensor  # (9, 64, 64)      [tap = (dy+1)*3 + dx+1, in, out]
    b2: torch.Tensor  # (64,) f32
    w3: torch.Tensor  # (64, 256)
    b3: torch.Tensor  # (256,) f32, plus the downsample bias on block 0
    wd: torch.Tensor | None  # (cin, 256) downsample on block 0, else None


def _scale_shift(bn: nn.BatchNorm2d):
    g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return g, bn.bias.float() - bn.running_mean.float() * g


@torch.no_grad()
def fold(blocks: Sequence[nn.Module], dtype=torch.bfloat16) -> list[FoldedBlock]:
    """Bottleneck modules (conv1/bn1/conv2/bn2/conv3/bn3 and, on block 0,
    downsample = (conv, bn)) -> folded GEMM weights."""
    out = []
    for blk in blocks:
        g1, s1 = _scale_shift(blk.bn1)
        g2, s2 = _scale_shift(blk.bn2)
        g3, s3 = _scale_shift(blk.bn3)
        w1 = (blk.conv1.weight.float()[:, :, 0, 0] * g1[:, None]).T
        w2 = (blk.conv2.weight.float() * g2[:, None, None, None]).permute(2, 3, 1, 0)
        w3 = (blk.conv3.weight.float()[:, :, 0, 0] * g3[:, None]).T
        wd = None
        if blk.downsample is not None:
            gd, sd = _scale_shift(blk.downsample[1])
            wd = (blk.downsample[0].weight.float()[:, :, 0, 0] * gd[:, None]).T
            wd = wd.to(dtype).contiguous()
            s3 = s3 + sd
        out.append(FoldedBlock(
            w1.to(dtype).contiguous(), s1.contiguous(),
            w2.reshape(9, F1, F1).to(dtype).contiguous(), s2.contiguous(),
            w3.to(dtype).contiguous(), s3.contiguous(), wd))
    return out


def stage1_forward(x: torch.Tensor, folded: Sequence[FoldedBlock]) -> torch.Tensor:
    """(B, H, W, 64) NHWC -> (B, H, W, 256) NHWC through the folded blocks."""
    if x.device.type == "cpu":
        return stage1_plain(x, folded)
    return _stage1_kernel(x, folded)


def _conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w.T[:, :, None, None].to(x.dtype))


def stage1_plain(x: torch.Tensor, folded: Sequence[FoldedBlock]) -> torch.Tensor:
    """The three blocks in F.conv2d, in x's dtype."""
    dt = x.dtype
    y = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
    for blk in folded:
        h = F.relu(_conv1x1(y, blk.w1) + blk.b1.to(dt)[:, None, None])
        w2 = blk.w2.reshape(3, 3, F1, F1).permute(3, 2, 0, 1).to(dt)
        h = F.relu(F.conv2d(h, w2, blk.b2.to(dt), padding=1))
        out = _conv1x1(h, blk.w3) + blk.b3.to(dt)[:, None, None]
        out = out + (_conv1x1(y, blk.wd) if blk.wd is not None else y)
        y = F.relu(out)
    return y.permute(0, 2, 3, 1)


def _stage1_kernel(x: torch.Tensor, folded: Sequence[FoldedBlock]) -> torch.Tensor:
    global launches
    ext.require(x.is_cuda, f"stage 1: unsupported device {x.device}")
    ext.require(x.dim() == 4 and x.shape[3] == F1,
                f"stage 1: x must be (B, H, W, 64), got {tuple(x.shape)}")
    ext.require(x.dtype == torch.bfloat16 and x.is_contiguous(),
                f"stage 1: x must be contiguous bfloat16 NHWC, got {x.dtype}")
    b, h, w, _ = x.shape
    lib = ext.load()
    stream = ext.stream_of(x)
    for blk in folded:
        cin = x.shape[3]
        ext.require(blk.w1.shape == (cin, F1) and blk.w2.shape == (9, F1, F1)
                    and blk.w3.shape == (F1, FOUT),
                    f"stage 1: folded weights do not fit cin={cin}")
        ext.require((blk.wd is not None and blk.wd.shape == (cin, FOUT)) or cin == FOUT,
                    "stage 1: a block without downsample needs cin == 256")
        for t in (blk.w1, blk.w2, blk.w3, *(() if blk.wd is None else (blk.wd,))):
            ext.require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.device == x.device,
                        "stage 1: folded weights must be contiguous bfloat16 on x's device")
        for t in (blk.b1, blk.b2, blk.b3):
            ext.require(t.dtype == torch.float32 and t.is_contiguous() and t.device == x.device,
                        "stage 1: folded biases must be contiguous float32 on x's device")
        out = torch.empty((b, h, w, FOUT), dtype=torch.bfloat16, device=x.device)
        err = lib.mhent_stage1_block(
            x.data_ptr(), blk.w1.data_ptr(), blk.b1.data_ptr(), blk.w2.data_ptr(),
            blk.b2.data_ptr(), blk.w3.data_ptr(),
            None if blk.wd is None else blk.wd.data_ptr(), blk.b3.data_ptr(),
            out.data_ptr(), b, h, w, cin, stream)
        ext.check(err, "mhent_stage1_block")
        launches += 1
        x = out
    return x
