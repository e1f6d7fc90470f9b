"""ResNet-18/50 image backbone, eval and train mode, as PyTorch modules.

Port of mhentropy_tpu/models/resnet.py: `BasicBlock` :159, `Bottleneck`
:185 (v1.5, stride on the 3x3), `ResNet` :215 (`__call__(train=)` :242 with
`norm` :254-260 and `fused_train_bn` :239/:244-251), `resnet18` :328 and
`resnet50` :336, under torchvision's parameter names (`conv1`, `bn1`,
`layer1.0.conv1`, ..., `downsample.0/1`), so a reference checkpoint loads
as-is. The space-to-depth stem (`S2DStemConv` :27) is not ported: it is off
by default and was measured as a loss.

The public input is the JAX package's NHWC image (B, H, W, 3). Inside,
activations are channels_last NCHW tensors, which are NHWC in memory: the
layout the kernels take and cuDNN's fast one. In eval mode on a CUDA tensor
in bfloat16, the stem and stage 1 run the port's CUDA kernels
(`stem_cuda`, `stage1_cuda`), as the JAX package runs its Pallas kernels
on the TPU; stages 2-4, the pool and the heads stay in plain PyTorch, as
XLA ran them outside any kernel. Setting `kernels = False` runs the plain
PyTorch modules there instead, to compare the two paths.

In train mode (`.train()`) the stem and stage-1 kernels stay off, as their
JAX gates say (`not train`), and every BatchNorm runs the flax train-mode
math of `bn_cuda.batch_norm_train`: its channel sums are the `bn_cuda`
kernels on the card, and `kernels = False` gives flax's plain statistics.
`bn_mode` ("stats" or "full") picks the autograd structure around the
kernels. Inside `parallel.sharded.tensor_parallel` each residual block's
`conv1` and `bn1` compute this rank's output channels and `conv2` their
part of its product, summed over the 'model' line (`_split_pair`). The parameters may stay f32 masters while the compute runs in
`dtype` (bf16): each conv casts its weight to its input's dtype in the
forward (flax's `param_dtype` f32 / `dtype` bf16), and `.to` returns the
very tensor when the dtypes already match, as on the serving path after
`mhent.prepare` cast the module.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn
from torch.nn import functional as F

from mhentropy_tpu_torch.models import bn_cuda, stage1_cuda, stem_cuda
from mhentropy_tpu_torch.parallel import sharded


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype (the weight cast to it)."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (same state_dict) whose train mode is flax's
    (`bn_cuda.batch_norm_train`); eval mode is nn.BatchNorm2d's.
    `mode` and `kernels` are set by the owning ResNet."""

    mode = "stats"
    kernels = True

    def forward(self, x):
        if self.training:
            return bn_cuda.batch_norm_train(x, self, self.mode, self.kernels)
        return super().forward(x)


def _bn_cols(bn: BatchNorm2d, y: torch.Tensor, cols: slice) -> torch.Tensor:
    """`bn` on the channels `cols` of its input (y holds those alone); in
    train mode it updates those channels' running statistics."""
    if bn.training:
        view = SimpleNamespace(weight=bn.weight[cols], bias=bn.bias[cols], eps=bn.eps,
                               momentum=bn.momentum, running_mean=bn.running_mean[cols],
                               running_var=bn.running_var[cols])
        return bn_cuda.batch_norm_train(y, view, bn.mode, bn.kernels)
    return F.batch_norm(y, bn.running_mean[cols], bn.running_var[cols], bn.weight[cols],
                        bn.bias[cols], False, 0.0, bn.eps)


def _split_pair(block, x: torch.Tensor, ln: sharded.Line) -> torch.Tensor:
    """relu(bn1(conv1(x))) on this rank's output channels, then conv2 on
    them: its partial product, summed over the line (Megatron's pair)."""
    cols = ln.cols(block.conv1.out_channels)
    xs = sharded.copy_to(x, ln)
    y = block.conv1._conv_forward(xs, block.conv1.weight[cols].to(x.dtype), None)
    y = torch.relu(_bn_cols(block.bn1, y, cols))
    y = block.conv2._conv_forward(y, block.conv2.weight[:, cols].to(y.dtype), None)
    return sharded.reduce_from(y, ln)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1):
    return (Conv2d(cin, cout, k, stride, k // 2, bias=False),
            BatchNorm2d(cout, eps=1e-5, momentum=0.1))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 3, stride)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(*_conv_bn(inplanes, planes, 1, stride))

    def forward(self, x):
        ln = sharded.line()
        if ln is None:
            y = self.conv2(torch.relu(self.bn1(self.conv1(x))))
        else:
            y = _split_pair(self, x, ln)
        y = self.bn2(y)
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 1)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, stride)
        self.conv3, self.bn3 = _conv_bn(planes, planes * 4, 1)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(*_conv_bn(inplanes, planes * 4, 1, stride))

    def forward(self, x):
        ln = sharded.line()
        if ln is None:
            y = self.conv2(torch.relu(self.bn1(self.conv1(x))))
        else:
            y = _split_pair(self, x, ln)
        y = torch.relu(self.bn2(y))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class ResNet(nn.Module):
    """Feature extractor: (B, H, W, 3) -> (B, feat_dim) pooled f32 features.

    Compute runs in `dtype`, or in the parameters' dtype when it is None;
    the image is cast to it at entry. The eval kernel path reads the weights
    that `fold_kernel_weights` folded, so call it (`mhent.prepare` does)
    after the weights are loaded and moved, and again after any change.
    In train mode the BN running statistics are updated in place.
    """

    def __init__(self, stage_sizes, block_cls, num_filters: int = 64, dtype=None,
                 bn_mode: str = "stats"):
        super().__init__()
        self.block_cls = block_cls
        self.dtype = dtype
        self.conv1, self.bn1 = _conv_bn(3, num_filters, 7, 2)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = num_filters
        for i, count in enumerate(stage_sizes):
            planes = num_filters * 2 ** i
            blocks = []
            for j in range(count):
                blocks.append(block_cls(inplanes, planes, 2 if i > 0 and j == 0 else 1))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.feat_dim = inplanes
        # (folded stem (w, b), folded stage-1 blocks or None when stage 1 is
        # not resnet50's), set by fold_kernel_weights.
        self.folded = None
        self.kernels = True
        self.bn_mode = bn_mode

    @property
    def kernels(self) -> bool:
        return self._kernels

    @kernels.setter
    def kernels(self, enabled: bool) -> None:
        self._kernels = enabled
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.kernels = enabled

    @property
    def bn_mode(self) -> str:
        return self._bn_mode

    @bn_mode.setter
    def bn_mode(self, mode: str) -> None:
        if mode not in ("stats", "full"):
            raise ValueError(f"train BN mode {mode!r}; expected 'stats' or 'full'")
        self._bn_mode = mode
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.mode = mode

    def place(self, dtype: torch.dtype, masters: bool = False) -> None:
        """channels_last memory, the parameters cast to `dtype` unless
        `masters` keeps them f32 for training (each conv then casts its
        weight in the forward)."""
        if masters:
            self.to(memory_format=torch.channels_last)
        else:
            self.to(dtype=dtype, memory_format=torch.channels_last)

    @torch.no_grad()
    def fold_kernel_weights(self) -> None:
        """Fold eval BN into the stem's and stage 1's kernel weights, on the
        parameters' device."""
        stem = stem_cuda.fold(self.conv1.weight, self.bn1.weight, self.bn1.bias,
                              self.bn1.running_mean, self.bn1.running_var, self.bn1.eps)
        fits = (self.block_cls is Bottleneck and len(self.layer1) == 3
                and self.conv1.out_channels == stage1_cuda.F1)
        self.folded = (stem, stage1_cuda.fold(self.layer1) if fits else None)

    def _use_kernels(self, x: torch.Tensor) -> bool:
        return self.kernels and not self.training and x.is_cuda and x.dtype == torch.bfloat16

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        image = image.to(self.dtype if self.dtype is not None else self.conv1.weight.dtype)
        kernels = self._use_kernels(image)
        if kernels and self.folded is None:
            raise RuntimeError("the CUDA kernel path needs ResNet.fold_kernel_weights() "
                               "first (mhent.prepare runs it)")
        if kernels:
            x = stem_cuda.stem_forward(image.contiguous(), *self.folded[0])
            x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        else:
            x = image.permute(0, 3, 1, 2)
            x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        if kernels and self.folded[1] is not None:
            x_nhwc = x.permute(0, 2, 3, 1).contiguous()
            x = stage1_cuda.stage1_forward(x_nhwc, self.folded[1]).permute(0, 3, 1, 2)
        else:
            x = self.layer1(x)
        x = self.layer4(self.layer3(self.layer2(x)))
        x = x.mean(dim=(2, 3))
        return x.to(torch.promote_types(x.dtype, torch.float32))  # f32 (f64 stays)


def resnet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, **kw)


FEAT_DIMS = {"resnet18": 512, "resnet50": 2048}


def make_backbone(name: str, **kw) -> ResNet:
    if name == "resnet18":
        return resnet18(**kw)
    if name == "resnet50":
        return resnet50(**kw)
    raise NotImplementedError(name)
