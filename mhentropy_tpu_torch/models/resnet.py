"""ResNet-18/50 image backbone, eval mode, as PyTorch modules.

Port of mhentropy_tpu/models/resnet.py: `BasicBlock` :159, `Bottleneck`
:185 (v1.5, stride on the 3x3), `ResNet` :215, `resnet18` :328 and
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
"""

from __future__ import annotations

import torch
from torch import nn

from mhentropy_tpu_torch.models import stage1_cuda, stem_cuda


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1):
    return (nn.Conv2d(cin, cout, k, stride, k // 2, bias=False),
            nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1))


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
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
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
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class ResNet(nn.Module):
    """Feature extractor: (B, H, W, 3) -> (B, feat_dim) pooled f32 features.

    Compute runs in the parameters' dtype (cast the module to bfloat16 for the
    kernel path); the image is cast to it at entry. The kernel path reads the
    weights that `fold_kernel_weights` folded, so call it (`mhent.prepare`
    does) after the weights are loaded and moved, and again after any change.
    """

    def __init__(self, stage_sizes, block_cls, num_filters: int = 64):
        super().__init__()
        self.block_cls = block_cls
        self.kernels = True
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
        dtype = self.conv1.weight.dtype
        image = image.to(dtype)
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
        return x.mean(dim=(2, 3)).float()


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
