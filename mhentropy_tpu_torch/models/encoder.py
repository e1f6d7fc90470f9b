"""BasicEnc: backbone + mu / sigma linear heads, eval and train mode.

Port of mhentropy_tpu/models/encoder.py (`EncoderConfig` :23 with
`fused_train_bn` :42, `backbone_features` :77, `apply` :105). The heads are
`nn.Sequential(nn.Linear)`, so the parameter names are the reference's
`l1.0.*` / `l2.0.*`. MHEnt conditions on the mu head. The module's mode
is the JAX `train` argument: in `.train()` the backbone's BatchNorms use
batch statistics and update their running mean and variance in place,
PyTorch's idiom for the new batch stats the JAX `apply` returns.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from mhentropy_tpu_torch.models import resnet


class EncoderConfig(NamedTuple):
    backbone: str = "resnet50"
    n_latent: tuple = (512, 512)  # (mu dim, sigma dim)
    feat_dim: int | None = None  # backbone feature dim override
    sigma_act: str = "exp"
    deterministic: bool = False
    dtype: str = "bfloat16"  # backbone compute dtype
    # Train-mode BN structure around the card's sum kernels: False | True
    # ("stats") | "full" (models/bn_cuda.py; utils/config.py says why the
    # first two are one run on the card).
    fused_train_bn: bool | str = False

    def resolved_feat_dim(self) -> int:
        return self.feat_dim or resnet.FEAT_DIMS[self.backbone]


def train_bn_mode(fused_train_bn: bool | str) -> str:
    """EncoderConfig.fused_train_bn -> the train BN mode: "full" or "stats"."""
    if isinstance(fused_train_bn, str):
        if fused_train_bn not in ("stats", "full"):
            raise ValueError(f"fused_train_bn {fused_train_bn!r}; expected false, true, "
                             f"'stats' or 'full'")
        return fused_train_bn
    return "stats"


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.res = resnet.make_backbone(cfg.backbone, dtype=getattr(torch, cfg.dtype),
                                        bn_mode=train_bn_mode(cfg.fused_train_bn))
        f = cfg.resolved_feat_dim()
        self.l1 = nn.Sequential(nn.Linear(f, cfg.n_latent[0]))
        self.l2 = nn.Sequential(nn.Linear(f, cfg.n_latent[1]))

    def forward(self, image: torch.Tensor):
        """(B, H, W, 3) NHWC image -> (mu, sigma), both f32. The sampled
        latent of the JAX `apply` is never drawn by the port's paths."""
        feats = self.res(image)
        mn = self.l1(feats)
        sd = self.l2(feats)
        if self.cfg.sigma_act == "exp":
            sd = torch.exp(0.5 * sd)
        elif self.cfg.sigma_act == "sigmoid":
            sd = torch.sigmoid(sd)
        return mn, sd


def backbone_features(encoder: Encoder, image: torch.Tensor) -> torch.Tensor:
    """Raw pooled backbone features (B, feat_dim) f32, no mu / sigma heads:
    what the ProHMR flow conditions on (models/prohmr.py)."""
    return encoder.res(image)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init distributions for every conv and linear under
    `module`, in module order: lecun-normal (truncated) convs, torch-default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) linears."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif isinstance(m, nn.Linear):
            lim = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-lim, lim, generator=generator)
            m.bias.uniform_(-lim, lim, generator=generator)
