"""BasicEnc: backbone + mu / sigma linear heads, eval mode.

Port of mhentropy_tpu/models/encoder.py (`EncoderConfig` :23, `apply`
:105). The heads are `nn.Sequential(nn.Linear)`, so the parameter names are
the reference's `l1.0.*` / `l2.0.*`. MHEnt conditions on the mu head.
"""

from __future__ import annotations

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

    def resolved_feat_dim(self) -> int:
        return self.feat_dim or resnet.FEAT_DIMS[self.backbone]


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.res = resnet.make_backbone(cfg.backbone)
        f = cfg.resolved_feat_dim()
        self.l1 = nn.Sequential(nn.Linear(f, cfg.n_latent[0]))
        self.l2 = nn.Sequential(nn.Linear(f, cfg.n_latent[1]))

    def forward(self, image: torch.Tensor):
        """(B, H, W, 3) NHWC image -> (mu, sigma), both f32. The sampled
        latent of the JAX `apply` is never drawn on the serving path."""
        feats = self.res(image)
        mn = self.l1(feats)
        sd = self.l2(feats)
        if self.cfg.sigma_act == "exp":
            sd = torch.exp(0.5 * sd)
        elif self.cfg.sigma_act == "sigmoid":
            sd = torch.sigmoid(sd)
        return mn, sd
