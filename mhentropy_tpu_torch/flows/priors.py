"""Flow base density. Port of mhentropy_tpu/flows/priors.py::std_normal_logp
(:112); the other priors belong to training and are not ported yet."""

from __future__ import annotations

import math

import torch


def std_normal_logp(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal log density summed over the last axis."""
    d = z.shape[-1]
    return -0.5 * torch.sum(z * z, dim=-1) - 0.5 * d * math.log(2.0 * math.pi)
