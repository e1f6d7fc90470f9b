"""Densities of the MHEnt objective.

Port of mhentropy_tpu/flows/priors.py: `ApproxUniform` :20 (log_prob, and
sample for the box and ball supports), `laplace_deadzone_log_prob` :60 and
`std_normal_logp` :112. torch cannot replay jax.random, so `sample` draws
from a `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.nn import functional as F


class ApproxUniform(NamedTuple):
    """Smooth-uniform energy log p~(x) = -alpha * relu(d(x) - 1)^2.

    rec: d = |x - c| / r per dim (summed); ball: d = |x - a| / b.
    """

    a: torch.Tensor | float  # rec: low; ball: centre (D,)
    b: torch.Tensor | float  # rec: high; ball: radius
    alpha: float = 1.0
    sup: str = "rec"

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        if self.sup == "rec":
            centre = (self.a + self.b) / 2.0
            radius = (self.b - self.a) / 2.0
            d = F.relu(torch.abs(x - centre) / radius - 1.0)
            return -(self.alpha * d ** 2).sum(-1)
        if self.sup == "ball":
            r = torch.linalg.norm(x - self.a, dim=-1)
            return -self.alpha * F.relu(r / self.b - 1.0) ** 2
        raise NotImplementedError(self.sup)

    def sample(self, sample_shape: tuple, generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
        if self.sup == "rec":
            u = torch.rand(sample_shape, generator=generator, device=device)
            return u * (self.b - self.a) + self.a
        if self.sup == "ball":
            # Uniform direction times radius * u^(1/2), as the reference's
            # sampler (u^0.5 whatever the dimension).
            a = torch.as_tensor(self.a, device=device)
            r = self.b * torch.rand(sample_shape, generator=generator, device=device) ** 0.5
            x = torch.randn((*sample_shape, a.shape[-1]), generator=generator, device=device)
            x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-16)
            return x * r[..., None] + a
        raise NotImplementedError(self.sup)


def laplace_deadzone_log_prob(x: torch.Tensor, mu: torch.Tensor, b,
                              weights: torch.Tensor | None = None,
                              deadzone: float = 1e-4) -> torch.Tensor:
    """Visibility-masked Laplace with a reconstruction deadzone:
    log p = sum_{weights == 1} [-(relu(|x - mu| - dz) + dz) / b - log(2b)].

    x, mu, weights: (B, D); b scalar. Returns (B,).
    """
    mask = torch.ones_like(mu) if weights is None else (weights == 1.0).to(mu.dtype)
    err = F.relu(torch.abs(x - mu) - deadzone) + deadzone
    terms = mask * (-err / b - math.log(2.0 * b))
    return terms.reshape(terms.shape[0], -1).sum(1)


def std_normal_logp(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal log density summed over the last axis."""
    d = z.shape[-1]
    return -0.5 * torch.sum(z * z, dim=-1) - 0.5 * d * math.log(2.0 * math.pi)
