"""Densities of the MHEnt objective.

Port of mhentropy_tpu/flows/priors.py: `ApproxUniform` :20 (log_prob, and
sample for the box and ball supports), `laplace_deadzone_log_prob` :60,
`laplace_sample` :89, `LogDist` :94, `categorical_log_prob` :107,
`std_normal_logp` :112, `categorical_sample` :120 and `gaussian_kl` :124.
torch cannot replay jax.random, so each sampler draws from a
`torch.Generator` or takes its standard draws (uniforms, normals, Laplace
or Gumbel noise) as an argument.
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
               device=None, u: torch.Tensor | None = None,
               normal: torch.Tensor | None = None) -> torch.Tensor:
        """u: the U[0, 1) draws of `sample_shape`; normal: the ball's
        standard-normal directions (*sample_shape, D). Each is drawn from
        `generator` when None."""
        if u is None:
            u = torch.rand(sample_shape, generator=generator, device=device)
        if self.sup == "rec":
            return u * (self.b - self.a) + self.a
        if self.sup == "ball":
            # Uniform direction times radius * u^(1/2), as the reference's
            # sampler (u^0.5 whatever the dimension).
            a = torch.as_tensor(self.a, device=u.device)
            r = self.b * u ** 0.5
            x = normal
            if x is None:
                x = torch.randn((*sample_shape, a.shape[-1]), generator=generator, device=u.device)
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


def laplace_sample(mu: torch.Tensor, b, generator: torch.Generator | None = None,
                   e: torch.Tensor | None = None) -> torch.Tensor:
    """mu + b * e, e standard Laplace of mu's shape (drawn from `generator`
    by the inverse CDF when None)."""
    if e is None:
        eps = torch.finfo(mu.dtype).eps
        u = torch.empty_like(mu).uniform_(eps - 1.0, 1.0, generator=generator)
        e = -torch.sign(u) * torch.log1p(-u.abs())
    return mu + b * e


class LogDist(NamedTuple):
    """Density of log s when s ~ Normal: log p_logs(x) = log p_s(x) - log x."""

    loc: float
    scale: float

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        normal_lp = -0.5 * z ** 2 - math.log(self.scale) - 0.5 * math.log(2 * math.pi)
        return normal_lp - torch.log(x)


def categorical_log_prob(logits: torch.Tensor) -> torch.Tensor:
    """log softmax over the last axis."""
    return torch.log_softmax(logits, dim=-1)


def std_normal_logp(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal log density summed over the last axis."""
    d = z.shape[-1]
    return -0.5 * torch.sum(z * z, dim=-1) - 0.5 * d * math.log(2.0 * math.pi)


def categorical_sample(logits: torch.Tensor, temp: float = 1.0,
                       generator: torch.Generator | None = None,
                       gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Gumbel-max draw over the last axis of logits / temp (as
    jax.random.categorical); gumbel: standard Gumbel noise of logits' shape,
    drawn from `generator` when None."""
    if gumbel is None:
        tiny = torch.finfo(logits.dtype).tiny
        u = torch.empty_like(logits).uniform_(tiny, 1.0, generator=generator)
        gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits / (temp + 1e-16) + gumbel, dim=-1)


def gaussian_kl(mean: torch.Tensor, std: torch.Tensor, goal_std: float = 1.0) -> torch.Tensor:
    """KL(N(mean, std) || N(0, 1)) summed over dim 1."""
    return 0.5 * torch.sum(mean ** 2 + std ** 2 - torch.log(std ** 2) - goal_std, dim=1)
