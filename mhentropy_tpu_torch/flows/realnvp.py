"""Conditional RealNVP coupling flow as a PyTorch module.

Port of mhentropy_tpu/flows/realnvp.py for the 45-dim conditional flow the
hand model uses: `RealNVPConfig` :42, `default_masks` :110, `init_params`
:122, `make_cond` :182, `cond_cache` :223, `forward` :289 with
`forward_layer` :321, and `sample` :479 with the base noise passed in.
The per-joint (dim 2/3), joint-embedding and actnorm branches are not
ported yet (ROADMAP queue 1, item 3).

Parameter names follow the reference's state_dict (`mask`, `s.{i}.l.{j}`,
`s.{i}.c.{j}`, the same under `t`), so a reference checkpoint loads as-is.
torch's Linear keeps (out, in) weights; `layers` hands the coupling math
(in, out) matrices like the JAX package's stacked params.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from mhentropy_tpu_torch.flows.priors import std_normal_logp


class RealNVPConfig(NamedTuple):
    dim: int = 45
    cond_dim: int = 0  # 0 => unconditional
    h_dim: int = 512
    num_steps: int = 6  # pairs of coupling layers => L = 2 * num_steps
    joint_n: int = 21

    @property
    def n_layers(self) -> int:
        return 2 * self.num_steps


def default_masks(dim: int, num_steps: int) -> np.ndarray:
    """Alternating half masks [A, B] * num_steps."""
    a = np.array([0] * (dim // 2) + [1] * (dim - dim // 2), np.float32)
    return np.stack([a, 1.0 - a] * num_steps)


class CouplingNet(nn.Module):
    """One s or t net: D -> H -> H -> D with the conditioning projections
    added after the first two layers."""

    def __init__(self, dim: int, h_dim: int, cond_dim: int):
        super().__init__()
        self.l = nn.ModuleList([nn.Linear(dim, h_dim), nn.Linear(h_dim, h_dim),
                                nn.Linear(h_dim, dim)])
        if cond_dim:
            self.c = nn.ModuleList([nn.Linear(cond_dim, h_dim),
                                    nn.Linear(cond_dim, h_dim)])


class RealNVP(nn.Module):
    def __init__(self, cfg: RealNVPConfig):
        super().__init__()
        if cfg.dim in (2, 3):
            raise NotImplementedError(
                "per-joint RealNVP (dim 2/3) is not ported yet (ROADMAP queue 1, item 3)")
        self.cfg = cfg
        self.register_buffer("mask", torch.from_numpy(default_masks(cfg.dim, cfg.num_steps)))
        self.s = nn.ModuleList(CouplingNet(cfg.dim, cfg.h_dim, cfg.cond_dim)
                               for _ in range(cfg.n_layers))
        self.t = nn.ModuleList(CouplingNet(cfg.dim, cfg.h_dim, cfg.cond_dim)
                               for _ in range(cfg.n_layers))

    @property
    def conditional(self) -> bool:
        return self.cfg.cond_dim > 0

    @torch.no_grad()
    def init_params(self, generator: torch.Generator | None = None) -> None:
        """Xavier(gain=0.01) weights and zero biases, so the flow starts near
        the identity (as the JAX package's init_params)."""
        for net in (*self.s, *self.t):
            for lin in (*net.l, *getattr(net, "c", ())):
                fan_out, fan_in = lin.weight.shape
                bound = 0.01 * math.sqrt(6.0 / (fan_in + fan_out))
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.zero_()


class Layer(NamedTuple):
    """One coupling layer's weights, (in, out) matrices."""

    mask: torch.Tensor  # (D,)
    s_w0: torch.Tensor  # (D, H)
    s_b0: torch.Tensor
    s_w1: torch.Tensor  # (H, H)
    s_b1: torch.Tensor
    s_w2: torch.Tensor  # (H, D)
    s_b2: torch.Tensor
    t_w0: torch.Tensor
    t_b0: torch.Tensor
    t_w1: torch.Tensor
    t_b1: torch.Tensor
    t_w2: torch.Tensor
    t_b2: torch.Tensor


def layers(flow: RealNVP) -> list[Layer]:
    out = []
    for i in range(flow.cfg.n_layers):
        s, t = flow.s[i], flow.t[i]
        out.append(Layer(
            flow.mask[i],
            *[x for lin in s.l for x in (lin.weight.T, lin.bias)],
            *[x for lin in t.l for x in (lin.weight.T, lin.bias)],
        ))
    return out


def make_cond(flow: RealNVP, feat: torch.Tensor) -> torch.Tensor:
    """Conditioning rows: the (B, C) image feature itself for the 45-dim
    flow."""
    return feat


def cond_cache(flow: RealNVP, cond: torch.Tensor) -> torch.Tensor:
    """Per-layer conditioning projections, once per image: (L, 4, B, H),
    layer x (s0, s1, t0, t1) x batch x hidden. An unconditional flow gets
    broadcastable (L, 4, B, 1) zeros."""
    cfg = flow.cfg
    if not flow.conditional:
        return cond.new_zeros((cfg.n_layers, 4, cond.shape[0], 1))
    return torch.stack([
        torch.stack([F.linear(cond, net.c[j].weight, net.c[j].bias)
                     for net, j in ((s, 0), (s, 1), (t, 0), (t, 1))])
        for s, t in zip(flow.s, flow.t)
    ])


def _lrelu(h):
    return F.leaky_relu(h, 0.01)


def forward_layer(layer: Layer, cp: torch.Tensor, x: torch.Tensor,
                  logdet: torch.Tensor):
    """One coupling layer, base -> data.

    Args:
        cp: (4, R, H) conditioning projections for this layer's rows (or
            broadcastable zeros for an unconditional flow).
    """
    mask = layer.mask
    x_masked = x * mask

    def mlp(w0, b0, w1, b1, w2, b2, c0, c1):
        h = _lrelu(x_masked @ w0 + b0 + c0)
        h = _lrelu(h @ w1 + b1 + c1)
        return h @ w2 + b2

    s = torch.tanh(mlp(layer.s_w0, layer.s_b0, layer.s_w1, layer.s_b1,
                       layer.s_w2, layer.s_b2, cp[0], cp[1]))
    t = mlp(layer.t_w0, layer.t_b0, layer.t_w1, layer.t_b1,
            layer.t_w2, layer.t_b2, cp[2], cp[3])
    inv = 1.0 - mask
    s = s * inv
    t = t * inv
    x = x_masked + inv * (x * torch.exp(s) + t)
    return x, logdet + s.sum(1)


def forward(flow: RealNVP, z: torch.Tensor, cproj: torch.Tensor | None = None):
    """Base -> data through the coupling stack, with the forward log-det.

    Args:
        z: (R, D) base samples.
        cproj: (L, 4, R, H) conditioning rows aligned with z (or None).

    Returns:
        (x (R, D), logdet (R,)) with logdet = log|det dx/dz|.
    """
    if cproj is None:
        cproj = z.new_zeros((flow.cfg.n_layers, 4, z.shape[0], 1))
    x, logdet = z, z.new_zeros(z.shape[0])
    for layer, cp in zip(layers(flow), cproj):
        x, logdet = forward_layer(layer, cp, x, logdet)
    return x, logdet


def sample(flow: RealNVP, z0: torch.Tensor, feat: torch.Tensor | None = None,
           cproj: torch.Tensor | None = None):
    """Push base samples through the flow; returns (x, log q(x)).

    z0 is the (R, D) base noise, already multiplied by the temperature (torch
    cannot replay jax.random, so the caller draws it). cproj, when given, is
    aligned with the rows; otherwise it is built from the (R, C) feat.
    """
    if cproj is None and flow.conditional:
        cproj = cond_cache(flow, make_cond(flow, feat))
    x, fwd_logdet = forward(flow, z0, cproj)
    return x, std_normal_logp(z0) - fwd_logdet
