"""Conditional RealNVP coupling flow as a PyTorch module.

Port of mhentropy_tpu/flows/realnvp.py: `RealNVPConfig` :42 (with the
per-joint fields and `effective_cond_dim` :59), `default_masks` :110,
`init_params` :122, `timestep_embedding` :169, `make_cond` :182 (the 45-dim
flow's feature, and the per-joint flows' rows with the `kemb` joint-index
embedding or the feature partitioner), `cond_cache` :223, `forward` :289
with `forward_layer` :321, `inverse_layer` :341, `inverse` :359, `_actnorm`
:389, `log_prob` :406 and `sample` :479 with the base noise passed in.

Parameter names follow the reference's state_dict (`mask`, `s.{i}.l.{j}`,
`s.{i}.c.{j}`, the same under `t`), so a reference checkpoint loads as-is.
The joint-index embedding (`kemb.0`, `kemb.2`: Linear, ReLU, Linear) and
the partitioner (`cond_mapping.{i}`) are named by the port: the JAX
package's checkpoint loader (tools/convert_torch.py `convert_realnvp`)
reads no key for them. torch's Linear keeps (out, in) weights; `layers`
hands the coupling math (in, out) matrices like the JAX package's stacked
params. Inside `parallel.sharded.tensor_parallel` each coupling net's first
layer and its `c.0` projection compute this rank's hidden columns and the
second layer their part of its product, summed over the 'model' line, on
the blocks of those parameters that the rank stores (`sharded.distribute`:
`l.0` and `c.0` their rows, `l.1` its columns).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from mhentropy_tpu_torch.flows.priors import std_normal_logp
from mhentropy_tpu_torch.parallel import sharded

KEMB_CH = 63  # the joint-index embedding's width


class RealNVPConfig(NamedTuple):
    dim: int = 45
    cond_dim: int = 0  # 0 => unconditional
    h_dim: int = 512
    num_steps: int = 6  # pairs of coupling layers => L = 2 * num_steps
    joint_n: int = 21  # rows per image when dim is 2 or 3 (one per joint)
    kemb: bool = False  # joint-index embedding (dim 2/3 only)
    tsfm_on: str | None = None  # None | 'x' | 'z': the actnorm by (mu, logvar)
    # Joint-feature partitioner: (in_f, out_f) pairs, each mapping
    # feat[:, :in_f] -> (B, joint_n, out_f / joint_n), concatenated.
    cond_mapping_dims: tuple = ()

    @property
    def n_layers(self) -> int:
        return 2 * self.num_steps

    def kemb_ch(self) -> int:
        return KEMB_CH

    def effective_cond_dim(self) -> int:
        """The coupling nets' conditioning width: cond_dim, plus the joint
        embedding when it is concatenated (its width differs from cond_dim)."""
        c = self.cond_dim
        if self.kemb and self.kemb_ch() != c:
            c += self.kemb_ch()
        return c


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
        self.cfg = cfg
        c = cfg.effective_cond_dim()
        self.register_buffer("mask", torch.from_numpy(default_masks(cfg.dim, cfg.num_steps)))
        self.s = nn.ModuleList(CouplingNet(cfg.dim, cfg.h_dim, c) for _ in range(cfg.n_layers))
        self.t = nn.ModuleList(CouplingNet(cfg.dim, cfg.h_dim, c) for _ in range(cfg.n_layers))
        if cfg.kemb:
            k = cfg.kemb_ch()
            self.kemb = nn.Sequential(nn.Linear(k, k), nn.ReLU(), nn.Linear(k, k))
        if cfg.cond_mapping_dims:
            self.cond_mapping = nn.ModuleList(nn.Linear(i, o) for i, o in cfg.cond_mapping_dims)

    @property
    def conditional(self) -> bool:
        return self.cfg.effective_cond_dim() > 0

    @torch.no_grad()
    def init_params(self, generator: torch.Generator | None = None) -> None:
        """As the JAX package's init_params: Xavier(gain=0.01) coupling
        weights, so the flow starts near the identity; Xavier(gain=1) for the
        joint embedding and the partitioner; zero biases."""
        def xavier(lin, gain):
            fan_out, fan_in = lin.weight.shape
            bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.zero_()

        for net in (*self.s, *self.t):
            for lin in (*net.l, *getattr(net, "c", ())):
                xavier(lin, 0.01)
        for lin in (*getattr(self, "kemb", ())[::2], *getattr(self, "cond_mapping", ())):
            xavier(lin, 1.0)


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


def timestep_embedding(timesteps: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """Sinusoidal embedding (the tensor2tensor convention): sin then cos of
    timesteps x exp(-log(1e4) i / (half - 1)), zero-padded to an odd width."""
    half = embedding_dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def make_cond(flow: RealNVP, feat: torch.Tensor) -> torch.Tensor:
    """Conditioning rows: the (B, C) image feature for the 45-dim flow. For
    the per-joint flows (dim 2/3), (B * joint_n, C') rows: with kemb each
    image's feature repeated for its joint_n rows and fused with the joint's
    embedding (added when the widths match, else concatenated); otherwise
    each row takes a contiguous chunk of the feature, after the partitioner
    (each of its linears reads the leading in_f slice) when there is one."""
    cfg = flow.cfg
    if cfg.dim not in (2, 3):
        return feat
    b = feat.shape[0]
    if cfg.kemb:
        cond = feat.repeat_interleave(cfg.joint_n, dim=0)
        idx = torch.arange(cfg.joint_n, device=feat.device).repeat(b)
        k = flow.kemb(timestep_embedding(idx, cfg.kemb_ch()))
        return cond + k if cond.shape[1] == k.shape[1] else torch.cat([cond, k], dim=1)
    if cfg.cond_mapping_dims:
        feat = torch.cat([lin(feat[:, :lin.in_features]).reshape(b, cfg.joint_n, -1)
                          for lin in flow.cond_mapping], dim=-1)
    return feat.reshape(b * cfg.joint_n, -1)


def cond_cache(flow: RealNVP, cond: torch.Tensor, gather: bool = False) -> torch.Tensor:
    """Per-layer conditioning projections, once per image: (L, 4, B, H),
    layer x (s0, s1, t0, t1) x batch x hidden. An unconditional flow gets
    broadcastable (L, 4, B, 1) zeros.

    Inside `parallel.sharded.tensor_parallel` the c.0 projections (s0, t0)
    are this rank's hidden columns, zero elsewhere; with `gather` they are
    all-gathered over the line instead, for a kernel's caller that reads
    the cache whole and differentiates it split (`cuda_sampler.
    sample_fused_diff`): the backward keeps this rank's columns of their
    cotangent, and cond's is summed over the line (`copy_to`)."""
    cfg = flow.cfg
    if not flow.conditional:
        return cond.new_zeros((cfg.n_layers, 4, cond.shape[0], 1))
    ln = sharded.line()
    if ln is not None:
        return _split_cond_cache(flow, cond, ln, gather)
    return torch.stack([
        torch.stack([F.linear(cond, net.c[j].weight, net.c[j].bias)
                     for net, j in ((s, 0), (s, 1), (t, 0), (t, 1))])
        for s, t in zip(flow.s, flow.t)
    ])


def _split_cond_cache(flow: RealNVP, cond: torch.Tensor, ln: sharded.Line,
                      gather: bool = False) -> torch.Tensor:
    """`cond_cache` with the column-parallel `c.0` projections (s0, t0)
    computed on this rank's hidden columns (the blocks it stores), zero
    elsewhere (gather: the ranks' columns all-gathered, every layer's in
    one collective)."""
    h = flow.cfg.h_dim
    cols = ln.cols(h)
    cs = sharded.copy_to(cond, ln)
    c0 = torch.stack([torch.stack([F.linear(cs, s.c[0].weight, s.c[0].bias),
                                   F.linear(cs, t.c[0].weight, t.c[0].bias)])
                      for s, t in zip(flow.s, flow.t)])
    if gather:
        c0 = sharded.gather_from(c0, ln)
    else:
        c0 = F.pad(c0, (cols.start, h - cols.stop))
    c1 = torch.stack([torch.stack([F.linear(cond, s.c[1].weight, s.c[1].bias),
                                   F.linear(cond, t.c[1].weight, t.c[1].bias)])
                      for s, t in zip(flow.s, flow.t)])
    return torch.stack([c0[:, 0], c1[:, 0], c0[:, 1], c1[:, 1]], dim=1)


def _lrelu(h):
    return F.leaky_relu(h, 0.01)


def _st_nets(layer: Layer, x_masked: torch.Tensor, cp: torch.Tensor):
    """The s (tanh-squashed) and t nets of one coupling layer."""
    ln = sharded.line()
    if ln is None:
        def mlp(w0, b0, w1, b1, w2, b2, c0, c1):
            h = _lrelu(x_masked @ w0 + b0 + c0)
            h = _lrelu(h @ w1 + b1 + c1)
            return h @ w2 + b2
    else:
        # w0, b0 (the c.0 projection's too) hold this rank's hidden columns,
        # w1 their rows; the cache holds every column.
        cols = ln.cols(layer.s_w0.shape[1] * ln.size)
        xs = sharded.copy_to(x_masked, ln)

        def mlp(w0, b0, w1, b1, w2, b2, c0, c1):
            h = _lrelu(xs @ w0 + b0 + c0[..., cols])
            h = _lrelu(sharded.reduce_from(h @ w1, ln) + b1 + c1)
            return h @ w2 + b2

    s = torch.tanh(mlp(layer.s_w0, layer.s_b0, layer.s_w1, layer.s_b1,
                       layer.s_w2, layer.s_b2, cp[0], cp[1]))
    t = mlp(layer.t_w0, layer.t_b0, layer.t_w1, layer.t_b1,
            layer.t_w2, layer.t_b2, cp[2], cp[3])
    return s, t


def forward_layer(layer: Layer, cp: torch.Tensor, x: torch.Tensor,
                  logdet: torch.Tensor):
    """One coupling layer, base -> data.

    Args:
        cp: (4, R, H) conditioning projections for this layer's rows (or
            broadcastable zeros for an unconditional flow).
    """
    mask = layer.mask
    x_masked = x * mask
    s, t = _st_nets(layer, x_masked, cp)
    inv = 1.0 - mask
    s = s * inv
    t = t * inv
    x = x_masked + inv * (x * torch.exp(s) + t)
    return x, logdet + s.sum(1)


def inverse_layer(layer: Layer, cp: torch.Tensor, z: torch.Tensor,
                  logdet: torch.Tensor):
    """One coupling layer, data -> base (the inverse of `forward_layer`)."""
    mask = layer.mask
    z_masked = z * mask
    s, t = _st_nets(layer, z_masked, cp)
    inv = 1.0 - mask
    s = s * inv
    t = t * inv
    z = inv * (z - t) * torch.exp(-s) + z_masked
    return z, logdet - s.sum(1)


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


def inverse(flow: RealNVP, x: torch.Tensor, cproj: torch.Tensor | None = None):
    """Data -> base, the layers walked in reverse.

    Returns:
        (z (R, D), logdet (R,)) with logdet = log|det dz/dx|.
    """
    if cproj is None:
        cproj = x.new_zeros((flow.cfg.n_layers, 4, x.shape[0], 1))
    z, logdet = x, x.new_zeros(x.shape[0])
    for layer, cp in reversed(list(zip(layers(flow), cproj))):
        z, logdet = inverse_layer(layer, cp, z, logdet)
    return z, logdet


def _actnorm(x: torch.Tensor, mu: torch.Tensor | None, logvar: torch.Tensor | None,
             reverse: bool):
    """The RLE actnorm by (mu, logvar). reverse (x -> z) returns (z, log-det),
    the log-det -0.5 sum(logvar), or 0 when logvar is None; forward (z -> x)
    returns x."""
    if reverse:
        logdet = x.new_zeros(x.shape[:-1])
        if mu is not None:
            x = x - mu
            if logvar is not None:
                x = x * torch.exp(-0.5 * logvar)
                logdet = -0.5 * logvar.sum(-1)
        return x, logdet
    if mu is not None:
        if logvar is not None:
            x = torch.exp(0.5 * logvar) * x
        x = x + mu
    return x


def log_prob(flow: RealNVP, x: torch.Tensor, feat: torch.Tensor | None = None,
             mu: torch.Tensor | None = None, logvar: torch.Tensor | None = None,
             weights: torch.Tensor | None = None,
             cproj: torch.Tensor | None = None) -> torch.Tensor:
    """Visibility-weighted log density, summed over each image's rows.

    Args:
        x: (B, D * K') data, taken as rows of cfg.dim.
        feat: (B, F) conditioning feature (conditional flows); not read when
            a precomputed `cproj` (L, 4, B * K', H) is given.
        mu, logvar: (B, D * K') actnorm statistics for tsfm_on 'x' or 'z'
            (on the data side for 'x', on the base side for 'z').
        weights: (B, D * K') visibility; each row counts with its first
            entry. Only per-joint flows (dim 2/3) take them; a wider flow
            accepts all-ones weights and raises on any other.

    Returns:
        (B,) log probability.
    """
    cfg = flow.cfg
    bs, d = x.shape[0], cfg.dim
    rows = x.reshape(-1, d)
    if weights is None:
        w_row = rows.new_ones(rows.shape[0])
    elif d not in (2, 3):
        if not bool(torch.all(weights == 1)):
            raise NotImplementedError(
                f"visibility weights need per-joint rows (dim 2/3), got dim={d} (only "
                f"all-ones weights are accepted there)")
        w_row = rows.new_ones(rows.shape[0])
    else:
        w_row = weights.reshape(-1, d)[:, 0]

    mu_r = logvar_r = None
    if cfg.tsfm_on in ("x", "z") and mu is not None:
        mu_r = mu.reshape(-1, d)
        logvar_r = None if logvar is None else logvar.reshape(-1, d)
    logdet_sigma = rows.new_zeros(rows.shape[0])
    if cfg.tsfm_on == "x" and mu_r is not None:
        rows, logdet_sigma = _actnorm(rows, mu_r, logvar_r, reverse=True)
    if cproj is None and flow.conditional:
        cproj = cond_cache(flow, make_cond(flow, feat))
    z, logdet = inverse(flow, rows, cproj)
    if cfg.tsfm_on == "z" and mu_r is not None:
        z, logdet_sigma = _actnorm(z, mu_r, logvar_r, reverse=True)
    lp = (std_normal_logp(z) + logdet + logdet_sigma) * w_row
    return lp.reshape(bs, -1).sum(1)


def sample(flow: RealNVP, z0: torch.Tensor, feat: torch.Tensor | None = None,
           cproj: torch.Tensor | None = None, mu: torch.Tensor | None = None,
           logvar: torch.Tensor | None = None, return_log_prob: bool = True):
    """Push base samples through the flow; returns (x, log q(x)), or x alone
    with return_log_prob=False.

    z0 is the (R, D) base noise, already multiplied by the temperature (torch
    cannot replay jax.random, so the caller draws it). cproj, when given, is
    aligned with the rows; otherwise it is built from feat (the rows'
    features, or per image for a per-joint flow). mu / logvar: the actnorm
    statistics of tsfm_on 'x' (applied to the flow's output) or 'z' (to its
    input), reshaped to rows; log q then includes the actnorm's scale,
    0.5 sum(logvar) a row.
    """
    cfg = flow.cfg
    d = cfg.dim
    mu_r = None if mu is None else mu.reshape(-1, d)
    logvar_r = None if logvar is None else logvar.reshape(-1, d)
    actnorm_ld = z0.new_zeros(())
    if cfg.tsfm_on in ("x", "z") and mu is not None and logvar is not None:
        actnorm_ld = 0.5 * logvar_r.sum(-1)
    z = z0
    if cfg.tsfm_on == "z" and mu is not None:
        z = _actnorm(z, mu_r, logvar_r, reverse=False)
    if cproj is None and flow.conditional:
        cproj = cond_cache(flow, make_cond(flow, feat))
    x, fwd_logdet = forward(flow, z, cproj)
    if cfg.tsfm_on == "x" and mu is not None:
        x = _actnorm(x, mu_r, logvar_r, reverse=False)
    if return_log_prob:
        return x, std_normal_logp(z0) - fwd_logdet - actnorm_ld
    return x
