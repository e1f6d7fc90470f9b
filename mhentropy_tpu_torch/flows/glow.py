"""ConditionalGlow, eval mode, as a PyTorch module.

Port of mhentropy_tpu/flows/glow.py for the Humans (ProHMR) flow:
`GlowConfig` :42, `coupling_masks` :52, `init_params` :78, `_lu_weight`
:142, `_residual_net` :165, `_ctx_cache` :207, `_scale_shift` :233,
`inverse` :239 (data -> base), `forward` :273 (base -> data), `log_prob`
:324 and `sample_and_log_prob` :341, which takes its base noise or draws it
from an explicit `torch.Generator` (torch cannot replay jax.random).

The module's `state_dict()` keys are the nkolot/nflows fork's
(`_transform._transforms.{3i}` ActNorm, `{3i+1}` LULinear, `{3i+2}` affine
coupling with its ResidualNet `transform_net`), with the fork's
`initialized`, `identity_features` and `transform_features` buffers, so a
ProHMR SMPL-flow checkpoint loads by name (convert.load_prohmr_smpl_flow).
The functions read the weights as (in, out) matrices like the JAX params.

Eval mode only: the coupling nets' BatchNorm (`use_batch_norm`), dropout,
`ddi` and `bn_stats_update` belong to training, which is not ported yet
(ROADMAP queue 1, item 9): `use_batch_norm=True` and a call on a module in
train mode raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from mhentropy_tpu_torch.flows.priors import std_normal_logp

LU_EPS = 1e-3
_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 9: ProHMR training)"


class GlowConfig(NamedTuple):
    features: int = 45
    hidden: int = 512
    num_layers: int = 4
    num_blocks: int = 2
    context_features: int = 512
    dropout: float = 0.0  # dropout_probability; only training reads it
    use_batch_norm: bool = False  # batch_norm_within_layers: not ported


def coupling_masks(features: int, num_layers: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(identity_features, transform_features) per step: the fork's mask
    starts at -1 on even indices (identity) and flips after every step."""
    mask = np.ones(features)
    mask[::2] = -1
    out = []
    for _ in range(num_layers):
        idx = np.arange(features)
        out.append((idx[mask <= 0], idx[mask > 0]))
        mask = -mask
    return out


class ActNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("initialized", torch.tensor(False))
        self.log_scale = nn.Parameter(torch.zeros(features))
        self.shift = nn.Parameter(torch.zeros(features))


class LULinear(nn.Module):
    """W = L U: L unit-lower-triangular, U upper with diag softplus(.) + eps;
    identity init."""

    def __init__(self, features: int):
        super().__init__()
        n_tri = (features - 1) * features // 2
        self.bias = nn.Parameter(torch.zeros(features))
        self.lower_entries = nn.Parameter(torch.zeros(n_tri))
        self.upper_entries = nn.Parameter(torch.zeros(n_tri))
        self.unconstrained_upper_diag = nn.Parameter(
            torch.full((features,), math.log(math.exp(1.0 - LU_EPS) - 1.0)))


class ResidualBlock(nn.Module):
    def __init__(self, hidden: int, context_features: int):
        super().__init__()
        self.context_layer = nn.Linear(context_features, hidden)
        self.linear_layers = nn.ModuleList([nn.Linear(hidden, hidden) for _ in range(2)])


class ResidualNet(nn.Module):
    def __init__(self, in_features: int, out_features: int, cfg: GlowConfig):
        super().__init__()
        self.initial_layer = nn.Linear(in_features + cfg.context_features, cfg.hidden)
        self.blocks = nn.ModuleList(ResidualBlock(cfg.hidden, cfg.context_features)
                                    for _ in range(cfg.num_blocks))
        self.final_layer = nn.Linear(cfg.hidden, out_features)


class AffineCoupling(nn.Module):
    def __init__(self, id_idx: np.ndarray, tr_idx: np.ndarray, cfg: GlowConfig):
        super().__init__()
        self.register_buffer("identity_features", torch.as_tensor(id_idx, dtype=torch.long))
        self.register_buffer("transform_features", torch.as_tensor(tr_idx, dtype=torch.long))
        self.transform_net = ResidualNet(len(id_idx), 2 * len(tr_idx), cfg)


class CompositeTransform(nn.Module):
    def __init__(self, transforms):
        super().__init__()
        self._transforms = nn.ModuleList(transforms)


class ConditionalGlow(nn.Module):
    """num_layers x (ActNorm, LULinear, affine coupling), the fork's names."""

    def __init__(self, cfg: GlowConfig):
        super().__init__()
        if cfg.use_batch_norm:
            raise NotImplementedError(f"the Glow coupling nets' BatchNorm {_NOT_PORTED}")
        self.cfg = cfg
        layers = []
        for id_idx, tr_idx in coupling_masks(cfg.features, cfg.num_layers):
            layers += [ActNorm(cfg.features), LULinear(cfg.features),
                       AffineCoupling(id_idx, tr_idx, cfg)]
        self._transform = CompositeTransform(layers)

    def step(self, i: int) -> tuple[ActNorm, LULinear, AffineCoupling]:
        t = self._transform._transforms
        return t[3 * i], t[3 * i + 1], t[3 * i + 2]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator | None = None) -> None:
        """The JAX init_params distributions: torch-default Linears, each
        block's last Linear U(-1e-3, 1e-3), identity LU, zero actnorm."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lim = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-lim, lim, generator=generator)
                m.bias.uniform_(-lim, lim, generator=generator)
            elif isinstance(m, ResidualBlock):
                for p in (m.linear_layers[1].weight, m.linear_layers[1].bias):
                    p.uniform_(-1e-3, 1e-3, generator=generator)


def _eval_only(flow: ConditionalGlow) -> None:
    if flow.training:
        raise NotImplementedError(f"a train-mode Glow call (dropout, DDI) {_NOT_PORTED}; "
                                  f"call flow.eval()")


def _lu_weight(lin: LULinear):
    """(W = L @ U, log|det W|) from the LU parametrization."""
    d = lin.bias.shape[0]
    li = torch.tril_indices(d, d, -1, device=lin.bias.device)
    ui = torch.triu_indices(d, d, 1, device=lin.bias.device)
    diag = F.softplus(lin.unconstrained_upper_diag) + LU_EPS
    lower = torch.eye(d, dtype=lin.bias.dtype, device=lin.bias.device)
    lower = lower.index_put((li[0], li[1]), lin.lower_entries)
    upper = torch.diag(diag).index_put((ui[0], ui[1]), lin.upper_entries)
    return lower @ upper, torch.sum(torch.log(diag))


def _ctx_cache(flow: ConditionalGlow, context: torch.Tensor) -> list[dict]:
    """Per-image context projections, computed once and broadcast across
    hypotheses: each step's initial-layer context slice (no bias) and every
    block's context_layer output."""
    out = []
    for i in range(flow.cfg.num_layers):
        net = flow.step(i)[2].transform_net
        ni = net.initial_layer.in_features - context.shape[-1]
        out.append({"initial": context @ net.initial_layer.weight[:, ni:].T,
                    "blocks": [blk.context_layer(context) for blk in net.blocks]})
    return out


def _residual_net(net: ResidualNet, x_id: torch.Tensor, cache: dict) -> torch.Tensor:
    """initial Linear on [x_id, ctx]; per block relu lin0 relu lin1, gated by
    sigmoid(context_layer(ctx)), residual add; final Linear."""
    ni = x_id.shape[-1]
    w_in = net.initial_layer.weight
    temps = x_id @ w_in[:, :ni].T + cache["initial"] + net.initial_layer.bias
    for k, blk in enumerate(net.blocks):
        t = blk.linear_layers[0](torch.relu(temps))
        t = blk.linear_layers[1](torch.relu(t))
        temps = temps + t * torch.sigmoid(cache["blocks"][k])
    return net.final_layer(temps)


def _scale_shift(cpl_out: torch.Tensor, nt: int):
    shift = cpl_out[:, :nt]
    scale = torch.sigmoid(cpl_out[:, nt:] + 2.0) + 1e-3
    return scale, shift


def _tile_cache(cache: list[dict], n: int) -> list[dict]:
    """The caches for n hypothesis-major blocks of the B context rows."""
    return [{"initial": c["initial"].repeat(n, 1),
             "blocks": [b.repeat(n, 1) for b in c["blocks"]]} for c in cache]


def inverse(flow: ConditionalGlow, x: torch.Tensor, cache: list[dict]):
    """data -> base (the nflows transform 'forward'), with log|det dz/dx|."""
    _eval_only(flow)
    logdet = x.new_zeros(x.shape[0])
    for i in range(flow.cfg.num_layers):
        an, lin, cpl = flow.step(i)
        x = x * torch.exp(an.log_scale) + an.shift
        logdet = logdet + torch.sum(an.log_scale)
        w, ld_w = _lu_weight(lin)
        x = x @ w.T + lin.bias
        logdet = logdet + ld_w
        id_idx, tr_idx = cpl.identity_features, cpl.transform_features
        x_id, x_tr = x[:, id_idx], x[:, tr_idx]
        scale, shift = _scale_shift(_residual_net(cpl.transform_net, x_id, cache[i]),
                                    len(tr_idx))
        x = torch.empty_like(x).index_copy(1, id_idx, x_id).index_copy(
            1, tr_idx, x_tr * scale + shift)
        logdet = logdet + torch.sum(torch.log(scale), dim=1)
    return x, logdet


def forward(flow: ConditionalGlow, z: torch.Tensor, cache: list[dict]):
    """base -> data (the nflows transform 'inverse'), with log|det dx/dz|."""
    _eval_only(flow)
    logdet = z.new_zeros(z.shape[0])
    for i in reversed(range(flow.cfg.num_layers)):
        an, lin, cpl = flow.step(i)
        id_idx, tr_idx = cpl.identity_features, cpl.transform_features
        z_id, z_tr = z[:, id_idx], z[:, tr_idx]
        scale, shift = _scale_shift(_residual_net(cpl.transform_net, z_id, cache[i]),
                                    len(tr_idx))
        z = torch.empty_like(z).index_copy(1, id_idx, z_id).index_copy(
            1, tr_idx, (z_tr - shift) / scale)
        logdet = logdet - torch.sum(torch.log(scale), dim=1)
        w, ld_w = _lu_weight(lin)
        # Invert the small D x D once; the rows then take one product.
        z = (z - lin.bias) @ torch.linalg.inv(w).T
        logdet = logdet - ld_w
        z = (z - an.shift) * torch.exp(-an.log_scale)
        logdet = logdet - torch.sum(an.log_scale)
    return z, logdet


def log_prob(flow: ConditionalGlow, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """log q(x | context); context rows aligned with x rows."""
    z, logdet = inverse(flow, x, _ctx_cache(flow, context))
    return std_normal_logp(z) + logdet


def sample_and_log_prob(flow: ConditionalGlow, context: torch.Tensor, n: int,
                        temp: float = 1.0, noise: torch.Tensor | None = None,
                        generator: torch.Generator | None = None):
    """n hypotheses per context row, hypothesis-major (n * B, D), with their
    log density from the same pass. noise: (n * B, D) base noise, already
    times temp; drawn from `generator` when None."""
    b = context.shape[0]
    if noise is None:
        noise = torch.randn((n * b, flow.cfg.features), generator=generator,
                            device=context.device, dtype=context.dtype) * temp
    cache = _tile_cache(_ctx_cache(flow, context), n)
    x, logdet = forward(flow, noise, cache)
    return x, std_normal_logp(noise) - logdet
