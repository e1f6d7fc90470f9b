"""ConditionalGlow as a PyTorch module, in eval and train mode.

Port of mhentropy_tpu/flows/glow.py: `GlowConfig` :42, `coupling_masks`
:52, `init_params` :78, `_lu_weight` :142, `_batch_norm` :155,
`_residual_net` :165 (the coupling nets' BatchNorm and dropout included),
`_ctx_cache` :207, `_scale_shift` :233, `inverse` :239 (data -> base),
`forward` :273 (base -> data), `log_prob` :324, `sample_and_log_prob` :341,
`ddi` :366, `bn_stats_update` :412 and `_bn_update` :472. torch cannot
replay jax.random: the base noise is an argument or comes from an explicit
`torch.Generator`, and so do the dropout masks.

The module's `state_dict()` keys are the nkolot/nflows fork's
(`_transform._transforms.{3i}` ActNorm, `{3i+1}` LULinear, `{3i+2}` affine
coupling with its ResidualNet `transform_net`, whose blocks hold
`batch_norm_layers.{0,1}` with `use_batch_norm`), with the fork's
`initialized`, `identity_features` and `transform_features` buffers, so a
ProHMR SMPL-flow checkpoint loads by name (convert.load_prohmr_smpl_flow).
The functions read the weights as (in, out) matrices like the JAX params.

Train mode is the functions' `train` argument, as in JAX, never the
module's `.training`:

* dropout: inverted dropout at `cfg.dropout` after the first Linear of each
  residual block (and its ReLU), only with `train=True`;
* BatchNorm (`use_batch_norm`): `train=True` normalises with the batch's
  statistics (biased variance) and leaves the running statistics alone, as
  JAX's `_batch_norm` does; `bn_stats_update` is the explicit pass that
  moves them (unbiased variance, momentum 0.1);
* ActNorm never initialises itself from data. The fork's ActNorm does on
  its first train-mode forward; JAX never does on its training path, and a
  fresh Glow starts at the identity ActNorm. `ddi` is the explicit
  data-dependent init: it writes log_scale and shift and sets the
  `initialized` buffer to True. Nothing in the port reads that buffer: it
  is kept so that the fork's checkpoints load and record what they did.

Inside `parallel.sharded.tensor_parallel` each ResidualNet block splits as
JAX's rule splits it (mhentropy_tpu/parallel/mesh.py:147-154, :184-195):
`linear_layers.0` column-parallel with its hidden BatchNorm on the same
columns, `linear_layers.1` row-parallel and summed over the 'model' line,
`context_layer` column-parallel over the residual width, its gate
all-gathered over the line before it multiplies the summed stream (the one
collective a block beside the sum). The dropout mask on a split hidden is
this rank's columns of the mask one process draws.
"""

from __future__ import annotations

import contextlib

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from mhentropy_tpu_torch.flows.priors import std_normal_logp
from mhentropy_tpu_torch.parallel import sharded

LU_EPS = 1e-3
BN_EPS = 1e-3


class GlowConfig(NamedTuple):
    features: int = 45
    hidden: int = 512
    num_layers: int = 4
    num_blocks: int = 2
    context_features: int = 512
    dropout: float = 0.0  # dropout_probability (0.2 for the MHEnt glow); train mode only
    use_batch_norm: bool = False  # batch_norm_within_layers


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
    def __init__(self, hidden: int, context_features: int, use_batch_norm: bool):
        super().__init__()
        if use_batch_norm:
            self.batch_norm_layers = nn.ModuleList(
                [nn.BatchNorm1d(hidden, eps=BN_EPS) for _ in range(2)])
        self.context_layer = nn.Linear(context_features, hidden)
        self.linear_layers = nn.ModuleList([nn.Linear(hidden, hidden) for _ in range(2)])


class ResidualNet(nn.Module):
    def __init__(self, in_features: int, out_features: int, cfg: GlowConfig):
        super().__init__()
        self.initial_layer = nn.Linear(in_features + cfg.context_features, cfg.hidden)
        self.blocks = nn.ModuleList(
            ResidualBlock(cfg.hidden, cfg.context_features, cfg.use_batch_norm)
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
        block's last Linear U(-1e-3, 1e-3), identity LU, zero actnorm, unit
        BatchNorm with running mean 0 and variance 1."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lim = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-lim, lim, generator=generator)
                m.bias.uniform_(-lim, lim, generator=generator)
            elif isinstance(m, ResidualBlock):
                for p in (m.linear_layers[1].weight, m.linear_layers[1].bias):
                    p.uniform_(-1e-3, 1e-3, generator=generator)


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


def _batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """BatchNorm1d(eps=1e-3): the batch's statistics in train mode, the
    running ones in eval; the running statistics are never updated here."""
    if train:
        return F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=False, eps=bn.eps)


# Inside `global_rows`: (n, b, rows), the dropout input's rows being this
# rank's images `rows` of n hypothesis-major blocks of a b-image batch.
_global = None


@contextlib.contextmanager
def global_rows(n: int, b: int, rows: slice):
    """Dropout inside draws its uniforms for the whole batch (n blocks of b
    rows) and keeps this rank's `rows` of each block, so that the ranks of a
    sharded step draw the masks one process draws."""
    global _global
    prev, _global = _global, (n, b, rows)
    try:
        yield
    finally:
        _global = prev


def dropout(t: torch.Tensor, p: float, generator: torch.Generator | None = None,
            cols: tuple[slice, int] | None = None):
    """Inverted dropout: each element kept with probability 1 - p and then
    scaled by 1 / (1 - p), else 0; the uniforms come from `generator`.
    cols: (this rank's columns, the whole width) of a split hidden: the
    uniforms are drawn for the whole width and t takes its columns."""
    part, width = cols if cols is not None else (slice(None), t.shape[-1])
    if _global is None:
        u = torch.rand((*t.shape[:-1], width), generator=generator, device=t.device)[..., part]
    else:
        n, b, rows = _global
        u = torch.rand((n, b, width), generator=generator,
                       device=t.device)[:, rows, part].reshape(t.shape)
    keep = u < 1.0 - p
    return torch.where(keep, t / (1.0 - p), torch.zeros_like(t))


def _ctx_cache(flow: ConditionalGlow, context: torch.Tensor) -> list[dict]:
    """Per-image context projections, computed once and broadcast across
    hypotheses: each step's initial-layer context slice (no bias) and every
    block's context_layer output (inside a tensor-parallel line, each rank's
    columns gathered over it)."""
    ln = sharded.line()
    ctx = context if ln is None else sharded.copy_to(context, ln)

    def gate(blk):
        g = blk.context_layer(ctx)
        return g if ln is None else sharded.gather_from(g, ln)

    out = []
    for i in range(flow.cfg.num_layers):
        net = flow.step(i)[2].transform_net
        ni = net.initial_layer.in_features - context.shape[-1]
        out.append({"initial": context @ net.initial_layer.weight[:, ni:].T,
                    "blocks": [gate(blk) for blk in net.blocks]})
    return out


def _residual_net(net: ResidualNet, x_id: torch.Tensor, cache: dict, train: bool = False,
                  p_drop: float = 0.0, generator: torch.Generator | None = None,
                  on_bn=None):
    """initial Linear on [x_id, ctx]; per block (bn) relu lin0 (bn) relu
    (dropout) lin1, gated by sigmoid(context_layer(ctx)), residual add;
    final Linear. on_bn(bn, t), when given, sees each BatchNorm's input
    before it is normalised. Inside a tensor-parallel line each block's
    hidden is this rank's columns (`linear_layers.0` and `.1` stored as
    their blocks, the hidden BatchNorm and the dropout mask on the same
    columns) and `linear_layers.1`'s partial products are summed over it."""
    ni = x_id.shape[-1]
    w_in = net.initial_layer.weight
    temps = x_id @ w_in[:, :ni].T + cache["initial"] + net.initial_layer.bias
    ln = sharded.line()

    def norm(bn, t, cols=None):
        if cols is not None:
            bn = _BNColumns(bn, cols)
        if on_bn is not None:
            on_bn(bn, t)
        return _batch_norm(bn, t, train)

    for k, blk in enumerate(net.blocks):
        bns = getattr(blk, "batch_norm_layers", None)
        t = temps if bns is None else norm(bns[0], temps)
        lin0, lin1 = blk.linear_layers
        if ln is None:
            cols = None
            t = lin0(torch.relu(t))
        else:
            cols = ln.cols(lin1.out_features)
            t = F.linear(sharded.copy_to(torch.relu(t), ln), lin0.weight, lin0.bias)
        if bns is not None:
            t = norm(bns[1], t, cols)
        t = torch.relu(t)
        if train and p_drop > 0.0:
            t = dropout(t, p_drop, generator,
                        None if cols is None else (cols, lin1.out_features))
        if ln is None:
            t = lin1(t)
        else:
            t = sharded.reduce_from(F.linear(t, lin1.weight), ln) + lin1.bias
        temps = temps + t * torch.sigmoid(cache["blocks"][k])
    return net.final_layer(temps)


class _BNColumns:
    """A BatchNorm1d's view on the columns of a split hidden (its running
    statistics are views: an update moves those columns)."""

    def __init__(self, bn: nn.BatchNorm1d, cols: slice):
        self.weight, self.bias = bn.weight[cols], bn.bias[cols]
        self.running_mean, self.running_var = bn.running_mean[cols], bn.running_var[cols]
        self.eps, self.momentum = bn.eps, bn.momentum


def _scale_shift(cpl_out: torch.Tensor, nt: int):
    shift = cpl_out[:, :nt]
    scale = torch.sigmoid(cpl_out[:, nt:] + 2.0) + 1e-3
    return scale, shift


def _tile_cache(cache: list[dict], n: int) -> list[dict]:
    """The caches for n hypothesis-major blocks of the B context rows."""
    return [{"initial": c["initial"].repeat(n, 1),
             "blocks": [b.repeat(n, 1) for b in c["blocks"]]} for c in cache]


def _merge(x: torch.Tensor, id_idx, x_id, tr_idx, x_tr) -> torch.Tensor:
    return torch.empty_like(x).index_copy(1, id_idx, x_id).index_copy(1, tr_idx, x_tr)


def _inverse_step(flow: ConditionalGlow, i: int, x: torch.Tensor, cache: dict,
                  train: bool = False, generator: torch.Generator | None = None,
                  p_drop: float | None = None, on_bn=None):
    """Step i data -> base (actnorm, LU, affine coupling), with the step's
    log|det| rows; p_drop defaults to cfg.dropout, on_bn as in
    `_residual_net`."""
    an, lin, cpl = flow.step(i)
    x = x * torch.exp(an.log_scale) + an.shift
    w, ld_w = _lu_weight(lin)
    x = x @ w.T + lin.bias
    id_idx, tr_idx = cpl.identity_features, cpl.transform_features
    x_id, x_tr = x[:, id_idx], x[:, tr_idx]
    p_drop = flow.cfg.dropout if p_drop is None else p_drop
    scale, shift = _scale_shift(
        _residual_net(cpl.transform_net, x_id, cache, train, p_drop, generator, on_bn),
        len(tr_idx))
    x = _merge(x, id_idx, x_id, tr_idx, x_tr * scale + shift)
    return x, torch.sum(an.log_scale) + ld_w + torch.sum(torch.log(scale), dim=1)


def inverse(flow: ConditionalGlow, x: torch.Tensor, cache: list[dict], train: bool = False,
            generator: torch.Generator | None = None):
    """data -> base (the nflows transform 'forward'), with log|det dz/dx|.
    train: the coupling nets' dropout at cfg.dropout (masks from
    `generator`) and batch-statistics BatchNorm."""
    logdet = x.new_zeros(x.shape[0])
    for i in range(flow.cfg.num_layers):
        x, ld = _inverse_step(flow, i, x, cache[i], train, generator)
        logdet = logdet + ld
    return x, logdet


def forward(flow: ConditionalGlow, z: torch.Tensor, cache: list[dict], train: bool = False,
            generator: torch.Generator | None = None):
    """base -> data (the nflows transform 'inverse'), with log|det dx/dz|;
    train as in `inverse`."""
    logdet = z.new_zeros(z.shape[0])
    for i in reversed(range(flow.cfg.num_layers)):
        an, lin, cpl = flow.step(i)
        id_idx, tr_idx = cpl.identity_features, cpl.transform_features
        z_id, z_tr = z[:, id_idx], z[:, tr_idx]
        scale, shift = _scale_shift(
            _residual_net(cpl.transform_net, z_id, cache[i], train, flow.cfg.dropout, generator),
            len(tr_idx))
        z = _merge(z, id_idx, z_id, tr_idx, (z_tr - shift) / scale)
        logdet = logdet - torch.sum(torch.log(scale), dim=1)
        w, ld_w = _lu_weight(lin)
        # Invert the small D x D once; the rows then take one product.
        z = (z - lin.bias) @ torch.linalg.inv(w).T
        logdet = logdet - ld_w
        z = (z - an.shift) * torch.exp(-an.log_scale)
        logdet = logdet - torch.sum(an.log_scale)
    return z, logdet


def log_prob(flow: ConditionalGlow, x: torch.Tensor, context: torch.Tensor,
             train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
    """log q(x | context); context rows aligned with x rows."""
    z, logdet = inverse(flow, x, _ctx_cache(flow, context), train, generator)
    return std_normal_logp(z) + logdet


def sample_and_log_prob(flow: ConditionalGlow, context: torch.Tensor, n: int,
                        temp: float = 1.0, noise: torch.Tensor | None = None,
                        generator: torch.Generator | None = None, train: bool = False):
    """n hypotheses per context row, hypothesis-major (n * B, D), with their
    log density from the same pass. noise: (n * B, D) base noise, already
    times temp; drawn from `generator` when None. train: the coupling nets'
    dropout (masks from `generator`) and batch-statistics BatchNorm."""
    b = context.shape[0]
    if noise is None:
        noise = torch.randn((n * b, flow.cfg.features), generator=generator,
                            device=context.device, dtype=context.dtype) * temp
    cache = _tile_cache(_ctx_cache(flow, context), n)
    x, logdet = forward(flow, noise, cache, train, generator)
    return x, std_normal_logp(noise) - logdet


@torch.no_grad()
def ddi(flow: ConditionalGlow, x: torch.Tensor, context: torch.Tensor) -> None:
    """ActNorm data-dependent init, in place: per step, log_scale =
    -log(std) and shift = -(x / std).mean(0) of that step's actnorm input
    (std unbiased), `initialized` set True; the step is then applied with
    the new values (its coupling net in eval mode: no dropout, running
    BatchNorm statistics) before the next is initialised, as JAX's `ddi`."""
    cache = _ctx_cache(flow, context)
    for i in range(flow.cfg.num_layers):
        an = flow.step(i)[0]
        std = torch.std(x, dim=0, correction=1)
        an.log_scale.copy_(-torch.log(std))
        an.shift.copy_(-(x / std).mean(0))
        an.initialized.fill_(True)
        x, _ = _inverse_step(flow, i, x, cache[i])


def _bn_update(bn: nn.BatchNorm1d, x: torch.Tensor, momentum: float) -> None:
    n = x.shape[0]
    var_unbiased = x.var(0, correction=0) * n / max(n - 1, 1)
    bn.running_mean.mul_(1 - momentum).add_(momentum * x.mean(0))
    bn.running_var.mul_(1 - momentum).add_(momentum * var_unbiased)


@torch.no_grad()
def bn_stats_update(flow: ConditionalGlow, x: torch.Tensor, context: torch.Tensor,
                    momentum: float = 0.1) -> None:
    """Move the coupling nets' BatchNorm running statistics towards one data
    batch, in place: each BN's input, walked through the flow in train mode
    (batch statistics, no dropout), updates its running mean and unbiased
    variance by `momentum`. A flow without BatchNorm is left as it is."""
    if not flow.cfg.use_batch_norm:
        return
    cache = _ctx_cache(flow, context)
    for i in range(flow.cfg.num_layers):
        x, _ = _inverse_step(flow, i, x, cache[i], train=True, p_drop=0.0,
                             on_bn=lambda bn, t: _bn_update(bn, t, momentum))
