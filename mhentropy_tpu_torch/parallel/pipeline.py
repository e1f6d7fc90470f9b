"""GPipe pipeline parallelism over the RealNVP coupling stack.

Port of mhentropy_tpu/parallel/pipeline.py: `inverse_pipelined` :52,
`forward_pipelined` :80, `log_prob_pipelined` :193 and `sample_pipelined`
:216. The stack of L couplings splits into P contiguous stages over the
mesh's 'pipe' axis (stage s on the line's s-th rank) and M microbatches
stream through them on a GPipe schedule: stage s runs microbatch m at tick
m + s, so the schedule takes M + P - 1 ticks. Activations (the rows and
their running log-det) move from stage to stage by point-to-point send /
recv; the last stage's output is broadcast over the line, as JAX's psum
makes its out_spec replicated.

It is differentiable: `_Send`'s backward receives the cotangent the next
stage sends back and `_Recv`'s sends its own back, so the backward runs
the reverse schedule. Every rank of the line computes the same loss of
the broadcast output, so `_Broadcast`'s backward hands the last stage that
loss's cotangent and the others none. A stage's cotangents leave by
`isend`; `drain()` waits for them (the train step calls it after its
backward), so no stage waits on another's order of autograd nodes.

Every rank of the line holds the whole flow (its parameters replicated)
and the rows of its 'data' rank; stage s reads only its couplings, so
their gradients are stage s's alone, and the train step sums them over
'pipe' (`stage_names`, `sharded.sync_grads`). The conditioning projections
enter through `CopyToGroup` over the line: each stage's backward gives the
part of their cotangent its layers read, summed over the stages, so what
lies before them (the projections' weights, the encoder) gets the same
gradient on every stage.
"""

from __future__ import annotations

import re

import torch

from mhentropy_tpu_torch.flows import realnvp
from mhentropy_tpu_torch.flows.priors import std_normal_logp
from mhentropy_tpu_torch.parallel import mesh as mesh_lib
from mhentropy_tpu_torch.parallel.mesh import PIPE_AXIS

# Cotangent sends in flight: (work, buffer) pairs that `drain` waits on.
_pending: list = []


def drain() -> None:
    """Wait for the cotangents this rank's backward sent."""
    while _pending:
        work, _ = _pending.pop()
        work.wait()


class _Send(torch.autograd.Function):
    """Send `x` to global rank dst (tag m); returns a scalar token that
    carries the backward: the cotangent dst sends back."""

    @staticmethod
    def forward(ctx, x, dst: int, tag: int):
        ctx.dst, ctx.tag, ctx.shape, ctx.dtype, ctx.device = dst, tag, x.shape, x.dtype, x.device
        work, _ = mesh_lib.isend(x, dst, tag)
        work.wait()
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return mesh_lib.recv(ctx.shape, ctx.dtype, ctx.device, ctx.dst, ctx.tag), None, None


class _Recv(torch.autograd.Function):
    """The tensor global rank src sent (tag m); `anchor` only ties it into
    the graph. Its backward sends the cotangent back to src."""

    @staticmethod
    def forward(ctx, anchor, shape, src: int, tag: int):
        ctx.src, ctx.tag, ctx.anchor_shape = src, tag, anchor.shape
        return mesh_lib.recv(shape, anchor.dtype, anchor.device, src, tag)

    @staticmethod
    def backward(ctx, g):
        _pending.append(mesh_lib.isend(g, ctx.src, ctx.tag))
        return g.new_zeros(ctx.anchor_shape), None, None, None


class _Broadcast(torch.autograd.Function):
    """Global rank src's tensor on every rank of the group; the backward
    gives src its own cotangent (every rank's loss is the same) and the
    others none."""

    @staticmethod
    def forward(ctx, x, src: int, group, is_src: bool):
        ctx.is_src = is_src
        return mesh_lib.broadcast_(x.clone(), src, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None, None


def stage_names(net: torch.nn.Module) -> set:
    """The parameters of `net` (a RealNVP, or a module holding one) that the
    stages split: the coupling layers' `{s,t}.{i}.l.*`."""
    return {k for k, _ in net.named_parameters() if re.search(r"(?:^|\.)[st]\.\d+\.l\.", k)}


def _run_pipelined(flow: realnvp.RealNVP, x: torch.Tensor, cproj: torch.Tensor, mesh,
                   n_micro: int, forward: bool):
    n_pipe = mesh.shape[PIPE_AXIS]
    n_layers = flow.cfg.n_layers
    if n_layers % n_pipe:
        raise ValueError(f"pipeline: {n_layers} couplings do not split into {n_pipe} stages")
    rows, dim = x.shape
    if rows % n_micro:
        raise ValueError(f"pipeline: {rows} rows do not split into {n_micro} microbatches")
    drain()
    per, rm = n_layers // n_pipe, rows // n_micro
    stage = mesh.index(PIPE_AXIS)
    ranks = mesh.ranks(PIPE_AXIS)
    group = mesh.group(PIPE_AXIS)
    # inverse applies the layers last-to-first: stage 0 runs the last ones.
    order = list(zip(realnvp.layers(flow), range(n_layers)))
    if not forward:
        order = order[::-1]
    mine = order[stage * per:(stage + 1) * per]
    layer_fn = realnvp.forward_layer if forward else realnvp.inverse_layer
    if group is not None:
        cproj = mesh_lib.CopyToGroup.apply(cproj, group)
    # Ties each received tensor into the graph whenever grad mode is on, so
    # that every stage's backward runs (and sends) even where nothing it
    # received from requires a gradient.
    anchor = x.new_zeros((), requires_grad=torch.is_grad_enabled())
    outs, tokens = [], []
    for m in range(n_micro):  # tick m + stage
        r = slice(m * rm, (m + 1) * rm)
        if stage == 0:
            z, ld = x[r], x.new_zeros(rm)
        else:
            packed = _Recv.apply(anchor, (rm, dim + 1), ranks[stage - 1], m)
            z, ld = packed[:, :dim], packed[:, dim]
        for layer, i in mine:
            cp = cproj[i]
            z, ld = layer_fn(layer, cp[:, r] if cp.shape[1] == rows else cp, z, ld)
        packed = torch.cat([z, ld[:, None]], dim=1)
        if stage < n_pipe - 1:
            tokens.append(_Send.apply(packed, ranks[stage + 1], m))
        else:
            outs.append(packed)
    if stage == n_pipe - 1:
        out = torch.cat(outs)
    else:
        out = x.new_zeros((rows, dim + 1)) + sum(tokens)
    if group is not None:
        out = _Broadcast.apply(out, ranks[-1], group, stage == n_pipe - 1)
    return out[:, :dim], out[:, dim]


def forward_pipelined(flow: realnvp.RealNVP, z: torch.Tensor, cproj: torch.Tensor, mesh,
                      n_micro: int):
    """`realnvp.forward` (base -> data) with the stack pipelined over
    'pipe': (x, logdet). cproj (L, 4, R, H) aligned with the R rows (or
    broadcastable zeros for an unconditional flow)."""
    return _run_pipelined(flow, z, cproj, mesh, n_micro, forward=True)


def inverse_pipelined(flow: realnvp.RealNVP, x: torch.Tensor, cproj: torch.Tensor, mesh,
                      n_micro: int):
    """`realnvp.inverse` (data -> base) with the stack pipelined over
    'pipe': (z, logdet)."""
    return _run_pipelined(flow, x, cproj, mesh, n_micro, forward=False)


def log_prob_pipelined(flow: realnvp.RealNVP, x: torch.Tensor, feat: torch.Tensor, mesh,
                       n_micro: int) -> torch.Tensor:
    """Standard-conditional log q(x | feat) through the pipelined stack (the
    per-joint and actnorm variants stay on `realnvp.log_prob`)."""
    if flow.cfg.dim in (2, 3) or flow.cfg.tsfm_on in ("x", "z"):
        raise NotImplementedError(
            "log_prob_pipelined covers the standard-conditional flow; per-joint (dim 2/3) and "
            "actnorm-wrapped flows use realnvp.log_prob")
    cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
    z, logdet = inverse_pipelined(flow, x, cproj, mesh, n_micro)
    return std_normal_logp(z) + logdet


def sample_pipelined(flow: realnvp.RealNVP, z0: torch.Tensor, feat: torch.Tensor | None, mesh,
                     n_micro: int, n_per_image: int = 1, return_log_prob: bool = False):
    """`realnvp.sample` (standard-conditional) with the stack pipelined over
    'pipe': the training draw, differentiable. z0: (R, D) base noise,
    already times the temperature; n_per_image hypotheses a feat row, rows
    hypothesis-major (the conditioning tiled as `mhent.sample_q_z` tiles
    it). Returns x, or (x, log q(x))."""
    if flow.cfg.tsfm_on in ("x", "z"):
        raise NotImplementedError(
            "sample_pipelined covers the standard-conditional flow; actnorm-wrapped flows use "
            "realnvp.sample")
    if flow.conditional:
        cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
        if n_per_image > 1:
            cproj = cproj.repeat(1, 1, n_per_image, 1)
    else:
        cproj = z0.new_zeros((flow.cfg.n_layers, 4, z0.shape[0], 1))
    x, fwd_logdet = forward_pipelined(flow, z0, cproj, mesh, n_micro)
    if return_log_prob:
        return x, std_normal_logp(z0) - fwd_logdet
    return x
