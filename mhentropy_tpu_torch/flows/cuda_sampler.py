"""Fused RealNVP hypothesis sampler: the CUDA kernels and their plain version.

Replaces mhentropy_tpu/flows/pallas_sampler.py::sample_fused (:191; Pallas
`_kernel` :64 via `_fused_transform` :115) with `csrc/realnvp_sampler.cu`
(bf16 weights), and `sample_fused_diff` (:338) / `transform_diff` (:288) with
`csrc/realnvp_sampler_f32.cu` (f32 weights, the `_kernel_transform` :304
launch) under a `torch.autograd.Function`. Each source's header says what
bounds its kernel on the H100 and how its design answers that. Here:

* `pack` lays a flow's weights out for the kernels (D padded to a multiple of
  16 with mask = 1 on the padding, the s and t nets stacked), in bf16 for
  the eval draw or f32 for the differentiable one.
* `transform` is the wrapper: image-major base samples (B, R, D) and the
  per-image conditioning cache (L, 4, B, H) -> (x (B, R, D), logdet (B, R)).
  CPU tensors take `transform_plain`; CUDA tensors launch the kernel of the
  packed weights' dtype, and anything it does not take raises. The bf16
  draw goes through the operator `mhent::realnvp_sample`
  (mhentropy_tpu_torch/ops.py), so that `torch.export` can trace it; the
  f32 one, the training side's, stays a plain call.
* `plan` picks each launch's tile rows and cluster size from the row count,
  H, Dp, the card's occupancy and the kernel's shared-memory layout, which
  it is given (CPU-testable); `launch_plan` gives it the card's, once a
  shape.
* `sample_fused` is the drop-in for the flow draw: hypothesis-major rows in,
  hypothesis-major rows and log q out.
* `sample_fused_diff` is the same draw under autograd: `TransformDiff`'s
  forward packs f32 weights and runs `transform`; its backward recomputes the
  plain f32 flow (`realnvp.forward`) from the saved (z0, cproj) and the
  flow's parameters, as `_transform_bwd` :327 reruns the XLA scan. The JAX
  package has no backward kernel here, and neither has the port. The masks
  are a buffer and get no gradient (`stop_gradient` in the JAX flow).

The bf16 kernel accumulates in f32, with x and the log-det in f32, as the
JAX path runs the fused sampler at h <= 512; the f32 kernel computes its
products as 3xTF32 on the tensor cores, so its forward is the plain f32
flow's to about f32 rounding.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.nn import functional as F
from torch.utils.weak import WeakIdKeyDictionary

from mhentropy_tpu_torch import ext, ops
from mhentropy_tpu_torch.flows import realnvp
from mhentropy_tpu_torch.flows.priors import std_normal_logp
from mhentropy_tpu_torch.parallel import sharded

# Kernel launches since the counts were last reset; nothing else touches them.
launches = 0  # bf16 weights (realnvp_sampler.cu)
launches_f32 = 0  # f32 weights (realnvp_sampler_f32.cu)


class Packed(NamedTuple):
    masks: torch.Tensor  # (L, Dp) 1 on padded dims
    w0: torch.Tensor  # (L, 2, Dp, H)   net 0 = s, 1 = t; [in, out]
    w1: torch.Tensor  # (L, 2, H, H)
    w2: torch.Tensor  # (L, 2, H, Dp)
    b0: torch.Tensor  # (L, 2, H)
    b1: torch.Tensor  # (L, 2, H)
    b2: torch.Tensor  # (L, 2, Dp)
    dim: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# The kernels' shape limits (csrc/realnvp_cluster.cuh); their shared-memory
# layout is the C entries' `mhent_realnvp_sample[_f32]_smem`.
CLUSTERS = (8, 4, 2, 1)  # CTAs a cluster, largest first
MAX_TILE_ROWS = 128  # one m16 row tile a warp
MAX_SLICE = 64  # hidden columns a CTA
MAX_DP = 64  # padded flow width


class Plan(NamedTuple):
    tile_rows: int  # rows a cluster owns (a multiple of 16)
    cluster: int  # CTAs a cluster: each takes H / cluster hidden columns
    tiles: int  # clusters launched
    smem: int  # shared memory a CTA (bytes)


def cluster_size(h: int, align: int = 16) -> int | None:
    """The largest cluster whose CTAs each take a slice of `align` to 64
    hidden columns in multiples of `align` (16: n16 tiles; the int8 kernel's
    32: its k-step), or None if H has none."""
    for c in CLUSTERS:
        if h % (align * c) == 0 and h // c <= MAX_SLICE:
            return c
    return None


def check_shape(h: int, dp: int, align: int = 16) -> int:
    """The cluster size for hidden width h and padded width dp; raises on a
    shape the kernels do not take (`align`: as `cluster_size`'s, and of
    dp)."""
    cluster = cluster_size(h, align)
    ext.require(cluster is not None and dp <= MAX_DP and dp % align == 0,
                f"fused sampler: no kernel shape for hidden width {h} and padded "
                f"width {dp}: H must be a multiple of {align} with H / C <= {MAX_SLICE} "
                f"for a cluster C of 1, 2, 4 or 8, and Dp <= {MAX_DP}")
    return cluster


def max_tile_rows(dp: int, h: int, cluster: int, smem) -> int:
    """The largest tile (a multiple of 16, at most 128 rows) that `smem`
    (tile_rows, dp, h, cluster) -> bytes, or -1 where it does not fit,
    fits."""
    rows = MAX_TILE_ROWS
    while rows > 16 and smem(rows, dp, h, cluster) < 0:
        rows -= 16
    return rows


def plan(rows: int, h: int, dp: int, wave_clusters: int, smem, align: int = 16) -> Plan:
    """Tile rows and cluster size for `rows` flattened rows: as few waves of
    `wave_clusters` clusters (the card's occupancy) as the largest tile
    allows, and in them tiles just large enough to cover the rows, so that
    one wave fills the card at small row counts (200 rows on an H100: 13
    tiles of 16) and few rows are padding. `smem` is the kernel's layout,
    as `max_tile_rows` takes it; `align` as `check_shape`'s (the int8
    kernel's 32)."""
    cluster = check_shape(h, dp, align)
    wave = max(1, wave_clusters)
    r_max = max_tile_rows(dp, h, cluster, smem)
    rounds = math.ceil(rows / (r_max * wave))
    tile = min(r_max, _round_up(math.ceil(rows / (rounds * wave)), 16))
    return Plan(tile, cluster, math.ceil(rows / tile), smem(tile, dp, h, cluster))


@functools.lru_cache(maxsize=256)
def launch_plan(device_index: int, rows: int, h: int, dp: int, f32: bool) -> Plan:
    """`plan` on the card, once a shape: the kernel's own shared-memory
    layout, and the clusters of its largest tile resident at once (CUDA's
    occupancy query)."""
    cluster = check_shape(h, dp)
    lib = ext.load()
    smem, resident = ((lib.mhent_realnvp_sample_f32_smem, lib.mhent_realnvp_sample_f32_clusters)
                      if f32 else (lib.mhent_realnvp_sample_smem, lib.mhent_realnvp_sample_clusters))
    with torch.cuda.device(device_index):
        n = resident(max_tile_rows(dp, h, cluster, smem), dp, h, cluster)
    if n < 0:
        ext.check(-n, "fused sampler cluster occupancy")
    ext.require(n > 0, f"fused sampler: no cluster of {cluster} CTAs fits on the card")
    return plan(rows, h, dp, n, smem)


@torch.no_grad()
def pack(flow: realnvp.RealNVP, dtype=torch.bfloat16) -> Packed:
    """Weights in `dtype`; masks and biases in f32 (f64 for f64 weights).
    One stack per field over all layers: the training step packs the f32
    weights at every draw, and the host issues these operations."""
    d = flow.cfg.dim
    dp = _round_up(d, 16)
    pad = dp - d
    n_layers = flow.cfg.n_layers
    acc = torch.float64 if dtype == torch.float64 else torch.float32

    def stack(j: int, attr: str) -> torch.Tensor:
        """(L, 2, ...) of linear j's `attr` in the s and t nets; weights [in, out]."""
        t = torch.stack([getattr(net[i].l[j], attr) for i in range(n_layers)
                         for net in (flow.s, flow.t)])
        t = t.view(n_layers, 2, *t.shape[1:])
        return t.transpose(-1, -2) if attr == "weight" else t

    return Packed(
        masks=F.pad(flow.mask.to(acc), (0, pad), value=1.0).contiguous(),
        w0=F.pad(stack(0, "weight"), (0, 0, 0, pad)).to(dtype).contiguous(),
        w1=stack(1, "weight").to(dtype).contiguous(),
        w2=F.pad(stack(2, "weight"), (0, pad)).to(dtype).contiguous(),
        b0=stack(0, "bias").to(acc).contiguous(),
        b1=stack(1, "bias").to(acc).contiguous(),
        b2=F.pad(stack(2, "bias"), (0, pad)).to(acc).contiguous(),
        dim=d,
    )


def transform(packed: Packed, z0: torch.Tensor, cproj: torch.Tensor):
    """(B, R, D) image-major base samples through every coupling layer.

    cproj: (L, 4, B, H) per-image conditioning projections.
    Returns (x (B, R, D), logdet (B, R)), f32 (f64 for f64 inputs on the CPU).
    """
    if packed.w1.dtype == torch.bfloat16:
        ext.require(z0.shape[-1] == packed.dim,
                    f"fused sampler: z0 has D={z0.shape[-1]}, flow has {packed.dim}")
        return _op(z0, cproj, *packed[:7])
    if z0.device.type == "cpu":
        return transform_plain(packed, z0, cproj)
    return _transform_kernel(packed, z0, cproj)


def transform_plain(packed: Packed, z0: torch.Tensor, cproj: torch.Tensor):
    """The Python loop over `realnvp.forward_layer`, on the packed weights
    widened to z0's precision, at least f32 (padded dims pass through
    exactly)."""
    b, r, d = z0.shape
    dp = packed.masks.shape[1]
    dt = torch.promote_types(z0.dtype, torch.float32)
    x = F.pad(z0.to(dt), (0, dp - d)).reshape(b * r, dp)
    logdet = x.new_zeros(b * r)
    for l in range(packed.masks.shape[0]):
        ws = [getattr(packed, n)[l].to(dt) for n in ("w0", "b0", "w1", "b1", "w2", "b2")]
        layer = realnvp.Layer(packed.masks[l].to(dt), *(w[0] for w in ws), *(w[1] for w in ws))
        cp = cproj[l].to(dt).repeat_interleave(r, dim=1)  # image-major row alignment
        x, logdet = realnvp.forward_layer(layer, cp, x, logdet)
    return x.reshape(b, r, dp)[..., :d], logdet.reshape(b, r)


def check_shapes(packed: Packed, z0: torch.Tensor, cproj: torch.Tensor) -> None:
    """The kernels' shape, dtype and layout checks (the fake
    implementation's too); `_transform_kernel` adds the alignment."""
    b, r, d = z0.shape
    n_layers, dp = packed.masks.shape
    h = packed.w1.shape[-1]
    wdtype = packed.w1.dtype
    ext.require(wdtype in (torch.bfloat16, torch.float32),
                f"fused sampler: packed weights are {wdtype}, not bfloat16 or float32")
    ext.require(z0.dtype == torch.float32 and z0.is_contiguous(),
                "fused sampler: z0 must be contiguous float32 (B, R, D)")
    ext.require(d == packed.dim, f"fused sampler: z0 has D={d}, flow has {packed.dim}")
    ext.require(cproj.shape == (n_layers, 4, b, h) and cproj.dtype == torch.float32
                and cproj.is_contiguous(),
                f"fused sampler: cproj must be contiguous float32 {(n_layers, 4, b, h)}, "
                f"got {tuple(cproj.shape)} {cproj.dtype}")
    for name in ("w0", "w1", "w2"):
        t = getattr(packed, name)
        ext.require(t.dtype == wdtype and t.is_contiguous(),
                    f"fused sampler: packed {name} must be contiguous {wdtype}")
    for name in ("masks", "b0", "b1", "b2"):
        t = getattr(packed, name)
        ext.require(t.dtype == torch.float32 and t.is_contiguous(),
                    f"fused sampler: packed {name} must be contiguous float32")
    for t in (cproj, *packed[:7]):
        ext.require(t.device == z0.device, "fused sampler: tensors on different devices")


def _transform_kernel(packed: Packed, z0: torch.Tensor, cproj: torch.Tensor):
    global launches, launches_f32
    ext.require(z0.is_cuda, f"fused sampler: unsupported device {z0.device}")
    check_shapes(packed, z0, cproj)
    b, r, d = z0.shape
    n_layers, dp = packed.masks.shape
    h = packed.w1.shape[-1]
    wdtype = packed.w1.dtype
    for name in ("w0", "w1", "w2"):
        ext.require(getattr(packed, name).data_ptr() % 16 == 0,
                    f"fused sampler: packed {name} must be 16-byte aligned")
    f32 = wdtype == torch.float32
    pl = launch_plan(z0.device.index, b * r, h, dp, f32)
    x = torch.empty_like(z0)
    logdet = torch.empty((b, r), dtype=torch.float32, device=z0.device)
    lib = ext.load()
    fn, name = ((lib.mhent_realnvp_sample_f32, "mhent_realnvp_sample_f32") if f32
                else (lib.mhent_realnvp_sample, "mhent_realnvp_sample"))
    err = fn(z0.data_ptr(), cproj.data_ptr(), packed.masks.data_ptr(),
             packed.w0.data_ptr(), packed.w1.data_ptr(), packed.w2.data_ptr(),
             packed.b0.data_ptr(), packed.b1.data_ptr(), packed.b2.data_ptr(),
             x.data_ptr(), logdet.data_ptr(), b, r, d, dp, h, n_layers, pl.tile_rows,
             pl.cluster, ext.stream_of(z0))
    ext.check(err, name)
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return x, logdet



def _packed(z0: torch.Tensor, fields) -> Packed:
    return Packed(*fields, dim=z0.shape[-1])


def _sample_cpu(z0, cproj, *fields):
    x, logdet = transform_plain(_packed(z0, fields), z0, cproj)
    return x.contiguous(), logdet


def _sample_fake(z0, cproj, *fields):
    ops.require_device(z0, "fused sampler")
    packed = _packed(z0, fields)
    if z0.is_cuda:
        check_shapes(packed, z0, cproj)
    dt = torch.promote_types(z0.dtype, torch.float32)
    return z0.new_empty(z0.shape, dtype=dt), z0.new_empty(z0.shape[:2], dtype=dt)


# The bf16 draw (the eval and serving paths'): the packed weights' seven
# tensors, `Packed`'s fields but `dim`, which is z0's last extent.
_op = ops.define(
    "realnvp_sample(Tensor z0, Tensor cproj, Tensor masks, Tensor w0, Tensor w1, Tensor w2, "
    "Tensor b0, Tensor b1, Tensor b2) -> (Tensor, Tensor)",
    cpu=_sample_cpu, cuda=lambda z0, cproj, *fields: _transform_kernel(
        _packed(z0, fields), z0, cproj),
    fake=_sample_fake)

def sample_fused(flow: realnvp.RealNVP, packed: Packed, feat: torch.Tensor,
                 n: int, z0_rows: torch.Tensor):
    """The flow draw for n hypotheses of each of B images.

    Args:
        feat: (B, C) conditioning features.
        z0_rows: (n * B, D) hypothesis-major base noise, already times temp.

    Returns:
        x (n * B, D) hypothesis-major and log q (n * B,).
    """
    b = feat.shape[0]
    d = flow.cfg.dim
    # Inside `parallel.sharded.tensor_parallel` the cache's columns are
    # gathered over the line (the kernel reads it whole, and the packed
    # weights are whole).
    cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat),
                               gather=True).float().contiguous()
    z0 = z0_rows.reshape(n, b, d).transpose(0, 1).contiguous()  # image-major
    with sharded.whole():
        x, logdet = transform(packed, z0, cproj)
    lp = std_normal_logp(z0) - logdet
    return x.transpose(0, 1).reshape(n * b, d), lp.transpose(0, 1).reshape(n * b)


def transform_params(flow: realnvp.RealNVP) -> list[torch.Tensor]:
    """The parameters the coupling transform reads (the s and t nets'
    linears, not the conditioning projections, which enter through cproj)."""
    return [p for net in (*flow.s, *flow.t) for lin in net.l for p in (lin.weight, lin.bias)]


def transform_reference(flow: realnvp.RealNVP, z0: torch.Tensor, cproj: torch.Tensor):
    """The plain f32 flow on image-major rows, under autograd
    (pallas_sampler._xla_equivalent): (B, R, D), (L, 4, B, H) -> (x, logdet)."""
    b, r, d = z0.shape
    x, logdet = realnvp.forward(flow, z0.reshape(b * r, d), cproj.repeat_interleave(r, dim=2))
    return x.reshape(b, r, d), logdet.reshape(b, r)


class TransformDiff(torch.autograd.Function):
    """`transform` with f32 weights, differentiable in z0, cproj and the
    flow's transform parameters: kernel forward, plain-flow backward.

    Inside `parallel.sharded.tensor_parallel` the kernel, which reads whole
    weights, runs on the transform's weights gathered whole
    (`sharded.whole`); the backward recomputes the couplings split on the
    caller's line and the blocks each rank stores, so that each rank's
    gradients are its blocks', as the split path's are."""

    @staticmethod
    def forward(ctx, flow, z0, cproj, *weights):
        # weights are transform_params(flow), passed so that autograd routes
        # their gradients; the backward differentiates the flow's own.
        dtype = torch.float64 if z0.dtype == torch.float64 else torch.float32
        ctx.flow, ctx.line = flow, sharded.line()
        with sharded.whole(list(weights)):
            x, logdet = transform(pack(flow, dtype=dtype), z0, cproj)
        ctx.save_for_backward(z0, cproj)
        return x, logdet

    @staticmethod
    def backward(ctx, dx, dlogdet):
        z0, cproj = ctx.saved_tensors
        with torch.enable_grad(), sharded.on_line(ctx.line):
            z = z0.detach().requires_grad_()
            c = cproj.detach().requires_grad_()
            x, logdet = transform_reference(ctx.flow, z, c)
            grads = torch.autograd.grad((x, logdet), (z, c, *transform_params(ctx.flow)),
                                        (dx, dlogdet))
        return (None, *grads)


def transform_diff(flow: realnvp.RealNVP, z0: torch.Tensor, cproj: torch.Tensor):
    return TransformDiff.apply(flow, z0, cproj, *transform_params(flow))


# flow -> (dtype, [(storage, version)] of what pack reads, Packed).
_PACKS = WeakIdKeyDictionary()


def packed_now(flow: realnvp.RealNVP, dtype=torch.float32) -> Packed:
    """`pack(flow, dtype)` of the transform's current weights (gathered
    whole when stored split), kept while they are unchanged: the same
    storages (held here, so that no other tensor takes their address) at
    the same version counters. A draw without gradients (the eval step's
    reverse-KL term) reads it: no gather or repack a call."""
    tensors = [*transform_params(flow), flow.mask]
    key = [(t.untyped_storage(), t._version) for t in tensors]
    hit = _PACKS.get(flow)
    if hit is not None and hit[0] == dtype and all(
            s.data_ptr() == hs.data_ptr() and v == hv
            for (s, v), (hs, hv) in zip(key, hit[1])):
        return hit[2]
    with sharded.whole(transform_params(flow)):
        packed = pack(flow, dtype=dtype)
    _PACKS[flow] = (dtype, key, packed)
    return packed


def sample_fused_diff(flow: realnvp.RealNVP, feat: torch.Tensor, n: int,
                      z0_rows: torch.Tensor):
    """`sample_fused` under autograd (pallas_sampler.sample_fused_diff): the
    same hypothesis-major rows in and out, gradients to feat (through the
    conditioning cache), the flow's parameters and the noise (without
    gradients, the same draw on `packed_now`'s weights). Inside
    `parallel.sharded.tensor_parallel` the draw is whole (the cache's
    columns gathered over the line) and its gradients split, as the split
    path's (`TransformDiff`)."""
    b = feat.shape[0]
    d = flow.cfg.dim
    cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat), gather=True).contiguous()
    z0 = z0_rows.reshape(n, b, d).transpose(0, 1).contiguous()  # image-major
    if torch.is_grad_enabled():
        x, logdet = transform_diff(flow, z0, cproj)
    else:
        dtype = torch.float64 if z0.dtype == torch.float64 else torch.float32
        with sharded.whole():
            x, logdet = transform(packed_now(flow, dtype), z0, cproj)
    lp = std_normal_logp(z0) - logdet
    return x.transpose(0, 1).reshape(n * b, d), lp.transpose(0, 1).reshape(n * b)
