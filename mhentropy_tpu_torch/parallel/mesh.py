"""The (data, hypo, model, pipe) layout of the ranks, the parameter layout
rules, and the collectives the parallel paths use.

Port of mhentropy_tpu/parallel/mesh.py onto torch.distributed: `make_mesh`
:39 (a `DeviceMesh` over the process group's ranks, one rank a device),
`batch_sharding` / `shard_batch` :93-114 (a rank's rows of the global batch),
`hypo_batch_spec` :102 (a rank's hypotheses of the N axis), `_tp_spec`
:136, `state_sharding` :231, `fsdp_sharding` :118 and `tp_sharding` :217
(which parameter is split along which dim, on the reference's state_dict
names), `shard_index` (a rank's block of a parameter under that layout, the
block JAX's `NamedSharding.devices_indices_map` gives its device), and
`fit_devices` :265 with the same errors and choices.

XLA inserts the collectives of a sharded jit; here they are explicit, and
`all_reduce_` / `all_gather` / `broadcast_` / `send` / `recv` wrap them: a
group of one rank is the identity. `timed()` counts their seconds. Under the gloo backend, a CUDA tensor
goes through pinned host memory for the collectives gloo has no CUDA
implementation of (all-gather, send, recv); `STAGED` names the ones that
did. That is the transport of those collectives, not another path: the
kernels still run on the card.
"""

from __future__ import annotations

import contextlib
import re
import time

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
HYPO_AXIS = "hypo"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, HYPO_AXIS, MODEL_AXIS, PIPE_AXIS)

# Collectives that went through host memory (gloo and a CUDA tensor).
STAGED: set = set()
_GLOO_HOST_ONLY = ("all_gather", "send", "recv")
# Seconds spent in each kind of collective (a blocking recv includes its
# wait for the sender) while `timed()` is on.
TIMES: dict = {}
_timing = False


@contextlib.contextmanager
def timed():
    """Count the wall seconds of every collective inside into TIMES (reset
    on entry). Each is bracketed by a synchronise of the card, so that its
    seconds are its own and not the queued work's: the count costs those
    synchronisations."""
    global _timing
    TIMES.clear()
    prev, _timing = _timing, True
    try:
        yield TIMES
    finally:
        _timing = prev


@contextlib.contextmanager
def _clock(name: str, t: torch.Tensor):
    if not _timing:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    TIMES[name] = TIMES.get(name, 0.0) + time.perf_counter() - t0


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """The ranks of the process group laid out row-major over (data, hypo,
    model, pipe), as `np.reshape` lays out JAX's device list. `group(axis)`
    is the process group of this rank's line along `axis` (None for an axis
    of one rank), `index(axis)` its position there. `device_mesh` is the
    `DeviceMesh` the groups come from (None in a single process)."""

    def __init__(self, shape: tuple, device_type: str = "cpu"):
        self.shape = dict(zip(AXES, (int(s) for s in shape)))
        self.rank, self.size = world()
        if int(np.prod(shape)) != self.size:
            raise ValueError(f"Mesh: {self.shape} needs {int(np.prod(shape))} ranks, the process "
                             f"group has {self.size}")
        grid = np.arange(self.size).reshape(shape)
        self.coords = dict(zip(AXES, (int(c) for c in np.argwhere(grid == self.rank)[0])))
        self._grid = grid
        self.device_mesh = None
        if self.size > 1:
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(device_type, tuple(shape), mesh_dim_names=AXES)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's line along `axis`, in axis order."""
        idx = tuple(slice(None) if a == axis else self.coords[a] for a in AXES)
        return [int(r) for r in self._grid[idx]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def make_mesh(n_devices: int | None = None, hypo: int = 1, tp: int = 1, pp: int = 1,
              device_type: str | None = None) -> Mesh:
    """A (data, hypo, model, pipe) mesh over the process group's ranks;
    hypo = tp = pp = 1 is pure data parallelism. The port runs one rank a
    device, so n_devices (default: the world size) must be the world size."""
    _, size = world()
    if n_devices is None:
        n_devices = size
    if n_devices != size:
        raise ValueError(
            f"make_mesh: need {n_devices} ranks, the process group has {size}; launch one "
            f"process a device, e.g. python -m torch.distributed.run --nproc_per_node="
            f"{n_devices} ...")
    grp = hypo * tp * pp
    if n_devices % grp != 0:
        raise ValueError(
            f"make_mesh: hypo*tp*pp = {hypo}*{tp}*{pp} = {grp} does not divide "
            f"n_devices={n_devices}; pick sizes whose product divides the device count "
            f"(fit_devices helps)")
    if device_type is None:
        device_type = "cuda" if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"
    return Mesh((n_devices // grp, hypo, tp, pp), device_type)


def fit_devices(batch_size: int, hypo: int = 1, tp: int = 1, pp: int = 1,
                n_available: int | None = None) -> int:
    """Largest usable device count: a multiple of `hypo*tp*pp` whose data
    axis divides the batch. Never exceeds n_available (default: the world
    size); an over-subscribed hypo*tp*pp is reported here."""
    if n_available is None:
        n_available = world()[1]
    grp = hypo * tp * pp
    if grp > n_available:
        raise ValueError(
            f"fit_devices: hypo*tp*pp = {hypo}*{tp}*{pp} = {grp} exceeds "
            f"the {n_available} available device(s)")
    for n in range(n_available, 0, -1):
        if n % grp == 0 and batch_size % (n // grp) == 0:
            return n
    raise AssertionError("unreachable: n=grp always satisfies the loop")


# --- a rank's share of the batch and of the hypotheses ----------------------

def batch_sharding(mesh: Mesh, b: int) -> slice:
    """This rank's rows of a global batch of b: the leading axis over
    'data', replicated over 'hypo', 'model' and 'pipe'."""
    n = mesh.shape[DATA_AXIS]
    if b % n:
        raise ValueError(f"batch_sharding: batch {b} does not divide over {n} data ranks")
    per = b // n
    i = mesh.index(DATA_AXIS)
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every tensor (or numpy array) with a leading batch
    axis in a batch tree (a tensor, a tuple or list, or a dict); other leaves
    pass."""
    if isinstance(tree, dict):
        b = next(v.shape[0] for v in tree.values() if getattr(v, "ndim", 0))
        rows = batch_sharding(mesh, b)
        return {k: v[rows] if getattr(v, "ndim", 0) and v.shape[0] == b else v
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(mesh, t) for t in tree)
    return tree[batch_sharding(mesh, tree.shape[0])]


def hypo_batch_spec(mesh: Mesh, n: int, b: int) -> tuple[slice, slice]:
    """This rank's (hypotheses, images) of (N, B, ...) hypothesis-major
    tensors: N over 'hypo', B over 'data'."""
    h = mesh.shape[HYPO_AXIS]
    if n % h:
        raise ValueError(f"hypo_batch_spec: {n} hypotheses do not divide over {h} hypo ranks")
    per = n // h
    i = mesh.index(HYPO_AXIS)
    return slice(i * per, (i + 1) * per), batch_sharding(mesh, b)


def shard_rows(mesh: Mesh, rows: torch.Tensor, n: int, b: int, hypo: bool = True) -> torch.Tensor:
    """This rank's part of hypothesis-major (n * b, ...) rows (base noise,
    drawn whole on every rank): its images, and with `hypo` its
    hypotheses; returned as (n' * b', ...) rows."""
    hs, bs = hypo_batch_spec(mesh, n, b) if hypo else (slice(None), batch_sharding(mesh, b))
    part = rows.reshape(n, b, *rows.shape[1:])[hs, bs]
    return part.reshape(-1, *rows.shape[1:])


# --- the layout rules --------------------------------------------------------

_COUPLING_COL = (".l.0.weight", ".l.0.bias", ".c.0.weight", ".c.0.bias")


def _tp_spec(name: str, shape, n: int) -> int | None:
    """The dim of one parameter split over 'model' (Megatron-style), or None.

    JAX's leaf rules on the reference's state_dict names (torch weights are
    (out, in), so column-parallel splits dim 0 and row-parallel dim 1):

    * RealNVP couplings (`q_z_giv_i.{s,t}.{i}`): `l.0` and `c.0` (weights and
      biases) column-parallel into the hidden, `l.1` row-parallel out of it;
      `l.2` and `c.1` replicated.
    * Glow ResidualNet blocks (`...transform_net.blocks.{k}`): `linear_layers.0`
      and `context_layer` column-parallel, `linear_layers.1` row-parallel.
    * ResNet residual blocks (`feat_extractor.res.layer*`): `conv1` and its
      `bn1` output-channel-parallel, `conv2` input-channel-parallel; `conv3`,
      the downsample and the stem replicated. Running statistics are
      buffers, not parameters: no rule.
    * det head: `det_head.0` column-, `det_head.2` row-parallel.
    """
    nd = len(shape)

    def div(d):
        return shape[d] % n == 0

    if re.match(r"q_z_giv_i\.[st]\.\d+\.", name):
        if name.endswith(_COUPLING_COL) and div(0):
            return 0
        if name.endswith(".l.1.weight") and nd == 2 and div(1):
            return 1
        return None
    if ".transform_net.blocks." in name:
        if (".linear_layers.0." in name or ".context_layer." in name) and div(0):
            return 0
        if name.endswith(".linear_layers.1.weight") and nd == 2 and div(1):
            return 1
        return None
    if name.startswith("feat_extractor.res.layer"):
        if (".conv1.weight" in name or ".bn1." in name) and div(0):
            return 0
        if name.endswith(".conv2.weight") and nd == 4 and div(1):
            return 1
        return None
    if name.startswith("det_head.0.") and div(0):
        return 0
    if name == "det_head.2.weight" and nd == 2 and div(1):
        return 1
    return None


def state_sharding(mesh: Mesh, named_shapes: dict, fsdp: bool = False, tp: bool = False,
                   min_size: int = 4096) -> dict:
    """{name: {"model": dim or None, "data": dim or None}} for each
    parameter shape: the TP rule first, then with `fsdp` the largest dim
    the TP rule left whole that divides over 'data', for parameters of at
    least min_size elements (smaller ones stay replicated)."""
    n_d, n_m = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    out = {}
    for name, shape in named_shapes.items():
        shape = tuple(shape)
        m = _tp_spec(name, shape, n_m) if tp and n_m > 1 else None
        d = None
        if fsdp and n_d > 1 and int(np.prod(shape)) >= min_size:
            for k in sorted(range(len(shape)), key=lambda k: shape[k], reverse=True):
                if k != m and shape[k] % n_d == 0:
                    d = k
                    break
        out[name] = {MODEL_AXIS: m, DATA_AXIS: d}
    return out


def shard_index(mesh: Mesh, name: str, shape, fsdp: bool = False, tp: bool = False,
                min_size: int = 4096, coords: dict | None = None) -> tuple:
    """This rank's block of parameter `name` (of the whole `shape`) under
    `state_sharding(mesh, ..., fsdp=, tp=)`: one slice a dim, the 'model'
    dim's part first, then the 'data' dim's (the two are never the same
    dim). coords: another rank's mesh coordinates (default: this rank's).
    The block is the one JAX's `NamedSharding(mesh, spec).
    devices_indices_map(shape)` gives the device at those coordinates."""
    coords = mesh.coords if coords is None else coords
    spec = state_sharding(mesh, {name: shape}, fsdp=fsdp, tp=tp, min_size=min_size)[name]
    index = [slice(None)] * len(shape)
    for axis in (MODEL_AXIS, DATA_AXIS):
        d = spec[axis]
        if d is not None:
            per = shape[d] // mesh.shape[axis]
            i = coords[axis]
            index[d] = slice(i * per, (i + 1) * per)
    return tuple(index)


def _shapes(net: torch.nn.Module) -> dict:
    return {k: tuple(p.shape) for k, p in net.named_parameters()}


def fsdp_sharding(mesh: Mesh, net: torch.nn.Module, min_size: int = 4096) -> dict:
    """{parameter name: dim split over 'data'} of JAX's FSDP layout
    (ZeRO-3: parameters, gradients and Adam moments partitioned there), for
    the parameters the rule splits; `sharded.distribute(fsdp=True)` stores
    each such parameter as this rank's block between steps."""
    spec = state_sharding(mesh, _shapes(net), fsdp=True, min_size=min_size)
    return {k: v[DATA_AXIS] for k, v in spec.items() if v[DATA_AXIS] is not None}


def tp_sharding(mesh: Mesh, net: torch.nn.Module) -> dict:
    """{parameter name: dim split over 'model'} of the Megatron layout."""
    spec = state_sharding(mesh, _shapes(net), tp=True)
    return {k: v[MODEL_AXIS] for k, v in spec.items() if v[MODEL_AXIS] is not None}


# --- collectives -------------------------------------------------------------

def _host(t: torch.Tensor, op: str, group) -> tuple[torch.Tensor, bool]:
    """The tensor to hand the backend: a pinned host copy of a CUDA tensor
    under gloo for the collectives gloo runs on host memory only."""
    if t.is_cuda and op in _GLOO_HOST_ONLY and dist.get_backend(group) == "gloo":
        STAGED.add(op)
        return t.to("cpu", non_blocking=False).pin_memory(), True
    return t, False


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group (bf16 and f16 reduced in f32)."""
    if group is None:
        return t
    with _clock("all_reduce", t):
        if t.dtype in (torch.bfloat16, torch.float16):
            buf = t.float()
            dist.all_reduce(buf, group=group)
            return t.copy_(buf)
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    return all_gather_many([t], group, [dim])[0]


def all_gather_many(tensors: list, group, dims: list) -> list:
    """`all_gather` of each tensor (along its dim of `dims`), in one
    collective of their flat concatenation."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    with _clock("all_gather", flat):
        src, staged = _host(flat, "all_gather", group)
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        if staged:
            parts = [p.to(flat.device) for p in parts]
    out, off = [], 0
    for t, d in zip(tensors, dims):
        n = t.numel()
        out.append(torch.cat([p[off:off + n].view(t.shape) for p in parts], dim=d))
        off += n
    return out


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place: global rank `src`'s tensor on every rank of the group."""
    if group is None:
        return t
    with _clock("broadcast", t):
        dist.broadcast(t, src, group=group)
    return t


def isend(t: torch.Tensor, dst: int, tag: int = 0):
    """Start sending t to global rank dst; returns (work, the buffer sent),
    both to keep until work.wait()."""
    with _clock("send", t):
        buf, _ = _host(t.detach().contiguous(), "send", None)
        return dist.isend(buf, dst, tag=tag), buf


def recv(shape, dtype, device, src: int, tag: int = 0) -> torch.Tensor:
    """A tensor received from global rank src."""
    out = torch.empty(shape, dtype=dtype, device=device)
    with _clock("recv", out):
        buf, staged = _host(out, "recv", None)
        dist.recv(buf, src, tag=tag)
        return out.copy_(buf) if staged else out


class AllReduceSum(torch.autograd.Function):
    """Sum over a group, differentiated: each rank's result is every rank's
    input summed, so its backward sums the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward into a split computation whose
    ranks each use a part of x; the backward sums their cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the sum of the ranks' partial results; the ranks then
    compute the same function of it, so the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromGroup(torch.autograd.Function):
    """The ranks' parts concatenated along `dim` (each rank computed its
    part of a tensor that every rank then uses whole, in the same way); the
    backward keeps this rank's part of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[i].contiguous(), None, None
