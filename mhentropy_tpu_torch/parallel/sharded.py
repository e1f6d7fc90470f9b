"""What a sharded step does around the model: Megatron tensor parallelism
over 'model', the gradients summed over the ranks that share them, and the
running statistics that tensor parallelism splits.

The JAX package gets these from XLA's partitioner (mhentropy_tpu/train/
engine.py `make_train_step` :359 with `mesh.state_sharding`); here:

* `tensor_parallel(mesh)`: inside it, the `_tp_spec` pairs compute
  Megatron-style. Each rank of the 'model' line computes its columns of a
  column-parallel member (`cols`), the row-parallel member's product of
  those columns, and `reduce_from` sums the partial products: one
  all-reduce a pair. `copy_to` marks the input of a split computation (its
  backward sums the ranks' cotangents). The parameters stay whole on every
  rank: a rank reads its columns of them, and the kernels, which take
  whole weights, read them as they are (`whole()` turns the split off
  around a kernel's call). The f32 sampler's backward recomputes the
  couplings split (`flows/cuda_sampler.TransformDiff`), so its gradients
  are summed as the split path's are. The ResNet blocks (`models/resnet.py`), the
  RealNVP couplings (`flows/realnvp.py`) and the det head
  (`models/mhent.py`) consult `line()`; the glow regressor's blocks are not
  split (the engine refuses tp with it).
* `sync_grads`: each rank's gradients summed over 'data' (its share of the
  global loss, so the sum is the global gradient); the split parameters'
  also over 'model' (each rank holds its columns' part), the pipelined
  flow's over 'pipe' (each stage holds its layers').
* `sync_split_stats`: the running statistics of the split BNs, each rank's
  channels gathered to all.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from mhentropy_tpu_torch.parallel import mesh as mesh_lib
from mhentropy_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS


class Line(NamedTuple):
    """This rank's place on the 'model' line: its group, index and size."""

    group: object
    index: int
    size: int

    def cols(self, n: int) -> slice:
        """This rank's part of a split dim of n."""
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


_line: Line | None = None


def line() -> Line | None:
    """The active tensor-parallel line, or None (no split)."""
    return _line


@contextlib.contextmanager
def tensor_parallel(mesh: mesh_lib.Mesh | None):
    """Split the `_tp_spec` pairs over the mesh's 'model' axis inside (a
    no-op for a mesh without one)."""
    if mesh is None or mesh.shape[MODEL_AXIS] == 1:
        yield
        return
    with on_line(Line(mesh.group(MODEL_AXIS), mesh.index(MODEL_AXIS), mesh.shape[MODEL_AXIS])):
        yield


@contextlib.contextmanager
def on_line(ln: Line | None):
    """`ln` the active line inside (None: no split)."""
    global _line
    prev, _line = _line, ln
    try:
        yield
    finally:
        _line = prev


def whole():
    """No split inside: a kernel's call, which reads whole weights."""
    return on_line(None)


def copy_to(x: torch.Tensor, ln: Line) -> torch.Tensor:
    return mesh_lib.CopyToGroup.apply(x, ln.group)


def reduce_from(x: torch.Tensor, ln: Line) -> torch.Tensor:
    return mesh_lib.ReduceFromGroup.apply(x, ln.group)


def _flat_all_reduce(tensors: list, group) -> None:
    """Sum each tensor over the group, in one collective."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh_lib.all_reduce_(flat, group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def sync_grads(net: torch.nn.Module, mesh: mesh_lib.Mesh, tp_names=(), pipe_names=()) -> None:
    """Sum the gradients over 'data', and those of `tp_names` over 'model'
    and of `pipe_names` over 'pipe' (a missing gradient there is a zero: a
    stage's unused layers)."""
    named = [(k, p) for k, p in net.named_parameters() if p.requires_grad]
    for k, p in named:
        if p.grad is None and k in pipe_names:
            p.grad = torch.zeros_like(p)
    _flat_all_reduce([p.grad for _, p in named if p.grad is not None], mesh.group(DATA_AXIS))
    _flat_all_reduce([p.grad for k, p in named if k in tp_names and p.grad is not None],
                     mesh.group(MODEL_AXIS))
    _flat_all_reduce([p.grad for k, p in named if k in pipe_names], mesh.group(PIPE_AXIS))


@torch.no_grad()
def sync_split_stats(net: torch.nn.Module, mesh: mesh_lib.Mesh, tp_names) -> None:
    """After a tensor-parallel train step: each split BN's running mean and
    variance hold this rank's channels only; gather every rank's."""
    ln = Line(mesh.group(MODEL_AXIS), mesh.index(MODEL_AXIS), mesh.shape[MODEL_AXIS])
    if ln.group is None:
        return
    bufs = []
    for name, mod in net.named_modules():
        if f"{name}.weight" in tp_names and isinstance(mod, torch.nn.BatchNorm2d):
            for buf in (mod.running_mean, mod.running_var):
                mine = torch.zeros_like(buf)
                cols = ln.cols(buf.shape[0])
                mine[cols] = buf[cols]
                bufs.append((buf, mine))
    _flat_all_reduce([m for _, m in bufs], ln.group)
    for buf, full in bufs:
        buf.copy_(full)
