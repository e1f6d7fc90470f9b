"""What a sharded step does around the model: the parameter layout of
`tpu.fsdp` and `tpu.tp` (each rank stores its block), Megatron tensor
parallelism over 'model', the gradients summed over the ranks that share
them, and the running statistics that tensor parallelism splits.

The JAX package gets these from XLA's partitioner (mhentropy_tpu/train/
engine.py `make_train_step` :359 with `mesh.state_sharding`); here:

* `distribute(net, mesh, fsdp=, tp=)`: each parameter that
  `mesh.state_sharding` splits holds only this rank's block of it
  (`mesh.shard_index`: its 'model' part, and of that its 'data' part).
  Gradients and Adam moments take the parameter's shape, so they are
  blocks as well. The net's `state_dict` gathers the blocks into the
  1-process layout and its `load_state_dict` takes that layout (hooks on
  the net, collectives: every rank calls them).
* `compute(net)` (ZeRO-3, `tpu.fsdp`): inside, every parameter split over
  'data' is all-gathered over 'data', the whole net at once; `sync_grads`
  then sums its gradient over 'data' (one all-reduce with the whole
  parameters', each rank keeping its block's part) and puts the block
  back (the gathered copy is dropped, never written into it).
* `tensor_parallel(mesh)`: inside, the `_tp_spec` pairs compute
  Megatron-style on the blocks a rank stores. Each rank of the 'model'
  line computes its columns of a column-parallel member, the row-parallel
  member's product of those columns, and `reduce_from` sums the partial
  products: one all-reduce a pair. `copy_to` marks the input of a split
  computation (its backward sums the ranks' cotangents); `gather_from`
  all-gathers a split output that every rank uses whole (the glow
  blocks' context gate, the f32 sampler's conditioning cache). The
  ResNet blocks (`models/resnet.py`), the RealNVP couplings
  (`flows/realnvp.py`), the glow blocks (`flows/glow.py`) and the det head
  (`models/mhent.py`) consult `line()`.
* `whole(module)`: no split inside, and the module's split parameters
  hold their whole tensors, all-gathered over 'data' and 'model' (no
  gradient; the blocks are put back after): the kernels, which take whole
  weights, are called inside it, and `mhent.refresh_kernel_weights` folds
  and packs their weights inside it. The f32 sampler's backward
  recomputes the couplings split on the blocks
  (`flows/cuda_sampler.TransformDiff`).
* `sync_grads`: each rank's gradients summed over 'data' (its share of the
  global loss, so the sum is the global gradient); a split parameter's
  gradient is its block's already, and a whole parameter that the split
  computation reads by columns (`partial_names`) is summed over 'model';
  the pipelined flow's over 'pipe' (each stage holds its layers').
* `sync_split_stats`: the running statistics of the split BNs, each rank's
  channels gathered to all.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

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


def copy_to(x: torch.Tensor, ln: Line) -> torch.Tensor:
    return mesh_lib.CopyToGroup.apply(x, ln.group)


def reduce_from(x: torch.Tensor, ln: Line) -> torch.Tensor:
    return mesh_lib.ReduceFromGroup.apply(x, ln.group)


def gather_from(x: torch.Tensor, ln: Line, dim: int = -1) -> torch.Tensor:
    return mesh_lib.GatherFromGroup.apply(x, ln.group, dim % x.dim())


# --- the layout --------------------------------------------------------------

class Piece(NamedTuple):
    """A split parameter: its layout, name, whole shape and the dims split
    over 'model' and 'data' (None: not split there)."""

    layout: "Layout"
    name: str
    full: tuple
    model: int | None
    data: int | None

    def shape(self, model: bool = True, data: bool = True) -> tuple:
        """Its shape split over 'model' (model) and 'data' (data)."""
        shape = list(self.full)
        for split, d, axis in ((model, self.model, MODEL_AXIS), (data, self.data, DATA_AXIS)):
            if split and d is not None:
                shape[d] //= self.layout.mesh.shape[axis]
        return tuple(shape)

    def index(self, model: bool = True, data: bool = True) -> tuple:
        """This rank's block of the whole tensor, split as `shape`."""
        idx = list(mesh_lib.shard_index(self.layout.mesh, self.name, self.full,
                                        fsdp=self.layout.fsdp, tp=self.layout.tp,
                                        min_size=self.layout.min_size))
        for split, d in ((model, self.model), (data, self.data)):
            if not split and d is not None:
                idx[d] = slice(None)
        return tuple(idx)


class Layout(NamedTuple):
    mesh: mesh_lib.Mesh
    fsdp: bool
    tp: bool
    min_size: int


# Parameter -> Piece; net -> Layout; a parameter gathered by `compute` ->
# its block, until `sync_grads` (or the context's end) puts it back.
_PIECES = WeakIdKeyDictionary()
_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_REST = WeakIdKeyDictionary()


def piece(p: torch.Tensor) -> Piece | None:
    return _PIECES.get(p)


def layout(net: torch.nn.Module) -> Layout | None:
    """The layout `distribute` gave the net, or None (whole parameters)."""
    return _LAYOUTS.get(net)


def _like(t: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """t in the memory format of its block (a channels_last conv weight
    gathers channels_last, so the convolutions run as on the whole one)."""
    if (t.dim() == 4 and block.is_contiguous(memory_format=torch.channels_last)
            and not t.is_contiguous(memory_format=torch.channels_last)):
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _block(t: torch.Tensor, index: tuple) -> torch.Tensor:
    """A copy of t[index] in t's memory format (channels_last stays)."""
    part = t[index]
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return part.clone(memory_format=torch.channels_last)
    return part.clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def distribute(net: torch.nn.Module, mesh: mesh_lib.Mesh, fsdp: bool = False,
               tp: bool = False, min_size: int = 4096) -> Layout | None:
    """Store each parameter of `net` that `mesh.state_sharding(fsdp=, tp=)`
    splits as this rank's block: once, by whoever builds the net (the
    steps and the optimizer read `layout(net)`; a net already split
    raises). Returns the layout (None when nothing is split: one data rank
    without tp, or one model rank without fsdp). Gradients are dropped;
    call it before the optimizer is made."""
    if layout(net) is not None:
        raise ValueError(f"distribute: the net is already split as {layout(net)}")
    fsdp = fsdp and mesh.shape[DATA_AXIS] > 1
    tp = tp and mesh.shape[MODEL_AXIS] > 1
    if not (fsdp or tp):
        return None
    lay = Layout(mesh, fsdp, tp, min_size)
    shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
    spec = mesh_lib.state_sharding(mesh, shapes, fsdp=fsdp, tp=tp, min_size=min_size)
    for k, p in net.named_parameters():
        m, d = spec[k][MODEL_AXIS], spec[k][DATA_AXIS]
        if m is None and d is None:
            continue
        pc = Piece(lay, k, shapes[k], m, d)
        p.grad = None
        p.data = _block(p.data, pc.index())
        _PIECES[p] = pc
    _LAYOUTS[net] = lay
    net._register_state_dict_hook(_gather_state_dict)
    net._register_load_state_dict_pre_hook(_split_state_dict, with_module=True)
    return lay


def _assemble(pairs: list, model: bool = True) -> list:
    """[(piece, tensor)] with each tensor a block of its piece (split as at
    rest, or over 'model' only) -> the tensors whole over 'data', and with
    `model` over 'model' too; one all-gather an axis a layout."""
    out = [t for _, t in pairs]
    layouts = {}
    for j, (pc, _) in enumerate(pairs):
        layouts.setdefault(id(pc.layout), []).append(j)
    with torch.no_grad(), torch.inference_mode(False):
        for items in layouts.values():
            mesh = pairs[items[0]][0].layout.mesh
            for axis in (DATA_AXIS, MODEL_AXIS) if model else (DATA_AXIS,):
                dims = {j: pairs[j][0].data if axis == DATA_AXIS else pairs[j][0].model
                        for j in items}
                sel = [j for j, d in dims.items()
                       if d is not None and out[j].shape[d] != pairs[j][0].full[d]]
                if not sel:
                    continue
                full = mesh_lib.all_gather_many([out[j] for j in sel], mesh.group(axis),
                                                [dims[j] for j in sel])
                for j, t in zip(sel, full):
                    out[j] = _like(t, out[j])
    return out


def to_whole(params: list, tensors: list) -> list:
    """Each tensor (a parameter's shape: its gradient or an Adam moment) in
    the 1-process layout; a whole parameter's passes. Collective."""
    idx = [j for j, p in enumerate(params) if piece(p) is not None]
    out = list(tensors)
    for j, t in zip(idx, _assemble([(piece(params[j]), tensors[j]) for j in idx])):
        out[j] = t
    return out


def to_block(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of `t` (the 1-process layout) for parameter p as p
    is stored now; t itself for a whole parameter."""
    pc = piece(p)
    if pc is None or tuple(t.shape) != pc.full:
        return t
    for model, data in ((True, True), (True, False), (False, False)):
        if tuple(p.shape) == pc.shape(model, data):
            return t[pc.index(model, data)]
    raise ValueError(f"{pc.name}: stored {tuple(p.shape)}, not a block of {pc.full}")


def _gather_state_dict(module, state_dict, prefix, local_metadata):
    pieces = [(prefix + pc.name, pc) for p in module.parameters()
              if (pc := piece(p)) is not None and prefix + pc.name in state_dict]
    full = _assemble([(pc, state_dict[k]) for k, pc in pieces])
    for (k, _), t in zip(pieces, full):
        state_dict[k] = t
    return state_dict


def _split_state_dict(module, state_dict, prefix, local_metadata, strict, missing, unexpected,
                      errors):
    for p in module.parameters():
        pc = piece(p)
        if pc is not None and prefix + pc.name in state_dict:
            state_dict[prefix + pc.name] = to_block(p, state_dict[prefix + pc.name])


@contextlib.contextmanager
def compute(net: torch.nn.Module):
    """ZeRO-3's gather: inside, each parameter split over 'data' holds its
    part whole over 'data' (one all-gather for the whole net). `sync_grads`
    sums the gradients, keeps each block's part and puts the blocks back; at the end any
    block still out is put back, its gradient dropped."""
    pairs = [(p, pc) for p in net.parameters() if (pc := piece(p)) is not None
             and pc.data is not None and tuple(p.shape) == pc.shape()]
    if not pairs:
        yield
        return
    for (p, _), t in zip(pairs, _assemble([(pc, p.data) for p, pc in pairs], model=False)):
        _REST[p] = p.data
        p.data = t
    try:
        yield
    finally:
        for p, _ in pairs:
            if p in _REST:
                p.grad = None
                p.data = _REST.pop(p)


@contextlib.contextmanager
def whole(module=None):
    """No split inside: a kernel's call, which reads whole weights. With
    `module` (a module, or a list of its parameters), its split parameters
    hold their whole tensors inside, all-gathered (collective; no
    gradient), and their blocks after."""
    with on_line(None):
        params = module.parameters() if isinstance(module, torch.nn.Module) else module or ()
        pairs = [(p, pc) for p in params
                 if (pc := piece(p)) is not None and tuple(p.shape) != pc.full]
        if not pairs:
            yield
            return
        saved = [p.data for p, _ in pairs]
        for (p, _), t in zip(pairs, _assemble([(pc, p.data) for p, pc in pairs])):
            p.data = t
        try:
            yield
        finally:
            for (p, _), t in zip(pairs, saved):
                p.data = t


def gathered_grads(net: torch.nn.Module) -> dict:
    """{name: gradient} of every parameter with one, in the 1-process
    layout. Collective."""
    named = [(k, p) for k, p in net.named_parameters() if p.grad is not None]
    grads = to_whole([p for _, p in named], [p.grad for _, p in named])
    return {k: g for (k, _), g in zip(named, grads)}


def global_norm(params: list) -> torch.Tensor:
    """The norm of the gradients of `params` together, in the 1-process
    layout: a block's squares are summed over the axes it is split over.
    One process takes the float32 norm of the per-tensor norms. In a
    process group of more than one rank the squares accumulate in float64
    (the result is float32), so that every layout there (DP, ZeRO-3, TP),
    each summing in its own order, clips by the same float32 norm: ZeRO-3's
    steps are DP's to the bit. Float64 in one process as well would move
    its clip by an ulp, and with it the state that the card's one-process
    f32 gradient check reads (PERF.md, open questions)."""
    named = [p for p in params if p.grad is not None]
    if mesh_lib.world()[1] == 1:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([p.grad for p in named])))
    groups = {}
    for p in named:
        pc = piece(p)
        # Split over 'data' only while at rest (compute() gathers it).
        key = (None if pc is None else
               (pc.layout, pc.model is not None,
                pc.data is not None and tuple(p.shape) == pc.shape()))
        groups.setdefault(key, []).append(p.grad)
    total = torch.zeros((), dtype=torch.float64, device=named[0].grad.device)
    for key, grads in groups.items():
        sq = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64)).pow(2).sum()
        if key is not None:
            lay, model, data = key
            if data:
                sq = mesh_lib.all_reduce_(sq, lay.mesh.group(DATA_AXIS))
            if model:
                sq = mesh_lib.all_reduce_(sq, lay.mesh.group(MODEL_AXIS))
        total = total + sq
    return torch.sqrt(total).float()


# --- the sums after a step ---------------------------------------------------

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


def _split_glow_blocks(net: torch.nn.Module) -> list:
    """(name, block) of each glow ResidualNet block with BatchNorm whose
    first Linear is split over 'model' (its hidden BatchNorm runs on the
    split columns)."""
    out = []
    for name, mod in net.named_modules():
        if getattr(mod, "batch_norm_layers", None) is not None and hasattr(mod, "linear_layers"):
            pc = piece(mod.linear_layers[0].weight)
            if pc is not None and pc.model is not None:
                out.append((name, mod))
    return out


def partial_names(net: torch.nn.Module) -> set:
    """Whole parameters that the split computation reads by columns (so
    each rank's gradient is its columns' part, summed over 'model'): the
    hidden BatchNorm of each glow block whose first Linear is split."""
    return {f"{name}.batch_norm_layers.1.{k}" for name, _ in _split_glow_blocks(net)
            for k in ("weight", "bias")}


@torch.no_grad()
def sync_grads(net: torch.nn.Module, mesh: mesh_lib.Mesh, model_names=(), pipe_names=()) -> None:
    """Sum the gradients over 'data', in one all-reduce (a parameter that
    `compute` gathered then keeps its block's part of the sum, and its
    block goes back in place: gloo has no reduce-scatter, and NCCL takes
    the same route), those of `model_names` over 'model' and of
    `pipe_names` over 'pipe' (a missing gradient there is a zero: a stage's
    unused layers)."""
    named = [(k, p) for k, p in net.named_parameters() if p.requires_grad]
    for k, p in named:
        if p.grad is None and k in pipe_names:
            p.grad = torch.zeros_like(p)
    _flat_all_reduce([p.grad for _, p in named if p.grad is not None], mesh.group(DATA_AXIS))
    for p in [p for _, p in named if p in _REST]:
        g = p.grad
        p.grad = None
        p.data = _REST.pop(p)
        if g is not None:
            p.grad = _block(g, piece(p).index(model=False))
    _flat_all_reduce([p.grad for k, p in named if k in model_names and p.grad is not None],
                     mesh.group(MODEL_AXIS))
    _flat_all_reduce([p.grad for k, p in named if k in pipe_names], mesh.group(PIPE_AXIS))


def _split_bns(net: torch.nn.Module) -> list:
    """The BatchNorms whose channels the split computation divides: a
    ResNet block's bn1 (its weight split over 'model') and a glow block's
    hidden BatchNorm (its first Linear split)."""
    bn2d = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)
            and m.weight is not None and (pc := piece(m.weight)) is not None
            and pc.model is not None]
    return bn2d + [blk.batch_norm_layers[1] for _, blk in _split_glow_blocks(net)]


@torch.no_grad()
def sync_split_stats(net: torch.nn.Module, mesh: mesh_lib.Mesh) -> None:
    """After a tensor-parallel train step: each split BN's running mean and
    variance hold this rank's channels only; gather every rank's."""
    ln = Line(mesh.group(MODEL_AXIS), mesh.index(MODEL_AXIS), mesh.shape[MODEL_AXIS])
    if ln.group is None:
        return
    bufs = []
    for mod in _split_bns(net):
        for buf in (mod.running_mean, mod.running_var):
            mine = torch.zeros_like(buf)
            cols = ln.cols(buf.shape[0])
            mine[cols] = buf[cols]
            bufs.append((buf, mine))
    _flat_all_reduce([m for _, m in bufs], ln.group)
    for buf, full in bufs:
        buf.copy_(full)
