"""The serving kernels as PyTorch operators, so that `torch.export` can
trace and serialise the paths that launch them.

Each kernel on `models/mhent.py::sample_hypotheses`'s paths is an operator
`mhent::<name>`, defined when its wrapper module is imported (nothing builds
or loads then) with three implementations:

* CUDA: the wrapper's launcher, with its argument checks, launch plan and
  launch count; it never falls back to the plain version;
* CPU: the plain PyTorch version, so CPU tensors keep taking it;
* fake (also the Meta kernel): output shapes, dtypes and strides from the
  input shapes alone, with the shape and dtype part of the launcher's
  checks; it counts nothing and reads no data. `torch.export` traces it;
* autograd: the wrapper's backward formula where it gives one (the LBS
  blend), else one that raises when a gradient is asked of the operator
  (the eval-only kernels), so that a backward never silently leaves the
  inputs without their gradient from it.

An operator takes flat tensors and ints: a wrapper's lists of NamedTuples
travel as one `Tensor?[]` (`flatten` / `unflatten`). The operators are
registered with `torch.library.Library` directly, which adds the least
dispatch cost to the eager path. The training-side kernels (the BN sums,
the f32 sampler) and the probes stay plain ctypes calls.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

NAMESPACE = "mhent"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, cpu: Callable, cuda: Callable, fake: Callable,
           backward: Callable | None = None, setup_context: Callable | None = None):
    """Define `mhent::<schema>` with its CPU, CUDA and fake implementations
    and its autograd formula (`backward` / `setup_context` as
    `torch.library.register_autograd` takes them; None registers one that
    raises: an eval-only kernel); returns the operator's default overload."""
    name = schema.split("(", 1)[0]
    qualname = f"{NAMESPACE}::{name}"
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(qualname, fake, lib=LIB)
    if backward is None:
        backward, setup_context = _no_gradient(qualname), _save_nothing
    torch.library.register_autograd(qualname, backward, setup_context=setup_context, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _save_nothing(ctx, inputs, output) -> None:
    pass


def _no_gradient(qualname: str) -> Callable:
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{qualname} is an eval-only kernel and has no gradient: run the plain path "
            f"(set_kernels(False), or the differentiable route the training step takes) "
            f"where a gradient is needed")
    return backward


def flatten(blocks: Sequence[NamedTuple]) -> list[torch.Tensor | None]:
    """A list of NamedTuples of tensors (or None) as one flat list."""
    return [t for blk in blocks for t in blk]


def unflatten(flat: Sequence[torch.Tensor | None], cls) -> list:
    """`flatten`'s inverse for NamedTuples of class `cls`."""
    n = len(cls._fields)
    if len(flat) % n:
        raise ValueError(f"{len(flat)} tensors do not make whole {cls.__name__}s of {n}")
    return [cls(*flat[i:i + n]) for i in range(0, len(flat), n)]


def require_device(t: torch.Tensor, what: str) -> None:
    """The operators run on CPU and CUDA tensors only (the fake's first check)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
