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
  checks; it counts nothing and reads no data. `torch.export` traces it.

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


def define(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define `mhent::<schema>` with its CPU, CUDA and fake implementations;
    returns the operator's default overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


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
