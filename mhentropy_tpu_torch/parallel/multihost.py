"""Process-group bring-up and each rank's share of a dataset.

Port of mhentropy_tpu/parallel/multihost.py: `initialize` :27 (here
`torch.distributed.init_process_group`), `host_shard_indices` :72,
`host_shard_valid` :82, `wrap_padded` :89 and `multihost_batches` :123 over
the port's `data.common.batches`, with the same wrap padding and `valid`
masking. A rank plays the part of a JAX host: it reads only its contiguous
slice of the dataset, padded by wrapping so that every rank serves the same
count (a ragged last rank would hang the collectives inside a step), and
the wrapped duplicates are masked out of the eval metrics by `valid`.

JAX's `global_batch_from_local` stitches the hosts' arrays into one global
array; the port's steps take a rank's rows themselves (`mesh.shard_batch`),
so a rank's batch stays its own and there is nothing to stitch.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from mhentropy_tpu_torch.parallel import mesh as mesh_lib


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device_type: str = "cuda") -> None:
    """Join the process group (a no-op when this process already has one).

    Explicit arguments (`coordinator_address` "host:port", `num_processes`,
    `process_id`) make an explicit multi-process bring-up: a failure raises,
    never degrading to a single-process run (`is not None`, not truthiness:
    process 0 of every group is falsy). Otherwise the environment decides:
    torchrun's multi-node signals (MASTER_ADDR with WORLD_SIZE > 1) join the
    group from the environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    and a failure raises; without them the process runs undistributed.

    backend: NCCL on the card and gloo on the CPU by default (device_type).
    On the card each process takes the device of its LOCAL_RANK.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize: an explicit bring-up names coordinator_address, "
                             "num_processes and process_id")
        _set_device(device_type, process_id)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
        return
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1 and os.environ.get("MASTER_ADDR"):
        _set_device(device_type, int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))))
        dist.init_process_group(backend, init_method="env://")


def _set_device(device_type: str, local_rank: int) -> None:
    if device_type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def host_shard_indices(n: int, process_index: int | None = None,
                       process_count: int | None = None) -> np.ndarray:
    """A rank's contiguous slice of n indices, padded by wrapping so that
    every rank serves the same count; host_shard_valid flags the wrapped
    duplicates."""
    return _host_slice(n, process_index, process_count)[0]


def host_shard_valid(n: int, process_index: int | None = None,
                     process_count: int | None = None) -> np.ndarray:
    """Boolean mask over host_shard_indices: False where the slice wrapped
    past the dataset's end."""
    return _host_slice(n, process_index, process_count)[1]


def wrap_padded(n: int, process_count: int) -> bool:
    """True when any rank's shard wraps (ceil(n / pc) * pc != n): a fact of
    n and the rank count alone, the same on every rank."""
    return (-(-n // process_count)) * process_count != n


def _host_slice(n, process_index, process_count):
    rank, size = mesh_lib.world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    per_host = -(-n // pc)  # ceil
    pos = np.arange(pi * per_host, (pi + 1) * per_host)
    return pos % n, pos < n


def multihost_batches(dataset, global_batch_size: int, shuffle: bool = False, seed: int = 0,
                      pad_remainder: bool = True, device=None):
    """Yield this rank's (image, target) batches of global_batch_size /
    world size, each rank having read only its slice of the dataset.

    Every rank iterates in lockstep (same seed, same order). The wrapped
    duplicates of the shards are folded into each batch's 'valid' mask
    (both pad_remainder modes: when a shard's count divides the local batch
    the duplicates land in full batches). Whether batches carry 'valid' is
    decided from the slice layout, the same on every rank, so that the
    ranks' batches have one structure.
    """
    from mhentropy_tpu_torch.data import common as data_common

    _, pc = mesh_lib.world()
    if global_batch_size % pc:
        raise ValueError(f"multihost_batches: batch {global_batch_size} does not divide over "
                         f"{pc} ranks")
    local_bs = global_batch_size // pc
    n = dataset.images.shape[0] if hasattr(dataset, "images") else len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    local_idx, local_valid = _host_slice(len(order), None, None)
    any_host_wraps = len(local_idx) * pc != len(order)
    view = _IndexedView(dataset, order[local_idx])
    pos = 0
    for batch in data_common.batches(view, local_bs, shuffle=False, pad_remainder=pad_remainder,
                                     drop_remainder=not pad_remainder, device=device):
        image, target = batch[0], batch[1]
        rows = np.arange(pos, pos + image.shape[0])
        vrow = np.where(rows < len(local_valid),
                        local_valid[np.minimum(rows, len(local_valid) - 1)], False)
        if "valid" in target or any_host_wraps:
            target = dict(target)
            prior = target.get("valid")
            vt = torch.as_tensor(vrow.astype(np.float32))
            if isinstance(prior, torch.Tensor):
                target["valid"] = prior * vt.to(prior.device)
            elif prior is not None:
                target["valid"] = np.asarray(prior, np.float32) * vrow.astype(np.float32)
            elif isinstance(image, torch.Tensor):
                target["valid"] = vt.to(image.device)
            else:
                target["valid"] = vrow.astype(np.float32)
        pos += image.shape[0]
        yield image, target


class _IndexedView:
    """len / __getitem__ over a permuted subset of a dataset (an array
    container's rows as (image, target) items)."""

    def __init__(self, dataset, indices: np.ndarray):
        self._ds = dataset
        self._idx = np.asarray(indices)
        self._array_backed = hasattr(dataset, "images")

    def __len__(self):
        return len(self._idx)

    def __getitem__(self, i: int):
        j = int(self._idx[i])
        if self._array_backed:
            return (np.asarray(self._ds.images[j]),
                    {k: np.asarray(v[j]) for k, v in self._ds.targets.items()})
        return self._ds[j]
