"""Preprocessed-sample disk cache for deterministic eval epochs.

Port of mhentropy_tpu/data/cached.py, line for line: `config_fingerprint`,
`heavy_field_tag`, `atomic_publish`, `read_or_compute_pickle`,
`eval_deterministic`, `fingerprint` and `SampleCache`. Its fingerprints
equal the JAX package's, so one cache directory serves both packages.

The decode cache (`common.set_decode_cache`) removes PNG decode from the
per-item budget, but an eval item still pays the whole preprocessing
chain (crop, visibility, projection fits, ...). Eval-mode items are
DETERMINISTIC for the shipped configurations — no augmentation, and the
patch occluder is idx-seeded exactly like the reference's
(rhddataloader.py:131-137) — so from the second epoch on the entire
`__getitem__` can be served from disk: one pickle read per sample
instead of the preprocessing.

Not a training feature: train items draw from the dataset RNG
(augmentation), and caching them would freeze one epoch's augmentations
forever. `SampleCache` refuses datasets that do not declare themselves
deterministic.

Wiring: `cfg.tpu.sample_cache = <dir>` makes `Experiment.make_datasets`
wrap its EVAL dataset; the fingerprint (dataset class, preprocessing
options, annotation count) isolates incompatible configurations in
separate subdirectories, so flipping e.g. image_u8 or target_fields
never serves stale items.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading


def config_fingerprint(fields: dict) -> str:
    """sha1 of a sorted field dict — one implementation for every
    preprocessing cache (eval SampleCache + the loaders' prefix caches),
    so distinctions like heavy=None ('full') vs heavy=set() can never
    silently diverge between copies."""
    return hashlib.sha1(
        repr(sorted(fields.items())).encode()
    ).hexdigest()[:16]


def heavy_field_tag(heavy):
    """Cache-identity of a loader's heavy_fields setting. None (the full
    reference-parity target) must NOT collide with the empty set."""
    return "full" if heavy is None else sorted(heavy)


def atomic_publish(path: str, write) -> None:
    """tmp-write + os.replace cache publication, safe under concurrent
    collation workers (pid AND thread id in the tmp name: two pool
    threads computing the same path must not interleave writes into one
    tmp file — a truncate mid-write can publish a hole-filled file that
    reads back as corrupt zeros). Best-effort: failures are swallowed,
    the caller still holds the computed value."""
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except OSError:
        pass


def read_or_compute_pickle(path: str, compute):
    """Atomic read-through pickle cache: one open+load on a hit; on a
    miss, compute() then `atomic_publish`."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (FileNotFoundError, EOFError, pickle.UnpicklingError):
        pass
    item = compute()
    atomic_publish(path, lambda f: pickle.dump(item, f, protocol=5))
    return item


def eval_deterministic(ds) -> bool:
    """True when every __getitem__ of `ds` is a pure function of its
    index (no RNG draws): eval mode, and no RNG-consuming optional field.
    The RHD cloud resample is the one eval-mode RNG consumer across the
    loaders (depth_to_cloud + the 256-point output permutation)."""
    declared = getattr(ds, "eval_deterministic", None)
    if declared is not None:
        # A dataset may declare itself (subclasses and new loaders would
        # otherwise silently fall through the name switch below to False).
        return bool(declared)
    if type(ds).__name__ == "MixedDataset":
        # Deterministic iff every member is (the projection is pure).
        # Checked BEFORE the aug probe: MixedDataset has no aug attr.
        return all(eval_deterministic(m) for m in ds.datasets)
    if getattr(ds, "aug", True):
        return False
    heavy = getattr(ds, "heavy", None)
    cls = type(ds).__name__
    if cls == "RHDDataset":
        return heavy is not None and "cloud" not in heavy
    if cls == "HO3DDataset":
        # Eval-mode object-vertex subsampling is idx-seeded (ho3d.py).
        return True
    if cls == "FreiHANDDataset":
        return True
    return False


def fingerprint(ds) -> str:
    """Stable identity of the preprocessing configuration. Everything
    that changes item VALUES must land here."""
    cls = type(ds).__name__
    if cls == "MixedDataset":
        # Member fingerprints carry the preprocessing identity; the
        # intersection projection is a pure function of the members.
        return config_fingerprint(
            {"cls": cls, "members": tuple(fingerprint(m)
                                          for m in ds.datasets)})
    root = getattr(ds, "root", None) or getattr(ds, "base", None)
    fields = {
        "cls": cls,
        "root": os.path.abspath(root) if root else None,  # no cross-root hits
        "mode": getattr(ds, "mode", None),
        "n": len(ds),
        "size": getattr(ds, "size", getattr(ds, "image_size", None)),
        "heavy": heavy_field_tag(getattr(ds, "heavy", None)),
        "image_u8": getattr(ds, "image_u8", False),
        "device_st": getattr(ds, "device_st", False),
        "uv_norm": getattr(ds, "uv_norm", None),
        "vc": getattr(ds, "vc", None),
        "patch_occlude": getattr(ds, "patch_occlude", None),
        # In-place annotation swaps (same root/mode/count) must miss —
        # same reason the prefix caches carry (mtime, size)
        # (rhd.py/ho3d.py _anno_stat).
        "anno": getattr(ds, "_anno_stat", None),
        # Bump when a code fix changes item VALUES (the prefix caches'
        # "v" convention).
        "v": 1,
    }
    return config_fingerprint(fields)


class SampleCache:
    """Index-addressable wrapper: first access computes and persists the
    item; later accesses (same process or not) are one pickle read.
    Atomic writes keep it safe under concurrent collation workers."""

    def __init__(self, ds, cache_dir: str):
        if not eval_deterministic(ds):
            raise ValueError(
                f"{type(ds).__name__} items are not deterministic "
                "(training mode, or an RNG-consuming field like the RHD "
                "cloud is enabled) — caching would freeze RNG draws"
            )
        self.ds = ds
        self.dir = os.path.join(cache_dir, fingerprint(ds))
        os.makedirs(self.dir, exist_ok=True)

    def __len__(self):
        return len(self.ds)

    def __getattr__(self, name):  # delegate heavy/mode/... to the wrapped ds
        if name == "ds" or name.startswith("__"):
            # Unpickling/copying probes dunders (e.g. __setstate__) before
            # __init__ sets self.ds — delegating then would recurse
            # through this __getattr__ forever.
            raise AttributeError(name)
        return getattr(self.ds, name)

    def __getitem__(self, idx: int):
        path = os.path.join(self.dir, f"{idx}.pkl")
        return read_or_compute_pickle(path, lambda: self.ds[idx])
