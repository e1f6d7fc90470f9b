"""Batch collation for index-addressable datasets (RHD, FreiHAND, HO3D,
mixed), the decode cache and the prefetch thread: the port's DataLoader.

Port of mhentropy_tpu/data/common.py: `field_gate` :24, `item_rng` :31,
`item_rng_stream` :45, `_collate` :55, `batches` :75, `imread` :188 with
the decode cache (`set_decode_cache` :277, the .npy header memo), `grid2d`
:285 and `prefetch` :298. Items are host numpy, made by a thread pool in
the JAX package's order with its RNG streams, so both packages give the
same items. `batches(..., device=)` moves each collated batch to the
device in ONE host-to-device copy: every field is packed into one (pinned,
on the card) byte buffer, copied with non_blocking=True, and split on the
device into views. Run under `prefetch`, that copy is made in the
producer thread, so the step never waits on the host for it.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def field_gate(heavy):
    """Membership test for a loader's heavy_fields setting — ONE place
    owns 'None means the full reference-parity target'."""
    return heavy.__contains__ if heavy is not None else (lambda _k: True)


def item_rng(seed: int, epoch: int, idx: int) -> np.random.RandomState:
    """Per-item augmentation RNG: a pure function of (seed, epoch, idx), so
    the items are the same whatever order the thread pool makes them in,
    and set_epoch makes augmentations differ across epochs."""
    return np.random.RandomState(
        np.array([seed & 0x7FFFFFFF, epoch, idx], dtype=np.uint32))


def item_rng_stream(seed: int, epoch: int, idx: int,
                    stream: int) -> np.random.RandomState:
    """A SEPARATE per-item stream (same discipline as item_rng) for
    augmentations added after a loader shipped: drawing from the main
    stream would shift every later draw and silently change all seeded
    items. `stream` is a small constant per augmentation family."""
    return np.random.RandomState(
        np.array([seed & 0x7FFFFFFF, epoch, idx, 0x9E3779B9 ^ stream],
                 dtype=np.uint32))


def _collate(samples):
    """Stack (image, target) pairs — or the RLE datasets' 4-tuples
    (img, target, img_id, bbox), collated to (images, target, img_ids,
    bboxes). String fields are dropped."""
    images = np.stack([s[0] for s in samples])
    keys = samples[0][1].keys()
    target = {}
    for k in keys:
        vals = [s[1][k] for s in samples]
        if isinstance(vals[0], (str,)):
            continue
        target[k] = np.stack([np.asarray(v) for v in vals])
    if len(samples[0]) == 4:
        ids = np.asarray([s[2] for s in samples])
        bboxes = np.stack([np.asarray(s[3]) for s in samples])
        return images, target, ids, bboxes
    return images, target


_ALIGN = 64  # bytes: every field's view starts at a multiple of its item size


def to_device(images: np.ndarray, target: dict, device):
    """(images, target) numpy -> torch tensors on `device` through ONE
    host-to-device copy: the fields are packed into one byte buffer (pinned
    when `device` is a card, so the non-blocking copy is asynchronous) and
    split into views of the copied buffer."""
    import torch

    device = torch.device(device)
    arrays = {"": np.ascontiguousarray(images),
              **{k: np.ascontiguousarray(v) for k, v in target.items()}}
    offsets, total = {}, 0
    for k, a in arrays.items():
        offsets[k] = total
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=device.type == "cuda")
    host = buf.numpy()
    for k, a in arrays.items():
        host[offsets[k]:offsets[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = buf.to(device, non_blocking=True)
    out = {}
    for k, a in arrays.items():
        view = dev[offsets[k]:offsets[k] + a.nbytes]
        out[k] = view.view(torch.from_numpy(a[:0].reshape(-1)).dtype).reshape(a.shape)
    images = out.pop("")
    return images, out


def batches(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    num_workers: int = 4,
    drop_remainder: bool = True,
    device=None,
    pad_remainder: bool = False,
):
    """Yield (image, target) batches from either kind of dataset: host numpy
    with device=None, else torch tensors on `device` (`to_device`).

    pad_remainder=True keeps tail samples (the reference eval DataLoader has
    no drop_last): the final short batch is padded to batch_size by wrapping
    indices and every target carries a 'valid' (B,) mask, so the step sees
    one shape and metrics can exclude the padding. The synthetic container
    goes through `synthetic.batches`: tensors (on the CPU for device=None),
    shuffle permuting its batch order, a short tail kept only padded.
    """
    if hasattr(dataset, "images"):  # synthetic array container
        from mhentropy_tpu_torch.data import synthetic

        yield from synthetic.batches(dataset, batch_size, pad_remainder=pad_remainder,
                                     device=device or "cpu", shuffle=shuffle, seed=seed)
        return

    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    if pad_remainder:
        drop_remainder = False
    end = n - batch_size + 1 if drop_remainder else n
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, end, batch_size):
            idxs = order[start : start + batch_size]
            k = idxs.shape[0]
            if pad_remainder and k < batch_size:
                idxs = np.concatenate([idxs, order[np.arange(batch_size - k) % n]])
            samples = list(pool.map(dataset.__getitem__, idxs))
            batch = _collate(samples)
            images, target, extras = batch[0], batch[1], batch[2:]
            if pad_remainder:
                target["valid"] = (np.arange(batch_size) < k).astype(np.float32)
            if device is not None:
                images, target = to_device(images, target, device)
            yield (images, target, *extras)


_PIL = None
_GRID_MEMO: dict = {}


def decode_cache_file(path) -> str:
    """The decode cache's .npy file for image `path`: named by the sha1 of
    its absolute path, mtime and size, so an edited file decodes anew. A
    caller may write an array there with np.save (`imread` then reads it
    without decoding)."""
    st = os.stat(path)
    key = hashlib.sha1(
        f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}".encode()
    ).hexdigest()
    return os.path.join(_DECODE_CACHE["dir"], key + ".npy")


def imread(path):
    """Image decode with Pillow (EXIF orientation honoured, as imageio's
    default).

    When a decode cache is set (`set_decode_cache`), decoded arrays are
    persisted as .npy files (`decode_cache_file`) and later reads are a
    header memo lookup and one read. In cache mode the result is ALWAYS a
    private writable array (hit and miss paths alike); without a cache
    the PIL-backed array is read-only."""
    if _DECODE_CACHE["dir"] is not None:
        cpath = decode_cache_file(path)
        try:
            # Parse the .npy header ONCE per file per process, then plain
            # seek + fromfile (already a private writable array). The
            # file name bakes in (path, mtime, size), so a changed source
            # file lands on a NEW cpath and the memo can never serve a
            # stale header.
            entry = _NPY_HDR_MEMO.get(cpath)
            if entry is None:
                with open(cpath, "rb") as f:
                    version = np.lib.format.read_magic(f)
                    if version == (1, 0):
                        shape, fortran, dtype = \
                            np.lib.format.read_array_header_1_0(f)
                    elif version == (2, 0):
                        shape, fortran, dtype = \
                            np.lib.format.read_array_header_2_0(f)
                    else:
                        raise ValueError(f"npy version {version}")
                    if fortran or dtype.hasobject:
                        raise ValueError("unsupported npy layout")
                    entry = (shape, dtype, f.tell())
                _NPY_HDR_MEMO[cpath] = entry
            shape, dtype, off = entry
            n = int(np.prod(shape, dtype=np.int64))
            with open(cpath, "rb") as f:
                f.seek(off)
                arr = np.fromfile(f, dtype=dtype, count=n)
            if arr.size != n:
                raise ValueError("short read")
            return arr.reshape(shape)
        except (FileNotFoundError, ValueError, OSError):
            pass
        arr = _decode(path)
        from mhentropy_tpu_torch.data.cached import atomic_publish

        # np.save(str) would append .npy — hand it the open fileobj.
        atomic_publish(cpath, lambda fp: np.save(fp, arr))
        return np.array(arr)  # writable copy — same contract as the hit path
    return _decode(path)


def _decode(path):
    global _PIL
    if _PIL is None:
        try:
            from PIL import Image, ImageOps
        except ImportError as e:
            raise ImportError(f"decoding {path} needs Pillow (the PIL package), which is not "
                              f"installed") from e

        _PIL = (Image, ImageOps)
    image_mod, ops_mod = _PIL
    with image_mod.open(path) as im:
        im = ops_mod.exif_transpose(im)
        return np.asarray(im)


_DECODE_CACHE = {"dir": None}
_NPY_HDR_MEMO: dict = {}


def set_decode_cache(path: str | None):
    """Enable/disable the decoded-image cache (None disables). The cache
    keys on (abspath, mtime, size), so edited files re-decode. Safe for
    concurrent workers (atomic rename). Pays off from the second epoch
    (or second run — it persists on disk)."""
    if path is not None:
        os.makedirs(path, exist_ok=True)
    _DECODE_CACHE["dir"] = path


def grid2d(h, w):
    """Cached read-only np.mgrid[0:h, 0:w]: one allocation per shape, not
    one per item."""
    g = _GRID_MEMO.get((h, w))
    if g is None:
        g = np.mgrid[0:h, 0:w]
        g.setflags(write=False)
        _GRID_MEMO[(h, w)] = g
    return g


class _PrefetchDone:
    pass


def prefetch(iterator, size: int = 2):
    """Run `iterator` in a background thread, keeping up to `size` items
    ready ahead of the consumer.

    The torch-DataLoader-workers equivalent for this pipeline: CUDA
    launches are asynchronous, so the device overlaps with building the
    NEXT batch, but only until the first host hiccup (a slow decode, a GC
    pause) lands synchronously between steps. A bounded queue decouples
    host jitter from the step cadence; `size` stays small because each
    slot holds a full device-ready batch.

    Exceptions in the producer propagate to the consumer at the point of
    `next()`; abandoning the generator (break / close) stops the producer
    promptly via a poison check on a bounded queue.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()
    err: list[BaseException] = []

    def producer():
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # propagated to the consumer
            err.append(e)
        finally:
            # Deterministic cleanup of the wrapped generator: an abandoned
            # batches() generator would keep its ThreadPoolExecutor's
            # worker threads alive until GC when the consumer breaks early.
            close = getattr(iterator, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            while not stop.is_set():
                try:
                    q.put(_PrefetchDone, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _PrefetchDone:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
