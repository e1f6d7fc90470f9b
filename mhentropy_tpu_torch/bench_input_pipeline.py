"""Host-side input-pipeline throughput: can this host feed the card?

Port of tools/bench_input_pipeline.py. Writes an RHD tree
(`data/fixtures.py`, RHD_ITEMS samples in each split, 320 x 320), then
measures sustained images/s through the path the trainer uses:
`RHDDataset.__getitem__` (PNG decode, hand-side masking, depth
visibility, crop, augmentation, heatmaps) collated by
`data.common.batches` (THREADS threads) under `data.common.prefetch`,
for two target configurations: "full" (the reference's whole target) and
"auto" (the Experiment's defaults: heavy fields skipped, uint8 image
transport, device-side st). With `cached`, the decoded images come from
the decode cache (one pass fills it first: the steady state from epoch 2
on).

One JSON line a configuration, with the JAX tool's keys:
`imgs_per_sec_per_core` is the pipeline's images/s (its THREADS threads
share one interpreter lock), `train_step_demand_imgs_s` the train step's
images/s given as `--demand` (for example B = 64 over the card's ms a
step; null without it) and `cores_needed_per_chip` their ratio.

Usage: python -m mhentropy_tpu_torch.bench_input_pipeline [n_batches]
[training|evaluation] [cached] [--demand IMGS_PER_S]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from mhentropy_tpu_torch.data import common, fixtures, rhd

RHD_ITEMS = 64  # distinct samples a split, cycled
BATCH = 32
THREADS = 4
CONFIGS = (("full", {}),
           ("auto", {"heavy_fields": set(), "image_u8": True, "device_st": True}))


def _cycle_batches(ds, n_batches: int):
    """n_batches shuffled host batches, epoch after epoch."""
    made = 0
    while made < n_batches:
        for batch in common.batches(ds, BATCH, shuffle=True, seed=made, num_workers=THREADS):
            yield batch
            made += 1
            if made >= n_batches:
                return


def _drain(iterator) -> int:
    """Images in the batches of `iterator`, consumed to its end."""
    return sum(images.shape[0] for images, *_ in iterator)


def measure(root: str, n_batches: int, mode: str, cached: bool,
            demand: float | None = None) -> list[dict]:
    """One result line a target configuration, over the RHD tree at `root`."""
    lines = []
    for label, kw in CONFIGS:
        ds = rhd.load(root, mode, **kw)
        _drain(_cycle_batches(ds, 1))  # warm: imports, the numpy pools
        t0 = time.perf_counter()
        n_imgs = _drain(common.prefetch(_cycle_batches(ds, n_batches), size=2))
        rate = n_imgs / (time.perf_counter() - t0)
        lines.append({
            "metric": "host input pipeline (RHD preprocess, num_workers="
                      f"{THREADS}" + (", decode-cached)" if cached else ")"),
            "target_fields": label,
            "imgs_per_sec_per_core": rate,
            "train_step_demand_imgs_s": demand,
            "cores_needed_per_chip": demand / rate if demand else None,
            "cpu_count": os.cpu_count()})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_batches", nargs="?", type=int, default=12)
    ap.add_argument("mode", nargs="?", default="training", choices=("training", "evaluation"))
    ap.add_argument("cached", nargs="?", default=None,
                    help="any value: read the decoded images from the decode cache")
    ap.add_argument("--demand", type=float, default=None,
                    help="the train step's images/s, to print the cores it needs")
    args = ap.parse_args(argv)
    cached = args.cached is not None
    with tempfile.TemporaryDirectory() as root:
        fixtures.write_rhd(root, RHD_ITEMS, RHD_ITEMS, seed=0)
        if cached:
            common.set_decode_cache(os.path.join(root, "_decode_cache"))
        try:
            if cached:  # fill the cache: one pass over the split
                _drain(common.batches(rhd.load(root, args.mode), BATCH, num_workers=THREADS))
            for line in measure(root, args.n_batches, args.mode, cached, args.demand):
                print(json.dumps(line), flush=True)
        finally:
            if cached:
                common.set_decode_cache(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
