"""Times the RealNVP sampler kernels of one checkout of the port at the main
path's shapes, so that two trees can be compared on one card in turns.

    python mhentropy_tpu_torch/sampler_ab.py [--root DIR] [--label NAME] [--out FILE]

`--root` is the checkout whose `mhentropy_tpu_torch` is imported (default:
the one holding this file), so the same script times an older tree's
kernels through that tree's own wrappers (`cuda_sampler.pack`, `transform`):
run it on the parent tree and on this one in turns (parent, this, this,
parent) within one call. Each shape prints one JSON line: the kernel's
median ms of RUNS windows as CUDA-graph replays and eagerly, with [min,
max], its max-abs error against the tree's plain version, and the card's
name and power limit. `--out` appends the lines to a file. Shapes (L = 12,
H = 512, D = 45): the bf16 draw at B x N = 1 x 200, 8 x 200, 32 x 100 and
64 x 200, the f32 draw at 64 x 10 and 7 x 93. Runs only on a CUDA card.
It times with the tree's own `profile_step` helpers (`cuda_ms`, `graphed`,
`card_line`), so both trees need that module.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

BF16_SHAPES = ((1, 200), (8, 200), (32, 100), (64, 200))
F32_SHAPES = ((64, 10), (7, 93))
RUNS = 3
WINDOW_S = 0.5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))  # run as a file: not a package root
    sys.path[:] = [os.path.abspath(args.root)] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    if not torch.cuda.is_available():
        print("sampler_ab: no CUDA device; it times the kernels on the card", file=sys.stderr)
        return 1
    from mhentropy_tpu_torch import ext, profile_step
    from mhentropy_tpu_torch.flows import cuda_sampler, realnvp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = profile_step.card_line()
    t0 = time.perf_counter()
    ext.load()
    build_s = time.perf_counter() - t0
    torch.manual_seed(3)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=512, h_dim=512,
                                                 num_steps=6)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    lines = []
    for dtype, shapes in ((torch.bfloat16, BF16_SHAPES), (torch.float32, F32_SHAPES)):
        packed = cuda_sampler.pack(flow, dtype=dtype)
        for b, n in shapes:
            with torch.inference_mode():
                feat = torch.randn((b, 512), generator=g, device=dev)
                z0 = torch.randn((b, n, 45), generator=g, device=dev) * 0.8
                cproj = realnvp.cond_cache(flow, feat).contiguous()
                x, ld = cuda_sampler.transform(packed, z0, cproj)
                x_ref, ld_ref = cuda_sampler.transform_plain(packed, z0, cproj)
                err = max((x - x_ref).abs().max().item(), (ld - ld_ref).abs().max().item())

                def call():
                    cuda_sampler.transform(packed, z0, cproj)

                replay = profile_step.graphed(call)
                times = {"graph_ms": [], "ms": []}
                for _ in range(RUNS):
                    times["graph_ms"].append(profile_step.cuda_ms(replay, WINDOW_S))
                    times["ms"].append(profile_step.cuda_ms(call, WINDOW_S))
            line = {"label": args.label, "root": os.path.abspath(args.root),
                    "dtype": str(dtype).removeprefix("torch."), "shape": [b, n], "rows": b * n,
                    **{k: statistics.median(v) for k, v in times.items()},
                    **{f"{k}_min_max": [min(v), max(v)] for k, v in times.items()},
                    "max_abs_err": err, "build_s": build_s, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
