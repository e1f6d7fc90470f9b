"""Full-pipeline throughput of the Humans (ProHMR) path, on the card.

Port of tools/bench_prohmr.py: resnet50 at 224 px -> ConditionalGlow(144,
1024, 4, 2, context 2048) draw -> SMPL 6D decode (6,890 vertices) ->
weak-perspective projection, N hypotheses per image at B images a step.

    python -m mhentropy_tpu_torch.bench_prohmr [plain|kernel|quant|all]
    python -m mhentropy_tpu_torch.bench_prohmr all --device cpu --tiny --batch 2 --n 4

Variants: `plain` runs every stage on its plain PyTorch version
(`set_kernels(False)`: cuDNN stem and stage 1, the f32 flow; the XLA
variant's counterpart), `kernel` the stem, stage-1 and Glow sampler kernels,
`quant` the int8 W8A8 context encoder (int8 stage-1 kernel, stages 2-4 on
`torch._int_mm`) with the Glow kernel. The SMPL blend runs the LBS kernel in
all three. Each step draws for a different batch of images (a pool of four,
in turn). Timing: CUDA events around windows of whole steps after warmup,
the variants in alternating windows; prints one JSON line per variant with
hypotheses/s and ms per step (median of the windows, with their spread)
and the card's name.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from mhentropy_tpu_torch import eval_prohmr
from mhentropy_tpu_torch.models import prohmr
from mhentropy_tpu_torch.models import quant as quant_mod

VARIANTS = ("plain", "kernel", "quant")
POOL = 4  # image batches a step cycles through


def make_steps(model, net, batch: int, n: int, variants=VARIANTS, seed: int = 2) -> dict:
    """{variant: step()}: each call draws n hypotheses for the next batch of
    the pool and reduces every output, as the JAX bench does."""
    dev = model.v_template.device
    g = torch.Generator(device=dev).manual_seed(seed)
    size = net.cfg.image_size
    images = [torch.rand((batch, size, size, 3), generator=g, device=dev) * 2 - 1
              for _ in range(POOL)]
    noise = [torch.randn((n * batch, net.cfg.flow.features), generator=g, device=dev)
             for _ in range(POOL)]
    quant = None
    if "quant" in variants:
        with torch.inference_mode():
            quant = quant_mod.quantize_encoder(net.encoder, images[0])
    count = [0]

    def step(kernels: bool, q):
        i = count[0] % POOL
        count[0] += 1
        net.set_kernels(kernels)
        with torch.inference_mode():
            out = prohmr.sample_hypotheses(model, net, images[i], n=n, noise=noise[i], quant=q)
            return out["joints3d"].sum() + out["uv"].sum() + out["log_q"].sum()

    table = {"plain": lambda: step(False, None), "kernel": lambda: step(True, None),
             "quant": lambda: step(True, quant)}
    return {v: table[v] for v in variants}


def _window_ms(step, seconds: float, cuda: bool, min_steps: int = 3) -> float:
    """ms per step over a window of about `seconds` (at least `min_steps`
    steps), by CUDA events on the card, by the host clock on the CPU."""
    t0 = time.perf_counter()
    count = 0
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    while time.perf_counter() - t0 < seconds or count < min_steps:
        step()
        count += 1
    if cuda:
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / count
    return (time.perf_counter() - t0) * 1e3 / count


def alternate(steps: dict, cuda: bool, windows: int = 3, seconds: float = 2.0,
              warmup: int = 2, min_steps: int = 3) -> dict:
    """{variant: [ms per step of each window]}, the variants in alternating
    order (reversed on odd windows), after `warmup` steps each; a window is
    `seconds` long and at least `min_steps` steps."""
    for step in steps.values():
        for _ in range(warmup):
            step()
    if cuda:
        torch.cuda.synchronize()
    order = tuple(steps)
    runs = {v: [] for v in order}
    for r in range(windows):
        for v in (order if r % 2 == 0 else order[::-1]):
            runs[v].append(_window_ms(steps[v], seconds, cuda, min_steps))
    return runs


def summary(runs: dict, batch: int, n: int) -> dict:
    out = {}
    for v, ms in runs.items():
        med = statistics.median(ms)
        out[v] = {"ms_per_step": med, "ms_min_max": [min(ms), max(ms)], "windows": len(ms),
                  "hypotheses_per_s": batch * n / med * 1e3}
    return out


def main(argv=None) -> dict:
    from mhentropy_tpu_torch.train.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("variant", nargs="?", default="all", choices=(*VARIANTS, "all"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0, help="length of a window")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="small geometry for a CPU run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model, net = eval_prohmr.build(dev, tiny=args.tiny)
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    steps = make_steps(model, net, args.batch, args.n, variants)
    res = summary(alternate(steps, dev.type == "cuda", args.windows, args.seconds), args.batch,
                  args.n)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for v, r in res.items():
        print(json.dumps({"metric": f"prohmr hypotheses/s (N={args.n}, B={args.batch}, {v})",
                          "value": r["hypotheses_per_s"], "unit": "hypotheses/s",
                          "ms_per_step": r["ms_per_step"], "ms_min_max": r["ms_min_max"],
                          "device": device}), flush=True)
    return res


if __name__ == "__main__":
    main()
