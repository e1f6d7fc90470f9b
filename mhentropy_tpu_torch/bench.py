"""Benchmark of the port: hypotheses per second on one card at N = 100 on the
flagship MHEnt pipeline (resnet50 conditioning, conditional RealNVP draw,
MANO decode of xyz and uv, orthographic projection).

Port of bench.py, with its model and defaults: resnet50 at 256 px,
RealNVP(45, cond 512, H 512, 6 steps), feat 512, the synthetic MANO of seed
0, fresh weights of seed 0, temperature 0.8, mods xyz and uv.

    python -m mhentropy_tpu_torch.bench [N] [B] [--steps 250] [--device cpu --tiny]

Headline: whole `sample_hypotheses` steps on a fixed image batch, each step
offset by a fresh 1e-6 (bench.py:102) and drawing fresh base noise, run back
to back with one sync a round of `--steps` steps (the counterpart of
bench.py's 250-step scan), timed by CUDA events; three rounds, the best
rate. Then, while the budget (MHENT_BENCH_BUDGET_S, default 480 s) affords
each, bench.py's sections in its order:

- int8: the quantised serving path (`quantize_encoder`, q_from "auto", and
  the int8 sampler), calibrated on the bench image (MHENT_BENCH_INT8=0 skips);
- eval_shape: N = 200, B = 64 (EVAL_SHAPE);
- train: ms a step of the reverse-KL train step at tools/bench_train.py's
  shape (B = 32, 10 train hypotheses, Adam 1e-4, clip 1.0), 50 steps a
  round, the best of two;
- per_call: the headline step with a device sync after every step (the
  caller that waits for each result), the best of two rounds;
- int8_eval_shape: the int8 path at EVAL_SHAPE, the same calibration;
- serve_b1: B = 1, N = 200, ms a step, the best of two rounds.

A section that raises goes into `skipped` as `<name>_failed` (its error on
stderr); the headline never does. `model_flops` is one step's FLOPs counted
by `torch.utils.flop_counter.FlopCounterMode` on the plain path (the kernels
off, so every convolution and product is a PyTorch op it sees); `mfu` is
that count times the headline's steps a second over PEAK_FLOPS, the H100
SXM's dense bf16 peak. `profile` is `profile_step.step_stats` of three
headline steps: device time by layer, busy share, top operations. Prints one
JSON line with the card's name and power limit. On the CPU (`--device cpu
--tiny`, for the tests) nothing is a device number: mfu and profile are
null.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from mhentropy_tpu_torch import bench_quant, profile_step
from mhentropy_tpu_torch.data import synthetic
from mhentropy_tpu_torch.models import mhent, quant as quant_mod
from mhentropy_tpu_torch.train import engine

TEMP = 0.8
STEPS = 250  # steps a round (bench.py's scan length)
ROUNDS = 3
EVAL_SHAPE = (200, 64)  # N, B
SERVE_B1 = (200, 1)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_HYPO = 32, 50, 10
PEAK_FLOPS = 989e12  # NVIDIA H100 SXM, dense bf16 (data sheet, 700 W)
BASELINE = 20000.0  # BASELINE.json's hypotheses/s target


def build(dev, tiny: bool = False):
    """(MANO model, prepared net): bench.py's model (bench_quant's builder)."""
    return bench_quant.build(dev, tiny=tiny)


def bench_image(net, batch: int, dev, seed: int) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    size = net.cfg.image_size
    return torch.rand((batch, size, size, 3), generator=g, device=dev) * 2 - 1


def make_step(model, net, n: int, batch: int, dev, quant=None, seed: int = 2):
    """step() draws n hypotheses for the bench image offset by a fresh 1e-6,
    with fresh base noise, and reduces every output."""
    image = bench_image(net, batch, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)

    @torch.inference_mode()
    def step():
        img = image + torch.rand((1,), generator=g, device=dev) * 1e-6
        out = mhent.sample_hypotheses(model, net, img, n=n, temp=TEMP, mods=("xyz", "uv"),
                                      generator=g, quant=quant)
        return out["xyz"].sum() + out["uv"].sum()

    return step


@torch.inference_mode()
def quantize(net, batch: int, dev, seed: int = 2) -> tuple:
    """(spec, qtree) of the int8 serving path calibrated on the bench image:
    the encoder at q_from "auto", and the int8 sampler where it applies."""
    image = bench_image(net, batch, dev, seed)
    spec, qtree = quant_mod.quantize_encoder(net.feat_extractor, image)
    if quant_mod.sampler_supported(net.cfg):
        spec, qtree = quant_mod.quantize_sampler_into(spec, qtree, net, image, temp=TEMP)
    return spec, qtree


def make_train_step(model, cfg, batch: int, dev, seed: int = 0):
    """step() runs one reverse-KL train step (tools/bench_train.py: 10 train
    hypotheses, Adam 1e-4, clip 1.0) on a synthetic batch offset by a fresh
    1e-6, with fresh base noise; fresh f32 master weights of `seed`."""
    tcfg = cfg._replace(n_train_hypotheses=TRAIN_HYPO)
    net = mhent.prepare(mhent.init(tcfg, seed=seed), dev, masters=True).train()
    opt = engine.Optimizer(net.parameters(), 1e-4, (), 1)
    data = synthetic.make_dataset(model, n=batch, image_size=cfg.image_size, seed=seed)
    image, target = engine._prep_batch(*next(synthetic.batches(data, batch, device=dev)))
    fn = engine.make_train_step(model, net, opt)
    g = torch.Generator(device=dev).manual_seed(seed + 100)

    def step():
        img = image + torch.rand((1,), generator=g, device=dev) * 1e-6
        noise = torch.randn((TRAIN_HYPO * batch, tcfg.flow.dim), generator=g, device=dev)
        return fn(img, target, noise)["loss"]

    return step


def round_ms(step, steps: int, cuda: bool, sync_each: bool = False) -> float:
    """ms a step over one round of `steps` steps back to back: CUDA events
    around the round on the card (the host clock with sync_each, or on the
    CPU)."""
    if cuda and not sync_each:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
        if cuda:
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def timed_rounds(step, steps: int, rounds: int, cuda: bool, sync_each: bool = False) -> list:
    step()  # warm: cuDNN plans, the kernel library
    if cuda:
        torch.cuda.synchronize()
    return [round_ms(step, steps, cuda, sync_each) for _ in range(rounds)]


def step_flops(net, step) -> int:
    """One step's FLOPs on the plain path, as FlopCounterMode counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    kernels = net.kernels
    net.set_kernels(False)
    try:
        with FlopCounterMode(display=False) as counter:
            step()
    finally:
        net.set_kernels(kernels)
    return counter.get_total_flops()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_hypo", nargs="?", type=int, default=100)
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("--steps", type=int, default=STEPS, help="steps a round")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="small geometry for a CPU run")
    args = ap.parse_args(argv)
    budget_s = float(os.environ.get("MHENT_BENCH_BUDGET_S", "480"))
    t_start = time.monotonic()
    dev = engine.resolve_device(args.device)
    cuda = dev.type == "cuda"
    n, b, steps = args.n_hypo, args.batch, args.steps

    model, net = build(dev, tiny=args.tiny)
    step = make_step(model, net, n, b, dev)
    step()  # builds the kernel library on the card
    setup_s = time.monotonic() - t_start
    ms = timed_rounds(step, steps, ROUNDS, cuda)
    rates = [n * b / m * 1e3 for m in ms]
    rate = max(rates)
    headline_s = time.monotonic() - t_start
    flops = step_flops(net, step)

    skipped = []

    def afford(name, scale=1.0, margin=10.0):
        if budget_s - (time.monotonic() - t_start) > max(5.0, headline_s) * scale + margin:
            return True
        skipped.append(name)
        return False

    def section(name, fn):
        try:
            return fn()
        except Exception as e:  # recorded, never masked as an opt-out
            skipped.append(f"{name}_failed")
            print(f"{name} bench failed: {e!r:.300}", file=sys.stderr)
            return None

    def best_rate(nn, bb, q=None, seed=2):
        return max(nn * bb / m * 1e3
                   for m in timed_rounds(make_step(model, net, nn, bb, dev, q, seed), steps,
                                         ROUNDS, cuda))

    quant, int8_rate, int8_error = None, None, None
    if os.environ.get("MHENT_BENCH_INT8", "1") != "1":
        skipped.append("int8 (disabled)")
    elif afford("int8"):
        try:
            quant = quantize(net, b, dev)
            int8_rate = best_rate(n, b, quant)
        except Exception as e:
            int8_error = repr(e)[:200]
            print(f"int8 bench failed: {int8_error}", file=sys.stderr)
    eval_rate = None
    if (n, b) != EVAL_SHAPE and afford("eval_shape"):
        eval_rate = section("eval_shape", lambda: best_rate(*EVAL_SHAPE, seed=3))
    train_ms = None
    if afford("train", scale=2.0):
        train_ms = section("train", lambda: min(timed_rounds(
            make_train_step(model, net.cfg, TRAIN_BATCH, dev), TRAIN_STEPS, 2, cuda)))
    per_call = None
    if afford("per_call"):
        per_call = section("per_call", lambda: max(
            n * b / m * 1e3 for m in timed_rounds(step, steps, 2, cuda, sync_each=True)))
    int8_eval_rate = None
    if quant is None:
        skipped.append("int8_eval_shape")
    elif (n, b) != EVAL_SHAPE and afford("int8_eval_shape"):
        int8_eval_rate = section("int8_eval_shape",
                                 lambda: best_rate(*EVAL_SHAPE, quant, seed=4))
    serve_b1_ms = None
    if afford("serve_b1"):
        serve_b1_ms = section("serve_b1", lambda: min(timed_rounds(
            make_step(model, net, *SERVE_B1, dev, seed=5), steps, 2, cuda)))

    prof = (section("profile", lambda: profile_step.step_stats(step, n * b / rate * 1e3))
            if cuda else None)
    out = {
        "metric": f"hypotheses/sec/chip (N={n}, B={b}, full pipeline, {steps} steps back to "
                  f"back a round)",
        "value": rate, "unit": "hypos/s", "vs_baseline": rate / BASELINE,
        "rounds": rates, "spread_pct": 100.0 * (max(rates) - min(rates)) / max(rates),
        "model_flops": flops,
        "mfu": flops * rate / (n * b) / PEAK_FLOPS if cuda else None,
        "peak_flops": PEAK_FLOPS, "peak": "NVIDIA H100 SXM dense bf16 (data sheet)",
        "int8_serving": int8_rate, "int8_speedup": int8_rate / rate if int8_rate else None,
        **({"int8_error": int8_error} if int8_error else {}),
        "eval_shape_n200_b64": eval_rate, "int8_eval_shape_n200_b64": int8_eval_rate,
        "train_ms_per_step": train_ms, "per_call": per_call, "serve_b1_ms": serve_b1_ms,
        "skipped": skipped, "compile_s": setup_s, "budget_s": budget_s,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": profile_step.card_line() if cuda else None,
        "profile": prof,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
