"""Profile the port's bench step on the card and print where the device time
goes; the tracing helpers the port's other tools read their device
attribution from.

Port of tools/profile_step.py. `torch.profiler` records the card's kernels
(CUPTI, as `jax.profiler` does on the TPU); `device_events` turns a trace
into (name, start_ns, dur_ns) tuples, and `summarize` gives the JAX tool's
three outputs over them: the device's busy time, the top operations (self
time, count, category) and the idle gaps over 50 us.

    python -m mhentropy_tpu_torch.profile_step [infer|train|quant]

profiles `mhentropy_tpu_torch.bench`'s step (N = 100, B = 32: the float
path, its train step, or the int8 path) and prints the summary, the time
per layer a step (`layer_split`) and one JSON line. The card's name and
power limit come first. It needs a card: a CPU trace has no device events.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
import sys
import time

import torch

GAP_NS = 50_000  # idle stretches reported, as the JAX tool's 50 us
TRACED_STEPS = 5

# Device operations by layer: the first substring found in a kernel's name
# names its layer (PERF.md section 3); the port's kernels by their CUDA names.
LAYERS = (
    ("probe kernels", ("stem_probe_kernel", "bottleneck_probe_kernel", "::gemm_kernel")),
    ("stem kernel", ("stem_kernel", "stem_int8_kernel")),
    ("stage-1 kernel", ("bottleneck_kernel", "bottleneck_q_kernel")),
    ("int8 stage kernel", ("conv_q_kernel", "quantize_kernel")),
    ("flow sampler kernel", ("realnvp_sample", "glow_")),
    ("LBS kernel", ("lbs_blend",)),
    ("BN sums kernel", ("partial_sums_kernel", "finish_kernel")),
    ("convolution (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "sm90_", "splitk")),
    ("reduction", ("reduce", "Reduce", "norm")),
    ("copy / fill", ("Memcpy", "Memset", "copy", "Copy", "fill", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def category(name: str) -> str:
    for layer, keys in LAYERS:
        if any(k in name for k in keys):
            return layer
    return "other"


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profile(fn, n: int = 3):
    """torch.profiler over n calls of fn. One warm-up call runs under the
    profiler's schedule first and is dropped: a trace without it loses the
    first kernels of its first call (the tracer starts late). The device is
    synced before the last step closes the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for i in range(n + 1):
            fn()
            if i == n:
                torch.cuda.synchronize()
            prof.step()
    return prof


def device_events(prof) -> list:
    """[(name, start_ns, dur_ns)] of every device operation in the trace;
    the schedule's step annotations ("ProfilerStep#n", which the trace also
    places on the device's timeline) are not operations and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, int(e.time_range.start * 1e3), int(e.time_range.elapsed_us() * 1e3))
            for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


def summarize(events, top: int = 30) -> dict:
    """Per-name self time (with count and category), the busy envelope and
    the idle gaps over GAP_NS, as the JAX tool's `summarize` (:59)."""
    agg = collections.defaultdict(lambda: [0, 0])
    for name, _, dur in events:
        agg[name][0] += dur
        agg[name][1] += 1
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    merged = []
    for s, e in sorted((s, s + d) for _, s, d in events if d > 0):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(e0, s1 - e0) for (_, e0), (s1, _) in zip(merged, merged[1:]) if s1 - e0 > GAP_NS]
    return {"total_self_ns": sum(v[0] for v in agg.values()),
            "span_ns": merged[-1][1] - merged[0][0] if merged else 0,
            "busy_ns": sum(e - s for s, e in merged),
            "rows": [(n, v[0], v[1], category(n)) for n, v in rows],
            "gaps": gaps}


def layer_split(events, n: int) -> dict:
    """Device ms a step by layer (`LAYERS`), over a trace of n steps."""
    out = collections.defaultdict(float)
    for name, _, dur in events:
        out[category(name)] += dur / 1e6 / n
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def print_summary(label: str, s: dict) -> None:
    print(f"== {label} ==")
    print(f"span {s['span_ns'] / 1e6:.3f} ms | busy {s['busy_ns'] / 1e6:.3f} ms "
          f"({100 * s['busy_ns'] / max(1, s['span_ns']):.1f}%) | "
          f"self-time sum {s['total_self_ns'] / 1e6:.3f} ms")
    print(f"{'self ms':>10} {'n':>6}  {'category':<20} op")
    for name, ns, cnt, cat in s["rows"]:
        print(f"{ns / 1e6:>10.3f} {cnt:>6}  {cat:<20} {name[:100]}")
    if s["gaps"]:
        print(f"idle gaps > 50us: {len(s['gaps'])}, "
              f"total {sum(g for _, g in s['gaps']) / 1e6:.3f} ms, "
              f"largest {max(g for _, g in s['gaps']) / 1e6:.3f} ms")
    sys.stdout.flush()


def step_stats(fn, untraced_ms: float, n: int = 3, top: int = 15) -> dict:
    """A trace of n calls of fn: device time and operations a call, the busy
    share against the untraced call time, the device time by layer and the
    top operations (self time, calls, category)."""
    events = device_events(profile(fn, n))
    s = summarize(events, top)
    dev_ms = s["total_self_ns"] / 1e6 / n
    return {"device_ms_per_step": dev_ms, "device_ops_per_step": len(events) / n,
            "busy_share": dev_ms / untraced_ms, "layer_ms_per_step": layer_split(events, n),
            "idle_gaps_over_50us_per_step": len(s["gaps"]) / n,
            "top_ops": [{"name": name[:90], "ms_per_step": ns / 1e6 / n, "calls_per_step": cnt / n,
                         "category": cat} for name, ns, cnt, cat in s["rows"]]}


def cuda_ms(fn, seconds: float = 0.25) -> float:
    """Mean ms a call, by CUDA events, over a window of about `seconds` (the
    call count set from three warm calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    iters = max(10, math.ceil(seconds * 3 / (time.perf_counter() - t0)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graphed(fn):
    """One call of fn captured as a CUDA graph; its replay runs the same
    device work without the host's launch gaps between operations."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def untraced_ms(fn, n: int = 10) -> float:
    """Host wall ms a call over n calls, ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main(argv=None) -> dict:
    from mhentropy_tpu_torch import bench

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", nargs="?", default="infer", choices=("infer", "train", "quant"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    model, net = bench.build(dev)
    if args.mode == "train":
        step = bench.make_train_step(model, net.cfg, 32, dev)
    else:
        quant = bench.quantize(net, 32, dev) if args.mode == "quant" else None
        step = bench.make_step(model, net, 100, 32, dev, quant=quant)
    wall = untraced_ms(step)
    events = device_events(profile(step, TRACED_STEPS))
    s = summarize(events)
    print_summary(f"{args.mode}: {TRACED_STEPS} steps, {wall:.3f} ms a step untraced [{card}]", s)
    out = {"mode": args.mode, "card": card, "untraced_ms_per_step": wall,
           "device_ms_per_step": s["total_self_ns"] / 1e6 / TRACED_STEPS,
           "busy_ms_per_step": s["busy_ns"] / 1e6 / TRACED_STEPS,
           "device_ops_per_step": len(events) / TRACED_STEPS,
           "layer_ms_per_step": layer_split(events, TRACED_STEPS),
           "idle_gaps_over_50us": len(s["gaps"])}
    out["busy_share"] = out["device_ms_per_step"] / wall
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
