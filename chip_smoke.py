#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mhentropy_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit).
2. Builds the CUDA kernels from mhentropy_tpu_torch/csrc/ (nvcc, sm_90a).
3. Runs each kernel against its plain PyTorch version on the card at the
   serving shapes (stem (8, 256, 256, 3); stage 1 (8, 64, 64, 64); sampler
   B=8, N=200, L=12, H=512) with random weights of realistic magnitude, checks
   the max-abs error against the stated bf16 tolerance and times both with
   CUDA events: RUNS windows of at least KERNEL_WINDOW_S seconds each, kernel
   and plain alternating; the median and the spread are reported. Each is
   timed as called (ms, plain_ms) and as a CUDA-graph replay (graph_ms,
   plain_graph_ms), which leaves out the host's launch gaps: the plain
   versions issue several operations per call.
4. Serves configs/ho3d.yaml (resnet50 at 256 px, 12x512 RealNVP, N=200,
   fresh seeded weights, synthetic MANO) through InferenceServer and its HTTP
   front end: GET /healthz and POST /predict at B=1 u8, B=3 f32, B=8 u8, with
   every kernel's launch count reset before and read after. Then the B=8 and
   B=1 request latencies through predict are timed over RUNS windows of at
   least SLICE_WINDOW_S seconds each. Last, the served flow's weights are
   drawn at the torch-default O(1) scale and the kernel path and the plain
   path serve one batch with the same base noise and must agree.
5. Prints the kernels' JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero. It refuses to run
without a CUDA device; it never falls back to the CPU or to a plain path.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

N_HYPO = 200
BATCH = 8
# Kernel vs plain on the same bf16 inputs and bf16 weights, the plain one in
# f32: the kernel rounds its activations to bf16 (2^-9 relative) between
# products, so the max-abs error is held to a share of the output's range.
TOL = {"stem": 2e-2, "stage1": 3e-2, "sampler": 1e-2}
# Whole slice, kernel path vs plain path on one batch with the same base
# noise and the flow at O(1) weights: xyz is bone-normalised (largest value
# about 3), uv in pixels. On an H100 the two paths differed by 0.0138 (xyz)
# and 1.72 px (uv); the bounds are about three times that.
SLICE_TOL = {"xyz": 4e-2, "uv": 5.0}
# Timing: RUNS windows per version, each at least this many seconds long.
RUNS = 5
KERNEL_WINDOW_S = 1.0
SLICE_WINDOW_S = 3.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def spread(xs: list[float]) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "runs": len(xs)}


def cuda_ms(torch, fn, seconds: float = KERNEL_WINDOW_S) -> float:
    """Mean ms per call, by CUDA events, over a window of about `seconds`
    (the call count is set from three warm calls)."""
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


# The timings ab_ms takes of each kernel and its plain version.
TIMES = ("ms", "plain_ms", "graph_ms", "plain_graph_ms")


def graphed(torch, fn):
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


def ab_ms(torch, kernel_fn, plain_fn) -> dict:
    """Spreads of RUNS windows each of kernel and plain, called eagerly (ms,
    plain_ms) and as CUDA-graph replays (graph_ms, plain_graph_ms), in
    alternating order (plain first on even runs, kernel first on odd ones)."""
    fns = dict(zip(TIMES, (kernel_fn, plain_fn, graphed(torch, kernel_fn),
                           graphed(torch, plain_fn))))
    times = {k: [] for k in TIMES}
    for r in range(RUNS):
        for pair in (("plain_ms", "ms"), ("plain_graph_ms", "graph_ms")):
            for k in (pair if r % 2 == 0 else pair[::-1]):
                times[k].append(cuda_ms(torch, fns[k]))
    return {k: spread(v) for k, v in times.items()}


def rand_bn(torch, bn, g) -> None:
    n = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
        bn.bias.copy_(0.1 * torch.randn(n, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(n, generator=g))
        bn.running_var.copy_(1.0 + 0.5 * torch.rand(n, generator=g))


def he_(torch, w, g) -> None:
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=g) * math.sqrt(2.0 / w[0].numel()))


def phase_stem(torch, dev):
    from mhentropy_tpu_torch.models import stem_cuda

    g = torch.Generator().manual_seed(1)
    conv_w = torch.empty(64, 3, 7, 7)
    he_(torch, conv_w, g)
    bn = torch.nn.BatchNorm2d(64)
    rand_bn(torch, bn, g)
    image = torch.randn((BATCH, 256, 256, 3), generator=g).to(dev, torch.bfloat16)
    w, b = stem_cuda.fold(conv_w, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    w, b = w.to(dev), b.to(dev)
    out = stem_cuda.stem_forward(image, w, b)
    torch.cuda.synchronize()
    ref = stem_cuda.stem_plain(image.float(), w.float(), b)
    check(out.shape == (BATCH, 64, 64, 64), f"stem: shape {tuple(out.shape)}")
    err = (out.float() - ref).abs().max().item()
    bound = TOL["stem"] * max(1.0, ref.abs().max().item())
    check(err <= bound, f"stem: max-abs error {err} > {bound}")
    times = ab_ms(torch, lambda: stem_cuda.stem_forward(image, w, b),
                  lambda: stem_cuda.stem_plain(image, w, b))
    return {"name": "stem", "source": "mhentropy_tpu_torch/csrc/stem.cu",
            "replaces": "mhentropy_tpu/models/stem_pallas.py:120",
            "max_abs_err": err, "tol": bound, **times}


def phase_stage1(torch, dev):
    from mhentropy_tpu_torch.models import resnet, stage1_cuda

    g = torch.Generator().manual_seed(2)
    layer1 = torch.nn.Sequential(resnet.Bottleneck(64, 64), resnet.Bottleneck(256, 64),
                                 resnet.Bottleneck(256, 64))
    for m in layer1.modules():
        if isinstance(m, torch.nn.Conv2d):
            he_(torch, m.weight, g)
        elif isinstance(m, torch.nn.BatchNorm2d):
            rand_bn(torch, m, g)
    folded = [stage1_cuda.FoldedBlock(*(None if t is None else t.to(dev) for t in blk))
              for blk in stage1_cuda.fold(layer1)]
    x = torch.relu(torch.randn((BATCH, 64, 64, 64), generator=g)).to(dev, torch.bfloat16)
    out = stage1_cuda.stage1_forward(x, folded)
    torch.cuda.synchronize()
    ref = stage1_cuda.stage1_plain(x.float(), folded)
    check(out.shape == (BATCH, 64, 64, 256), f"stage 1: shape {tuple(out.shape)}")
    err = (out.float() - ref).abs().max().item()
    bound = TOL["stage1"] * max(1.0, ref.abs().max().item())
    check(err <= bound, f"stage 1: max-abs error {err} > {bound}")
    times = ab_ms(torch, lambda: stage1_cuda.stage1_forward(x, folded),
                  lambda: stage1_cuda.stage1_plain(x, folded))
    return {"name": "stage1", "source": "mhentropy_tpu_torch/csrc/stage1.cu",
            "replaces": "mhentropy_tpu/models/stage1_pallas.py:160",
            "max_abs_err": err, "tol": bound, **times}


def phase_sampler(torch, dev):
    from mhentropy_tpu_torch.flows import cuda_sampler, realnvp

    torch.manual_seed(3)  # torch-default Linear init: the reference's own
    cfg = realnvp.RealNVPConfig(dim=45, cond_dim=512, h_dim=512, num_steps=6)
    flow = realnvp.RealNVP(cfg).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    feat = torch.randn((BATCH, 512), generator=g, device=dev)
    z0 = torch.randn((BATCH, N_HYPO, 45), generator=g, device=dev) * 0.8
    with torch.inference_mode():
        cproj = realnvp.cond_cache(flow, feat).contiguous()
        packed = cuda_sampler.pack(flow)  # bf16 weights, as the kernel runs
        packed_f32 = cuda_sampler.pack(flow, dtype=torch.float32)
        x, ld = cuda_sampler.transform(packed, z0, cproj)
        torch.cuda.synchronize()
        x_ref, ld_ref = cuda_sampler.transform_plain(packed, z0, cproj)
        check(x.shape == (BATCH, N_HYPO, 45) and ld.shape == (BATCH, N_HYPO),
              f"sampler: shapes {tuple(x.shape)} {tuple(ld.shape)}")
        err_x = (x - x_ref).abs().max().item()
        err_ld = (ld - ld_ref).abs().max().item()
        bound_x = TOL["sampler"] * max(1.0, x_ref.abs().max().item())
        bound_ld = TOL["sampler"] * max(1.0, ld_ref.abs().max().item())
        check(err_x <= bound_x, f"sampler: x max-abs error {err_x} > {bound_x}")
        check(err_ld <= bound_ld, f"sampler: logdet max-abs error {err_ld} > {bound_ld}")
        times = ab_ms(torch, lambda: cuda_sampler.transform(packed, z0, cproj),
                      lambda: cuda_sampler.transform_plain(packed_f32, z0, cproj))
    return {"name": "realnvp_sampler", "source": "mhentropy_tpu_torch/csrc/realnvp_sampler.cu",
            "replaces": "mhentropy_tpu/flows/pallas_sampler.py:191",
            "max_abs_err": max(err_x, err_ld), "max_abs_err_x": err_x,
            "max_abs_err_logdet": err_ld, "tol": bound_x, **times}


def http(url: str, body: bytes | None = None, headers: dict | None = None):
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def phase_slice(torch, dev):
    from mhentropy_tpu_torch import serve
    from mhentropy_tpu_torch.flows import cuda_sampler
    from mhentropy_tpu_torch.models import mhent, stage1_cuda, stem_cuda
    from mhentropy_tpu_torch.utils.config import load_cfg

    kernels = {"stem": stem_cuda, "stage1": stage1_cuda, "realnvp_sampler": cuda_sampler}
    cfg = load_cfg("configs/ho3d.yaml")
    t0 = time.perf_counter()
    server = serve.InferenceServer(cfg, max_batch=BATCH, device=dev, seed=0)
    check(server.n_hypo == N_HYPO and server.image_size == 256,
          f"slice: n_hypo {server.n_hypo}, image_size {server.image_size}")
    print(f"slice: server built in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.RandomState(0)
    size = server.image_size
    requests = [(1, "uint8"), (3, "float32"), (BATCH, "uint8"), (BATCH, "uint8")]
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    warm = threading.Event()
    errors = []

    def serve_thread():
        # Warm up in the thread that serves, as serve.main does: cuDNN's plan
        # cache and the cuBLAS handle are per thread.
        try:
            server.warmup()
        except Exception as e:  # re-raised by the main thread
            errors.append(e)
            return
        finally:
            warm.set()
        httpd.serve_forever()

    thread = threading.Thread(target=serve_thread, daemon=True)
    thread.start()
    try:
        check(warm.wait(timeout=600), "slice: warmup did not finish")
        if errors:
            raise errors[0]
        print(f"slice: warmed up after {time.perf_counter() - t0:.1f} s", flush=True)
        for mod in kernels.values():
            mod.launches = 0
        status, health = http(base + "/healthz")
        check(status == 200 and health.get("ok") is True and health["n_hypo"] == N_HYPO,
              f"slice: /healthz {status} {health}")
        http_ms = []
        for b, dt in requests:
            raw = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
            images = raw if dt == "uint8" else raw.astype(np.float32) * (2 / 255) - 1
            t1 = time.perf_counter()
            status, out = http(base + "/predict", images.tobytes(),
                               {"X-Batch": str(b), "X-Dtype": dt})
            http_ms.append((time.perf_counter() - t1) * 1e3)
            xyz, uv = np.asarray(out["xyz"]), np.asarray(out["uv"])
            check(status == 200, f"slice: /predict B={b} {dt}: HTTP {status}")
            check(xyz.shape == (b, N_HYPO, 21, 3) and uv.shape == (b, N_HYPO, 21, 2),
                  f"slice: /predict B={b} {dt}: shapes {xyz.shape} {uv.shape}")
            check(np.isfinite(xyz).all() and np.isfinite(uv).all(),
                  f"slice: /predict B={b} {dt}: non-finite outputs")
            print(f"slice: POST /predict B={b} {dt}: HTTP {status}, server "
                  f"{out['ms']:.3f} ms, round trip {http_ms[-1]:.3f} ms", flush=True)
        launches = {name: mod.launches for name, mod in kernels.items()}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    for name, n in launches.items():
        check(n > 0, f"slice: kernel {name} was not launched on the main path")
    print(f"slice: launches during the requests: {launches}", flush=True)

    # Request latency through predict (host to host), steady state: RUNS
    # windows of SLICE_WINDOW_S seconds at each batch size.
    timing = {}
    for b in (BATCH, 1):
        imgs = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
        server.predict(imgs)
        runs, n_requests = [], 0
        for _ in range(RUNS):
            count, t1 = 0, time.perf_counter()
            while time.perf_counter() - t1 < SLICE_WINDOW_S:
                server.predict(imgs)
                count += 1
            runs.append((time.perf_counter() - t1) * 1e3 / count)
            n_requests += count
        ms = spread(runs)
        timing[f"b{b}"] = {"ms_per_request": ms, "requests": n_requests,
                           "hypotheses_per_s": b * N_HYPO / ms["median"] * 1e3}

    # Kernel path vs plain path on one batch, same base noise. The served
    # flow's linears are first drawn at the torch-default O(1) scale: under
    # the near-identity init x stays close to z0, and the comparison would
    # hardly test the sampler along this path.
    torch.manual_seed(7)
    for m in server.net.q_z_giv_i.modules():
        if isinstance(m, torch.nn.Linear):
            m.reset_parameters()
    mhent.prepare(server.net, dev)
    images = rng.randint(0, 256, (BATCH, size, size, 3)).astype(np.uint8)
    g = torch.Generator(device=dev).manual_seed(7)
    noise = torch.randn((N_HYPO * BATCH, 45), generator=g, device=dev) * server.temp
    kern = server.predict(images, base_noise=noise)
    server.net.set_kernels(False)
    plain = server.predict(images, base_noise=noise)
    server.net.set_kernels(True)
    for k in ("xyz", "uv"):
        check(np.isfinite(kern[k]).all() and np.isfinite(plain[k]).all(),
              f"slice: non-finite {k} under the O(1) flow")
    agree = {k: float(np.abs(kern[k] - plain[k]).max()) for k in ("xyz", "uv")}
    scale = {k: float(np.abs(plain[k]).max()) for k in ("xyz", "uv")}
    print(f"slice: kernel vs plain path, max-abs difference {agree} (tolerance {SLICE_TOL}; "
          f"largest plain value {scale})", flush=True)
    for k, v in agree.items():
        check(v <= SLICE_TOL[k], f"slice: kernel and plain paths differ in {k} by {v}")
    return launches, agree, http_ms, timing


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    from mhentropy_tpu_torch import ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {name}",
          flush=True)
    print("TF32 off for f32 matmuls and convolutions (the f32 references)", flush=True)

    t0 = time.perf_counter()
    lib = ext.load()
    print(f"build: {lib.path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"build: {line.strip()}", flush=True)

    results = []
    for phase in (phase_stem, phase_stage1, phase_sampler):
        r = phase(torch, dev)
        results.append(r)
        print(f"kernel {r['name']}: max-abs error {r['max_abs_err']:.6g} (tol {r['tol']:.6g}); "
              f"median [min, max] of {RUNS} windows of >= {KERNEL_WINDOW_S} s [{card}]:",
              flush=True)
        for key in TIMES:
            t = r[key]
            print(f"  {key}: {t['median']:.4f} [{t['min']:.4f}, {t['max']:.4f}]", flush=True)

    launches, agree, http_ms, timing = phase_slice(torch, dev)
    for b, t in timing.items():
        ms = t["ms_per_request"]
        print(f"slice {b}: median {ms['median']:.3f} ms/request [{ms['min']:.3f}, "
              f"{ms['max']:.3f}] over {t['requests']} requests in {RUNS} windows, "
              f"{t['hypotheses_per_s']:.1f} hypotheses/s [{card}]", flush=True)

    kernels = [{"name": r["name"], "route": "cuda", "source": r["source"],
                "replaces": r["replaces"], "launches": launches[r["name"]],
                "max_abs_err": r["max_abs_err"],
                **{key: r[key]["median"] for key in TIMES},
                **{f"{key}_min_max": [r[key]["min"], r[key]["max"]] for key in TIMES}}
               for r in results]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"slice": {"timing": timing, "http_round_trip_ms": http_ms,
                                "kernel_vs_plain_max_abs": agree}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
