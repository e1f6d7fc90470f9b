"""Where a served request's time goes, on one CUDA card.

    python -m mhentropy_tpu_torch.profile_serve [--cfg configs/ho3d.yaml]
        [--batches 8 1] [--reps 50] [--traced 20] [--quantize]

For each batch size it serves a warmed-up InferenceServer (fresh seeded
weights, synthetic MANO when there are no assets; with --quantize the
buckets of 8 and more run the int8 encoder and sampler) and prints

- the stages' wall times, each closed by a device sync: encoder, flow draw
  with the det head, MANO decode, copy to the host (mean over --reps);
- the untraced request time through `predict` (mean over --reps);
- from torch.profiler over --traced requests: device kernel time and device
  operations per request, the device's busy share (device time over the
  untraced request time), then the top device operations.

The last line is one JSON object with these numbers. The card's name and
power limit (nvidia-smi) come first.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mhentropy_tpu_torch import profile_step, serve
from mhentropy_tpu_torch.models import mhent, quant
from mhentropy_tpu_torch.utils.config import load_cfg


def stage_walls(server: serve.InferenceServer, images: np.ndarray, reps: int) -> dict:
    net, cfg, dev = server.net, server.model_cfg, server.device
    scale, bias = server.image_norm
    x = torch.from_numpy(images).to(dev).float() * scale + bias
    int8 = server._quantized_bucket(images.shape[0])
    spec, qtree = server._quant if int8 else (None, None)
    flow_q = qtree.get("flow") if int8 and spec.int8_sampler else None
    walls = {"encoder": 0.0, "flow_and_det": 0.0, "decode": 0.0, "to_host": 0.0}
    with torch.inference_mode():
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            feat = (quant.encoder_feat(spec, qtree, net.feat_extractor, x) if int8
                    else mhent.extract_feat(net, x))
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            z, _ = mhent.sample_q_z(net, feat, server.n_hypo, temp=server.temp,
                                    generator=server._gen, flow_q=flow_q)
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            dec = mhent.decode(server.model, cfg, z[:, :mhent.TH_BT], z[:, -3:],
                               mods=("xyz", "uv"), inv_norm=True, fold=server.fold)
            torch.cuda.synchronize(dev)
            t3 = time.perf_counter()
            dec["xyz"].cpu(), dec["uv"].cpu()
            t4 = time.perf_counter()
            for k, (a, b) in zip(walls, ((t0, t1), (t1, t2), (t2, t3), (t3, t4))):
                walls[k] += (b - a) * 1e3 / reps
    return walls


def trace(server: serve.InferenceServer, images: np.ndarray, n: int, reps: int):
    """Device time and operations per request from a trace of n requests
    (profile_step.step_stats); the busy share divides the device time by the
    untraced request time (mean of `reps` requests), since tracing slows the
    host."""
    t0 = time.perf_counter()
    for _ in range(reps):
        server.predict(images)
    wall = (time.perf_counter() - t0) * 1e3 / reps
    stats = profile_step.step_stats(lambda: server.predict(images), wall, n, top=25)
    summary = {"request_ms": wall, "device_ms": stats["device_ms_per_step"],
               "device_ops": stats["device_ops_per_step"], "busy_share": stats["busy_share"],
               "layer_ms": stats["layer_ms_per_step"]}
    table = "\n".join(f"{op['ms_per_step']:10.4f} ms {op['calls_per_step']:8.1f}x  "
                      f"{op['category']:<20} {op['name']}" for op in stats["top_ops"])
    return summary, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", default="configs/ho3d.yaml")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--traced", type=int, default=20)
    ap.add_argument("--quantize", action="store_true", help="int8 serving")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA card")
    card = profile_step.card_line()
    print(f"card: {card}", flush=True)
    server = serve.InferenceServer(load_cfg(args.cfg), max_batch=args.max_batch,
                                   quantize=args.quantize, device="cuda", transports=("u8",))
    server.warmup()
    rng = np.random.RandomState(0)
    result = {"card": card, "quantize": args.quantize}
    for b in args.batches:
        size = server.image_size
        images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
        for _ in range(3):
            server.predict(images)
        walls = stage_walls(server, images, args.reps)
        summary, table = trace(server, images, args.traced, args.reps)
        print(f"B={b} stage walls, synced, mean of {args.reps} (ms): {json.dumps(walls)}")
        print(f"B={b} traced over {args.traced} requests: {json.dumps(summary)}")
        print(table, flush=True)
        result[f"b{b}"] = {"stage_walls_ms": walls, **summary}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
