"""Full-pipeline A/B of the int8 W8A8 encoder against the bf16 path, on the
card.

Port of tools/bench_quant.py: resnet50 at 256 px -> RealNVP(45, cond 512,
H 512, 6 steps) draw -> synthetic MANO decode (xyz, uv), N hypotheses per
image at B images a step, every output reduced.

    python -m mhentropy_tpu_torch.bench_quant [n_hypo] [batch] [steps] [q_from] [mid|sampler]
    python -m mhentropy_tpu_torch.bench_quant 4 1 3 1 mid --device cpu --tiny

Sides: `bf16` (the float path: stem, stage-1 and sampler kernels, cuDNN
stages 2-4), `int8` (models/quant.py at q_from: stages 2-4 on
`torch._int_mm`, stage 1 the int8 stage-1 kernel at q_from = 0), and with
the fifth argument `mid` the int8 side with the fused stage-2/3 kernel
(`QuantSpec.pallas_mid=True`), or with `sampler` the int8 side whose draw
runs the int8 sampler. Each step draws for the next batch of a pool of
four. Timing: CUDA events around windows of `steps` whole steps after
warmup, the sides in alternating windows (reversed on odd ones); prints one
JSON line per side with hypotheses/s and ms per step (median of the
windows, with their spread), its speed against the bf16 side, and the
card's name. The int8 stem has no switch here, as in the JAX tool: it is
`QuantSpec(int8_stem=True)` (`quantize(..., int8_stem=True)` below).
"""

from __future__ import annotations

import argparse
import json

import torch

from mhentropy_tpu_torch import bench_prohmr
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent, quant
from mhentropy_tpu_torch.models.encoder import EncoderConfig

POOL = 4  # image batches a step cycles through
TEMP = 0.8


def build(dev, tiny: bool = False):
    """(MANO model, prepared net): the JAX tool's model with seeded weights,
    or a small geometry for a CPU run."""
    if tiny:
        cfg = mhent.MHEntConfig(
            encoder=EncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32"),
            flow=RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=1), feat_dim=32,
            image_size=64)
    else:
        cfg = mhent.MHEntConfig(
            encoder=EncoderConfig(backbone="resnet50", n_latent=(512, 512)),
            flow=RealNVPConfig(dim=45, cond_dim=512, h_dim=512, num_steps=6), feat_dim=512,
            image_size=256)
    net = mhent.prepare(mhent.init(cfg, seed=0), dev)
    return mano.synthetic_mano_model(0, device=dev), net


def images_pool(net, batch: int, dev, seed: int = 2) -> list:
    g = torch.Generator(device=dev).manual_seed(seed)
    size = net.cfg.image_size
    return [torch.rand((batch, size, size, 3), generator=g, device=dev) * 2 - 1
            for _ in range(POOL)]


@torch.inference_mode()
def quantize(net, images: torch.Tensor, q_from: int, **switches) -> tuple:
    """(spec, qtree) of the encoder calibrated on `images`, with QuantSpec's
    kernel switches (pallas_mid, int8_stem) as given."""
    cfg = net.feat_extractor.cfg
    spec = quant.QuantSpec(backbone=cfg.backbone, dtype=cfg.dtype, q_from=q_from, **switches)
    res = net.feat_extractor.res
    return spec, quant.prepare(spec, res, quant.calibrate(spec, res, images))


def make_sides(net, images: list, q_from: int, extra: str | None = None) -> dict:
    """{side: None (bf16) or (spec, qtree)}: bf16, int8, and int8_mid or
    int8_sampler as `extra` asks."""
    spec, qtree = quantize(net, images[0], q_from)
    sides = {"bf16": None, "int8": (spec, qtree)}
    if extra == "mid":
        mid = spec._replace(pallas_mid=True)
        sides["int8_mid"] = (mid, quant.finish(dict(qtree), mid))
    elif extra == "sampler":
        with torch.inference_mode():
            sides["int8_sampler"] = quant.quantize_sampler_into(spec, qtree, net, images[0],
                                                                temp=TEMP)
    return sides


def make_steps(model, net, images: list, n: int, sides: dict, seed: int = 3) -> dict:
    """{side: step()}: each call draws n hypotheses for the next batch of the
    pool and reduces every output, as the JAX tool's scan body does."""
    g = torch.Generator(device=images[0].device).manual_seed(seed)
    count = [0]

    def step(q):
        image = images[count[0] % POOL]
        count[0] += 1
        with torch.inference_mode():
            out = mhent.sample_hypotheses(model, net, image, n=n, temp=TEMP,
                                          mods=("xyz", "uv"), generator=g, quant=q)
            return out["xyz"].sum() + out["uv"].sum()

    return {side: (lambda q=q: step(q)) for side, q in sides.items()}


def run(steps: dict, n_steps: int, cuda: bool, batch: int, n: int) -> dict:
    """bench_prohmr's timing: the sides in alternating windows (reversed on
    odd ones) of `n_steps` steps after two warm steps each, by CUDA events
    on the card; {side: median ms a step, the windows' spread,
    hypotheses/s, and its speed against the bf16 side}."""
    runs = bench_prohmr.alternate(steps, cuda, seconds=0.0, min_steps=n_steps)
    out = bench_prohmr.summary(runs, batch, n)
    if "bf16" in out:
        for r in out.values():
            r["vs_bf16"] = r["hypotheses_per_s"] / out["bf16"]["hypotheses_per_s"]
    return out


def main(argv=None) -> dict:
    from mhentropy_tpu_torch.train.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_hypo", nargs="?", type=int, default=100)
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("steps", nargs="?", type=int, default=250, help="steps a window")
    ap.add_argument("q_from", nargs="?", type=int, default=1)
    ap.add_argument("extra", nargs="?", choices=("mid", "sampler"), default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="small geometry for a CPU run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model, net = build(dev, tiny=args.tiny)
    images = images_pool(net, args.batch, dev)
    sides = make_sides(net, images, args.q_from, args.extra)
    res = run(make_steps(model, net, images, args.n_hypo, sides), args.steps,
              dev.type == "cuda", args.batch, args.n_hypo)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for s, r in res.items():
        print(json.dumps({"metric": f"full pipeline, {s} (N={args.n_hypo}, B={args.batch}, "
                                    f"q_from={args.q_from})",
                          "value": r["hypotheses_per_s"], "unit": "hypotheses/s", **r,
                          "device": device}), flush=True)
    return res


if __name__ == "__main__":
    main()
