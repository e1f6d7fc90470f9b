"""Learning demo: train MHEnt on the synthetic fixture and report the
best-hypothesis MPJPE before and after, evidence that the entropy-augmented
reverse-KL objective optimises end to end.

Port of tools/train_synthetic_demo.py (its sizes, schedule, metrics and
lines): 256 synthetic training items at B = 32, 64 eval items, N = 100
hypotheses at temperature 0.8, Adam with one milestone at 80 % of the
epochs. After training, the W8A8 eval of the trained model (the int8
encoder, then with the int8 sampler where `quant.sampler_supported` says
so) and its BH-MPJPE delta against float, on the same split and noise.

    python -m mhentropy_tpu_torch.train_synthetic_demo [epochs] [lr] [backbone] [img]
        [--device cpu]

(e.g. `30 2e-4 resnet50 256` runs the int8 check at the shipped serving
geometry). Runs on the card unless --device says otherwise. Exits 0 when
BH-MPJPE fell, else 1.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.data import synthetic
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent, quant
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.models.mhent import MHEntConfig
from mhentropy_tpu_torch.train import engine

BATCH, N_TRAIN, N_EVAL, N_HYPO, TEMP = 32, 256, 64, 100, 0.8


def demo_config(backbone: str, img: int) -> MHEntConfig:
    """tools/train_synthetic_demo.py's model: the serving geometry for
    resnet50 (512-wide feature, 6-step RealNVP of H = 512, bf16), a smaller
    one otherwise (128, 4 steps of H = 256, f32)."""
    big = backbone == "resnet50"
    width = 512 if big else 128
    return MHEntConfig(
        encoder=EncoderConfig(backbone=backbone, n_latent=(width, width),
                              dtype="bfloat16" if big else "float32"),
        flow=RealNVPConfig(dim=45, cond_dim=width, h_dim=512 if big else 256,
                           num_steps=6 if big else 4),
        feat_dim=width, image_size=img, n_train_hypotheses=10, b_2d=0.03)


def _staged(data, dev) -> list:
    """Every batch on the device once, in order."""
    return list(synthetic.batches(data, BATCH, device=dev))


def report(tag: str, m: dict) -> None:
    print(f"{tag}: BH-MPJPE {m['eucLoss_3d_rgb_sample'] * 1000:.2f} mm  "
          f"2D-vis WH {m['eucLoss_2d_rgb_vis']:.2f} px  "
          f"2D-vis mean {m['eucLoss_2d_rgb_vis_mean']:.2f} px  "
          f"3D-occ PJD {m['eucLoss_3d_rgb_invis_std'] * 1000:.2f} mm", flush=True)


def main(epochs: int = 30, lr: float = 2e-4, backbone: str = "resnet18", img: int = 64,
         device=None) -> dict:
    """Train and evaluate; returns {"before", "after", "after_int8"[,
    "after_int8_sampler"]} metric dicts and "improved"."""
    dev = engine.resolve_device(device)
    cfg = demo_config(backbone, img)
    model = mano.synthetic_mano_model(0, device=dev)
    fold = mano.fold_keypoints(model)
    net = mhent.prepare(mhent.init(cfg, seed=0), dev, masters=True)
    optimizer = engine.make_optimizer(net, lr, [int(epochs * 0.8)], N_TRAIN // BATCH)
    train = _staged(synthetic.make_dataset(model, n=N_TRAIN, image_size=img, seed=0,
                                           occlusion_rate=0.3), dev)
    evald = _staged(synthetic.make_dataset(model, n=N_EVAL, image_size=img, seed=1,
                                           occlusion_rate=0.3), dev)
    step = engine.make_train_step(model, net, optimizer, fold=fold)

    def evaluate(quant_spec=None, qtree=None) -> dict:
        """The eval split at N_HYPO hypotheses, the same noise every call."""
        net.eval()
        mhent.refresh_kernel_weights(net)
        eval_step = engine.make_eval_step(model, net, N_HYPO, TEMP, quant_spec=quant_spec,
                                          fold=fold)
        g = torch.Generator(device=dev).manual_seed(9)
        mets = []
        for image, target in evald:
            b = image.shape[0]
            kld = torch.randn((cfg.n_train_hypotheses * b, 45), generator=g, device=dev)
            hypo = torch.randn((N_HYPO * b, 45), generator=g, device=dev) * TEMP
            mets.append(eval_step(image, target, kld, hypo, qtree))
        host = {k: torch.stack([m[k].float() for m in mets]).tolist() for k in mets[0]}
        return {k: float(np.mean(v)) for k, v in host.items()}

    out = {"before": evaluate()}
    report("before", out["before"])
    g = torch.Generator(device=dev).manual_seed(42)
    t0 = time.perf_counter()
    for epoch in range(epochs):
        net.train()
        for image, target in train:
            aux = step(image, target, torch.randn((cfg.n_train_hypotheses * image.shape[0], 45),
                                                  generator=g, device=dev))
        if epoch % 10 == 0 or epoch == epochs - 1:
            print(f"epoch {epoch}: loss {aux['loss'].item():.1f} h_q {aux['h_q'].item():.1f}",
                  flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"trained {epochs} epochs in {time.perf_counter() - t0:.0f}s", flush=True)
    out["after"] = evaluate()
    report("after", out["after"])

    # The int8 W8A8 eval of the trained model: BH-MPJPE against float on the
    # same split and noise.
    calib = evald[0][0]
    with torch.inference_mode():
        spec, qtree = quant.quantize_encoder(net.feat_extractor, calib)
    out["after_int8"] = evaluate(spec, qtree)
    report("after-int8", out["after_int8"])
    delta = (out["after_int8"]["eucLoss_3d_rgb_sample"]
             - out["after"]["eucLoss_3d_rgb_sample"]) * 1000
    print(f"int8 BH-MPJPE delta {delta:+.3f} mm", flush=True)
    if quant.sampler_supported(cfg):
        with torch.inference_mode():
            spec_s, qtree_s = quant.quantize_sampler_into(spec, qtree, net, calib, temp=TEMP)
        out["after_int8_sampler"] = evaluate(spec_s, qtree_s)
        report("after-int8+sampler", out["after_int8_sampler"])
        delta_s = (out["after_int8_sampler"]["eucLoss_3d_rgb_sample"]
                   - out["after"]["eucLoss_3d_rgb_sample"]) * 1000
        print(f"int8+sampler BH-MPJPE delta {delta_s:+.3f} mm", flush=True)

    drop = 1.0 - out["after"]["eucLoss_3d_rgb_sample"] / out["before"]["eucLoss_3d_rgb_sample"]
    out["improved"] = drop > 0
    print(f"BH-MPJPE drop {drop * 100:.1f}%  "
          + ("IMPROVED" if out["improved"] else "NOT IMPROVED"), flush=True)
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("epochs", nargs="?", type=int, default=30)
    ap.add_argument("lr", nargs="?", type=float, default=2e-4)
    ap.add_argument("backbone", nargs="?", default="resnet18")
    ap.add_argument("img", nargs="?", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    out = main(args.epochs, args.lr, args.backbone, args.img, device=args.device)
    return 0 if out["improved"] else 1


if __name__ == "__main__":
    sys.exit(cli())
