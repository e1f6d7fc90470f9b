"""Human-body multi-hypothesis evaluation: ProHMR (SMPL conditional flow),
3DPW-style BH-MPJPE, mean MPJPE and 3D PJD.

Port of tools/eval_prohmr.py. Runs the SMPL fixture at SMPL's real size
(6,890 vertices, 24 joints) and fresh seeded weights when no files are
given, so the whole Humans path runs anywhere:

    python -m mhentropy_tpu_torch.eval_prohmr                # on the card
    python -m mhentropy_tpu_torch.eval_prohmr --smpl SMPL_NEUTRAL.pkl --pth smpl_flow.pt
    python -m mhentropy_tpu_torch.eval_prohmr --device cpu --tiny --n 4 --batch 2

The ground truth is the rest pose (identity rotations, zero betas) decoded
by the same SMPL. `--tiny` swaps in a small geometry (resnet18 at 32 px, a
two-layer H = 64 flow in f32, a 256-vertex fixture) for a quick CPU run.
"""

from __future__ import annotations

import argparse

import torch

from mhentropy_tpu_torch.core import smpl as smpl_lib
from mhentropy_tpu_torch.flows.glow import GlowConfig
from mhentropy_tpu_torch.models import prohmr
from mhentropy_tpu_torch.models.encoder import EncoderConfig


def tiny_config() -> prohmr.ProHMRConfig:
    return prohmr.ProHMRConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(64, 64), dtype="float32"),
        flow=GlowConfig(features=prohmr.POSE_DIM, hidden=64, num_layers=2, num_blocks=2,
                        context_features=64),
        image_size=32)


def build(device, smpl_path: str | None = None, pth: str | None = None, tiny: bool = False):
    """(SMPL model, prepared ProHMR net) on `device`: the SMPL file or the
    fixture (6,890 vertices, 256 with `tiny`), seeded weights with the flow
    of `pth` when given."""
    from mhentropy_tpu_torch.convert import load_prohmr_smpl_flow

    if smpl_path:
        model = smpl_lib.load_smpl_pkl(smpl_path, device=device)
    else:
        model = smpl_lib.synthetic_smpl_model(0, n_verts=256 if tiny else smpl_lib.N_VERTS,
                                              device=device)
    cfg = tiny_config() if tiny else prohmr.ProHMRConfig()
    net = prohmr.init(cfg, seed=0)
    if pth:
        net.flow.load_state_dict(load_prohmr_smpl_flow(pth, cfg.flow).state_dict())
    return model, prohmr.prepare(net, device)


def synthetic_batch(model, net, batch: int, seed: int = 1):
    """A synthetic "3DPW" batch: uniform images in [0, 1) and the rest-pose
    joints as ground truth (joints only, no mesh)."""
    dev = model.v_template.device
    g = torch.Generator(device=dev).manual_seed(seed)
    size = net.cfg.image_size
    image = torch.rand((batch, size, size, 3), generator=g, device=dev)
    rotmats = torch.eye(3, device=dev).expand(batch, smpl_lib.N_JOINTS, 3, 3)
    _, gt_joints = smpl_lib.smpl_forward(model, rotmats, torch.zeros((batch, 10), device=dev),
                                         with_mesh=False)
    return image, gt_joints


@torch.inference_mode()
def evaluate(model, net, image, gt_joints, n: int, noise=None, generator=None, quant=None):
    """(samples, metrics): N hypotheses per image and their metrics."""
    samples = prohmr.sample_hypotheses(model, net, image, n=n, noise=noise,
                                       generator=generator, quant=quant)
    return samples, prohmr.multi_hypothesis_metrics(samples, {"joints3d": gt_joints})


def main(argv=None) -> dict:
    from mhentropy_tpu_torch.train.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smpl", default=None, help="SMPL pkl (the fixture if absent)")
    ap.add_argument("--pth", default=None, help="ProHMR SMPL-flow checkpoint")
    ap.add_argument("--n", type=int, default=100, help="hypotheses per image")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="small geometry for a CPU run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model, net = build(dev, args.smpl, args.pth, args.tiny)
    if not args.smpl:
        print(f"using the synthetic SMPL fixture ({model.v_template.shape[0]} vertices; pass "
              f"--smpl for the real model)")
    image, gt = synthetic_batch(model, net, args.batch)
    g = torch.Generator(device=dev).manual_seed(2)
    _, mets = evaluate(model, net, image, gt, args.n, generator=g)
    out = {k: float(v.mean()) for k, v in mets.items()}
    print(f"N={args.n} hypotheses over {args.batch} images on {dev}")
    print(f"BH-MPJPE:   {out['mpjpe_bh']:.2f} mm")
    print(f"mean MPJPE: {out['mpjpe_mean']:.2f} mm")
    print(f"3D PJD:     {out['pjd_3d']:.2f} mm")
    return out


if __name__ == "__main__":
    main()
