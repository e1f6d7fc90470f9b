"""Reproduce the reference's HO3D results table with its released checkpoint.

Port of tools/eval_released_checkpoint.py: the reference's README table
(hand/README.md:46-50: MPJPE 20.55 mm / AH 16.95 px / PJD 3.30 px /
11.93 mm) from `./model/ent_ho3d.pth` with configs/ho3d.yaml:

    python -m mhentropy_tpu_torch.eval_released_checkpoint \\
        --pth ./model/ent_ho3d.pth --data ./datasets --mano ./mano

It loads the reference checkpoint (`convert.load_reference_state`: its
MANO layer's `mano_dec.*` buffers dropped, every other key strict), reads
HO3D_v3's evaluation split (the held-out ABF14 / MC5 / SB14 / ShSu13
sequences) through the port's `data/ho3d.py`, draws N = 200 hypotheses at
temperature 0.8 through the port's eval step, keeps the split's tail
(`pad_remainder=True`: the reference's eval loader has no drop_last) and
averages the metrics with valid-weighted AverageMeters: `engine.Experiment.
eval_loop`, whose summary it prints as the README table's four lines. Runs
on the card unless --device says otherwise. The HO3D_v3 download, the
released .pth and MANO_RIGHT.pkl do not ship with the repository.
"""

from __future__ import annotations

import argparse
import os
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = (("MPJPE (BH, mm):  ", "eucLoss_3d_rgb_sample", 1000.0, "20.55"),
         ("AH 2D EPE (px):  ", "eucLoss_2d_rgb_vis_mean", 1.0, "16.95"),
         ("2D Vis PJD (px): ", "eucLoss_2d_rgb_vis_std", 1.0, "3.30"),
         ("3D Occ PJD (mm): ", "eucLoss_3d_rgb_invis_std", 1000.0, "11.93"))


def evaluate(pth: str, data: str, mano: str = "./mano/", batch: int = 64, n: int = 200,
             device=None, seed: int = 0, cfg_path: str | None = None) -> dict:
    """The eval loop's summary of the checkpoint on HO3D's evaluation split."""
    from mhentropy_tpu_torch.train.engine import Experiment
    from mhentropy_tpu_torch.utils.config import load_cfg

    cfg = load_cfg(cfg_path or os.path.join(REPO, "configs", "ho3d.yaml"))
    cfg.training.pth = pth
    cfg.training.mode = "eval"
    cfg.training.batch_size = batch
    cfg.training.test_samples = n
    cfg.training.eval_temp = 0.8
    cfg.training.seed = seed
    cfg.tpu.data_dir = data
    with tempfile.TemporaryDirectory() as model_dir:
        cfg.model_dir = model_dir
        with Experiment(cfg, device=device, mano_dir=mano) as exp:
            _, evald = exp.make_datasets(which=("eval",))
            print(f"evaluation split: {len(evald)} samples", flush=True)
            return exp.eval_loop(evald)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pth", required=True, help="released ent_ho3d.pth")
    ap.add_argument("--data", required=True, help="datasets root (HO3D_v3)")
    ap.add_argument("--mano", default="./mano/", help="MANO pkl dir")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0, help="the hypotheses' base-noise seed")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    summary = evaluate(args.pth, args.data, args.mano, args.batch, args.n, args.device,
                       args.seed)
    print("\n=== README-table metrics (hand/README.md:46-50) ===")
    for label, key, scale, ref in TABLE:
        print(f"{label} {summary[key] * scale:.2f}   (reference: {ref})")
    return summary


if __name__ == "__main__":
    main()
