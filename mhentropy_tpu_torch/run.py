"""CLI entry point of the port: `python -m mhentropy_tpu_torch.run --cfg configs/ho3d.yaml`.

Port of run.py: reads the experiment YAML, builds the experiment and
dispatches on training.mode. `baseline_VAE` runs the JAX `train_baseline`:
the initial eval, then `training.epochs` epochs of train steps with their
evals and .pth checkpoints under model_dir (`epochs: 0` stops after the
initial eval); `eval` evaluates training.pth. Runs on the card unless
--device says otherwise (e.g. --device cpu). The log and the scalars go to
model_dir (info_<mode>.log, scalars.jsonl); `tpu.autoresume: true`
continues a run from the newest per-epoch checkpoint there. Returns the
last eval's summary.

Under `python -m torch.distributed.run --nproc_per_node=K -m
mhentropy_tpu_torch.run --cfg ...` the K processes join one process group
(`parallel.multihost.initialize`: NCCL on the card, gloo with --device
cpu) and the Experiment shards its steps over them (tpu.mesh_hypo, fsdp,
tp, pp as in JAX); rank 0 alone writes the log, the scalars and the
checkpoints.
"""

from __future__ import annotations

import argparse

import torch

from mhentropy_tpu_torch.parallel import multihost
from mhentropy_tpu_torch.train.engine import Experiment
from mhentropy_tpu_torch.utils.config import load_cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--mano", default="./mano/",
                    help="MANO asset dir (MANO_RIGHT.pkl); absent -> synthetic stand-in")
    args = ap.parse_args(argv)
    cfg = load_cfg(args.cfg)
    multihost.initialize(device_type=torch.device(args.device).type)
    with Experiment(cfg, device=args.device, mano_dir=args.mano) as exp:
        if cfg.training.mode == "baseline_VAE":
            return exp.train_baseline()
        if cfg.training.mode == "eval":
            return exp.eval(name=cfg.training.pth)
        raise NotImplementedError(cfg.training.mode)


if __name__ == "__main__":
    main()
