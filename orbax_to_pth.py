#!/usr/bin/env python3
"""Convert a JAX Experiment's orbax checkpoint to a .pth the PyTorch port
restores.

    python orbax_to_pth.py model/<run>/baseline_final out.pth

mhentropy_tpu's `Experiment.save_model` writes an orbax directory of
{"params", "batch_stats", "opt_state", "step"} (mhentropy_tpu/train/
engine.py:1043-1082). orbax imports JAX and the port imports neither, so
the conversion lives here, in neither package, and runs where orbax is
installed. It reads the raw pytree (no template, so nothing of the JAX
package is imported) and writes the reference's schema through the port's
converters: {"encoderRGB": `convert.from_jax(params, batch_stats)` (the
glow regressor's flow too), "optimizer": `convert.opt_state_from_jax`'s
Adam moments by parameter name and its update count, "step"}. The port's
server, `run.py` (training.pth) and export load it; `Experiment` continues
training from its moments and count.
"""

from __future__ import annotations

import argparse
import os
import sys
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _numpy(tree):
    """The raw restore's arrays as numpy (None and empty tuples kept)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return None if tree is None else np.asarray(tree)


def _adam_nodes(tree):
    """Raw dicts of optax's ScaleByAdamState {count, mu, nu} as objects with
    those attributes, the form `opt_state_from_jax` looks for."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return SimpleNamespace(count=tree["count"], mu=tree["mu"], nu=tree["nu"])
        return {k: _adam_nodes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_adam_nodes(v) for v in tree]
    return tree


def read_orbax(path: str) -> dict:
    """The checkpoint's raw pytree, as numpy."""
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as loader:
        raw = loader.restore(os.path.abspath(path))
    return _numpy(raw)


def convert(raw: dict) -> dict:
    """The raw orbax pytree -> the reference-schema checkpoint dict."""
    import torch

    from mhentropy_tpu_torch import convert as conv

    params = raw["params"]
    if "encoder" not in params:
        raise ValueError("orbax_to_pth: not an MHEnt checkpoint (no params['encoder']); the "
                         "RLE mode's checkpoints convert with convert.rle_from_jax")
    out = {"encoderRGB": conv.from_jax(params, raw.get("batch_stats") or {}),
           "step": int(np.asarray(raw.get("step", 0)))}
    if raw.get("opt_state") is not None:
        out["optimizer"] = conv.opt_state_from_jax(_adam_nodes(raw["opt_state"]))
    out["encoderRGB"] = {k: torch.as_tensor(v) for k, v in out["encoderRGB"].items()}
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("orbax_dir", help="a JAX Experiment's checkpoint directory")
    ap.add_argument("out", help="the .pth to write")
    args = ap.parse_args(argv)
    if not args.out.endswith(".pth"):
        raise SystemExit("orbax_to_pth: the output must end in .pth (the port's loaders "
                         "dispatch on it)")
    import torch

    ckpt = convert(read_orbax(args.orbax_dir))
    torch.save(ckpt, args.out)
    print(f"{args.orbax_dir} -> {args.out}: {len(ckpt['encoderRGB'])} tensors, step "
          f"{ckpt['step']}, optimizer moments "
          f"{len(ckpt.get('optimizer', {}).get('state', {}))}")
    return args.out


if __name__ == "__main__":
    main()
