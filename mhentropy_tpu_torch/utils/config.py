"""The experiment YAML, read for the keys the port's serving path uses.

The schema, its merge rules and its defaults belong to the JAX package's
mhentropy_tpu/utils/config.py. The port does not import that package, so
that it runs where only torch is installed; it reads a YAML under configs/
for the keys below, takes the JAX schema's default for each one a file
leaves out, and ignores every other key. tests/test_torch_imports.py holds
these defaults and every shipped YAML equal to the JAX loader's on them.
"""

from __future__ import annotations

from types import SimpleNamespace

import yaml

# group -> key -> the JAX schema's default (utils/config.py get_cfg_defaults).
DEFAULTS = {
    "dataset": {"dataset_name": "rhd", "image_size": [256, 256], "jointN": 21},
    "network": {"num_latent": 64, "nums_latent": None, "backbone": "resnet18",
                "feat_dim": None, "acts": "exp", "deterministic": False,
                "regressor": "realnvp", "h_dims": [64, 64], "num_steps": 3},
    "training": {"test_samples": 200},
    "tpu": {"compute_dtype": "bfloat16"},
}


def make_cfg(overlay: dict | None = None) -> SimpleNamespace:
    """The defaults with `overlay` ({group: {key: value}}) on top, as
    cfg.<group>.<key> attributes."""
    overlay = overlay or {}
    return SimpleNamespace(**{
        group: SimpleNamespace(**{k: (overlay.get(group) or {}).get(k, v)
                                  for k, v in keys.items()})
        for group, keys in DEFAULTS.items()})


def load_cfg(path: str) -> SimpleNamespace:
    with open(path) as f:
        return make_cfg(yaml.safe_load(f))
