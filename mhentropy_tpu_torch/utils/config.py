"""The experiment YAML, read for the keys the port's serving, eval and
training paths use.

The schema, its merge rules and its defaults belong to the JAX package's
mhentropy_tpu/utils/config.py. The port does not import that package, so
that it runs where only torch is installed; it reads a YAML under configs/
for the keys below, takes the JAX schema's default for each one a file
leaves out, and ignores every other key. tests/test_torch_imports.py holds
these defaults and every shipped YAML equal to the JAX loader's on them.

`tpu.fused_train_bn` reads differently on the card than on the TPU. There
the Pallas sums lost their A/B to a relayout copy of every activation, so
`false` (the default) kept XLA's reductions. The port's activations are
already channels-last, the (M, C) rows its kernels read, so on the card
train-mode BN always computes its sums with the `bn_cuda` kernels, and the
key only picks the autograd structure around them: `false`, `true` and
"stats" run the forward sums in the kernel and leave the backward to
autograd; "full" also reduces the backward with the grad-sums kernel.
`false` and `true` therefore give the same run. What `false` chose in the
JAX package, the plain reductions, is `MHEnt.set_kernels(False)` in the port.
"""

from __future__ import annotations

import random
import string
from types import SimpleNamespace

import yaml

# Top-level key or group -> key -> the JAX schema's default
# (utils/config.py get_cfg_defaults). model_dir's default is random per load.
DEFAULTS = {
    "model_dir": None,
    "info_interval": 200,
    "save_interval": 5,
    "eval_interval": 1,
    "dataset": {"dataset_name": "rhd", "image_size": [256, 256], "jointN": 21, "pe": "3d"},
    "network": {"enc_type": "BasicEnc", "num_latent": 64, "nums_latent": None,
                "backbone": "resnet18", "feat_dim": None, "acts": "exp", "deterministic": False,
                "decoder_type": "mano",
                "regressor": "realnvp", "h_dims": [64, 64], "num_steps": 3,
                "w_reg_th": 50, "b_2d": 0.03, "b_3d": 0.03, "entropy": True, "T": 1.0,
                "th3_ref_alpha": 5.0, "bt_alpha": 50.0, "use_chamfer_loss": False,
                "w_chamfer": 10.0, "use_mask_loss": False,
                # The non-integrated RLE mode (engine.build_rle_config).
                "p_nf": None, "p_nf_dim": 3, "tsfm_on": None, "cond_mapping_dims": None,
                "kemb": False, "nf_res": None},
    "training": {"mode": "pretrain", "seed": None, "batch_size": 32, "pth": None,
                 "epochs": 80, "lr": 1e-4, "milestones": [30, 60], "test_samples": 200,
                 "n_train_hypotheses": 10, "test_quant": None, "eval_temp": 0.8},
    "tpu": {"compute_dtype": "bfloat16", "data_dir": None, "quantize_encoder": False,
            "quantize_q_from": "auto", "quantize_sampler": True, "fused_train_bn": False,
            "autoresume": False,
            # The dataset loaders (train/engine.py make_datasets).
            "decode_cache": None, "target_fields": "auto", "image_u8": True,
            "sample_cache": None, "device_st": True},
}


def random_model_dir() -> str:
    """The JAX schema's default model_dir: ./model/<6 random letters or digits>/."""
    name = "".join(random.choice(string.ascii_letters + string.digits) for _ in range(6))
    return f"./model/{name}/"


def make_cfg(overlay: dict | None = None) -> SimpleNamespace:
    """The defaults with `overlay` ({group: {key: value}} and top-level keys)
    on top, as cfg.<key> and cfg.<group>.<key> attributes."""
    overlay = overlay or {}
    cfg = SimpleNamespace(**{
        key: SimpleNamespace(**{k: (overlay.get(key) or {}).get(k, v) for k, v in keys.items()})
        if isinstance(keys, dict) else overlay.get(key, keys)
        for key, keys in DEFAULTS.items()})
    if cfg.model_dir is None:
        cfg.model_dir = random_model_dir()
    return cfg


def load_cfg(path: str) -> SimpleNamespace:
    with open(path) as f:
        return make_cfg(yaml.safe_load(f))
