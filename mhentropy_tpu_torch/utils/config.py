"""The experiment YAML: the JAX package's schema, defaults and merge rules.

The schema belongs to the JAX package's mhentropy_tpu/utils/config.py
(`get_cfg_defaults` :108-268, the yacs-style `CfgNode` merge :41-52 and
`_coerce` :68-106). The port does not import that package, so that it runs
where only torch is installed; it keeps its own copy here, every key and
default, those the port does not read too. So a YAML loads as the JAX
loader loads it, and fails where that one fails:

* a key outside the schema raises KeyError, except in the groups that
  take new keys (`training`, `network`, `tpu`);
* a value of another type than the default's raises TypeError: a quoted
  bool (`fsdp: "false"`), a string for a number (`lr: "1e-3"`, which is how
  PyYAML reads `1e-3`), a non-integral float for an int (`tp: 2.5`), a
  group set to null (an empty YAML section);
* a number is cast to the default's type (`b_2d: 1` is 1.0) and a list
  replaces a list; a key whose default is None takes any value.

`model_dir` defaults to `./model/<6 random letters or digits>/`, drawn at
each load as in JAX (and `pretrain_model` / `final_model` beside it).
tests/test_torch_imports.py and tests/test_torch_config.py hold the
defaults, every shipped YAML and the refusals equal to the JAX loader's.

`tpu.fused_train_bn` reads differently on the card than on the TPU. There
the Pallas sums lost their A/B to a relayout copy of every activation, so
`false` (the default) kept XLA's reductions. The port's activations are
already channels-last, the (M, C) rows its kernels read, so on the card
train-mode BN always computes its sums with the `bn_cuda` kernels, and the
key only picks the autograd structure around them: `false`, `true` and
"stats" run the forward sums in the kernel and leave the backward to
autograd; "full" also reduces the backward with the grad-sums kernel.
`false` and `true` therefore give the same run. The schema's default is a
bool, so a YAML holds `true` / `false` (the JAX loader refuses "full" there
too); the mode strings are set on a loaded config
(`cfg.tpu.fused_train_bn = "full"`). What `false` chose in the
JAX package, the plain reductions, is `MHEnt.set_kernels(False)` in the port.
"""

from __future__ import annotations

import copy
import random
import string
from typing import Any

import yaml

# The groups whose YAML may add keys the schema lacks (JAX's new_allowed).
OPEN_GROUPS = ("training", "network", "tpu")

# Top-level key or group -> key -> the JAX schema's default, in its order.
# model_dir, pretrain_model and final_model are drawn at each load.
DEFAULTS = {
    "dataset": {"dataset_name": "rhd", "image_size": [256, 256],
                "range_": [[-5.0, -5.0, -5.0], [5.0, 5.0, 5.0]], "pe": "3d", "jointN": 21},
    "model_dir": None,
    "pretrain_model": None,
    "final_model": None,
    "info_interval": 200,
    "save_interval": 5,
    "eval_interval": 1,
    "eval_mscoco": False,
    "training": {"mode": "pretrain", "seed": None, "view_correction": True, "batch_size": 32,
                 "num_workers": 32, "pth": None, "load_mod_names": None, "epochs": 80,
                 "lr": 1e-4, "milestones": [30, 60], "warmups": 0, "criterion": "ELBOLoss",
                 "test_samples": 200, "n_train_hypotheses": 10, "test_quant": None,
                 "eval_temp": 0.8},
    "network": {"enc_type": "BasicEnc", "input": "image", "num_latent": 64, "nums_latent": None,
                "backbone": "resnet18", "resnet_pretrained": True, "conditional_p": False,
                "conditional_i": False, "feat_dim": None, "acts": "exp", "deterministic": False,
                "iterative_refinement": False, "decoder_type": "mano", "pgm": None,
                "p_nf": None, "p_nf_dim": 3, "tsfm_on": None, "cond_mapping_dims": None,
                "kemb": False, "h_dims": [64, 64], "num_steps": 3, "nf_res": None,
                "ddpm": False, "regressor": "realnvp", "rot_prior": None, "w_reg_th": 50,
                "w_prior_2d": 0, "w_reg_ds": 0, "b_2d": 0.03, "entropy": True, "mode": False,
                "b_3d": 0.03, "glow_hidden": 512, "glow_layers": 4, "glow_blocks": 2,
                "T": 1.0, "kld_w": 1.0, "kld_w_annealing": [1.0, 24000], "th3_ref_alpha": 5.0,
                "bt_alpha": 50.0, "use_chamfer_loss": False, "w_chamfer": 10.0,
                "use_mask_loss": False, "b_mask": 0.02},
    "loss": {"kl": 0.0001},
    "tpu": {"mesh_hypo": 1, "fsdp": False, "tp": 1, "pp": 1, "autoresume": False,
            "compute_dtype": "bfloat16", "data_dir": None, "quantize_encoder": False,
            "quantize_q_from": "auto", "quantize_sampler": True, "fused_train_bn": False,
            "decode_cache": None, "target_fields": "auto", "image_u8": True,
            "sample_cache": None, "device_st": True},
}


class CfgNode(dict):
    """A config group: a dict with attribute access, merged from a YAML
    overlay by the JAX package's rules (`merge_from_other_cfg`)."""

    def __init__(self, init: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, "_new_allowed", new_allowed)
        for k, v in (init or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_other_cfg(self, other: dict) -> None:
        for k, v in other.items():
            if k not in self:
                if not object.__getattribute__(self, "_new_allowed"):
                    raise KeyError(f"Non-existent config key: {k}")
                self[k] = CfgNode(v) if isinstance(v, dict) else v
                continue
            cur = self[k]
            if isinstance(cur, CfgNode) and isinstance(v, dict):
                cur.merge_from_other_cfg(v)
            else:
                self[k] = _coerce(v, cur, k)

    def dump(self) -> str:
        def plain(node):
            return {k: plain(v) if isinstance(v, CfgNode) else v for k, v in node.items()}

        return yaml.safe_dump(plain(self), default_flow_style=False)


def _coerce(new: Any, old: Any, key: str) -> Any:
    """An overlay's value for a key whose current value is `old`, as the
    JAX loader takes it (see the module docstring); raises TypeError."""
    if old is None:
        return CfgNode(new) if isinstance(new, dict) else new
    if new is None:
        if isinstance(old, CfgNode):
            raise TypeError(
                f"Type mismatch for key {key}: the YAML overlay sets the config group to null "
                "(empty section?); delete the section header or give it keys")
        return new
    if isinstance(old, bool):
        if not isinstance(new, bool):
            raise TypeError(f"Type mismatch for key {key}: bool vs {type(new)} ({new!r}); "
                            "unquote true/false in the YAML")
        return new
    if isinstance(old, (int, float)) and isinstance(new, (int, float)) \
            and not isinstance(new, bool):
        coerced = type(old)(new)
        if isinstance(old, int) and coerced != new:
            raise TypeError(f"Type mismatch for key {key}: int default cannot hold {new!r} "
                            "losslessly")
        return coerced
    if type(old) is type(new):
        return new
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return list(new)
    raise TypeError(f"Type mismatch for key {key}: {type(old)} vs {type(new)}")


def random_model_dir() -> str:
    """The JAX schema's default model_dir: ./model/<6 random letters or digits>/."""
    name = "".join(random.choice(string.ascii_letters + string.digits) for _ in range(6))
    return f"./model/{name}/"


def get_cfg_defaults() -> CfgNode:
    """The schema's defaults, with a fresh random model_dir."""
    cfg = CfgNode()
    for key, value in DEFAULTS.items():
        cfg[key] = CfgNode(value, new_allowed=key in OPEN_GROUPS) if isinstance(value, dict) \
            else copy.deepcopy(value)
    cfg.model_dir = random_model_dir()
    cfg.pretrain_model = cfg.model_dir + "pretrain.pth"
    cfg.final_model = cfg.model_dir + "final.pth"
    return cfg


def make_cfg(overlay: dict | None = None) -> CfgNode:
    """The defaults with `overlay` ({group: {key: value}} and top-level
    keys, as a YAML file reads) merged on top by the JAX loader's rules."""
    cfg = get_cfg_defaults()
    cfg.merge_from_other_cfg(overlay or {})
    return cfg.clone()


def load_cfg(path: str) -> CfgNode:
    with open(path) as f:
        return make_cfg(yaml.safe_load(f) or {})
