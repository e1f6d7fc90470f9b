"""The port Experiment's `load_model` and `models.txt` against the JAX
Experiment's (mhentropy_tpu/train/engine.py `load_model` :1053-1083,
`_merge_params`, the queued restore :670-680, `_dump_models_txt` :764-783),
the counterparts of tests/test_experiment_integration.py:64, :74 and :289.

* models.txt: the model config's repr, a parameter count a top-level
  module, `total` and `batch_stats`; the counts equal JAX's for the same
  YAML (the port's module names: feat_extractor for JAX's encoder,
  q_z_giv_i for its flow; the RLE mode's encoderRGB and p_nf).
* `load_model(path, mod_names)`: only the named top-level modules take the
  checkpoint's state, in both packages, from the same .pth.
* A restore asked for before the train state exists is queued, and
  applied when the state is built (`_ensure_state`), in both packages;
  `eval(name=)` replaces a queued restore, as JAX's `eval` does, so its
  metrics are those of the named checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.utils import config as jconfig
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.utils.config import load_cfg
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

TINY = """\
dataset: {{dataset_name: ho3d, image_size: [32, 32]}}
network: {{enc_type: {enc}, num_latent: {latent}, backbone: resnet18, h_dims: [16, 16],
          num_steps: 1, tsfm_on: {tsfm}, regressor: {regressor}, glow_hidden: 16,
          glow_layers: 2{extra}}}
training: {{mode: baseline_VAE, batch_size: 4, epochs: 1, test_samples: 2, seed: {seed},
           n_train_hypotheses: 2}}
tpu: {{compute_dtype: float32}}
"""
NETS = {"realnvp": dict(enc="MHEnt", latent=16, tsfm=16, regressor="realnvp", extra=""),
        "glow": dict(enc="MHEnt", latent=16, tsfm=16, regressor="glow", extra=""),
        "rle": dict(enc="BasicEnc", latent=63, tsfm="x", regressor="realnvp",
                    extra=", p_nf: realnvp, p_nf_dim: 3, nf_res: rle")}
# The port's top-level modules -> the JAX parameter tree's groups.
GROUPS = {"feat_extractor": "encoder", "q_z_giv_i": "flow", "det_head": "det_head",
          "encoderRGB": "encoder", "p_nf": "p_nf"}


def _yaml(tmp_path, name, seed=0):
    path = tmp_path / f"{name}_{seed}.yaml"
    path.write_text(TINY.format(seed=seed, **NETS[name]))
    return str(path)


def _counts(text: str) -> dict:
    """{group: count} of a models.txt's count lines."""
    out = {}
    for line in text.splitlines():
        if line.endswith((" params", " entries")):
            name, n = line.split(": ")
            out[name] = int(n.split()[0].replace(",", ""))
    return out


@pytest.mark.parametrize("name", sorted(NETS))
def test_models_txt_counts_equal_jax(name, tmp_path):
    path = _yaml(tmp_path, name)
    cfg = load_cfg(path)
    cfg.model_dir = str(tmp_path / "port") + "/"
    with engine.Experiment(cfg, device="cpu") as exp:
        text = open(os.path.join(cfg.model_dir, "models.txt")).read()
        assert text.startswith(repr(exp.model_cfg) + "\n\n")
    jcfg = jconfig.update_cfg(path)
    jcfg.model_dir = str(tmp_path / "jax") + "/"
    with jengine.Experiment(jcfg) as jexp:
        jexp._ensure_state(1)
        jtext = open(os.path.join(jcfg.model_dir, "models.txt")).read()
    ours, theirs = _counts(text), _counts(jtext)
    assert ours["total"] == theirs["total"] and ours["batch_stats"] == theirs["batch_stats"]
    groups = {GROUPS[k]: v for k, v in ours.items() if k in GROUPS}
    assert groups == {k: v for k, v in theirs.items() if k not in ("total", "batch_stats")}
    assert sum(groups.values()) == ours["total"]


def _state(exp) -> dict:
    return {k: v.detach().clone() for k, v in exp.net.state_dict().items()}


def _module(sd: dict, name: str) -> dict:
    return {k: v for k, v in sd.items() if k.split(".", 1)[0] == name}


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A port .pth (save_model of a seed-0 Experiment) and the state it
    holds."""
    tmp = tmp_path_factory.mktemp("snap")
    cfg = load_cfg(_yaml(tmp, "realnvp"))
    cfg.model_dir = str(tmp / "run") + "/"
    with engine.Experiment(cfg, device="cpu") as exp:
        path = exp.save_model("snap")
        return path, _state(exp), tmp


def test_load_model_before_the_state_is_queued(snapshot):
    """load_model on a fresh Experiment queues the restore (the weights stay
    the seed's); `_ensure_state` applies it, every module."""
    path, snap, tmp = snapshot
    cfg = load_cfg(_yaml(tmp, "realnvp", seed=9))
    cfg.model_dir = str(tmp / "queued") + "/"
    with engine.Experiment(cfg, device="cpu") as exp:
        fresh = _state(exp)
        assert not torch.equal(fresh["det_head.0.weight"], snap["det_head.0.weight"])
        exp.load_model(path)
        assert exp._pending_restore == (path, None)
        assert _equal(_state(exp), fresh)
        exp._ensure_state(3)
        assert exp._pending_restore is None
        assert _equal(_state(exp), snap)


def test_load_model_overwrites_only_the_named_modules(snapshot):
    """With mod_names, queued or not, only those modules take the
    checkpoint's state; the others keep the Experiment's."""
    path, snap, tmp = snapshot
    cfg = load_cfg(_yaml(tmp, "realnvp", seed=9))
    for queued in (True, False):
        cfg.model_dir = str(tmp / f"named_{queued}") + "/"
        with engine.Experiment(cfg, device="cpu") as exp:
            fresh = _state(exp)
            if not queued:
                exp._ensure_state(3)
            exp.load_model(path, mod_names=["det_head", "q_z_giv_i"])
            if queued:
                assert exp._pending_restore is not None
                exp._ensure_state(3)
            got = _state(exp)
        for name in ("det_head", "q_z_giv_i"):
            assert _equal(_module(got, name), _module(snap, name)), name
        assert _equal(_module(got, "feat_extractor"), _module(fresh, "feat_extractor"))
        assert not _equal(_module(got, "feat_extractor"), _module(snap, "feat_extractor"))


def test_jax_load_model_of_the_port_checkpoint_overwrites_the_same_module(snapshot):
    """JAX's Experiment, queued before its state, with mod_names=["det_head"]
    (its group name) on the same .pth: its det_head takes the checkpoint's
    weights and its encoder keeps its own, as the port's does."""
    path, snap, tmp = snapshot
    jcfg = jconfig.update_cfg(_yaml(tmp, "realnvp", seed=9))
    jcfg.model_dir = str(tmp / "jax_named") + "/"
    with jengine.Experiment(jcfg) as jexp:
        jexp.load_model(path, mod_names=["det_head"])
        assert jexp.state is None and jexp._pending_restore is not None
        jexp._ensure_state(3)
        head = np.asarray(jexp.state.params["det_head"]["l0"]["w"])
        # HWIO -> the port's (out, in, h, w).
        stem = np.asarray(jexp.state.params["encoder"]["backbone"]["conv1"]["kernel"]).transpose(
            3, 2, 0, 1)
    np.testing.assert_array_equal(head, snap["det_head.0.weight"].numpy().T)
    conv1 = snap["feat_extractor.res.conv1.weight"].numpy()
    assert stem.shape == conv1.shape and not np.allclose(stem, conv1)


def test_eval_of_a_named_checkpoint_replaces_a_queued_restore(snapshot):
    """load_model(A) then eval(name=B) on a fresh Experiment evaluates B (JAX's
    `eval(name)` overwrites its queued restore): the weights after are B's,
    nothing stays queued, and the summary equals that of the same
    Experiment evaluating B with nothing queued."""
    path_a, _, tmp = snapshot
    cfg = load_cfg(_yaml(tmp, "realnvp", seed=5))
    cfg.model_dir = str(tmp / "b") + "/"
    with engine.Experiment(cfg, device="cpu") as exp:
        path_b, snap_b = exp.save_model("b"), _state(exp)
    summaries = []
    for queued in (True, False):
        cfg = load_cfg(_yaml(tmp, "realnvp", seed=9))
        cfg.model_dir = str(tmp / f"eval_{queued}") + "/"
        with engine.Experiment(cfg, device="cpu") as exp:
            if queued:
                exp.load_model(path_a)
            summaries.append(exp.eval(name=path_b))
            assert exp._pending_restore is None
            assert _equal(_state(exp), snap_b)
    assert summaries[0] == summaries[1]
