"""The released-checkpoint eval (mhentropy_tpu_torch/eval_released_
checkpoint.py) and the orbax conversion (orbax_to_pth.py).

* The eval runs its CLI, as tests/test_released_checkpoint_drill.py runs
  JAX's, on a full-schema file at configs/ho3d.yaml's width (the port's
  MHEnt state dict with the `mano_dec.th_*` buffers and an empty
  `decoderPose`), an HO3D tree from `data/fixtures.write_ho3d` (2
  evaluation frames) and the synthetic MANO, at B = 2, N = 4: it prints the
  README table's four lines, and its numbers equal the port's eval loop's
  summary on the same files and noise (an Experiment built apart, same
  seed).
* A tiny JAX Experiment saves an orbax checkpoint; the script converts it;
  run.py's eval restores the .pth and gives the summary of the same
  weights carried by `convert.from_jax` from the live JAX state (equal
  within 1e-6 relative: the same f32 weights), and the converted Adam
  moments are `opt_state_from_jax`'s of the live state, exactly.
"""

import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.utils.config import update_cfg
from mhentropy_tpu_torch import eval_released_checkpoint as released
from mhentropy_tpu_torch import run
from mhentropy_tpu_torch.convert import from_jax, opt_state_from_jax
from mhentropy_tpu_torch.data import fixtures
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.train.engine import Experiment
from mhentropy_tpu_torch.utils.config import load_cfg
from tests.test_torch_repairs import full_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ORBAX_YAML = """\
dataset: {{dataset_name: ho3d, image_size: [32, 32]}}
network: {{enc_type: MHEnt, backbone: resnet18, num_latent: 32, h_dims: [32, 32],
          num_steps: 1}}
training: {{mode: {mode}, epochs: 0, batch_size: 4, seed: 3, test_samples: 4,
           n_train_hypotheses: 2, pth: {pth}}}
tpu: {{compute_dtype: float32}}
model_dir: {model_dir}
"""


def _orbax_to_pth():
    spec = importlib.util.spec_from_file_location("orbax_to_pth",
                                                  os.path.join(REPO, "orbax_to_pth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def released_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("released")
    cfg = load_cfg(os.path.join(REPO, "configs", "ho3d.yaml"))
    net = mhent.init(engine.build_model_config(cfg), seed=11)
    pth = root / "ent_ho3d.pth"
    torch.save(full_schema(net), str(pth))
    data = fixtures.write_ho3d(str(root / "data"), n_train=1, n_eval=2, seed=7)
    mano = root / "mano"
    mano.mkdir()
    return str(pth), data, str(mano)


def test_released_eval_cli_prints_the_eval_loops_numbers(released_files, capsys):
    pth, data, mano = released_files
    summary = released.main(["--pth", pth, "--data", data, "--mano", mano, "--batch", "2",
                             "--n", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "evaluation split: 2 samples" in out
    assert "README-table metrics" in out
    vals = [float(v) for v in re.findall(
        r"(?:MPJPE|AH 2D EPE|2D Vis PJD|3D Occ PJD)[^:]*:\s+([-\d.]+)", out)]
    assert len(vals) == 4 and all(np.isfinite(vals)), out
    cfg = load_cfg(os.path.join(REPO, "configs", "ho3d.yaml"))
    cfg.training.pth, cfg.training.mode, cfg.training.seed = pth, "eval", 0
    cfg.training.batch_size, cfg.training.test_samples, cfg.training.eval_temp = 2, 4, 0.8
    cfg.tpu.data_dir = data
    cfg.model_dir = os.path.join(os.path.dirname(pth), "loop")
    with Experiment(cfg, device="cpu", mano_dir=mano) as exp:
        _, evald = exp.make_datasets(which=("eval",))
        want = exp.eval_loop(evald)
    assert summary == want
    for (_, key, scale, _), v in zip(released.TABLE, vals):
        assert v == pytest.approx(round(want[key] * scale, 2), abs=1e-9), key


@pytest.fixture(scope="module")
def orbax_ckpt(tmp_path_factory):
    """A tiny JAX Experiment's state (fresh init, its Adam state one update
    in so the moments are not zero), saved by its own save_model."""
    root = tmp_path_factory.mktemp("orbax")
    yaml = root / "jax.yaml"
    yaml.write_text(ORBAX_YAML.format(mode="baseline_VAE", pth="null",
                                      model_dir=f"{root / 'jax'}/"))
    exp = jengine.Experiment(update_cfg(str(yaml)))
    try:
        # _ensure_state(4, for_training=True)'s state, with the init and the
        # update jitted: they compile once instead of op by op.
        exp.steps_per_epoch = 4
        exp.optimizer = exp._get_optimizer(4)
        exp.state = jax.jit(lambda k: jengine.init_state(k, exp.model_cfg, exp.optimizer))(
            jax.random.split(exp.key)[1])
        rng = np.random.RandomState(0)
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32) * 1e-3,
                             exp.state.params)
        _, opt_state = jax.jit(exp.optimizer.update)(grads, exp.state.opt_state,
                                                     exp.state.params)
        exp.state = exp.state._replace(opt_state=opt_state)
        exp.save_model("ckpt")
        state = jax.tree.map(np.asarray, exp.state)
    finally:
        exp.close()
    return root, str(root / "jax" / "ckpt"), state


def test_orbax_checkpoint_converts_and_evaluates_alike(orbax_ckpt, capsys):
    root, ckpt, state = orbax_ckpt
    out = str(root / "converted.pth")
    _orbax_to_pth().main([ckpt, out])
    assert "optimizer moments" in capsys.readouterr().out
    yaml = root / "eval.yaml"
    yaml.write_text(ORBAX_YAML.format(mode="eval", pth=out, model_dir=f"{root / 'port'}/"))
    got = run.main(["--cfg", str(yaml), "--device", "cpu"])
    cfg = load_cfg(str(yaml))
    cfg.training.pth, cfg.model_dir = None, str(root / "live")
    with Experiment(cfg, device="cpu") as exp:
        exp.net.load_state_dict(from_jax(state.params, state.batch_stats), strict=True)
        exp.net = mhent.prepare(exp.net, "cpu")
        _, evald = exp.make_datasets(which=("eval",))
        want = exp.eval_loop(evald)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6 * max(abs(v), 1.0), (k, got[k], v)


def test_orbax_moments_and_step_carry_over(orbax_ckpt):
    root, ckpt, state = orbax_ckpt
    out = str(root / "moments.pth")
    _orbax_to_pth().main([ckpt, out])
    conv = torch.load(out)
    want = opt_state_from_jax(state.opt_state)
    assert conv["step"] == int(state.step) and conv["optimizer"]["count"] == want["count"] == 1
    assert set(conv["optimizer"]["state"]) == set(want["state"])
    for k, m in want["state"].items():
        for part in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(conv["optimizer"]["state"][k][part]),
                               torch.as_tensor(m[part])), (k, part)
    assert float(np.abs(np.asarray(want["state"]["det_head.0.weight"]["exp_avg"])).max()) > 0
