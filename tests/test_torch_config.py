"""The port's reading of `network.enc_type` and its eval summary, against the
JAX package's.

The JAX Experiment builds the integrated MHEnt only for enc_type "MHEnt"
(train/engine.py:510) and otherwise its non-integrated RLE mode, which the
port does not have: the port's Experiment refuses those configs. The eval
summary averages each metric as the JAX loop's `AverageMeter()` does: a
batch whose value is exactly 0 does not enter that metric's mean.
"""

import os

import pytest
import torch

from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.utils import config as jconfig
from mhentropy_tpu.utils.logging import AverageMeter as JAverageMeter
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.utils import logging as tlogging
from mhentropy_tpu_torch.utils.config import load_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    return os.path.join(REPO, "configs", name)


def _without_enc_type(tmp_path):
    """configs/smoke.yaml with its enc_type line taken out."""
    text = open(_config("smoke.yaml")).read()
    assert "  enc_type: MHEnt\n" in text
    path = tmp_path / "no_enc_type.yaml"
    path.write_text(text.replace("  enc_type: MHEnt\n", ""))
    return str(path)


@pytest.mark.parametrize("name", ["smoke_rle.yaml", "rhd_rle.yaml", None])
def test_experiment_refuses_the_non_integrated_mode(name, tmp_path):
    path = _config(name) if name else _without_enc_type(tmp_path)
    cfg = load_cfg(path)
    assert cfg.network.enc_type == ("BasicEnc" if name is None else
                                    jconfig.update_cfg(path).network.enc_type)
    with pytest.raises(NotImplementedError, match="RLE, rendering and viz"):
        engine.Experiment(cfg, device="cpu")
    # The JAX Experiment takes its non-integrated branch on the same file
    # (and, without network.p_nf, refuses it too).
    jcfg = jconfig.update_cfg(path)
    jcfg.model_dir = str(tmp_path / "jax") + "/"
    if jcfg.network.p_nf:
        exp = jengine.Experiment(jcfg)
        try:
            assert not exp.integrated and type(exp.model_cfg).__name__ == "RLEConfig"
        finally:
            exp.close()
    else:
        with pytest.raises(NotImplementedError, match="p_nf"):
            jengine.Experiment(jcfg)


@pytest.mark.parametrize("name", ["smoke.yaml", "ho3d.yaml", "rhd.yaml"])
def test_experiment_builds_an_mhent_for_enc_type_mhent(name):
    cfg = load_cfg(_config(name))
    assert cfg.network.enc_type == "MHEnt"
    exp = engine.Experiment(cfg, device="cpu")
    assert isinstance(exp.net, mhent.MHEnt)
    assert exp.model_cfg.encoder.backbone == cfg.network.backbone


@pytest.mark.parametrize("drop_zeros", [True, False])
def test_average_meter_is_the_jax_one(drop_zeros):
    ours, theirs = tlogging.AverageMeter(drop_zeros), JAverageMeter(drop_zeros)
    for v, n in ((0.0, 2.0), (12.0, 1.0), (3.5, 4.0), (0.0, 1.0), (-1.25, 2.0)):
        ours.update(v, n=n)
        theirs.update(v, n=n)
        assert (ours.val, ours.sum, ours.count, ours.avg) == (
            theirs.val, theirs.sum, theirs.count, theirs.avg)
    assert tlogging.AverageMeter().drop_zeros


def test_eval_summary_drops_zero_batches_as_jax_does(tmp_path, monkeypatch):
    """Two eval batches: the `_invis` metric scores 0.0 in the first (no
    invisible joint) and 12.0 in the second; the summary is 12.0, as the JAX
    loop's AverageMeter gives, not the valid-weighted 6.0 (or 4.0)."""
    path = tmp_path / "tiny.yaml"
    path.write_text(
        "dataset: {dataset_name: ho3d, image_size: [32, 32]}\n"
        "network: {enc_type: MHEnt, num_latent: 16, backbone: resnet18, h_dims: [32, 32],\n"
        "          num_steps: 1}\n"
        "training: {mode: eval, batch_size: 16, epochs: 0, test_samples: 2, seed: 1,\n"
        "           n_train_hypotheses: 2}\n"
        "tpu: {compute_dtype: float32}\n")
    batches = [{"eucLoss_3d_rgb_invis": torch.tensor(0.0), "loss_total": torch.tensor(3.0),
                "n_valid": torch.tensor(16.0)},
               {"eucLoss_3d_rgb_invis": torch.tensor(12.0), "loss_total": torch.tensor(5.0),
                "n_valid": torch.tensor(8.0)}]
    calls = iter(batches)
    monkeypatch.setattr(engine, "make_eval_step",
                        lambda *a, **k: lambda *args: dict(next(calls)))
    exp = engine.Experiment(load_cfg(str(path)), device="cpu")
    _, data = exp.make_datasets(which=("eval",))
    summary = exp.eval_loop(data)
    want = {}
    for mets in batches:
        n_valid = float(mets["n_valid"])
        for k, v in mets.items():
            if k != "n_valid":
                want.setdefault(k, JAverageMeter()).update(float(v), n=n_valid)
    assert summary == {k: m.avg for k, m in want.items()}
    assert summary["eucLoss_3d_rgb_invis"] == 12.0
    assert summary["loss_total"] == pytest.approx((3.0 * 16 + 5.0 * 8) / 24)
