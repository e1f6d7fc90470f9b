"""The port's reading of `network.enc_type` and its eval summary, against the
JAX package's.

The JAX Experiment builds the integrated MHEnt only for enc_type "MHEnt"
(train/engine.py:510) and otherwise its non-integrated RLE mode, which it
refuses without network.p_nf; the port's Experiment does the same, with the
same RLEConfig. The eval summary averages each metric as the JAX loop's
`AverageMeter()` does: a batch whose value is exactly 0 does not enter that
metric's mean.
"""

import os

import pytest
import torch

from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.utils import config as jconfig
from mhentropy_tpu.utils.logging import AverageMeter as JAverageMeter
from mhentropy_tpu_torch.models import mhent, rle
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
    """The non-integrated mode as the JAX Experiment takes it: the RLE
    configs build it (the same RLEConfig in both packages); a YAML without
    network.p_nf is refused by both, naming p_nf."""
    path = _config(name) if name else _without_enc_type(tmp_path)
    cfg = load_cfg(path)
    assert cfg.network.enc_type == ("BasicEnc" if name is None else
                                    jconfig.update_cfg(path).network.enc_type)
    jcfg = jconfig.update_cfg(path)
    jcfg.model_dir = str(tmp_path / "jax") + "/"
    if not jcfg.network.p_nf:
        with pytest.raises(NotImplementedError, match="p_nf"):
            engine.Experiment(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="p_nf"):
            jengine.Experiment(jcfg)
        return
    cfg.model_dir = str(tmp_path / "torch") + "/"
    exp = engine.Experiment(cfg, device="cpu")
    assert not exp.integrated and isinstance(exp.net, rle.RLE)
    jexp = jengine.Experiment(jcfg)
    try:
        assert not jexp.integrated and type(jexp.model_cfg).__name__ == "RLEConfig"
        ours, theirs = exp.model_cfg, jexp.model_cfg
    finally:
        jexp.close()
    assert ours.flow._asdict() == theirs.flow._asdict()
    for k in ("pe", "k1", "sample_temp", "nf_res", "image_size"):
        assert getattr(ours, k) == getattr(theirs, k), k
    for k in ours.encoder._fields:
        assert getattr(ours.encoder, k) == getattr(theirs.encoder, k), k
    assert ours.flow.dim == 3 and ours.flow.tsfm_on == "x" and ours.nf_res == "rle"


@pytest.mark.parametrize("name", ["smoke.yaml", "ho3d.yaml", "rhd.yaml"])
def test_experiment_builds_an_mhent_for_enc_type_mhent(name, tmp_path):
    cfg = load_cfg(_config(name))
    assert cfg.network.enc_type == "MHEnt"
    cfg.model_dir = str(tmp_path) + "/"
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
    cfg = load_cfg(str(path))
    cfg.model_dir = str(tmp_path / "model") + "/"
    exp = engine.Experiment(cfg, device="cpu")
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


@pytest.mark.parametrize("extra", ["", "  regressor: glow\n  glow_hidden: 64\n  glow_layers: 3\n"
                                   "  glow_blocks: 1\n  kld_w: 0.5\n"
                                   "  kld_w_annealing: [0.1, 500]\n"])
def test_build_model_config_reads_every_key_jax_reads(extra, tmp_path):
    """build_model_config gives JAX's MHEntConfig field for field (the port's
    fields, encoder, flow and MANO config as dicts), with the schema's
    defaults and with the glow sizes and the KLD-weight schedule set: keys
    the port ignored before (a YAML's kld_w reached JAX's kld_weight, not
    the port's)."""
    path = tmp_path / "c.yaml"
    path.write_text("dataset: {dataset_name: ho3d, image_size: [64, 64]}\n"
                    "network:\n  enc_type: MHEnt\n  backbone: resnet18\n" + extra
                    + "training: {n_train_hypotheses: 4}\n")
    ours = engine.build_model_config(load_cfg(str(path)))
    theirs = jengine.build_model_config(jconfig.update_cfg(str(path)))
    for k in ours._fields:
        a, b = getattr(ours, k), getattr(theirs, k)
        if hasattr(a, "_asdict"):
            b = b._asdict()
            a = {f: v for f, v in a._asdict().items() if f in b}
            b = {f: b[f] for f in a}
        assert a == b, k
    if extra:
        assert ours.regressor == "glow" and ours.kld_w == 0.5 and ours.glow_blocks == 1
        assert mhent.kld_weight(ours, 250).item() == pytest.approx(0.3)
