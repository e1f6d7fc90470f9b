"""The port's config loader, its reading of `network.enc_type` and its eval
summary, against the JAX package's.

The loader keeps JAX's whole schema and merge rules: every shipped YAML
loads to JAX's values on every key of the schema, and an overlay that the
JAX loader refuses (an unknown key, a quoted bool, a string for a number,
a non-integral float for an int, a group set to null) raises the same
exception class in the port's.

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
import yaml

from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.utils import config as jconfig
from mhentropy_tpu.utils.logging import AverageMeter as JAverageMeter
from mhentropy_tpu_torch.models import mhent, rle
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.utils import logging as tlogging
from mhentropy_tpu_torch.utils import config as tconfig
from mhentropy_tpu_torch.utils.config import load_cfg
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    return os.path.join(REPO, "configs", name)


def _schema_values(cfg) -> dict:
    """Every key of the schema and every key an open group took, as plain
    values; model_dir's random default (and the paths under it) by its
    pattern."""
    out = yaml.safe_load(cfg.dump())
    for key in ("model_dir", "pretrain_model", "final_model"):
        out[key] = out[key].replace(cfg.model_dir, "<model_dir>/") \
            if cfg.model_dir.startswith("./model/") else out[key]
    return out


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                                        if f.endswith(".yaml")))
def test_shipped_yaml_loads_to_jax_values_on_every_key(name):
    path = _config(name)
    ours, theirs = load_cfg(path), jconfig.update_cfg(path)
    assert _schema_values(ours) == _schema_values(theirs)
    assert list(ours) == list(theirs)
    for group in tconfig.OPEN_GROUPS:
        assert list(ours[group]) == list(theirs[group]), group


BAD_OVERLAYS = {
    "quoted_bool": "tpu: {fsdp: 'false'}\n",
    "unknown_group": "trainng: {lr: 1.0}\n",
    "unknown_dataset_key": "dataset: {image_sizes: [64, 64]}\n",
    "string_for_float": "training: {lr: 1e-3}\n",
    "fractional_int": "tpu: {tp: 2.5}\n",
    "fractional_int_default": "info_interval: 0.5\n",
    "null_group": "tpu:\n",
    "null_network": "network: null\n",
    "string_for_int": "training: {batch_size: '64'}\n",
    "bool_for_int": "tpu: {mesh_hypo: true}\n",
    "mode_string_for_bool": "tpu: {fused_train_bn: full}\n",
    "list_for_str": "network: {backbone: [resnet50]}\n",
}


@pytest.mark.parametrize("name", sorted(BAD_OVERLAYS))
def test_bad_overlay_raises_as_jax(name, tmp_path):
    """The port refuses what the JAX loader refuses, with its exception
    class (KeyError for a key outside the schema, TypeError for a value of
    another type than the default's)."""
    path = tmp_path / f"{name}.yaml"
    path.write_text(BAD_OVERLAYS[name])
    with pytest.raises((KeyError, TypeError)) as theirs:
        jconfig.update_cfg(str(path))
    with pytest.raises(theirs.type):
        load_cfg(str(path))


GOOD_OVERLAYS = {
    "int_to_float": ("network: {b_2d: 1}\n", ("network", "b_2d"), 1.0),
    "integral_float_to_int": ("tpu: {tp: 2.0}\n", ("tpu", "tp"), 2),
    "open_group_new_key": ("training: {my_key: 3}\n", ("training", "my_key"), 3),
    "none_default_takes_any": ("training: {seed: 7}\n", ("training", "seed"), 7),
    "null_value": ("tpu: {data_dir: null}\n", ("tpu", "data_dir"), None),
    "list": ("dataset: {image_size: [64, 64]}\n", ("dataset", "image_size"), [64, 64]),
}


@pytest.mark.parametrize("name", sorted(GOOD_OVERLAYS))
def test_overlay_coerces_as_jax(name, tmp_path):
    text, (group, key), want = GOOD_OVERLAYS[name]
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    ours, theirs = load_cfg(str(path))[group][key], jconfig.update_cfg(str(path))[group][key]
    assert ours == theirs == want and type(ours) is type(theirs)


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
