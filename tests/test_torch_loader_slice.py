"""The loader-fed slice, port against the JAX package: the first batches of
the RHD fixture (tests/fixtures_data.py) through `_prep_batch`, the train
step and the eval step of both packages, then the port's
`Experiment.train_baseline` reading `tpu.data_dir`, and the host metrics.

Weights move with `from_jax`; the noise is the one the JAX step draws from
its key (jax.random.normal), passed to the port. resnet18 at 64 px (the
loaders' image_size), flow h = 32 with one step, two reverse-KL hypotheses,
f32. Tolerances (the ROADMAP's budgets): the prepared image exactly (the
same f32 affine of u8 values), `st` 1e-5 (the same SVD fit); the loss and
the aux terms of one train step and every eval metric within 1e-4 relative;
the hypotheses' bone-normalised xyz within 1e-4 and, scaled by the batch's
bone length, within 0.02 mm.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.data import common as jcommon
from mhentropy_tpu.data import rhd as jrhd
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu.parallel import mesh as mesh_lib
from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.train import metrics as jmetrics
from mhentropy_tpu.utils import config as jconfig
from mhentropy_tpu_torch import run
from mhentropy_tpu_torch.convert import from_jax
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.data import cached, common, rhd
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.train import engine, metrics
from mhentropy_tpu_torch.utils.config import load_cfg
from tests import fixtures_data
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

B, N, IMG, TEMP, NT = 2, 4, 64, 0.8, 2
TOL = 1e-4
MM_TOL = 0.02


def _close(got, want, rel, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(scope="module")
def rhd_root(tmp_path_factory):
    return fixtures_data.build_rhd(str(tmp_path_factory.mktemp("rhd")), n=3)


@pytest.fixture(scope="module")
def model():
    """The JAX and port MHEnt (ds "rhd") with one set of weights: non-default
    BN statistics and the flow at O(1)."""
    jcfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(32, 32), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=1),
        feat_dim=32, image_size=IMG, n_train_hypotheses=NT, ds="rhd")
    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(32, 32), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=1),
        feat_dim=32, image_size=IMG, n_train_hypotheses=NT, ds="rhd")
    params, stats = jmhent.init(jax.random.key(0), jcfg)
    rng = np.random.RandomState(1)
    stats = jax.tree.map(lambda v: (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32), stats)
    flow = params["flow"]
    fields = {n: (rng.uniform(-1, 1, v.shape) / np.sqrt(v.shape[-2] if v.ndim == 3
                                                       else v.shape[-1])).astype(np.float32)
              for n, v in flow._asdict().items() if hasattr(v, "shape") and n != "masks"}
    params = jax.tree.map(np.asarray, dict(params, flow=flow._replace(**fields)))
    return jcfg, cfg, params, stats


def _net(cfg, params, stats):
    net = mhent.MHEnt(cfg)
    net.load_state_dict(from_jax(params, jax.tree.map(np.asarray, stats)), strict=True)
    return net


def _batch(rhd_root, mode, which=0):
    """Batch `which` (B = 2) of an epoch of each package's RHD loader at the
    Experiment's settings: u8 images, minimal fields, st on the device;
    train mode shuffled as train_epoch does, both padded."""
    kw = dict(image_size=IMG, heavy_fields=set(), image_u8=True, device_st=True)
    jds, ds = jrhd.load(rhd_root, mode=mode, **kw), rhd.load(rhd_root, mode=mode, **kw)
    shuffle = mode == "training"
    jimage, jtarget = list(jcommon.batches(jds, B, shuffle=shuffle, seed=7, pad_remainder=True,
                                           to_device=False))[which]
    image, target = list(common.prefetch(common.batches(ds, B, shuffle=shuffle, seed=7,
                                                        pad_remainder=True, device="cpu")))[which]
    assert image.dtype == torch.uint8 and "st" not in target
    np.testing.assert_array_equal(image.numpy(), jimage)
    for k, v in jtarget.items():
        np.testing.assert_array_equal(target[k].numpy(), v, err_msg=k)
    return (jnp.asarray(jimage), {k: jnp.asarray(v) for k, v in jtarget.items()}), (image, target)


def test_prep_batch_matches_jax(rhd_root):
    (jimage, jtarget), (image, target) = _batch(rhd_root, "training")
    jimg, jt = jengine._prep_batch(jimage, jtarget)
    img, t = engine._prep_batch(image, target)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    _close(t["st"].numpy(), jt["st"], 1e-5, "st")


def test_train_step_on_a_loader_batch_matches_jax(rhd_root, model):
    """One JAX make_train_step step and one port step from the same state
    on the first shuffled train batch: the pre-update loss and aux terms,
    and the running statistics the step leaves."""
    jcfg, cfg, params, stats = model
    (jimage, jtarget), (image, target) = _batch(rhd_root, "training")
    optimizer = jengine.make_optimizer(1e-6, [5], steps_per_epoch=2)
    state = jengine.TrainState(params, stats, optimizer.init(params), jnp.zeros((), jnp.int32))
    step = jengine.make_train_step(jmano.synthetic_mano_model(0), jcfg, optimizer,
                                   mesh_lib.make_mesh(n_devices=1))
    key = jax.random.key(21)
    new_state, jaux = step(state, jimage, jtarget, key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (NT * B, 45))))
    net = _net(cfg, params, stats).train()
    opt = engine.make_optimizer(net, 1e-6, [5], steps_per_epoch=2)
    aux = engine.make_train_step(mano.synthetic_mano_model(0), net, opt)(image, target, noise)
    for k in ("loss", "th_norm", "bt_norm", "h_q", "q_log_p"):
        _close(float(aux[k]), float(jaux[k]), TOL, k)
    want = from_jax(jax.tree.map(np.asarray, new_state.params),
                    jax.tree.map(np.asarray, new_state.batch_stats))
    for name, t in net.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            _close(t.numpy(), want[name], TOL, name)


def test_eval_step_on_a_loader_batch_matches_jax(rhd_root, model):
    """The eval split's padded tail batch (3 items, B = 2: valid [1, 0])
    through both eval steps, and the hypotheses of sample_hypotheses on it
    (xyz and verts bone-normalised, and xyz in mm by the batch's bone)."""
    jcfg, cfg, params, stats = model
    (jimage, jtarget), (image, target) = _batch(rhd_root, "evaluation", which=-1)
    assert target["valid"].tolist() == [1.0, 0.0]
    key = jax.random.key(6)
    jstep = jengine.make_eval_step(jmano.synthetic_mano_model(0), jcfg,
                                   mesh_lib.make_mesh(n_devices=1), N, TEMP)
    ref = jax.device_get(jstep(params, stats, jimage, jtarget, key))
    k_kld, k_hypo = jax.random.split(key)
    kld = torch.from_numpy(np.array(jax.random.normal(k_kld, (NT * B, 45))))
    hypo = torch.from_numpy(np.array(jax.random.normal(k_hypo, (N * B, 45)) * TEMP))
    net = _net(cfg, params, stats).eval()
    model_t = mano.synthetic_mano_model(0)
    got = engine.make_eval_step(model_t, net, N, TEMP)(image, target, kld, hypo)
    assert set(got) == set(ref)
    for k in ref:
        assert np.isfinite(float(got[k])), k
        _close(float(got[k]), float(ref[k]), TOL, k)

    jimg = jengine._prep_image(jimage, jtarget)
    jout = jax.jit(lambda p, s, img: jmhent.sample_hypotheses(
        jmano.synthetic_mano_model(0), p, s, jcfg, img, k_hypo, n=N, temp=TEMP,
        mods=("xyz", "uv", "verts")))(params, stats, jimg)
    with torch.inference_mode():
        out = mhent.sample_hypotheses(model_t, net, engine._prep_image(image, target), n=N,
                                      temp=TEMP, mods=("xyz", "uv", "verts"), base_noise=hypo)
    for k in ("xyz", "verts"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=TOL, err_msg=k)
    bone_mm = target["scale"].numpy()[None, :, None] * 1000.0
    np.testing.assert_allclose(out["xyz"].numpy() * bone_mm, np.asarray(jout["xyz"]) * bone_mm,
                               atol=MM_TOL, err_msg="xyz in mm")
    np.testing.assert_allclose(out["uv"].numpy(), np.asarray(jout["uv"]), atol=TOL * IMG / 2)


def _tiny_yaml(tmp_path, root, epochs=1, extra=""):
    path = tmp_path / "tiny.yaml"
    path.write_text(
        f"model_dir: {tmp_path / 'ckpt'}/\n"
        "info_interval: 1\n"
        "dataset: {dataset_name: rhd, image_size: [256, 256]}\n"
        "network: {enc_type: MHEnt, num_latent: 16, backbone: resnet18, h_dims: [32, 32],\n"
        "          num_steps: 1}\n"
        f"training: {{mode: baseline_VAE, batch_size: 2, epochs: {epochs}, test_samples: 3,\n"
        "           seed: 1, n_train_hypotheses: 2}\n"
        f"tpu: {{compute_dtype: float32, data_dir: {root}{extra}}}\n")
    return path


def test_make_datasets_builds_the_jax_loaders(rhd_root, tmp_path):
    """The port's make_datasets and the JAX Experiment's on one YAML (with
    the sample and decode caches): the same loader classes and settings,
    the eval split behind a SampleCache, and equal items."""
    path = _tiny_yaml(tmp_path, rhd_root, extra=f", sample_cache: {tmp_path / 'sc'}, "
                                                f"decode_cache: {tmp_path / 'dc'}")
    exp = engine.Experiment(load_cfg(str(path)), device="cpu")
    jexp = jengine.Experiment(jconfig.update_cfg(str(path)))
    try:
        pairs = list(zip(exp.make_datasets(), jexp.make_datasets()))
    finally:
        jexp.close()
        common.set_decode_cache(None)
        jcommon.set_decode_cache(None)
    (train, jtrain), (evald, jevald) = pairs
    assert isinstance(evald, cached.SampleCache) and type(jevald).__name__ == "SampleCache"
    for ds, jds in pairs:
        for attr in ("mode", "heavy", "image_u8", "device_st", "prefix_cache", "size"):
            assert getattr(ds, attr) == getattr(jds, attr), attr
        assert len(ds) == len(jds) == engine._num_samples(ds)
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1].keys() == want[1].keys()
    assert train.heavy == frozenset() and train.prefix_cache == str(tmp_path / "sc")


def test_train_baseline_reads_data_dir(rhd_root, tmp_path, capsys):
    """run.py on a tiny YAML with tpu.data_dir at the fixture: the initial
    eval, ceil(3 / 2) = 2 train steps a epoch (the tail padded), the eval,
    and checkpoints in the reference's schema that reload."""
    path = _tiny_yaml(tmp_path, rhd_root)
    summary = run.main(["--cfg", str(path), "--device", "cpu"])
    assert summary and all(np.isfinite(v) for v in summary.values())
    log = capsys.readouterr().out
    assert log.count("Epoch:0| eval_3d_rgb:") == 2 and "Epoch:0| Step:1| Avg_Loss:" in log
    ckpt = torch.load(tmp_path / "ckpt" / "baseline_final.pth", map_location="cpu")
    assert set(ckpt) == {"encoderRGB", "optimizer", "step"} and ckpt["step"] == 2
    assert (tmp_path / "ckpt" / "baseline_mano_0.pth").is_file()
    cfg = load_cfg(str(path))
    net = mhent.init(engine.build_model_config(cfg), seed=9)
    engine.Experiment._restore(net, str(tmp_path / "ckpt" / "baseline_final.pth"))
    for k, v in net.state_dict().items():
        assert torch.equal(v, ckpt["encoderRGB"][k]), k


@pytest.mark.parametrize("output_3d,root_idx,ds_type,normalized",
                         [(False, None, "human", True), (False, None, "hand", False),
                          (True, 12, "human", True), (True, None, "hand", False)])
def test_calc_coord_accuracy_matches_jax(output_3d, root_idx, ds_type, normalized):
    """Host float64 on both sides: equal, from numpy or CPU tensors."""
    rng = np.random.RandomState(3)
    d = 3 if output_3d else 2
    target = {"pose3d": rng.uniform(-0.5, 0.5, (6, 63)).astype(np.float32),
              "crop_uv": rng.uniform(-0.5, 0.5, (6, 42)).astype(np.float32),
              "target_uv_weight": (rng.rand(6, 21) > 0.2).astype(np.float32)}
    key = "pose3d" if output_3d else "crop_uv"
    if normalized:
        coords = target[key] + rng.randn(*target[key].shape).astype(np.float32) * 0.02 * d
    else:  # coords in heatmap units; 3D labels too (2D labels are always scaled)
        px = (target[key].reshape(6, 21, d) + 0.5) * np.array([64.0, 48.0, 64.0])[:d]
        if output_3d:
            target[key] = px.reshape(6, -1).astype(np.float32)
        coords = (px + rng.randn(*px.shape)).reshape(6, -1).astype(np.float32)
    kw = dict(output_3d=output_3d, root_idx=root_idx, ds_type=ds_type,
              output_normalized=normalized)
    want = jmetrics.calc_coord_accuracy(coords, dict(target), **kw)
    assert 0.0 < want <= 1.0
    assert metrics.calc_coord_accuracy(coords, dict(target), **kw) == want
    assert metrics.calc_coord_accuracy(
        torch.from_numpy(coords), {k: torch.from_numpy(v) for k, v in target.items()},
        **kw) == want


def test_evaluate_map_refuses_without_pycocotools(monkeypatch):
    monkeypatch.setitem(sys.modules, "pycocotools", None)
    with pytest.raises(ImportError, match="pycocotools"):
        metrics.evaluate_map("res.json", "ann.json")
