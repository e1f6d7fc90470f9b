"""The port's eval step and its parts against the JAX package's.

Inputs come from numpy seeds or from JAX's own draws; weights move with
`from_jax` / `qtree_from_jax`. Tolerances:

* compute_st, the priors, forward_log_p and mhent_metrics: 1e-5 relative,
  the same f32 formulas;
* reverse_kld: 1e-4 relative, its log p sums Laplace terms of decoded
  keypoints that agree within 1e-4;
* the synthetic dataset: 1e-4, the two MANO decodes agree to f32
  reassociation;
* the whole eval step: every metric within 1e-4 relative (float) and 1e-3
  relative (int8: a quantised activation within an ulp of a rounding
  boundary may land on the neighbouring integer, which moves a hypothesis
  slightly; the metrics are minima, maxima and means over hypotheses).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import camera as jcamera
from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.data import synthetic as jsynthetic
from mhentropy_tpu.flows import priors as jpriors
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models import quant as jquant
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu.parallel import mesh as mesh_lib
from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.train import metrics as jmetrics
from mhentropy_tpu_torch import run
from mhentropy_tpu_torch.convert import from_jax, qtree_from_jax
from mhentropy_tpu_torch.core import camera, mano
from mhentropy_tpu_torch.data import synthetic
from mhentropy_tpu_torch.flows import priors
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent, quant
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.train import engine, metrics

B, N, IMG, TEMP = 2, 4, 64, 0.8


def _t(a):
    return torch.from_numpy(np.array(a))


def _target(t):
    return {k: _t(v) for k, v in t.items()}


def _close(got, want, rel, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(scope="module")
def setup():
    """resnet50 at 64 px, flow h = 32 with 2 steps, 3 hypotheses for the
    reverse-KL draw; non-default BN stats and an O(1) flow."""
    jcfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2),
        feat_dim=32, image_size=IMG, n_train_hypotheses=3)
    params, stats = jmhent.init(jax.random.key(0), jcfg)
    rng = np.random.RandomState(1)
    stats = jax.tree.map(lambda v: (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32), stats)
    flow = params["flow"]
    fields = {n: (rng.uniform(-1, 1, v.shape) / np.sqrt(v.shape[-2] if v.ndim == 3
                                                       else v.shape[-1])).astype(np.float32)
              for n, v in flow._asdict().items() if hasattr(v, "shape") and n != "masks"}
    params = jax.tree.map(np.asarray, dict(params, flow=flow._replace(**fields)))
    jmodel = jmano.synthetic_mano_model(0)
    data = jsynthetic.make_dataset(jmodel, n=B, image_size=IMG, seed=0)
    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2),
        feat_dim=32, image_size=IMG, n_train_hypotheses=3)
    net = mhent.MHEnt(cfg)
    net.load_state_dict(from_jax(params, stats), strict=True)
    return jcfg, params, stats, jmodel, data, net.eval(), mano.synthetic_mano_model(0)


def test_compute_st_matches_jax():
    rng = np.random.RandomState(0)
    pose = rng.randn(5, 21, 3).astype(np.float32)
    uv = (pose[..., :2] * 0.3 + 0.1 + rng.randn(5, 21, 2) * 0.01).astype(np.float32)
    ref = np.asarray(jcamera.compute_st(jnp.asarray(pose), jnp.asarray(uv)))
    _close(camera.compute_st(_t(pose), _t(uv)).numpy(), ref, 1e-5)


def test_priors_match_jax():
    rng = np.random.RandomState(1)
    x3 = (rng.randn(64, 3) * 3).astype(np.float32)
    x45 = (rng.randn(64, 45) * 2).astype(np.float32)
    for jp, p, x in (
            (jpriors.ApproxUniform(-2.0, 2.0, alpha=50.0),
             priors.ApproxUniform(-2.0, 2.0, alpha=50.0), x45),
            (jpriors.ApproxUniform(jnp.zeros(3), np.pi, alpha=5.0, sup="ball"),
             priors.ApproxUniform(torch.zeros(3), np.pi, alpha=5.0, sup="ball"), x3)):
        _close(p.log_prob(_t(x)).numpy(), jp.log_prob(jnp.asarray(x)), 1e-5)
    mu = rng.randn(6, 42).astype(np.float32)
    obs = mu + (rng.randn(6, 42) * 0.05).astype(np.float32)
    w = rng.randint(0, 3, (6, 42)).astype(np.float32)
    ref = jpriors.laplace_deadzone_log_prob(jnp.asarray(obs), jnp.asarray(mu), 0.03,
                                            weights=jnp.asarray(w))
    _close(priors.laplace_deadzone_log_prob(_t(obs), _t(mu), 0.03, weights=_t(w)).numpy(),
           ref, 1e-5)
    # Samples stay in the support (ball of radius pi; box [-0.03, 0.03]).
    g = torch.Generator().manual_seed(0)
    ball = priors.ApproxUniform(torch.zeros(3), np.pi, sup="ball").sample((100,), g)
    assert ball.shape == (100, 3) and float(ball.norm(dim=-1).max()) <= np.pi + 1e-5
    box = priors.ApproxUniform(-0.03, 0.03).sample((100, 10), g)
    assert float(box.abs().max()) <= 0.03


@pytest.mark.parametrize("mods", [("uv",), ("uv", "xyz")])
def test_forward_log_p_matches_jax(setup, mods):
    jcfg, _, _, jmodel, data, net, model = setup
    rng = np.random.RandomState(2)
    z = np.concatenate([rng.randn(3 * B, 48) * 0.4, rng.randn(3 * B, 10) * 0.02,
                        rng.randn(3 * B, 1) * 0.1 - 1.0, rng.randn(3 * B, 2) * 0.1],
                       axis=1).astype(np.float32)
    y = {k: data.targets[k] for k in ("crop_uv", "pose3d", "vis")}
    ref = jmhent.forward_log_p(jmodel, jcfg, jnp.asarray(z), {k: jnp.asarray(v)
                                                             for k, v in y.items()}, mods=mods)
    got = mhent.forward_log_p(model, net.cfg, _t(z), _target(y), mods=mods)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k].numpy(), ref[k], 1e-5, k)


def test_reverse_kld_matches_jax(setup):
    jcfg, params, stats, jmodel, data, net, model = setup
    image = data.images[:B]
    y = {k: jnp.asarray(v) for k, v in data.targets.items()}
    key = jax.random.key(4)
    ref, _ = jmhent.reverse_kld(jmodel, params, stats, jcfg, y, jnp.asarray(image), key,
                                train=False)
    noise = np.array(jax.random.normal(key, (3 * B, 45)))
    with torch.inference_mode():
        got = mhent.reverse_kld(model, net, _target(data.targets), _t(image),
                                base_noise=_t(noise))
    for k in ("log_p", "q_log_p_z_giv_y", "h_q_z_giv_i", "th_norm", "bt_norm"):
        _close(got[k].numpy(), ref[k], 1e-4, k)
    # train=True: batch-statistics BN, the net in train mode. 1e-2: with two
    # images, resnet50's last stage normalises 8 rows a channel, where the
    # f32 rounding of flax's fast variance dominates (the JAX f32 features
    # lie 3.4e-3 from a float64 evaluation here) and the 0.03 Laplace scale
    # of log p amplifies it (tests/test_torch_train.py holds the train path
    # tightly at better-conditioned sizes).
    ref, _ = jmhent.reverse_kld(jmodel, params, stats, jcfg, y, jnp.asarray(image), key,
                                train=True)
    train_net = copy.deepcopy(net).train()
    got = mhent.reverse_kld(model, train_net, _target(data.targets), _t(image),
                            base_noise=_t(noise), train=True)
    for k in ("log_p", "q_log_p_z_giv_y", "h_q_z_giv_i"):
        _close(got[k].detach().numpy(), ref[k], 1e-2, k)
    with pytest.raises(ValueError, match="net.train"):
        mhent.reverse_kld(model, net, _target(data.targets), _t(image), train=True)


@pytest.mark.parametrize("with_valid", [False, True])
def test_mhent_metrics_match_jax(with_valid):
    rng = np.random.RandomState(3)
    n, b = 5, 3
    out = {"log_p": rng.randn(b).astype(np.float32) * 10,
           "xyz": rng.randn(n, b, 63).astype(np.float32),
           "uv": (rng.rand(n, b, 42) * 64).astype(np.float32)}
    tg = {"pose3d": rng.randn(b, 63).astype(np.float32),
          "crop_uv": (rng.rand(b, 42) * 2 - 1).astype(np.float32),
          "vis": rng.randint(0, 3, (b, 21)).astype(np.float32),
          "scale": (rng.rand(b) * 0.1 + 0.05).astype(np.float32),
          "st": rng.randn(b, 3).astype(np.float32)}
    if with_valid:
        tg["valid"] = np.array([1, 1, 0], np.float32)
    total, losses, mets = jmetrics.mhent_metrics(
        {k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in tg.items()},
        image_size=64)
    g_total, g_losses, g_mets = metrics.mhent_metrics(_target(out), _target(tg), image_size=64)
    assert set(g_mets) == set(mets) and ("n_valid" in g_mets) == with_valid
    _close(g_total.item(), total, 1e-5, "total")
    for k in mets:
        _close(g_mets[k].numpy(), mets[k], 1e-5, k)


def test_synthetic_dataset_matches_jax():
    jdata = jsynthetic.make_dataset(jmano.synthetic_mano_model(0), n=3, image_size=32, seed=5)
    data = synthetic.make_dataset(mano.synthetic_mano_model(0), n=3, image_size=32, seed=5)
    assert set(data.targets) == set(jdata.targets)
    np.testing.assert_allclose(data.images, jdata.images, atol=1e-4)
    for k, v in jdata.targets.items():
        np.testing.assert_allclose(data.targets[k], np.asarray(v), atol=1e-4, err_msg=k)
    batches = list(synthetic.batches(data, 2, pad_remainder=True))
    assert len(batches) == 2 and batches[1][1]["valid"].tolist() == [1.0, 0.0]


def _metric_check(got, ref, rel):
    assert set(got) == set(ref)
    for k in ref:
        assert np.isfinite(float(got[k])), k
        _close(float(got[k]), float(ref[k]), rel, k)


@pytest.mark.parametrize("int8", [False, True])
def test_eval_step_matches_jax(setup, int8):
    """JAX make_eval_step on a one-device CPU mesh against the port's.
    int8: q_from = 1 and the int8 sampler on the same carried qtree, with
    the second image marked as padding."""
    jcfg, params, stats, jmodel, data, net, model = setup
    image = data.images[:B]
    y = dict(data.targets)
    if int8:
        y["valid"] = np.array([1.0, 0.0], np.float32)
    jy = {k: jnp.asarray(v) for k, v in y.items()}
    key = jax.random.key(6)
    mesh = mesh_lib.make_mesh(n_devices=1)
    qargs, spec, qtree = (), None, None
    if int8:
        jspec = jquant.QuantSpec(backbone="resnet50", q_from=1, dtype="float32",
                                 int8_sampler=True)
        act = jquant.calibrate(jspec, params["encoder"]["backbone"], stats, jnp.asarray(image))
        jqt = jquant.prepare(jspec, params["encoder"]["backbone"], stats, act)
        jspec, jqt = jquant.quantize_sampler_into(jspec, jqt, params, jcfg.flow,
                                                  jnp.asarray(image), temp=TEMP)
        qargs = (jqt,)
        spec = quant.QuantSpec(backbone="resnet50", q_from=1, dtype="float32",
                               int8_sampler=True)
        qtree = qtree_from_jax(spec, jax.tree.map(np.asarray, jqt))
    jstep = jengine.make_eval_step(jmodel, jcfg, mesh, N, TEMP,
                                   quant_spec=jspec if int8 else None)
    ref = jax.device_get(jstep(params, stats, jnp.asarray(image), jy, key, *qargs))
    k_kld, k_hypo = jax.random.split(key)
    kld = np.array(jax.random.normal(k_kld, (3 * B, 45)))
    hypo = np.array(jax.random.normal(k_hypo, (N * B, 45)) * TEMP)

    step = engine.make_eval_step(model, net, N, TEMP, quant_spec=spec)
    got = step(_t(image), _target(y), _t(kld), _t(hypo), qtree)
    _metric_check(got, ref, 1e-3 if int8 else 1e-4)


def test_float_eval_step_runs_the_encoder_once(setup, monkeypatch):
    """The float eval step computes the conditioning feature once and hands
    it to both the reverse-KL term and the draw: one encoder forward and one
    `extract_feat` a batch, and its metrics equal those of the two terms
    each computing their own feature."""
    jcfg, params, stats, jmodel, data, net, model = setup
    rng = np.random.RandomState(3)
    image, y = _t(data.images[:B]), _target(dict(data.targets))
    kld = _t(rng.randn(3 * B, 45).astype(np.float32))
    hypo = _t((rng.randn(N * B, 45) * TEMP).astype(np.float32))
    calls = {"extract_feat": 0, "forward": 0}
    extract = mhent.extract_feat

    def counted(*args, **kwargs):
        calls["extract_feat"] += 1
        return extract(*args, **kwargs)

    def hook(*_):
        calls["forward"] += 1

    monkeypatch.setattr(mhent, "extract_feat", counted)
    handle = net.feat_extractor.register_forward_hook(hook)
    try:
        got = engine.make_eval_step(model, net, N, TEMP)(image, y, kld, hypo)
    finally:
        handle.remove()
    assert calls == {"extract_feat": 1, "forward": 1}
    with torch.inference_mode():
        out = mhent.reverse_kld(model, net, y, image, base_noise=kld)
        samples = mhent.sample_hypotheses(model, net, image, n=N, temp=TEMP,
                                          mods=("xyz", "uv"), base_noise=hypo)
    total, _, mets = metrics.mhent_metrics({**samples, "log_p": out["log_p"]}, y,
                                           image_size=IMG)
    ref = {k: v.mean() for k, v in mets.items()}
    ref["loss_total"] = total
    _metric_check(got, ref, 1e-6)
    with pytest.raises(ValueError, match="int8 encoder"):
        mhent.sample_hypotheses(model, net, image, n=N, feat=torch.zeros(B, 32),
                                quant=(quant.QuantSpec(), {}))


def test_run_cli_evaluates_tiny_config_on_cpu(tmp_path, capsys):
    path = tmp_path / "tiny.yaml"
    path.write_text(
        "dataset: {dataset_name: ho3d, image_size: [32, 32]}\n"
        "network: {enc_type: MHEnt, num_latent: 16, backbone: resnet18, h_dims: [32, 32],\n"
        "          num_steps: 1}\n"
        "training: {mode: baseline_VAE, batch_size: 4, epochs: 0, test_samples: 3, seed: 1,\n"
        "           n_train_hypotheses: 2}\n"
        "tpu: {compute_dtype: float32, quantize_encoder: true}\n"
        f"model_dir: {tmp_path / 'eval'}/\n")
    summary = run.main(["--cfg", str(path), "--device", "cpu"])
    assert np.isfinite(summary["eucLoss_3d_rgb_sample"]) and "loss_total" in summary
    assert "Epoch:0| eval_3d_rgb:" in capsys.readouterr().out
    path.write_text(path.read_text().replace("epochs: 0", "epochs: 1")
                    .replace(f"{tmp_path / 'eval'}/", f"{tmp_path / 'ckpt'}/"))
    summary = run.main(["--cfg", str(path), "--device", "cpu"])
    assert np.isfinite(summary["eucLoss_3d_rgb_sample"])
    assert "Epoch:0| Step:0| Avg_Loss:" in capsys.readouterr().out
    assert (tmp_path / "ckpt" / "baseline_final.pth").is_file()


def test_experiment_refuses_what_is_not_ported(tmp_path, monkeypatch):
    cfg_text = ("dataset: {image_size: [32, 32]}\n"
                "network: {enc_type: MHEnt, num_latent: 16, h_dims: [32, 32],\n"
                "          num_steps: 1}\n"
                "training: {mode: eval, batch_size: 2, seed: 1, pth: some/orbax/dir}\n"
                "tpu: {compute_dtype: float32}\n"
                f"model_dir: {tmp_path / 'model'}/\n")
    path = tmp_path / "c.yaml"
    path.write_text(cfg_text)
    with pytest.raises(NotImplementedError, match="orbax"):
        run.main(["--cfg", str(path), "--device", "cpu"])
    path.write_text(cfg_text.replace("pth: some/orbax/dir", "pth: null")
                    .replace("compute_dtype: float32", "compute_dtype: float32, data_dir: /x"))
    # tpu.data_dir is read now: a directory that holds no dataset raises.
    with pytest.raises(FileNotFoundError, match="/x"):
        run.main(["--cfg", str(path), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--cfg", str(path)])
