"""The port's RLE mode (models/rle.py and the non-integrated Experiment)
against the JAX package's.

resnet18 at 64 px, B = 2, the per-joint RealNVP (dim 3, 21 joints, h 32, 2
steps, tsfm_on 'x', nf_res 'rle', K1 = 10) at O(1) flow weights and random
BN statistics; weights move with `convert.rle_from_jax`, the JAX draws
(the smoothing noise and the K1 tempered base draws, split from its key as
`rle.loss_and_predict` splits it) are handed to the port. Tolerances:

* eval mode: 1e-4 of the largest value, the flows' and the encoder's
  budget;
* train mode: both frameworks normalise with flax's fast variance
  E[x^2] - E[x]^2 in f32 (tests/test_torch_train.py says why that rounds
  badly). At B = 2 the last stage holds 8 values a channel: measured, the
  JAX f32 mu / logvar lie 1.9e-4 of their largest value from a float64
  evaluation of the same net, the port's 3.5e-6. So the port is held to
  its own float64 evaluation within 1e-4 / 4 (the rule of
  tests/test_torch_train.py for resnet18 at 64 px) and to JAX within 5e-4
  (the draws, which scale by exp(logvar / 2), measured 1.3e-4); the
  running statistics to JAX within 1e-4;
* log p sums 21 rows, so the rows are also compared one by one on the
  same (mu, logvar), within 1e-4;
* two train steps at lr 1e-6 (where the loss moves smoothly, as in
  tests/test_torch_train.py): loss and sigma_i within 1e-3 relative a step,
  parameters within 2 lr per step taken and at least 70 % of their
  elements within 1e-2 lr, the running statistics within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.data import synthetic as jsynthetic
from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models import rle as jrle
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu.parallel import mesh as mesh_lib
from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu_torch import run
from mhentropy_tpu_torch.convert import rle_from_jax
from mhentropy_tpu_torch.flows import realnvp
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import rle, stem_cuda
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.utils.config import load_cfg
from tools.convert_torch import load_rle_checkpoint
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

IMG, B, LR = 64, 2, 1e-6
FLOW = dict(dim=3, h_dim=32, num_steps=2, joint_n=21, tsfm_on="x")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())), err_msg=name)


def _configs(k1=10):
    enc = dict(backbone="resnet18", n_latent=(63, 63), dtype="float32")
    jcfg = jrle.RLEConfig(encoder=JEncoderConfig(**enc), flow=JRealNVPConfig(**FLOW), pe="3d",
                          k1=k1, nf_res="rle", image_size=IMG)
    cfg = rle.RLEConfig(encoder=EncoderConfig(**enc), flow=RealNVPConfig(**FLOW), pe="3d",
                        k1=k1, nf_res="rle", image_size=IMG)
    return jcfg, cfg


def _port_net(cfg, params, stats):
    net = rle.RLE(cfg)
    rle.load_checkpoint(net, rle_from_jax(jax.tree.map(np.asarray, params),
                                          jax.tree.map(np.asarray, stats)))
    return net


def _draws(key, target, cfg):
    """The two draws JAX's loss_and_predict makes from `key`."""
    k_noise, k_sample = jax.random.split(key)
    pose = target["pose3d"]
    rows = pose.shape[0] * pose.shape[1] // cfg.flow.dim
    noise = jax.random.normal(k_noise, pose.shape)
    base = jnp.stack([jax.random.normal(jax.random.fold_in(k_sample, i), (rows, cfg.flow.dim))
                      * cfg.sample_temp for i in range(cfg.k1)])
    return _t(noise), _t(base)


@pytest.fixture(scope="module")
def setup():
    """JAX params with an O(1) flow and random BN statistics, a synthetic
    batch of 2 and its targets (valid marks the second image as padding)."""
    jcfg, cfg = _configs()
    params, stats = jrle.init(jax.random.key(0), jcfg)
    rng = np.random.RandomState(1)
    flow = params["p_nf"]
    params = dict(params, p_nf=flow._replace(**{
        n: (rng.uniform(-1, 1, v.shape) / np.sqrt(v.shape[-2] if v.ndim == 3 else v.shape[-1]))
        .astype(np.float32)
        for n, v in flow._asdict().items() if hasattr(v, "shape") and n != "masks"}))
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(lambda v: (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32), stats)
    data = jsynthetic.make_dataset(jmano.synthetic_mano_model(0), n=B, image_size=IMG, seed=2,
                                   ds="rhd")
    return jcfg, cfg, params, stats, data


OUTPUTS = ("log_p", "log_phi", "log_q", "pose_rgb_sample", "pose_rgb_mu", "pred_jts", "sigma_i",
           "xyz")


@pytest.mark.parametrize("train", [False, True])
def test_loss_and_predict_matches_jax(setup, train):
    jcfg, cfg, params, stats, data = setup
    image = data.images[:B]
    jy = {k: jnp.asarray(v) for k, v in data.targets.items()}
    key = jax.random.key(3)
    out, new_stats = jrle.loss_and_predict(params, stats, jcfg, jnp.asarray(image), jy, key,
                                           train=train)
    net = _port_net(cfg, params, stats).train(train)
    y = {k: _t(v) for k, v in data.targets.items()}
    noise, base = _draws(key, jy, jcfg)
    got = rle.loss_and_predict(net, _t(image), y, noise=noise, base_noise=base, train=train)
    for k in OUTPUTS:
        _close(got[k].detach().numpy(), out[k], 5e-4 if train else 1e-4, k)
    assert got["xyz"].shape == (10, B, 63) and not got["xyz"].requires_grad
    assert got["log_p"].requires_grad
    if train:
        sd = net.encoderRGB.state_dict()
        want = rle_from_jax(params, jax.tree.map(np.asarray, new_stats))["encoderRGB"]
        keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(keys) == 40
        for k in keys:
            _close(sd[k].numpy(), want[k], 1e-4, k)
        net64 = _port_net(cfg, params, stats).train().double()
        net64.encoderRGB.res.dtype = torch.float64
        want64 = rle.loss_and_predict(net64, _t(image).double(),
                                      {k: v.double() for k, v in y.items()}, noise=noise.double(),
                                      base_noise=base.double(), train=True)
        for k in OUTPUTS:
            _close(got[k].detach().numpy(), want64[k].detach().numpy(), 1e-4 / 4, f"{k} f64")

    # Row by row on the same (mu, logvar): 21 rows an image, none averaged
    # away.
    _, mu, logvar, _ = jrle._encode(params, stats, jcfg, jnp.asarray(image), train)
    with torch.no_grad():
        mu_t, logvar_t = rle._encode(net.train(train), _t(image), train)
    _close(mu_t.numpy(), mu, 5e-4 if train else 1e-4, "mu")
    _close(logvar_t.numpy(), logvar, 5e-4 if train else 1e-4, "logvar")
    tld = np.asarray(jy["pose3d"] + noise.numpy() * 1e-4).reshape(-1, 3)
    rows = jrealnvp.log_prob(params["p_nf"], jcfg.flow, jnp.asarray(tld),
                             mu=mu.reshape(-1, 3), logvar=logvar.reshape(-1, 3))
    with torch.no_grad():
        rows_t = realnvp.log_prob(net.p_nf, _t(tld), mu=_t(mu).reshape(-1, 3),
                                  logvar=_t(logvar).reshape(-1, 3))
    assert rows_t.shape == (B * 21,)
    _close(rows_t.numpy(), rows, 1e-4, "log p per row")
    with pytest.raises(ValueError, match="net.eval" if not train else "net.train"):
        rle.loss_and_predict(net.train(not train), _t(image), y, noise=noise, base_noise=base,
                             train=train)


def test_log_q_needs_the_actnorm_mode(setup):
    _, cfg, params, stats, data = setup
    net = rle.RLE(cfg._replace(flow=cfg.flow._replace(tsfm_on="z"))).eval()
    with pytest.raises(NotImplementedError, match="tsfm_on='x'"):
        rle.loss_and_predict(net, _t(data.images[:B]), {k: _t(v) for k, v in
                                                         data.targets.items()})


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Two JAX make_rle_train_step steps on a one-device mesh, the second
    image marked as padding: the states (numpy), aux and keys."""
    jcfg, _, params, stats, data = setup
    optimizer = jengine.make_optimizer(LR, [1], steps_per_epoch=1)
    state = jengine.TrainState(params, stats, optimizer.init(params), jnp.zeros((), jnp.int32))
    step = jengine.make_rle_train_step(jcfg, optimizer, mesh_lib.make_mesh(n_devices=1))
    y = {k: jnp.asarray(v) for k, v in data.targets.items()}
    y["valid"] = jnp.asarray([1.0, 0.0])
    keys = [jax.random.key(30 + i) for i in range(2)]
    states, auxes = [jax.tree.map(np.asarray, state)], []
    for k in keys:
        state, aux = step(state, jnp.asarray(data.images[:B]), y, k)
        states.append(jax.tree.map(np.asarray, state))
        auxes.append(jax.device_get(aux))
    return states, auxes, keys, y


def test_train_steps_match_jax(setup, jax_steps):
    """Two steps from one init (the second at lr 0.1 x: milestone 1 at one
    step an epoch) against make_rle_train_step: loss, sigma_i, the
    parameters after Adam and the running statistics."""
    jcfg, cfg, _, _, data = setup
    states, jauxes, keys, jy = jax_steps
    net = _port_net(cfg, states[0].params, states[0].batch_stats).train()
    opt = engine.make_optimizer(net, LR, [1], steps_per_epoch=1)
    step = engine.make_rle_train_step(net, opt)
    y = {k: _t(v) for k, v in data.targets.items()}
    y["valid"] = torch.tensor([1.0, 0.0])
    for i, k in enumerate(keys):
        aux = step(_t(data.images[:B]), y, *_draws(k, jy, jcfg))
        for name in ("loss", "sigma_i"):
            _close(float(aux[name]), jauxes[i][name], 1e-3, f"{name} at step {i}")
    assert opt.count == 2 and opt.lr_at(1) == pytest.approx(LR * 0.1)
    want = rle_from_jax(states[2].params, states[2].batch_stats)
    agree = total = 0
    for mod in ("encoderRGB", "p_nf"):
        for name, t in getattr(net, mod).state_dict().items():
            if name.endswith("num_batches_tracked") or name == "mask":
                continue
            w = np.asarray(want[mod][name])
            if name.endswith(("running_mean", "running_var")):
                _close(t.numpy(), w, 1e-3, name)
                continue
            diff = np.abs(t.numpy() - w)
            assert diff.max() <= 2 * LR * 2, (mod, name, diff.max())
            agree += int((diff <= 1e-2 * LR).sum())
            total += diff.size
    assert agree >= 0.7 * total, agree / total


def test_eval_step_metrics_match_jax(setup):
    """One make_rle_eval_step batch (valid masking the padded image): every
    metric, loss_total and sigma_i."""
    jcfg, cfg, params, stats, data = setup
    jy = {k: jnp.asarray(v) for k, v in data.targets.items()}
    jy["valid"] = jnp.asarray([1.0, 0.0])
    key = jax.random.key(40)
    want = jax.device_get(jengine.make_rle_eval_step(jcfg, mesh_lib.make_mesh(n_devices=1))(
        params, stats, jnp.asarray(data.images[:B]), jy, key))
    net = _port_net(cfg, params, stats).eval()
    y = {k: _t(v) for k, v in data.targets.items()}
    y["valid"] = torch.tensor([1.0, 0.0])
    got = engine.make_rle_eval_step(net)(_t(data.images[:B]), y, *_draws(key, jy, jcfg))
    assert set(got) == set(want) and "sigma_i" in got and "n_valid" in got
    for k, v in want.items():
        _close(float(got[k]), v, 1e-4, k)


def test_best_hypothesis_uvd_matches_jax():
    rng = np.random.RandomState(0)
    k1, b = 3, 2
    samples = (rng.randn(k1, b, 51) * 0.1).astype(np.float32)
    target = {"pose3d": samples[1], "pose3d_root": rng.uniform(2, 4, (b, 3)).astype(np.float32),
              "st_cam": np.tile(np.array([500.0, 500.0, 128.0, 128.0], np.float32), (b, 1))}
    want = jrle.best_hypothesis_uvd(jnp.asarray(samples),
                                    {k: jnp.asarray(v) for k, v in target.items()})
    got = rle.best_hypothesis_uvd(_t(samples), {k: _t(v) for k, v in target.items()})
    assert got.shape == (b, 51)
    _close(got.numpy(), want, 1e-5)
    # The chosen draw is the GT one: depth = its relative z / 2.
    np.testing.assert_allclose(got.numpy().reshape(b, -1, 3)[..., 2],
                               samples[1].reshape(b, -1, 3)[..., 2] / 2.0, atol=1e-6)


def test_eval_refreshes_the_folded_kernel_weights(tmp_path):
    """Training moves the weights; the eval that follows folds the stem's
    and stage 1's BN again (the kernels' copies), so it never runs the
    weights of the eval before."""
    from mhentropy_tpu_torch.data import synthetic

    cfg = load_cfg("configs/smoke_rle.yaml")
    cfg.model_dir = str(tmp_path) + "/"
    cfg.training.batch_size = 2
    cfg.training.seed = 3
    exp = engine.Experiment(cfg, device="cpu")
    assert exp.masters and isinstance(exp.net, rle.RLE)
    res = exp.net.encoderRGB.res

    def folded_now():
        return stem_cuda.fold(res.conv1.weight, res.bn1.weight, res.bn1.bias,
                              res.bn1.running_mean, res.bn1.running_var, res.bn1.eps)[0]

    data = synthetic.make_dataset(exp.model, n=2, image_size=64, seed=4, ds="rhd")
    image, target = next(synthetic.batches(data, 2))
    exp._ensure_state(1)
    exp.net.train()
    exp._train_step(image, target, *exp._draws(target, 2))
    assert not torch.equal(res.folded[0][0], folded_now())
    exp.eval_loop(data)
    assert torch.equal(res.folded[0][0], folded_now())


def test_run_cli_trains_rle_and_its_checkpoint_loads_in_jax(tmp_path, capsys):
    """`run --device cpu` on a tiny RLE YAML trains and writes .pth files in
    the reference's RLE schema; tools/convert_torch.load_rle_checkpoint
    reads the final one into the JAX package, which gives the port's log p
    on the same batch and noise."""
    path = tmp_path / "tiny_rle.yaml"
    model_dir = tmp_path / "ckpt"
    path.write_text(
        f"model_dir: {model_dir}/\n"
        "info_interval: 1\n"
        "dataset: {dataset_name: rhd, image_size: [32, 32], pe: 3d}\n"
        "network: {enc_type: BasicEnc, num_latent: 63, backbone: resnet18, decoder_type: id,\n"
        "          p_nf: realnvp, p_nf_dim: 3, tsfm_on: x, h_dims: [16, 16], num_steps: 1,\n"
        "          nf_res: rle}\n"
        "training: {mode: baseline_VAE, batch_size: 8, epochs: 1, test_samples: 1, seed: 1,\n"
        "           lr: 0.001, milestones: [5]}\n"
        "tpu: {compute_dtype: float32}\n")
    summary = run.main(["--cfg", str(path), "--device", "cpu"])
    assert np.isfinite(summary["eucLoss_3d_rgb_sample"]) and np.isfinite(summary["sigma_i"])
    log = capsys.readouterr().out
    assert "Epoch:0| Step:0| Avg_Loss:" in log and "sigma_i:" in log and "h_q:" not in log
    ckpt_path = model_dir / "baseline_final.pth"
    assert (model_dir / "baseline_id_0.pth").is_file()
    ckpt = torch.load(ckpt_path, map_location="cpu")
    assert set(ckpt) == {"encoderRGB", "p_nf", "optimizer", "step"} and ckpt["step"] == 4

    cfg = load_cfg(str(path))
    port_cfg = engine.build_rle_config(cfg)
    net = rle.init(port_cfg, seed=7)
    engine.Experiment._restore(net, str(ckpt_path))
    net.eval()
    jcfg = jrle.RLEConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(63, 63), dtype="float32"),
        flow=JRealNVPConfig(dim=3, h_dim=16, num_steps=1, joint_n=21, tsfm_on="x"), pe="3d",
        nf_res="rle", image_size=32)
    jparams = load_rle_checkpoint(str(ckpt_path), jcfg)
    jstats = jparams.pop("_batch_stats")
    data = jsynthetic.make_dataset(jmano.synthetic_mano_model(0), n=2, image_size=32, seed=5,
                                   ds="rhd")
    jy = {k: jnp.asarray(v) for k, v in data.targets.items()}
    key = jax.random.key(6)
    want, _ = jrle.loss_and_predict(jparams, jstats, jcfg, jnp.asarray(data.images), jy, key,
                                    train=False)
    got = rle.loss_and_predict(net, _t(data.images), {k: _t(v) for k, v in data.targets.items()},
                               *_draws(key, jy, jcfg))
    _close(got["log_p"].detach().numpy(), want["log_p"], 1e-4, "log_p")
    _close(got["xyz"].numpy(), want["xyz"], 1e-4, "xyz")
    # And back: the converted JAX params give the checkpoint's tensors.
    back = rle_from_jax(jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, jstats))
    for mod in ("encoderRGB", "p_nf"):
        for k, v in back[mod].items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, ckpt[mod][k]), (mod, k)
