"""The port's glow regressor (MHEnt with a ConditionalGlow over theta45)
and ProHMR's `nll_loss` against the JAX package's.

MHEnt: resnet18 at 32 px, feat 32, a two-layer Glow of hidden width 32,
dropout 0 (torch cannot replay jax.random's masks), B = 4, the MANO
stand-in and a synthetic batch, as tests/test_glow_rle.py's glow test;
weights move with `convert.from_jax`, which takes the Glow's per-step
list, and JAX's own base noise is handed to the port. reverse_kld in eval
and train mode, sample_hypotheses and log_q_z within 1e-4 of the largest
value (the flows' and the encoder's budget); the train-mode BN's batch
statistics round as in tests/test_torch_mhent_det.py, whose bounds (5e-4,
log p 1e-3 relative) the train-mode objective keeps. A glow MHEnt's
reference-schema .pth goes through tools/convert_torch.py's
`load_torch_checkpoint` back to the JAX params it came from, exactly.

ProHMR: tests/test_smpl_prohmr.py's nll_loss at its geometry (resnet18 at
32 px, the 256-vertex SMPL fixture, a two-layer H = 64 flow) with every
target. In eval mode (the JAX test's) the loss terms and every parameter's
gradient against jax.grad within 1e-4 of each tensor's largest entry. In
train mode (the mode plus one draw) the loss terms within 1e-3 relative,
the batch-statistics rule above; its backbone gradients are not compared:
at B = 2 the last stage's BN normalises two values a channel, and the
f32 rounding of the two frameworks' batch statistics moves them by
percents (measured 5.7 % of the largest conv1 gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.core import smpl as jsmpl
from mhentropy_tpu.data import synthetic as jsynthetic
from mhentropy_tpu.flows.glow import GlowConfig as JGlowConfig
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models import prohmr as jprohmr
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu_torch.convert import from_jax, prohmr_from_jax
from mhentropy_tpu_torch.core import mano, smpl
from mhentropy_tpu_torch.flows import cuda_glow_sampler, glow
from mhentropy_tpu_torch.flows.glow import GlowConfig
from mhentropy_tpu_torch.models import mhent, prohmr
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.train import engine
from tools.convert_torch import load_torch_checkpoint

IMG, B, N = 32, 4, 3
GLOW = dict(regressor="glow", feat_dim=32, image_size=IMG, n_train_hypotheses=2,
            glow_hidden=32, glow_layers=2, glow_dropout=0.0)
ENC = dict(backbone="resnet18", n_latent=(32, 32), dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=1e-4, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())), err_msg=name)


def _noise(key, rows):
    """The base noise JAX's glow draw takes from `key`."""
    return np.array(jax.random.normal(jax.random.split(key)[1], (rows, 45)))


@pytest.fixture(scope="module")
def setup():
    jcfg = jmhent.MHEntConfig(encoder=JEncoderConfig(**ENC), **GLOW)
    cfg = mhent.MHEntConfig(encoder=EncoderConfig(**ENC), **GLOW)
    params, stats = jmhent.init(jax.random.key(3), jcfg)
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    rng = np.random.RandomState(4)
    for layer in params["flow"]:  # O(1) flow weights, off the identity init
        layer["actnorm"] = {"log_scale": (rng.randn(45) * 0.2).astype(np.float32),
                            "shift": (rng.randn(45) * 0.3).astype(np.float32)}
        for blk in layer["coupling"]["blocks"]:
            blk["l1"] = {"w": (rng.randn(32, 32) / np.sqrt(32)).astype(np.float32),
                         "b": (rng.randn(32) * 0.1).astype(np.float32)}
    stats = jax.tree.map(lambda v: (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32), stats)
    data = jsynthetic.make_dataset(jmano.synthetic_mano_model(0), n=B, image_size=IMG, seed=0)
    return jcfg, cfg, params, stats, data


def _net(cfg, params, stats):
    net = mhent.MHEnt(cfg)
    net.load_state_dict(from_jax(params, stats), strict=True)
    return mhent.prepare(net, "cpu")


@pytest.mark.parametrize("train", [False, True])
def test_glow_reverse_kld_matches_jax(setup, train):
    jcfg, cfg, params, stats, data = setup
    key = jax.random.key(1)
    jy = {k: jnp.asarray(v) for k, v in data.targets.items()}
    out, _ = jmhent.reverse_kld(jmano.synthetic_mano_model(0), params, stats, jcfg, jy,
                                jnp.asarray(data.images), key, train=train)
    net = _net(cfg, params, stats).train(train)
    assert isinstance(net.q_z_giv_i, glow.ConditionalGlow)
    with torch.no_grad():
        got = mhent.reverse_kld(mano.synthetic_mano_model(0), net,
                                {k: _t(v) for k, v in data.targets.items()}, _t(data.images),
                                base_noise=_t(_noise(key, 2 * B)), train=train)
    for k in ("log_p", "q_log_p_z_giv_y", "h_q_z_giv_i", "th_norm", "bt_norm"):
        _close(got[k].numpy(), out[k], (1e-3 if "log_p" in k else 5e-4) if train else 1e-4,
               name=k)


def test_glow_sample_hypotheses_and_log_q_match_jax(setup):
    """sample_hypotheses (all mods, and the top-N_quant filter by log q) on
    JAX's base noise, and log_q_z of its rows; on the CPU the draw is the
    plain Glow, no kernel launch."""
    jcfg, cfg, params, stats, data = setup
    key = jax.random.key(2)
    jmodel, model = jmano.synthetic_mano_model(0), mano.synthetic_mano_model(0)
    image = jnp.asarray(data.images)
    net = _net(cfg, params, stats)
    assert net.packed_flow is not None  # prepare packs a flow the kernel takes
    noise = _t(_noise(key, N * B) * 0.8)
    before = cuda_glow_sampler.launches
    with torch.inference_mode():
        for n_quant in (None, 2):
            want = jmhent.sample_hypotheses(jmodel, params, stats, jcfg, image, key, n=N,
                                            n_quant=n_quant, temp=0.8)
            got = mhent.sample_hypotheses(model, net, _t(image), n=N, n_quant=n_quant,
                                          temp=0.8, base_noise=noise)
            for k in ("th_bt", "logs_t", "xyz", "uv", "verts"):
                _close(got[k].numpy(), want[k], name=f"{k} n_quant={n_quant}")
        feat = mhent.extract_feat(net, _t(image))
        z, _ = mhent.sample_q_z(net, feat, N, base_noise=noise)
        lq = mhent.log_q_z(net, z, feat.repeat(N, 1))
    assert cuda_glow_sampler.launches == before
    want = jmhent.log_q_z(params, jcfg, jnp.asarray(z.numpy()),
                          jnp.asarray(feat.repeat(N, 1).numpy()))
    _close(lq.numpy(), want, name="log_q_z")


def test_glow_reverse_kld_draw_is_train_mode_with_dropout(setup):
    """At glow_dropout 0.2 the reverse-KL draw (the training step's and the
    eval step's alike, as JAX :464-465) runs the coupling nets' dropout
    from the step's generator, seeded draws repeat, and the eval draw of
    sample_hypotheses runs without it."""
    jcfg, cfg, params, stats, data = setup
    net = _net(cfg._replace(glow_dropout=0.2), params, stats)
    model = mano.synthetic_mano_model(0)
    y = {k: _t(v) for k, v in data.targets.items()}
    noise = torch.randn(2 * B, 45, generator=torch.Generator().manual_seed(0))

    def kld(seed):
        with torch.inference_mode():
            return mhent.reverse_kld(model, net, y, _t(data.images), base_noise=noise,
                                     generator=torch.Generator().manual_seed(seed))["log_p"]

    assert torch.equal(kld(1), kld(1)) and not torch.allclose(kld(1), kld(2))
    feat = mhent.extract_feat(net, _t(data.images))
    with torch.inference_mode():
        a, _ = mhent.sample_q_z(net, feat, 2, base_noise=noise,
                                generator=torch.Generator().manual_seed(1))
        b, _ = mhent.sample_q_z(net, feat, 2, base_noise=noise,
                                generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


def test_glow_pth_round_trips_through_the_reference_converter(setup, tmp_path):
    """A glow MHEnt's reference-schema .pth ({"encoderRGB": state_dict},
    q_z_giv_i.* under the fork's names) loads by name into a fresh MHEnt
    (Experiment._restore) and converts through tools/convert_torch.py's
    load_torch_checkpoint back to the JAX params it came from."""
    jcfg, cfg, params, stats, _ = setup
    net = _net(cfg, params, stats)
    path = tmp_path / "glow.pth"
    torch.save({"encoderRGB": {k: v.detach().cpu() for k, v in net.state_dict().items()}}, path)
    again = mhent.MHEnt(cfg)
    engine.Experiment._restore(again, str(path))
    for k, v in net.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    back = load_torch_checkpoint(str(path), jcfg)
    got, want = jax.tree.leaves(back["flow"]), jax.tree.leaves(params["flow"])
    assert len(got) == len(want) and jax.tree.structure(back["flow"]) == \
        jax.tree.structure(params["flow"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(back["det_head"]["l1"]["w"]),
                                  params["det_head"]["l1"]["w"])


PB = 2


@pytest.fixture(scope="module")
def prohmr_setup():
    jcfg = jprohmr.ProHMRConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(64, 64), dtype="float32"),
        flow=JGlowConfig(features=144, hidden=64, num_layers=2, num_blocks=2,
                         context_features=64), image_size=IMG)
    cfg = prohmr.ProHMRConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(64, 64), dtype="float32"),
        flow=GlowConfig(features=144, hidden=64, num_layers=2, num_blocks=2,
                        context_features=64), image_size=IMG)
    params, stats = jprohmr.init(jax.random.key(0), jcfg)
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    rng = np.random.RandomState(1)
    target = {"pose_6d": (rng.randn(PB, 144) * 0.3).astype(np.float32),
              "betas": (rng.randn(PB, 10) * 0.1).astype(np.float32),
              "keypoints3d": (rng.randn(PB, 24, 3) * 0.2).astype(np.float32),
              "keypoints2d": (rng.randn(PB, 24, 2) * 0.3).astype(np.float32)}
    image = rng.randn(PB, IMG, IMG, 3).astype(np.float32)
    return jcfg, cfg, params, stats, target, image


def _prohmr_loss(out):
    return (-out["log_p"].mean() + out["betas_l2"].mean() + out["kp3d_l1"].mean()
            + out["kp2d_l1"].mean())


@pytest.mark.parametrize("train", [False, True])
def test_prohmr_nll_loss_and_grads_match_jax(prohmr_setup, train):
    jcfg, cfg, params, stats, target, image = prohmr_setup
    key = jax.random.key(3)
    jmodel = jsmpl.synthetic_smpl_model(0, n_verts=256)
    jt = {k: jnp.asarray(v) for k, v in target.items()}

    def loss(p):
        out, _ = jprohmr.nll_loss(jmodel, p, stats, jcfg, jnp.asarray(image), jt, key,
                                  train=train)
        return _prohmr_loss(out), out

    if train:
        val, jout = loss(params)
    else:
        (val, jout), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    net = prohmr.ProHMR(cfg)
    net.load_state_dict(prohmr_from_jax(params, stats), strict=True)
    net.train(train)
    noise = np.array(jax.random.normal(jax.random.split(key)[1], (PB, 144)))
    out = prohmr.nll_loss(smpl.synthetic_smpl_model(0, n_verts=256), net, _t(image),
                          {k: _t(v) for k, v in target.items()}, noise=_t(noise), train=train)
    got = _prohmr_loss(out)
    got.backward()
    rel = 1e-3 if train else 1e-4
    for k in ("log_p", "betas_l2", "kp3d_l1", "kp2d_l1", "betas", "cam"):
        _close(out[k].detach().numpy(), jout[k], rel, name=k)
    _close(got.item(), val, rel, name="loss")
    assert np.abs(net.cam_head.weight.grad.numpy()).max() > 0
    if train:
        return
    want = prohmr_from_jax(jax.tree.map(np.asarray, grads), {})
    named = dict(net.named_parameters())
    assert {k for k in want if not k.endswith("num_batches_tracked")} - set(named) == {
        k for k in want if k.endswith(("initialized", "identity_features",
                                       "transform_features"))}
    for name, p in named.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want[name].numpy()
        err = np.abs(g - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-6), (name, err, np.abs(w).max())


def test_server_builds_and_serves_a_glow_mhent():
    """serve.py builds the model from the YAML as mhentropy_tpu/serve.py
    does (build_model_config), so `network.regressor: glow` serves a glow
    MHEnt; predict's rows follow the request."""
    from mhentropy_tpu_torch.serve import InferenceServer
    from mhentropy_tpu_torch.utils.config import make_cfg

    cfg = make_cfg({"dataset": {"dataset_name": "ho3d", "image_size": [32, 32]},
                    "network": {"enc_type": "MHEnt", "regressor": "glow", "num_latent": 16,
                                "glow_hidden": 32, "glow_layers": 2},
                    "tpu": {"compute_dtype": "float32"}})
    server = InferenceServer(cfg, max_batch=2, n_hypo=3, device="cpu", transports=("f32",))
    assert isinstance(server.net.q_z_giv_i, glow.ConditionalGlow)
    assert server.net.q_z_giv_i.cfg == glow.GlowConfig(45, 32, 2, 2, 16, 0.2)
    out = server.predict(np.zeros((2, 32, 32, 3), np.float32))
    assert out["xyz"].shape == (2, 3, 21, 3) and np.isfinite(out["uv"]).all()
