"""The port's det regressor and MHEnt's z-prior helpers against the JAX
package's, and the port of tests/test_mhent_e2e.py's oracle-z, KLD
annealing, det-mode and prior-sampling tests.

resnet18 at 64 px, B = 4, the MANO stand-in and a synthetic batch, as
tests/test_mhent_e2e.py; weights move with `convert.from_jax` (a det
MHEnt has no flow), the JAX draws are handed to the port. Tolerance 1e-4 of
the largest value, the flows' and the encoder's budget (and the train-mode
rule of tests/test_torch_train.py for resnet18 at 64 px).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.data import synthetic as jsynthetic
from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu.parallel import mesh as mesh_lib
from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.train import metrics as jmetrics
from mhentropy_tpu_torch.convert import from_jax, realnvp_state_dict
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.train import engine, metrics

IMG, B = 64, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=1e-4, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())), err_msg=name)


def _det_configs():
    kw = dict(regressor="det", feat_dim=64, image_size=IMG, n_train_hypotheses=2)
    enc = dict(backbone="resnet18", n_latent=(64, 64), dtype="float32")
    return (jmhent.MHEntConfig(encoder=JEncoderConfig(**enc), **kw),
            mhent.MHEntConfig(encoder=EncoderConfig(**enc), **kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _det_configs()
    params, stats = jmhent.init(jax.random.key(5), jcfg)
    rng = np.random.RandomState(6)
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(lambda v: (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32), stats)
    jmodel = jmano.synthetic_mano_model(0)
    data = jsynthetic.make_dataset(jmodel, n=B, image_size=IMG, seed=0)
    return jcfg, cfg, params, stats, jmodel, data


def _port_net(cfg, params, stats):
    net = mhent.MHEnt(cfg)
    net.load_state_dict(from_jax(params, stats), strict=True)
    return net


def test_det_regressor_matches_jax(setup):
    """No flow parameters in either package; reverse_kld (eval BN, entropy
    on: log q is 0), sample_hypotheses (its n rows repeat the det head's z)
    and log_q_z against JAX. The glow regressor, refused here once, builds
    its ConditionalGlow (tests/test_torch_mhent_glow.py holds it to JAX)."""
    jcfg, cfg, params, stats, jmodel, data = setup
    assert "flow" not in params and cfg.det_dims() == 61
    glow_net = mhent.MHEnt(cfg._replace(regressor="glow"))
    assert glow_net.q_z_giv_i.cfg == mhent.glow_config(cfg) and glow_net.cfg.det_dims() == 16
    net = mhent.prepare(_port_net(cfg, params, stats), "cpu")
    assert not any(k.startswith("q_z_giv_i") for k in net.state_dict())
    assert net.q_z_giv_i is None and net.packed_flow is None
    image = jnp.asarray(data.images[:B])
    jy = {k: jnp.asarray(v) for k, v in data.targets.items()}
    y = {k: _t(v) for k, v in data.targets.items()}
    model = mano.synthetic_mano_model(0)
    with torch.inference_mode():
        out, _ = jmhent.reverse_kld(jmodel, params, stats, jcfg, jy, image, jax.random.key(1),
                                    train=False)
        got = mhent.reverse_kld(model, net, y, _t(image))
        for k in ("log_p", "q_log_p_z_giv_y", "h_q_z_giv_i", "th_norm", "bt_norm"):
            _close(got[k].numpy(), out[k], name=k)
        assert not got["h_q_z_giv_i"].any()
        want = jmhent.sample_hypotheses(jmodel, params, stats, jcfg, image, jax.random.key(2),
                                        n=3, temp=0.8)
        hyp = mhent.sample_hypotheses(model, net, _t(image), n=3, temp=0.8)
        for k in ("th_bt", "logs_t", "xyz", "uv", "verts"):
            _close(hyp[k].numpy(), want[k], name=k)
        assert torch.equal(hyp["xyz"][0], hyp["xyz"][2])
        feat = mhent.extract_feat(net, _t(image))
        z, log_q = mhent.sample_q_z(net, feat, 2)
        assert z.shape == (2 * B, 61) and not log_q.any()
        assert not mhent.log_q_z(net, z, feat.repeat(2, 1)).any()
    assert not np.asarray(jmhent.log_q_z(params, jcfg, jnp.asarray(z.numpy()),
                                         jnp.asarray(feat.repeat(2, 1).numpy()))).any()


@pytest.mark.parametrize("train", [False, True])
def test_det_reverse_kld_matches_jax(setup, train):
    """The det MHEnt's objective in both BN modes against JAX's reverse_kld,
    within 1e-4. In train mode both frameworks take flax's f32 batch
    statistics, whose rounding the det head's outputs carry (as in
    tests/test_torch_rle.py: measured, th_norm 2.4e-4 of its largest value from
    JAX): the port is held to its own float64 evaluation within 1e-4 / 4
    (tests/test_torch_train.py's rule for resnet18 at 64 px) and to JAX
    within 5e-4, log p within 1e-3 relative as tests/test_torch_train.py
    holds it (Laplace terms of scale 0.03 over the decoded keypoints), the
    new running statistics within 1e-4."""
    jcfg, cfg, params, stats, jmodel, data = setup
    jy = {k: jnp.asarray(v) for k, v in data.targets.items()}
    out, new_stats = jmhent.reverse_kld(jmodel, params, stats, jcfg, jy,
                                        jnp.asarray(data.images[:B]), jax.random.key(1),
                                        train=train)
    net = _port_net(cfg, params, stats).train(train)
    with torch.no_grad():
        got = mhent.reverse_kld(mano.synthetic_mano_model(0), net,
                                {k: _t(v) for k, v in data.targets.items()},
                                _t(data.images[:B]), train=train)
    keys = ("log_p", "q_log_p_z_giv_y", "th_norm", "bt_norm")
    for k in keys:
        _close(got[k].numpy(), out[k], (1e-3 if "log_p" in k else 5e-4) if train else 1e-4,
               name=k)
    if train:
        net64 = _port_net(cfg, params, stats).train().double()
        net64.feat_extractor.res.dtype = torch.float64
        model64 = mano.ManoModel(*(t.double() if t.is_floating_point() else t
                                   for t in mano.synthetic_mano_model(0)))
        with torch.no_grad():
            want64 = mhent.reverse_kld(model64, net64,
                                       {k: _t(v).double() for k, v in data.targets.items()},
                                       _t(data.images[:B]).double(), train=True)
        for k in keys:
            _close(got[k].numpy(), want64[k].numpy(), 1e-4 / 4, name=f"{k} f64")
    want = from_jax(params, jax.tree.map(np.asarray, new_stats))
    for k, v in net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v.numpy(), want[k], name=k)


def test_det_train_step(setup):
    """Two make_train_step steps of the det MHEnt from one init (the second
    at lr 0.1 x: milestone 1 at one step an epoch), the last image marked
    as padding, against JAX make_train_step on a one-device mesh: the aux
    of each step within 1e-3 relative (train-mode BN, as
    tests/test_torch_train.py holds the MHEnt step), every parameter after
    Adam within 2 lr per step taken with at least 70 % of its elements
    within 1e-2 lr, the running statistics within 1e-3. The first loss is
    also the masked mean of -reverse_kld's log p on the step's weights, the
    optimizer takes every parameter (no flow among them) and moves the det
    head."""
    jcfg, cfg, params, stats, jmodel, data = setup
    lr = 1e-6
    optimizer = jengine.make_optimizer(lr, [1], steps_per_epoch=1)
    state = jengine.TrainState(params, stats, optimizer.init(params), jnp.zeros((), jnp.int32))
    jstep = jengine.make_train_step(jmodel, jcfg, optimizer, mesh_lib.make_mesh(n_devices=1))
    jy = {k: jnp.asarray(v) for k, v in data.targets.items()}
    jy["valid"] = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    jauxes = []
    for i in range(2):
        state, aux = jstep(state, jnp.asarray(data.images[:B]), jy, jax.random.key(20 + i))
        jauxes.append(jax.device_get(aux))

    net = _port_net(cfg, params, stats).train()
    before = copy.deepcopy(net)
    y = {k: _t(v) for k, v in data.targets.items()}
    y["valid"] = torch.tensor([1.0, 1.0, 1.0, 0.0])
    model = mano.synthetic_mano_model(0)
    with torch.no_grad():
        lp = mhent.reverse_kld(model, copy.deepcopy(net), y, _t(data.images[:B]),
                               train=True)["log_p"]
    opt = engine.make_optimizer(net, lr, [1], steps_per_epoch=1)
    assert not any("q_z_giv_i" in n for n, _ in net.named_parameters())
    step = engine.make_train_step(model, net, opt)
    auxes = [step(_t(data.images[:B]), y, torch.zeros(2 * B, 45)) for _ in range(2)]
    assert float(auxes[0]["loss"]) == pytest.approx(float(-(lp[:3]).mean()), rel=1e-6)
    for i, (got, want) in enumerate(zip(auxes, jauxes)):
        for k in ("loss", "th_norm", "bt_norm", "h_q", "q_log_p"):
            _close(float(got[k]), want[k], 1e-3, f"{k} at step {i}")
        assert float(got["h_q"]) == 0.0
    assert opt.count == 2 and opt.lr_at(1) == pytest.approx(lr * 0.1)
    want = from_jax(jax.tree.map(np.asarray, state.params),
                    jax.tree.map(np.asarray, state.batch_stats))
    agree = total = 0
    for name, t in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            _close(t.numpy(), want[name], 1e-3, name)
            continue
        diff = np.abs(t.numpy() - np.asarray(want[name]))
        assert diff.max() <= 2 * lr * 2, (name, diff.max())
        agree += int((diff <= 1e-2 * lr).sum())
        total += diff.size
    assert agree >= 0.7 * total, agree / total
    moved = {n for n, p in net.named_parameters()
             if not torch.equal(p, before.get_parameter(n))}
    assert {"det_head.0.weight", "det_head.2.bias", "feat_extractor.l1.0.weight"} <= moved


def test_log_q_z_matches_jax():
    """log q of z's theta45 block under the realnvp regressor."""
    kw = dict(feat_dim=16, image_size=IMG)
    jcfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(16, 16), dtype="float32"),
        flow=jrealnvp.RealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=2), **kw)
    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(16, 16), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=2), **kw)
    rng = np.random.RandomState(7)
    flow = jrealnvp.init_params(jax.random.key(7), jcfg.flow)
    flow = flow._replace(**{n: (rng.uniform(-1, 1, v.shape) / np.sqrt(v.shape[-2] if v.ndim == 3
                                                                       else v.shape[-1]))
                            .astype(np.float32)
                            for n, v in flow._asdict().items()
                            if hasattr(v, "shape") and n != "masks"})
    net = mhent.MHEnt(cfg)
    net.q_z_giv_i.load_state_dict(realnvp_state_dict(flow), strict=True)
    z = rng.randn(6, 61).astype(np.float32)
    feat = rng.randn(6, 16).astype(np.float32)
    want = jmhent.log_q_z({"flow": jax.tree.map(jnp.asarray, flow)}, jcfg, jnp.asarray(z),
                          jnp.asarray(feat))
    with torch.no_grad():
        _close(mhent.log_q_z(net, _t(z), _t(feat)).numpy(), want)


def test_oracle_z_achieves_near_zero_error(setup):
    """The GT (theta, beta, st) through the port's decode: BH-MPJPE ~0 and
    the same decode as JAX's."""
    jcfg, cfg, _, _, jmodel, data = setup
    t = data.targets
    th_bt = np.concatenate([t["theta_gt"], t["beta_gt"]], axis=1)
    logs_t = np.concatenate([np.log(t["st"][:, 0:1]), t["st"][:, 1:3]], axis=1)
    dec = mhent.decode(mano.synthetic_mano_model(0), cfg, _t(th_bt), _t(logs_t),
                       mods=("uv", "xyz"), inv_norm=True)
    want = jmhent.decode(jmodel, jcfg, jnp.asarray(th_bt), jnp.asarray(logs_t),
                         mods=("uv", "xyz"), inv_norm=True)
    for k in ("xyz", "uv"):
        _close(dec[k].numpy(), want[k], name=k)
    output = {"log_p": torch.zeros(B), "xyz": dec["xyz"].reshape(1, B, -1),
              "uv": dec["uv"].reshape(1, B, -1)}
    _, _, m = metrics.mhent_metrics(output, {k: _t(v) for k, v in t.items()}, image_size=IMG)
    assert m["eucLoss_3d_rgb_sample"].max() < 1e-4
    assert m["eucLoss_2d_rgb_sample"].max() < 0.1
    uv_gt_px = (t["crop_uv"] + 1) / 2 * IMG
    assert np.abs(dec["uv"].numpy().reshape(B, -1) - uv_gt_px).max() < 0.05
    _, _, jm = jmetrics.mhent_metrics(
        {"log_p": jnp.zeros(B), "xyz": want["xyz"].reshape(1, B, -1),
         "uv": want["uv"].reshape(1, B, -1)}, {k: jnp.asarray(v) for k, v in t.items()},
        image_size=IMG)
    _close(m["eucLoss_2d_rgb_sample"].numpy(), jm["eucLoss_2d_rgb_sample"])


@pytest.mark.parametrize("step", [0, 50, 200, 7])
def test_kld_weight_annealing(step):
    cfg = mhent.MHEntConfig(kld_w=1.0, kld_w_annealing=(0.0, 100))
    want = {0: 0.0, 50: 0.5, 200: 1.0}.get(step)
    got = float(mhent.kld_weight(cfg, step))
    if want is not None:
        assert abs(got - want) < 1e-6 and (step == 50 or got == want)
    jcfg = jmhent.MHEntConfig(kld_w=1.0, kld_w_annealing=(0.0, 100))
    assert got == pytest.approx(float(jmhent.kld_weight(jcfg, step)), abs=1e-7)
    cfg2, jcfg2 = cfg._replace(kld_w=0.2, kld_w_annealing=(1.0, 30)), \
        jcfg._replace(kld_w=0.2, kld_w_annealing=(1.0, 30))
    assert float(mhent.kld_weight(cfg2, step)) == pytest.approx(
        float(jmhent.kld_weight(jcfg2, step)), abs=1e-6)


def _jax_prior_draws(key, rows, means=()):
    """The standard draws JAX's sample_p_z makes from `key`, block by block."""
    draws = {}
    for name, nd in mhent.ZDIMS:
        key, k = jax.random.split(key)
        if name in means:
            draws[name] = {"normal": _t(jax.random.normal(k, (rows, nd)))}
        elif name == "th3":  # the pi ball: radius uniforms, then directions
            k1, k2 = jax.random.split(k)
            draws[name] = {"u": _t(jax.random.uniform(k1, (rows,))),
                           "normal": _t(jax.random.normal(k2, (rows, 3)))}
        elif name in ("th45", "bt"):  # the boxes
            draws[name] = {"u": _t(jax.random.uniform(k, (rows, nd)))}
        else:
            draws[name] = {"normal": _t(jax.random.normal(k, (rows, nd)))}
    return draws


def test_sample_p_z_and_evidence_match_jax(setup):
    jcfg, cfg, *_, data = setup
    n = 3
    key = jax.random.key(7)
    want = jmhent.sample_p_z(jcfg, key, n=n, b=B)
    z = mhent.sample_p_z(cfg, n, B, draws=_jax_prior_draws(key, n * B))
    assert z.shape == (n * B, 61)
    _close(z.numpy(), want, name="z")
    zn = z.numpy()
    assert zn[:, 3:48].min() >= -2.0 and zn[:, 3:48].max() <= 2.0
    assert np.abs(zn[:, 48:58]).max() <= 0.03
    assert np.all(np.linalg.norm(zn[:, :3], axis=1) <= np.pi + 1e-5)

    mean = np.random.RandomState(8).randn(n * B, 45).astype(np.float32)
    want_m = jmhent.sample_p_z(jcfg, key, n=n, b=B, th45_mean=jnp.asarray(mean))
    got_m = mhent.sample_p_z(cfg, n, B, draws=_jax_prior_draws(key, n * B, ("th45",)),
                             th45_mean=_t(mean))
    _close(got_m.numpy(), want_m, name="z with a th45 mean")

    t = data.targets
    ev = mhent.evidence_from_target({k: _t(v) for k, v in t.items()}, ["bt", "logs", "t"], n=n)
    jev = jmhent.evidence_from_target({k: jnp.asarray(v) for k, v in t.items()},
                                      ["bt", "logs", "t"], n=n)
    assert set(ev) == set(jev)
    for k in ev:
        _close(ev[k].numpy(), jev[k], name=k)
    z2 = mhent.set_evidences(z, ev)
    _close(z2.numpy(), jmhent.set_evidences(want, jev), name="set_evidences")
    assert not z2[:, 48:58].any() and torch.equal(z2[:, :48], z[:, :48])
    st = np.tile(t["st"], (n, 1))
    np.testing.assert_allclose(z2[:, 58].numpy(), np.log(st[:, 0]), rtol=1e-6)
    np.testing.assert_allclose(z2[:, 59:61].numpy(), st[:, 1:3], rtol=1e-6)
    assert mhent.set_evidences(z, None) is z
    g = torch.Generator().manual_seed(0)
    drawn = mhent.sample_p_z(cfg, n, B, generator=g)
    assert drawn.shape == (n * B, 61) and np.abs(drawn[:, 48:58].numpy()).max() <= 0.03
