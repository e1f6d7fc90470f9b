"""The port's training step and its parts against the JAX package's.

Inputs and noise come from numpy seeds or from JAX's own draws
(`jax.random.normal(key, (N * B, 45))` is the noise the JAX step draws from
its key); weights move with `from_jax`, the optimizer state with
`opt_state_from_jax`. The port runs on the CPU (plain sums, plain flow
under the sampler's Function); the JAX Pallas sampler runs in interpret
mode. Tolerances:

* the train-mode backbone (features, running statistics): 1e-4 relative
  for resnet18 at 64 px, 2e-3 for resnet50 at 128 px, where f32 rounding
  of flax's fast variance dominates (the test says how it was measured);
* the sampler under grad: values 1e-4 (the tests/test_flows.py anchor),
  gradients 2e-3 relative to each tensor's largest entry (the budget of
  tests/test_pallas_sampler.py's own kernel-vs-XLA gradient check);
* the loss and its gradients: see the test's docstring (1e-3 relative for
  the loss; the heads' and the flow's gradients 2e-3 of their largest
  entry, the backbone's a cosine of 0.99 with JAX and 1e-3 of the port's
  own float64 evaluation);
* the optimizer on one gradient sequence: 1e-6 (the same f32 formulas);
* whole steps, at lr 1e-6 so that the loss moves smoothly (at 2e-4 it
  swings by half between steps on this 4-image batch, and the two
  frameworks part by 4 % in two steps): loss and aux within 1e-3 relative
  per step (measured 2.8e-4). Adam's updates are at most lr per element and
  about lr * sign(g) at first, so where the gradients differ an element may
  step the other way: parameters are held to 2 lr per step taken, and at
  least 70 % of their elements to 1e-2 lr (measured 81 %); the moments of a
  continued JAX state as the gradients.
"""

import copy

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.data import synthetic as jsynthetic
from mhentropy_tpu.flows import pallas_sampler as ps
from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu.parallel import mesh as mesh_lib
from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu_torch import run
from mhentropy_tpu_torch.convert import from_jax, opt_state_from_jax, realnvp_state_dict
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.flows import cuda_sampler, realnvp
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.train import engine
from tools.convert_torch import load_torch_checkpoint
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

IMG, B, LR = 64, 4, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _target(t):
    return {k: _t(v) for k, v in t.items()}


def _close(got, want, rel, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())), err_msg=name)


def _close_to_largest(got, want, share, name=""):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= share * max(float(np.abs(want).max()), 1e-6), (name, err, np.abs(want).max())


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _configs(backbone="resnet18", img=IMG, h=32, steps=1, n=2, latent=32):
    """The JAX and port MHEntConfig at the tests/test_engine.py small_cfg sizes."""
    jcfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone=backbone, n_latent=(latent, latent), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=latent, h_dim=h, num_steps=steps),
        feat_dim=latent, image_size=img, n_train_hypotheses=n)
    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone=backbone, n_latent=(latent, latent), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=latent, h_dim=h, num_steps=steps),
        feat_dim=latent, image_size=img, n_train_hypotheses=n)
    return jcfg, cfg


def _o1(params, seed):
    """Numpy params with the flow at O(1) weights and non-default BN stats
    are made by the callers; this redraws the flow's linears."""
    rng = np.random.RandomState(seed)
    flow = params["flow"]
    fields = {n: (rng.uniform(-1, 1, v.shape) / np.sqrt(v.shape[-2] if v.ndim == 3
                                                       else v.shape[-1])).astype(np.float32)
              for n, v in flow._asdict().items() if hasattr(v, "shape") and n != "masks"}
    return dict(params, flow=flow._replace(**fields))


def _port_net(cfg, params, stats):
    net = mhent.MHEnt(cfg)
    net.load_state_dict(from_jax(jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray, stats)), strict=True)
    return net


@pytest.mark.parametrize("backbone,img,b,tol", [("resnet18", 64, 4, 1e-4),
                                                 ("resnet50", 128, 2, 2e-3)])
def test_train_mode_features_and_stats_match_jax(backbone, img, b, tol):
    """Both frameworks normalise with flax's fast variance E[x^2] - E[x]^2 in
    f32, whose cancellation amplifies summation-order rounding through the
    BNs; with few rows per channel in the last stage it dominates (resnet50
    at 128 px: the JAX f32 features lie 7e-4 from a float64 evaluation of
    the same net, the port's 1.1e-4). The port is held to JAX within tol
    of the largest value and to its own float64 evaluation within tol / 4."""
    jcfg, cfg = _configs(backbone, img)
    params, stats = jmhent.init(jax.random.key(0), jcfg)
    rng = np.random.RandomState(1)
    stats = jax.tree.map(lambda v: (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32), stats)
    image = (rng.randn(b, img, img, 3) * 0.5).astype(np.float32)
    feat, new_stats = jmhent.extract_feat(params, stats, jcfg, jnp.asarray(image), train=True)
    net = _port_net(cfg, params, stats).train()
    net64 = copy.deepcopy(net).double()
    got = mhent.extract_feat(net, _t(image), train=True)
    _close(got.detach().numpy(), feat, tol)
    res64 = net64.feat_extractor.res
    res64.dtype = torch.float64
    want64 = net64.feat_extractor.l1(res64(_t(image).double()).double())
    _close(got.detach().numpy(), want64.detach().numpy(), tol / 4)
    want = from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, new_stats))
    sd = net.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * (20 if backbone == "resnet18" else 53)
    for k in keys:
        _close(sd[k].numpy(), want[k], tol, k)
    with pytest.raises(ValueError, match="net.eval"):
        mhent.extract_feat(net, _t(image))


def _jax_flow(cfg, seed):
    params = jrealnvp.init_params(jax.random.key(seed), cfg)
    return _o1({"flow": params}, seed)["flow"]


def test_sample_fused_diff_matches_jax(interpret_mode):
    """Values and gradients (flow parameters, features) of the draw under
    autograd against JAX's pallas_sampler.sample_fused_diff."""
    jcfg = JRealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=1)
    params = _jax_flow(jcfg, 3)
    b, n = 3, 5
    feat = np.random.RandomState(4).randn(b, 16).astype(np.float32)
    key = jax.random.key(5)
    w = np.random.RandomState(6).randn(n * b, 45).astype(np.float32)

    def loss(p, f):
        x, lp = ps.sample_fused_diff(p, jcfg, key, f, n, temp=1.0, images_per_tile=2)
        return jnp.sum(x * w) + jnp.sum(lp), (x, lp)

    (_, (x_ref, lp_ref)), (g_params, g_feat) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(feat))

    flow = realnvp.RealNVP(RealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=1))
    flow.load_state_dict(realnvp_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    feat_t = _t(feat).requires_grad_()
    noise = _t(jax.random.normal(key, (n * b, 45)))
    x, lp = cuda_sampler.sample_fused_diff(flow, feat_t, n, noise)
    ((x * _t(w)).sum() + lp.sum()).backward()
    _close(x.detach().numpy(), x_ref, 1e-4)
    _close(lp.detach().numpy(), lp_ref, 1e-4)
    _close_to_largest(feat_t.grad.numpy(), g_feat, 2e-3, "feat")
    want = realnvp_state_dict(jax.tree.map(np.asarray, g_params))
    for name, p in flow.named_parameters():
        _close_to_largest(p.grad.numpy(), want[name], 2e-3, name)


def test_transform_diff_gradcheck_float64():
    """TransformDiff in float64 on a tiny flow: the backward's recomputed
    plain flow is the derivative of the forward (torch.autograd.gradcheck);
    under inference mode the Function runs without a graph."""
    torch.manual_seed(7)
    flow = realnvp.RealNVP(RealNVPConfig(dim=6, cond_dim=4, h_dim=8, num_steps=1)).double()
    z0 = torch.randn(1, 2, 6, dtype=torch.float64, requires_grad=True)
    cproj = torch.randn(2, 4, 1, 8, dtype=torch.float64, requires_grad=True)
    weights = cuda_sampler.transform_params(flow)
    assert torch.autograd.gradcheck(
        lambda z, c, *ws: cuda_sampler.TransformDiff.apply(flow, z, c, *ws),
        (z0, cproj, *weights), eps=1e-6, atol=1e-6)
    with torch.inference_mode():
        x, ld = cuda_sampler.transform_diff(flow, z0.detach(), cproj.detach())
    ref_x, ref_ld = cuda_sampler.transform_reference(flow, z0.detach(), cproj.detach())
    torch.testing.assert_close(x, ref_x.detach())
    torch.testing.assert_close(ld, ref_ld.detach())


@pytest.fixture(scope="module")
def small():
    """resnet18 at 64 px, flow h = 32 with one step, N = 2 (test_engine's
    small_cfg at twice its image size, which leaves 2 x 2 pixels in the
    last stage), an O(1) flow, a synthetic batch of 4 and the MANO
    stand-in."""
    jcfg, cfg = _configs()
    params, stats = jmhent.init(jax.random.key(0), jcfg)
    params = _o1(jax.tree.map(np.asarray, params), 11)
    jmodel = jmano.synthetic_mano_model(0)
    data = jsynthetic.make_dataset(jmodel, n=B, image_size=IMG, seed=0)
    return jcfg, cfg, params, jax.tree.map(np.asarray, stats), jmodel, data


def _port_loss(net, y, image, noise, dtype=torch.float32):
    model = mano.ManoModel(*(t.to(dtype) if t.is_floating_point() else t
                             for t in mano.synthetic_mano_model(0)))
    out = mhent.reverse_kld(model, net, {k: _t(v).to(dtype) for k, v in y.items()},
                            _t(image).to(dtype), base_noise=noise.to(dtype), train=True)
    v = _t(y["valid"]).to(dtype)
    loss = -(out["log_p"] * v).sum() / (v.sum() + 1e-16)
    loss.backward()
    return loss, out, {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double()
                       for n, p in net.named_parameters()}


def _cosine(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def test_reverse_kld_train_loss_and_gradients_match_jax(small):
    """The loss and log p terms within 1e-3 relative: log p sums Laplace
    terms (scale 0.03) of keypoints decoded from train-mode features, which
    carry the BN rounding (2e-5 of their range). That rounding also moves
    hypotheses across the likelihood's dead-zone kinks, which moves dlog p /
    dz, and the backbone's train-mode BN backward removes each channel's
    batch mean from a gradient that the 4 images largely share, so the
    remainder carries that difference amplified: measured, the JAX f32
    backbone gradients differ from the port's (f32 or f64) by up to 9 % of
    each tensor's largest entry, while the heads and the flow agree to
    3e-4. So the heads and flow are held to 2e-3 of their largest entry, the
    backbone to a cosine of 0.99 with JAX, and, tightly, to the port's own
    float64 evaluation (1e-3 of the largest entry) and to autograd through
    flax's plain statistics (set_kernels(False): the custom backward of
    the sums against autograd, 1e-5)."""
    jcfg, cfg, params, stats, jmodel, data = small
    image = data.images[:B]
    y = dict(data.targets, valid=np.array([1, 1, 1, 0], np.float32))
    jy = {k: jnp.asarray(v) for k, v in y.items()}
    key = jax.random.key(12)

    def loss_fn(p):  # the JAX make_train_step's loss_fn
        out, new_stats = jmhent.reverse_kld(jmodel, p, stats, jcfg, jy, jnp.asarray(image), key,
                                            train=True)
        v = jy["valid"]
        return -(out["log_p"] * v).sum() / (v.sum() + 1e-16), (out, new_stats)

    (loss, (out, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    noise = _t(jax.random.normal(key, (2 * B, 45)))
    net = _port_net(cfg, params, stats).train()
    port_loss, got, g32 = _port_loss(net, y, image, noise)
    _close(port_loss.item(), loss, 1e-3, "loss")
    for k in ("log_p", "q_log_p_z_giv_y", "h_q_z_giv_i", "th_norm", "bt_norm"):
        _close(got[k].detach().numpy(), out[k], 1e-3, k)
    want = from_jax(jax.tree.map(np.asarray, grads), {})
    for name, g in g32.items():
        if name.startswith("feat_extractor.res."):
            assert _cosine(g, want[name]) >= 0.99, name
        else:
            _close_to_largest(g.numpy(), want[name], 2e-3, name)
    sd, ref = net.state_dict(), from_jax(params, jax.tree.map(np.asarray, new_stats))
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k].numpy(), ref[k], 1e-4, k)

    plain = _port_net(cfg, params, stats).train()
    plain.set_kernels(False)
    net64 = _port_net(cfg, params, stats).train().double()
    net64.feat_extractor.res.dtype = torch.float64
    for other, share in ((plain, 1e-5), (net64, 1e-3)):
        _, _, g_other = _port_loss(other, y, image, noise,
                                   torch.float64 if other is net64 else torch.float32)
        for name, g in g32.items():
            _close_to_largest(g.numpy(), g_other[name].numpy(), share, name)


def test_optimizer_matches_optax():
    """clip_by_global_norm(1) + Adam + the piecewise schedule of the JAX
    make_optimizer on one gradient sequence that crosses a milestone (update
    2) and clips on some steps (global norm above 1) but not others."""
    rng = np.random.RandomState(13)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    opt = jengine.make_optimizer(0.01, [1], steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    topt = engine.Optimizer(tp.values(), 0.01, [1], steps_per_epoch=2)
    assert [topt.lr_at(k) for k in range(4)] == pytest.approx([0.01, 0.01, 0.001, 0.001])
    for step, scale in enumerate((3.0, 0.05, 2.0, 0.1, 5.0)):
        g = {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for k, p in tp.items():
            p.grad = _t(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} after update {step}")
    assert topt.count == 5
    mu, nu = state[1][0].mu, state[1][0].nu
    for k, p in tp.items():
        st = topt.adam.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(mu[k]), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(nu[k]), rtol=1e-6,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def jax_steps(small):
    """Three JAX make_train_step steps on a one-device mesh from one init,
    the batch's last image marked as padding; the states (numpy) and aux."""
    jcfg, _, params, stats, jmodel, data = small
    optimizer = jengine.make_optimizer(LR, [1], steps_per_epoch=2)
    state = jengine.TrainState(params, stats, optimizer.init(params), jnp.zeros((), jnp.int32))
    mesh = mesh_lib.make_mesh(n_devices=1)
    step = jengine.make_train_step(jmodel, jcfg, optimizer, mesh)
    y = {k: jnp.asarray(v) for k, v in data.targets.items()}
    y["valid"] = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    keys = [jax.random.key(20 + i) for i in range(3)]
    states, auxes = [jax.tree.map(np.asarray, state)], []
    for k in keys:
        state, aux = step(state, jnp.asarray(data.images[:B]), y, k)
        states.append(jax.tree.map(np.asarray, state))
        auxes.append(jax.device_get(aux))
    noises = [np.array(jax.random.normal(k, (2 * B, 45))) for k in keys]
    return states, auxes, noises


def _port_steps(cfg, state, data, noises, opt_state=None):
    net = _port_net(cfg, state.params, state.batch_stats).train()
    opt = engine.make_optimizer(net, LR, [1], steps_per_epoch=2)
    if opt_state is not None:
        opt.load_moments(dict(net.named_parameters()), opt_state_from_jax(opt_state))
    step = engine.make_train_step(mano.synthetic_mano_model(0), net, opt)
    y = _target(data.targets)
    y["valid"] = torch.tensor([1.0, 1.0, 1.0, 0.0])
    auxes = [{k: float(v) for k, v in step(_t(data.images[:B]), y, _t(n)).items()}
             for n in noises]
    return net, opt, auxes


def _check_params(net, params, stats, steps):
    want = from_jax(params, stats)
    agree = total = 0
    for name, t in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            _close(t.numpy(), want[name], 1e-3, name)
            continue
        diff = np.abs(t.numpy() - np.asarray(want[name]))
        assert diff.max() <= 2 * LR * steps, (name, diff.max())
        agree += int((diff <= 1e-2 * LR).sum())
        total += diff.size
    assert agree >= 0.7 * total, agree / total


def test_train_steps_match_jax(small, jax_steps):
    """Three steps from one init (the second update at lr 0.1 x: milestone
    1 x 2 steps per epoch falls on update 2) against make_train_step."""
    _, cfg, _, _, _, data = small
    states, jauxes, noises = jax_steps
    net, opt, auxes = _port_steps(cfg, states[0], data, noises)
    for i, (got, want) in enumerate(zip(auxes, jauxes)):
        for k in ("loss", "th_norm", "bt_norm", "h_q", "q_log_p"):
            _close(got[k], want[k], 1e-3, f"{k} at step {i}")
    assert opt.count == 3 and opt.lr_at(2) == pytest.approx(LR * 0.1)
    _check_params(net, states[3].params, states[3].batch_stats, 3)


def test_jax_optimizer_state_continues_in_the_port(small, jax_steps):
    """The JAX state after one step (params, stats, Adam moments and count)
    through from_jax / opt_state_from_jax, then two more steps in each."""
    _, cfg, _, _, _, data = small
    states, jauxes, noises = jax_steps
    net, opt, auxes = _port_steps(cfg, states[1], data, noises[1:], opt_state=states[1].opt_state)
    for i, (got, want) in enumerate(zip(auxes, jauxes[1:])):
        _close(got["loss"], want["loss"], 1e-3, f"loss at step {i + 1}")
    assert opt.count == 3
    want = opt_state_from_jax(states[3].opt_state)
    assert want["count"] == 3
    named = dict(net.named_parameters())
    for name, moments in want["state"].items():
        st = opt.adam.state.get(named[name])
        if st is None:  # no gradient reaches it: its JAX moments stay 0
            assert not np.any(moments["exp_avg"]), name
            continue
        for k in ("exp_avg", "exp_avg_sq"):
            if name.startswith("feat_extractor.res."):
                assert _cosine(st[k].numpy(), moments[k]) >= 0.99, (name, k)
            else:
                _close_to_largest(st[k].numpy(), moments[k], 2e-3, f"{name} {k}")
    _check_params(net, states[3].params, states[3].batch_stats, 2)


def test_run_cli_trains_and_its_checkpoint_loads_in_both_packages(tmp_path, capsys):
    path = tmp_path / "tiny.yaml"
    model_dir = tmp_path / "ckpt"
    path.write_text(
        f"model_dir: {model_dir}/\n"
        "info_interval: 2\n"
        "dataset: {dataset_name: ho3d, image_size: [32, 32]}\n"
        "network: {enc_type: MHEnt, num_latent: 16, backbone: resnet18, h_dims: [32, 32],\n"
        "          num_steps: 1}\n"
        "training: {mode: baseline_VAE, batch_size: 4, epochs: 1, test_samples: 3, seed: 1,\n"
        "           n_train_hypotheses: 2, lr: 0.001, milestones: [5]}\n"
        "tpu: {compute_dtype: float32, fused_train_bn: true}\n")
    summary = run.main(["--cfg", str(path), "--device", "cpu"])
    assert np.isfinite(summary["eucLoss_3d_rgb_sample"])
    log = capsys.readouterr().out
    assert "Epoch:0| Step:0| Avg_Loss:" in log and "h_q:" in log and "q_log_p:" in log
    ckpt_path = model_dir / "baseline_final.pth"
    assert (model_dir / "baseline_mano_0.pth").is_file() and ckpt_path.is_file()
    ckpt = torch.load(ckpt_path, map_location="cpu")
    assert set(ckpt) == {"encoderRGB", "optimizer", "step"} and ckpt["step"] == 8

    from mhentropy_tpu_torch.utils.config import load_cfg
    cfg = load_cfg(str(path))
    exp_cfg = engine.build_model_config(cfg)
    assert exp_cfg.encoder.fused_train_bn is True
    net = mhent.init(exp_cfg, seed=5)
    engine.Experiment._restore(net, str(ckpt_path))
    for k, v in net.state_dict().items():
        assert torch.equal(v, ckpt["encoderRGB"][k]), k

    _, jcfg_flow = jengine.build_model_config, None
    jcfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(16, 16), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=1), feat_dim=16,
        image_size=32, n_train_hypotheses=2)
    jparams = load_torch_checkpoint(str(ckpt_path), jcfg)
    sd = ckpt["encoderRGB"]
    np.testing.assert_array_equal(jparams["det_head"]["l0"]["w"], sd["det_head.0.weight"].numpy().T)
    np.testing.assert_array_equal(np.asarray(jparams["flow"].s_w1)[0],
                                  sd["q_z_giv_i.s.0.l.1.weight"].numpy().T)
    np.testing.assert_array_equal(jparams["_batch_stats"]["bn1"]["var"],
                                  sd["feat_extractor.res.bn1.running_var"].numpy())
    # The checkpoint's optimizer state resumes in a new Experiment.
    cfg.training.pth = str(ckpt_path)
    exp = engine.Experiment(cfg, device="cpu")
    exp._ensure_state(8)
    assert exp.step == 8 and exp.optimizer.count == 8
