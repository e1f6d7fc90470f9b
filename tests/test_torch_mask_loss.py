"""The mask likelihood (`network.use_mask_loss`) against the JAX package:
`forward_log_p`, `reverse_kld` and a train step's gradients on a small
MHEnt, the YAML keys, the loaders' fields, and run.py on an RHD tree.

The model is resnet18 at 32 px with a RealNVP of one step (2 coupling
layers) of width 32, B = 2, N = 4, an O(1) flow, weights carried by
`from_jax`; inputs from numpy seeds. The ground-truth masks are RHD's
64 x 64 `mask` and HO3D's 256 x 256 `hand_mask` (max-pooled 4 x 4 onto the
render grid). Tolerances:

* `forward_log_p` and `reverse_kld` in eval mode: 1e-4 relative (of each
  term's largest magnitude; the mesh, the splats and the Laplace sums in
  f32 in another order);
* a train step's objective 1e-4 relative and its gradients w.r.t. the flow,
  the det head and the conditioning feature within 1e-3 of each tensor's
  largest entry (the test says why).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.data import mixed as jmixed
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu.utils import config as jconfig
from mhentropy_tpu_torch import run
from mhentropy_tpu_torch.convert import from_jax
from mhentropy_tpu_torch.core import lbs_cuda, mano
from mhentropy_tpu_torch.data import fixtures, ho3d, mixed, synthetic
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.utils.config import load_cfg
from tests.test_torch_train import _configs, _o1
from tools.convert_torch import load_torch_checkpoint

IMG, B, N = 32, 2, 4
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _masks(seed):
    """RHD's (B, 64, 64) float mask and HO3D's (B, 256, 256) bool
    hand_mask: a seeded blob around the crop's centre."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0 * 2 - 1
    blobs = []
    for _ in range(B):
        cx, cy, r = rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), rng.uniform(0.2, 0.4)
        blobs.append((xx - cx) ** 2 + (yy - cy) ** 2 < r * r)
    hand_mask = np.stack(blobs)
    mask = hand_mask[:, ::4, ::4].astype(np.float32)
    return {"mask": mask, "hand_mask": hand_mask}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Both configs, the weights (the port's init carried into the JAX
    layout by tools/convert_torch.py, then an O(1) flow) and a synthetic
    batch of B."""
    jcfg, cfg = _configs(img=IMG, n=N)
    jcfg, cfg = jcfg._replace(use_mask_loss=True), cfg._replace(use_mask_loss=True)
    path = str(tmp_path_factory.mktemp("init") / "init.pth")
    torch.save({"encoderRGB": mhent.init(cfg, seed=0).state_dict()}, path)
    params = load_torch_checkpoint(path, jcfg)
    stats = params.pop("_batch_stats")
    params = _o1(params, 11)
    jmodel = jmano.synthetic_mano_model(0)
    data = synthetic.make_dataset(mano.synthetic_mano_model(0), n=B, image_size=IMG, seed=0)
    return jcfg, cfg, params, stats, jmodel, data


def _port_net(cfg, params, stats):
    net = mhent.MHEnt(cfg)
    net.load_state_dict(from_jax(params, stats), strict=True)
    return net


def _close(got, want, name):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


def _z_rows(seed):
    """(N * B, 61) hypothesis-major rows around a plausible hand: pose
    near the mean, scale about 0.4 (the mesh covers part of the crop)."""
    rng = np.random.RandomState(seed)
    z = np.concatenate([rng.randn(N * B, 48) * 0.3, rng.randn(N * B, 10) * 0.01,
                        np.log(rng.uniform(0.3, 0.5, (N * B, 1))),
                        rng.randn(N * B, 2) * 0.1], 1)
    return z.astype(np.float32)


@pytest.mark.parametrize("key", ["mask", "hand_mask"])
def test_forward_log_p_matches_jax(small, key, monkeypatch):
    """Every term in JAX's key order (uv, xyz, m, the priors), with RHD's
    64 x 64 mask and HO3D's 256 x 256 one; the likelihood's mesh never
    reaches the LBS operator (the plain blend that autograd
    differentiates), while decode's default mesh does."""
    jcfg, cfg, _, _, jmodel, data = small
    y = dict(data.targets, **{key: _masks(3)[key]})
    z = _z_rows(4)
    mods = ("uv", "xyz")
    want = jax.jit(lambda z, y: jmhent.forward_log_p(jmodel, jcfg, z, y, mods=mods))(
        jnp.asarray(z), {k: jnp.asarray(v) for k, v in y.items()})
    calls = []
    blend = lbs_cuda.lbs_blend
    monkeypatch.setattr(lbs_cuda, "lbs_blend", lambda *a: calls.append(1) or blend(*a))
    model = mano.synthetic_mano_model(0)
    got = mhent.forward_log_p(model, cfg, _t(z), {k: _t(v) for k, v in y.items()}, mods=mods)
    # JAX's order (mhent.py:403-442; a jitted dict comes back sorted).
    assert list(got) == ["log_p_uv_giv_z", "log_p_xyz_giv_z", "log_p_m_giv_z", "log_p_th3",
                         "log_p_th45", "log_p_bt", "log_p"] and set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], k)
    assert not calls
    mhent.decode(model, cfg, _t(z[:, :58]), _t(z[:, -3:]), mods=("m",))
    assert len(calls) == 1
    # The term is absent without the option or without a mask.
    assert "log_p_m_giv_z" not in mhent.forward_log_p(
        model, cfg._replace(use_mask_loss=False), _t(z), {k: _t(v) for k, v in y.items()})
    assert "log_p_m_giv_z" not in mhent.forward_log_p(
        model, cfg, _t(z), {k: _t(v) for k, v in data.targets.items()})


def test_reverse_kld_with_the_mask_matches_jax(small):
    """The eval step's reverse-KL term (eval-mode BN) with HO3D's
    hand_mask; the mask term moves log p."""
    jcfg, cfg, params, stats, jmodel, data = small
    y = dict(data.targets, hand_mask=_masks(5)["hand_mask"])
    key = jax.random.key(7)
    want, _ = jax.jit(lambda y, image, key: jmhent.reverse_kld(
        jmodel, params, stats, jcfg, y, image, key, train=False))(
        {k: jnp.asarray(v) for k, v in y.items()}, jnp.asarray(data.images[:B]), key)
    noise = _t(jax.random.normal(key, (N * B, 45)))
    net = _port_net(cfg, params, stats).eval()
    model = mano.synthetic_mano_model(0)
    ty = {k: _t(v) for k, v in y.items()}
    with torch.no_grad():
        got = mhent.reverse_kld(model, net, ty, _t(data.images[:B]), base_noise=noise)
        net.cfg = cfg._replace(use_mask_loss=False)
        plain = mhent.reverse_kld(model, net, ty, _t(data.images[:B]), base_noise=noise)
    for k in ("log_p", "q_log_p_z_giv_y", "h_q_z_giv_i", "th_norm", "bt_norm"):
        _close(got[k].numpy(), want[k], k)
    assert not torch.allclose(got["log_p"], plain["log_p"])


def test_train_step_gradients_match_jax(small):
    """A train step's objective with RHD's mask (its body as JAX's
    reverse_kld runs it: the differentiable draw, forward_log_p and the
    entropy term) and its gradients w.r.t. the flow, the det head and the
    conditioning feature (seeded), against jax.grad. The backbone's
    gradients are the chain rule through that feature, which
    tests/test_torch_train.py holds; here the same feature enters both
    sides, so the mesh, the splats and the likelihood's kinks are all that
    differ: 1e-3 of each tensor's largest entry. The mask term moves the
    flow's gradients."""
    jcfg, cfg, params, stats, jmodel, data = small
    y = dict(data.targets, mask=_masks(6)["mask"])
    jy = {k: jnp.asarray(v) for k, v in y.items()}
    feat = jnp.asarray(np.random.RandomState(8).randn(B, cfg.feat_dim).astype(np.float32))
    key = jax.random.key(12)

    def loss_fn(p, f):
        z, log_q = jmhent.sample_q_z(p, jcfg, f, key, N, temp=1.0, differentiable=True)
        log_p = jmhent.forward_log_p(jmodel, jcfg, z, jy)["log_p"].reshape(N, B).mean(0)
        return -(log_p + (-log_q).reshape(N, B).mean(0)).mean()

    heads = {k: params[k] for k in ("flow", "det_head")}
    loss, (g_heads, g_feat) = jax.jit(jax.value_and_grad(
        lambda h, f: loss_fn(dict(params, **h), f), argnums=(0, 1)))(heads, feat)
    names = {n for n, _ in mhent.MHEnt(cfg).named_parameters()
             if n.startswith(("q_z_giv_i.", "det_head."))}
    want = {k: v.numpy() for k, v in from_jax(jax.tree.map(np.asarray, dict(params, **g_heads)),
                                              {}).items() if k in names}
    want["feat"] = np.asarray(g_feat)
    noise = _t(jax.random.normal(key, (N * B, 45)))
    model = mano.synthetic_mano_model(0)
    got = {}
    for use_mask in (True, False):
        net = _port_net(cfg._replace(use_mask_loss=use_mask), params, stats).train()
        f = _t(feat).requires_grad_()
        out = mhent.reverse_kld(model, net, {k: _t(v) for k, v in y.items()}, None,
                                base_noise=noise, train=True, feat=f)
        port_loss = -out["log_p"].mean()
        port_loss.backward()
        grads = {n: p.grad for n, p in net.named_parameters() if n in want}
        got[use_mask] = (port_loss.item(), dict(grads, feat=f.grad))
    port_loss, g = got[True]
    np.testing.assert_allclose(port_loss, float(loss), rtol=TOL)
    assert set(g) == set(want)
    for name, grad in g.items():
        err = np.abs(grad.numpy() - want[name]).max()
        assert err <= 1e-3 * max(float(np.abs(want[name]).max()), 1e-6), (name, err)
    assert any(not torch.allclose(g[n], got[False][1][n]) for n in g if n.startswith("q_z"))


def test_build_model_config_reads_the_mask_keys(tmp_path):
    """network.use_mask_loss and b_mask reach MHEntConfig as in JAX, field
    for field."""
    path = tmp_path / "c.yaml"
    path.write_text("dataset: {dataset_name: rhd, image_size: [64, 64]}\n"
                    "network:\n  enc_type: MHEnt\n  backbone: resnet18\n"
                    "  use_mask_loss: true\n  b_mask: 0.05\n")
    ours = engine.build_model_config(load_cfg(str(path)))
    theirs = jengine.build_model_config(jconfig.update_cfg(str(path)))
    for k in ours._fields:
        a, b = getattr(ours, k), getattr(theirs, k)
        if hasattr(a, "_asdict"):
            b = b._asdict()
            a = {f: v for f, v in a._asdict().items() if f in b}
            b = {f: b[f] for f in a}
        assert a == b, k
    assert ours.use_mask_loss and ours.b_mask == 0.05


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trees"))
    fixtures.write_rhd(root, 2, 2, size=128)
    fixtures.write_ho3d(root, 2, 2)
    return root


def _yaml(tmp_path, root, dataset="rhd", mask=True, target_fields="auto", epochs=1):
    path = tmp_path / f"{dataset}_{mask}_{target_fields}.yaml"
    path.write_text(
        f"model_dir: {tmp_path / 'run'}/\n"
        f"dataset: {{dataset_name: {dataset}, image_size: [256, 256]}}\n"
        "network: {enc_type: MHEnt, num_latent: 16, backbone: resnet18, h_dims: [32, 32],\n"
        f"          num_steps: 1, use_mask_loss: {str(mask).lower()}}}\n"
        f"training: {{mode: baseline_VAE, batch_size: 2, epochs: {epochs}, test_samples: 3,\n"
        "           seed: 1, n_train_hypotheses: 2, lr: 0.001, milestones: [5]}\n"
        f"tpu: {{compute_dtype: float32, data_dir: {root}, target_fields: {target_fields}}}\n")
    return str(path)


def test_make_datasets_requests_the_masks(trees, tmp_path, monkeypatch):
    """tpu.target_fields "auto" asks the loaders for no heavy field, or for
    both masks with the mask likelihood ("full" for all), as JAX's
    tests/test_real_loaders.py holds the JAX Experiment; the RHD items then
    carry the 64 x 64 mask, the HO3D items the crop's hand_mask; the mixed
    set refuses the likelihood (hand_mask is HO3D's alone), as JAX's."""
    with engine.Experiment(load_cfg(_yaml(tmp_path, trees)), device="cpu") as exp:
        mask_cfg = exp.model_cfg
        assert mask_cfg.use_mask_loss
        sets = {"mask": exp.make_datasets()}
        exp.cfg.tpu.target_fields = "full"
        sets["full"] = exp.make_datasets()
        exp.cfg.tpu.target_fields = "auto"
        monkeypatch.setattr(exp, "model_cfg", mask_cfg._replace(use_mask_loss=False))
        sets["auto"] = exp.make_datasets()
        monkeypatch.setattr(exp, "model_cfg", mask_cfg)
        exp.cfg.dataset.dataset_name = "mixed_ho3d_rhd"
        with pytest.raises(ValueError, match="hand_mask"):
            exp.make_datasets()
    assert all(ds.heavy == frozenset({"hand_mask", "mask"}) for ds in sets["mask"])
    assert all(ds.heavy is None for ds in sets["full"])
    assert all(ds.heavy == frozenset() for ds in sets["auto"])
    _, target = sets["mask"][0][0]
    assert target["mask"].shape == (64, 64) and "object_mask" not in target
    _, target = sets["auto"][0][0]
    assert "mask" not in target
    _, target = ho3d.load(trees, mode="evaluation", heavy_fields={"hand_mask", "mask"})[0]
    assert target["hand_mask"].shape == (256, 256) and "object_mask" not in target
    with pytest.raises(ValueError, match="hand_mask"):
        jmixed.load(trees, mode="evaluation", required={"hand_mask"},
                    heavy_fields={"hand_mask", "mask"})
    assert isinstance(mixed.load(trees, mode="evaluation", heavy_fields=set()),
                      mixed.MixedDataset)


def test_run_cli_trains_with_the_mask_loss(trees, tmp_path, monkeypatch):
    """run.py --device cpu: an epoch and its evals on the RHD tree with
    the mask likelihood on; every train step's and eval batch's objective
    carries a finite log p(m | z)."""
    seen = []
    flp = mhent.forward_log_p

    def spy(*a, **kw):
        out = flp(*a, **kw)
        seen.append(out.get("log_p_m_giv_z"))
        return out

    monkeypatch.setattr(mhent, "forward_log_p", spy)
    path = _yaml(tmp_path, trees)
    summary = run.main(["--cfg", path, "--device", "cpu"])
    assert np.isfinite(summary["eucLoss_3d_rgb_sample"]) and np.isfinite(summary["loss_total"])
    # Initial eval (1 batch), 1 train step, final eval (1 batch).
    assert len(seen) == 3 and all(t is not None for t in seen)
    assert all(torch.isfinite(t).all() and (t != 0).all() for t in seen)
    assert os.path.isfile(os.path.join(load_cfg(path).model_dir, "baseline_final.pth"))
