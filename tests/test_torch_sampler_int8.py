"""The port's int8 RealNVP sampler against the JAX package's
(flows/pallas_sampler_int8.py).

Weights move with `realnvp_state_dict` and the quantised tree with
`flowq_from_jax`; the base and calibration noise are the draws JAX made.
Calibration amaxes and the prepared tree agree to 1e-6 relative (the same
f32 ops on the same inputs); x within 2e-5 and log q within 1e-4, the JAX
tests' own kernel-vs-emulation bounds, against both the JAX emulation and
the Pallas kernel in interpret mode.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.flows import pallas_sampler_int8 as jq8
from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu_torch.convert import flowq_from_jax, realnvp_state_dict
from mhentropy_tpu_torch.flows import cuda_sampler_int8 as q8
from mhentropy_tpu_torch.flows import realnvp

D = 45


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _setup(num_steps=2, cond_dim=32, h_dim=64, b=4, gain=20.0, seed=0):
    """The JAX tests' flow: near-identity init scaled up by `gain`."""
    cfg = jrealnvp.RealNVPConfig(dim=D, cond_dim=cond_dim, h_dim=h_dim, num_steps=num_steps)
    params = jrealnvp.init_params(jax.random.key(seed), cfg)
    params = jax.tree.map(lambda v: v * gain if v is not None and v.ndim == 3 else v, params)
    params = params._replace(masks=jnp.asarray(jrealnvp.default_masks(D, num_steps)))
    feat = jax.random.normal(jax.random.key(seed + 1), (b, cond_dim))
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=D, cond_dim=cond_dim, h_dim=h_dim,
                                                 num_steps=num_steps))
    flow.load_state_dict(realnvp_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return cfg, params, feat, flow.eval()


def _rel_close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(1e-30, np.abs(b).max()))


def test_calibration_and_prepare_match_jax():
    cfg, params, feat, flow = _setup()
    n = 32
    key = jax.random.key(17)
    b = feat.shape[0]
    z0 = jax.random.normal(key, (n * b, D)) * 0.8
    cproj = jrealnvp.cond_cache(params, cfg, jrealnvp.make_cond(params, cfg, feat))
    act = jq8.collect_act_maxabs(params, cfg, z0, jnp.tile(cproj, (1, 1, n, 1)))
    jtree = jq8.quantize_sampler(params, cfg, feat, key, n=n, temp=0.8)

    with torch.no_grad():
        feat_t = torch.from_numpy(np.array(feat))
        cp = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat_t)).repeat(1, 1, n, 1)
        got_act = q8.collect_act_maxabs(flow, torch.from_numpy(np.array(z0)), cp)
        tree = q8.quantize_sampler(flow, feat_t, torch.from_numpy(np.array(z0)))
    for k in ("a0", "s_h1", "s_h2", "t_h1", "t_h2"):
        _rel_close(got_act[k].numpy(), act[k], 1e-6)
    want = flowq_from_jax(jtree, dim=D)
    for name in q8.FlowQTree._fields[:-1]:
        got, ref = getattr(tree, name), getattr(want, name)
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        if got.dtype == torch.int8:  # the same f32 division and rounding
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
        else:
            _rel_close(got.numpy(), ref.numpy(), 1e-6)


@pytest.mark.parametrize("emulate", [True, False])
def test_sample_fused_q_matches_jax(emulate):
    """emulate=False runs the Pallas kernel in interpret mode."""
    cfg, params, feat, flow = _setup()
    jtree = jq8.quantize_sampler(params, cfg, feat, jax.random.key(2))
    n, key, temp = 16, jax.random.key(5), 0.8
    x_ref, lp_ref = jq8.sample_fused_q(params, cfg, jtree, key, feat, n, temp=temp,
                                       return_log_prob=True, images_per_tile=2,
                                       emulate=emulate)
    z0 = np.asarray(jax.random.normal(key, (n * feat.shape[0], D)) * temp)
    tree = flowq_from_jax(jtree, dim=D)
    with torch.no_grad():
        x, lp = q8.sample_fused_q(flow, tree, torch.from_numpy(np.array(feat)), n,
                                  torch.from_numpy(z0))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=2e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), atol=1e-4)


def test_zero_weight_flow_is_exact_identity():
    """All coupling weights zero: x = z0 whatever the scales, and log q is
    the base density."""
    cfg, params, feat, _ = _setup(num_steps=1, h_dim=32, gain=1.0)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=D, cond_dim=32, h_dim=32, num_steps=1))
    with torch.no_grad():
        for p in flow.parameters():
            p.zero_()
        feat_t = torch.from_numpy(np.array(feat))
        tree = q8.quantize_sampler(flow, feat_t, torch.randn(32 * 4, D))
        z0 = torch.randn(8 * 4, D) * 0.7
        x, lp = q8.sample_fused_q(flow, tree, feat_t, 8, z0)
    torch.testing.assert_close(x, z0, rtol=0, atol=1e-6)
    base = -0.5 * (z0 ** 2).sum(-1) - 0.5 * D * np.log(2 * np.pi)
    torch.testing.assert_close(lp, base, rtol=0, atol=1e-4)


def test_shape_gate_and_kernel_layout():
    assert q8.shape_ok(realnvp.RealNVPConfig(dim=45))
    assert not q8.shape_ok(realnvp.RealNVPConfig(dim=200))
    assert not q8.shape_ok(realnvp.RealNVPConfig(dim=3))
    _, _, feat, flow = _setup(num_steps=1, h_dim=32)
    with torch.no_grad():
        tree = q8.quantize_sampler(flow, torch.from_numpy(np.array(feat)), torch.randn(128, D))
    k = tree.kernel
    assert tree.masks.shape[-1] == 64 and k.w0.shape == (2, 2, 32, 64)
    torch.testing.assert_close(k.w1[1, 0], tree.s_w1[1].T)
    torch.testing.assert_close(k.w2[0, 1], tree.t_w2[0].T)
    torch.testing.assert_close(k.e2[1, 1], tree.t_e2[1, 0])
