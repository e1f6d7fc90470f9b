"""The port's RealNVP flow and fused-sampler wrapper vs the JAX package.

The JAX side runs the Pallas sampler's transform in interpret mode (as
tests/test_pallas_sampler.py does); the port side runs the wrapper's plain
version on the CPU. Inputs come from numpy seeds; tolerance 1e-4 (the
tests/test_flows.py anchor). The CUDA kernel is held to the plain version
on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.flows import pallas_sampler as ps
from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu_torch.convert import realnvp_state_dict
from mhentropy_tpu_torch.flows import cuda_sampler, realnvp

TOL = 1e-4
CFG = dict(dim=45, cond_dim=32, h_dim=64, num_steps=2)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _jax_flow(seed=0):
    """JAX RealNVP params with random weights of O(1) effect (the init's
    near-identity flow would make the comparison vacuous)."""
    cfg = jrealnvp.RealNVPConfig(**CFG)
    params = jrealnvp.init_params(jax.random.key(seed), cfg)
    rng = np.random.RandomState(seed)
    fields = {}
    for name, v in params._asdict().items():
        if v is None or name == "masks" or not hasattr(v, "shape"):
            continue
        fan_in = v.shape[-2] if v.ndim == 3 else v.shape[-1]
        fields[name] = jnp.asarray(
            rng.uniform(-1, 1, v.shape).astype(np.float32) / np.sqrt(fan_in))
    return cfg, params._replace(**fields)


def _port_flow(params):
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(**CFG))
    flow.load_state_dict(realnvp_state_dict(params), strict=True)
    return flow.eval()


def _np(t):
    return t.detach().numpy()


def test_cond_cache_matches_jax():
    cfg, params = _jax_flow()
    feat = np.random.RandomState(1).randn(3, 32).astype(np.float32)
    ref = jrealnvp.cond_cache(params, cfg, jrealnvp.make_cond(params, cfg, jnp.asarray(feat)))
    flow = _port_flow(params)
    ours = realnvp.cond_cache(flow, realnvp.make_cond(flow, torch.from_numpy(feat)))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=TOL)


def test_plain_transform_matches_pallas_kernel_transform(interpret_mode):
    """B=3, N=5: neither the image tile nor the 8-row tile is full."""
    cfg, params = _jax_flow()
    rng = np.random.RandomState(2)
    b, n = 3, 5
    feat = rng.randn(b, 32).astype(np.float32)
    z0 = (rng.randn(b, n, 45) * 0.8).astype(np.float32)
    cproj = jrealnvp.cond_cache(params, cfg, jnp.asarray(feat))
    x_ref, ld_ref = ps._kernel_transform(params, cfg, jnp.asarray(z0), cproj, 2)

    flow = _port_flow(params)
    packed = cuda_sampler.pack(flow, dtype=torch.float32)
    cp = realnvp.cond_cache(flow, torch.from_numpy(feat))
    x, ld = cuda_sampler.transform(packed, torch.from_numpy(z0), cp)
    assert x.shape == (b, n, 45) and ld.shape == (b, n)
    np.testing.assert_allclose(_np(x), np.asarray(x_ref), atol=TOL)
    np.testing.assert_allclose(_np(ld), np.asarray(ld_ref), atol=TOL)


def test_sample_matches_jax_sample_with_same_noise():
    cfg, params = _jax_flow(3)
    b, n, temp = 2, 4, 0.8
    feat = np.random.RandomState(4).randn(b, 32).astype(np.float32)
    key = jax.random.key(5)
    cproj = jrealnvp.cond_cache(params, cfg, jnp.asarray(feat))
    x_ref, lp_ref = jrealnvp.sample(params, cfg, key, n * b, cproj=jnp.tile(cproj, (1, 1, n, 1)),
                                    temp=temp, return_log_prob=True)
    z0 = torch.from_numpy(np.array(jax.random.normal(key, (n * b, 45)) * temp))

    flow = _port_flow(params)
    cp = realnvp.cond_cache(flow, torch.from_numpy(feat)).repeat(1, 1, n, 1)
    x, lp = realnvp.sample(flow, z0, cproj=cp)
    np.testing.assert_allclose(_np(x), np.asarray(x_ref), atol=TOL)
    np.testing.assert_allclose(_np(lp), np.asarray(lp_ref), atol=TOL)


def test_sample_fused_orders_rows_like_the_flow():
    """The wrapper regroups hypothesis-major rows image-major and back: its
    plain path must equal realnvp.sample on the tiled cache (1e-5, f32)."""
    _, params = _jax_flow(6)
    flow = _port_flow(params)
    rng = np.random.RandomState(7)
    b, n = 3, 6
    feat = torch.from_numpy(rng.randn(b, 32).astype(np.float32))
    z0 = torch.from_numpy(rng.randn(n * b, 45).astype(np.float32))
    x, lp = cuda_sampler.sample_fused(flow, cuda_sampler.pack(flow, torch.float32), feat, n, z0)
    cp = realnvp.cond_cache(flow, feat).repeat(1, 1, n, 1)
    x_ref, lp_ref = realnvp.sample(flow, z0, cproj=cp)
    np.testing.assert_allclose(_np(x), _np(x_ref), atol=1e-5)
    np.testing.assert_allclose(_np(lp), _np(lp_ref), atol=1e-5)


def test_pack_pads_with_pass_through_dims():
    _, params = _jax_flow()
    packed = cuda_sampler.pack(_port_flow(params))
    assert packed.masks.shape == (4, 48) and packed.w0.shape == (4, 2, 48, 64)
    assert packed.w2.shape == (4, 2, 64, 48) and packed.w1.dtype == torch.bfloat16
    assert torch.all(packed.masks[:, 45:] == 1)
    assert torch.all(packed.w0[:, :, 45:] == 0) and torch.all(packed.w2[..., 45:] == 0)


def test_wrapper_takes_plain_path_only_on_cpu():
    """CPU tensors run the plain version without counting a launch; any
    other non-CUDA device raises instead of falling back."""
    _, params = _jax_flow()
    flow = _port_flow(params)
    packed = cuda_sampler.pack(flow)
    z0 = torch.zeros(2, 3, 45)
    cp = torch.zeros(4, 4, 2, 64)
    before = cuda_sampler.launches
    cuda_sampler.transform(packed, z0, cp)
    assert cuda_sampler.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sampler.transform(packed, z0.to("meta"), cp.to("meta"))
