"""The port's plain int8 stage 1 against the JAX package's
`stage1_int8.stage1_forward_q` (Pallas kernel in interpret mode), on the
JAX test's random sites at its shape (B = 2, 16 x 16).

The integer products are exact in both; rtol 1e-6 / atol 1e-4 covers f32
ulps of the epilogues (the JAX test's own bound against its numpy replica).
The `quant._qconv` walk differs in f32 association, which can flip a
requantise tie, so it is held to the JAX test's loose bound.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import stage1_int8 as jstage1_int8
from mhentropy_tpu_torch.models import quant, stage1_int8_cuda
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

H = W = 16


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _rand_site(key, kshape):
    ks = jax.random.split(key, 4)
    cout = kshape[-1]
    return {
        "w8": jax.random.randint(ks[0], kshape, -90, 90, jnp.int8),
        "scale": jax.random.uniform(ks[1], (cout,), jnp.float32, 2e-4, 2e-3),
        "bias": jax.random.normal(ks[2], (cout,)) * 0.05,
        "inv_sa": jax.random.uniform(ks[3], (), jnp.float32, 30.0, 80.0),
    }


def _sites(key):
    """tests/test_stage1_int8.py's sites."""
    sites = {}
    for j in range(3):
        ks = jax.random.split(jax.random.fold_in(key, j), 4)
        cin = 64 if j == 0 else 256
        sites[f"layer1_{j}/conv1"] = _rand_site(ks[0], (1, 1, cin, 64))
        sites[f"layer1_{j}/conv2"] = _rand_site(ks[1], (3, 3, 64, 64))
        sites[f"layer1_{j}/conv3"] = _rand_site(ks[2], (1, 1, 64, 256))
        if j == 0:
            sites["layer1_0/downsample_conv"] = _rand_site(ks[3], (1, 1, 64, 256))
    sites["layer1_0/downsample_conv"]["inv_sa"] = sites["layer1_0/conv1"]["inv_sa"]
    return sites


def _torch_sites(sites):
    return {k: {n: torch.from_numpy(np.array(v)) for n, v in s.items()} for k, s in sites.items()}


def test_plain_matches_jax_kernel():
    sites = _sites(jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (2, H, W, 64), jnp.float32)
    ref = np.asarray(jstage1_int8.stage1_forward_q(x, sites, out_dtype=jnp.float32))
    packed = stage1_int8_cuda.pack(_torch_sites(sites))
    got = stage1_int8_cuda.stage1_plain(torch.from_numpy(np.array(x)), packed)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)
    # The CPU route of the wrapper is the plain version, emitted as bf16.
    out = stage1_int8_cuda.stage1_forward_q(torch.from_numpy(np.array(x)), packed)
    assert out.dtype == torch.bfloat16 and out.shape == (2, H, W, 256)
    torch.testing.assert_close(out, got.to(torch.bfloat16), rtol=0, atol=0)


def test_plain_tracks_qconv_walk():
    """The structure (strides, residuals, site wiring) agrees with the
    per-conv quant._qconv walk; only requantise ties may differ."""
    sites = _torch_sites(_sites(jax.random.key(2)))
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.key(3), (2, H, W, 64))))
    got = stage1_int8_cuda.stage1_plain(x, stage1_int8_cuda.pack(sites)).numpy()

    def qconv(v, key, pad):
        return quant._qconv(v, sites[key], 1, pad)

    y = torch.relu(qconv(x, "layer1_0/conv1", 0))
    y = torch.relu(qconv(y, "layer1_0/conv2", 1))
    y = qconv(y, "layer1_0/conv3", 0)
    walk = torch.relu(y + qconv(x, "layer1_0/downsample_conv", 0))
    for j in (1, 2):
        y = torch.relu(qconv(walk, f"layer1_{j}/conv1", 0))
        y = torch.relu(qconv(y, f"layer1_{j}/conv2", 1))
        walk = torch.relu(qconv(y, f"layer1_{j}/conv3", 0) + walk)
    walk = walk.numpy()
    assert np.abs(got - walk).mean() / (np.abs(walk).mean() + 1e-9) < 0.02
    cos = float((got * walk).sum() / (np.linalg.norm(got) * np.linalg.norm(walk) + 1e-9))
    assert cos > 0.999, cos


def test_pack_layout_and_sites_gate():
    sites = _torch_sites(_sites(jax.random.key(4)))
    assert stage1_int8_cuda.sites_ok(sites)
    packed = stage1_int8_cuda.pack(sites)
    b0, b1 = packed[0], packed[1]
    assert b0.w1.shape == (64, 64) and b1.w1.shape == (64, 256) and b1.wd is None
    assert b0.wd.shape == (256, 64) and b0.w2.shape == (64, 576) and b0.w3.shape == (256, 64)
    # Tap t of the packed 3x3 is HWIO[dy + 1, dx + 1] transposed.
    torch.testing.assert_close(b0.w2[:, 64 * 5:64 * 6], sites["layer1_0/conv2"]["w8"][1, 2].T)
    # conv1's epilogue carries conv2's requantise factor.
    torch.testing.assert_close(
        b1.s1, sites["layer1_1/conv1"]["scale"] * sites["layer1_1/conv2"]["inv_sa"])
    del sites["layer1_1/conv2"]
    assert not stage1_int8_cuda.sites_ok(sites)
