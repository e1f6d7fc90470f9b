"""The port's plain W8A8 stage 2/3 (models/stage2_int8_cuda.py) against the
JAX package's `stage2_int8.stage_forward_q` (Pallas kernel in interpret
mode), on the JAX test's random sites.

* At the JAX test's small geometry StageGeom(8, 16, 32, 2, 32): the integer
  products are exact in both, so rtol 1e-6 / atol 1e-4 covers f32 ulps of
  the epilogues (the JAX test's bound against its numpy replica).
* At the real stage-2 geometry (4 blocks) and the stage-3 widths at 3
  blocks, B = 1: the interpreted kernel's f32 epilogues differ from the
  plain version's in the last ulp (about 14 % of a block's outputs), and
  random, uncalibrated sites grow the activations block by block until such
  an ulp flips a requantise tie, so the bound is tests/test_stage2_int8.py's
  own for those depths: median relative error below 1e-5, at most 0.2 % of
  the values off by more than 1 %, cosine above 0.9999.
* The full 6-block stage 3, where the flips cascade, is held to that JAX
  file's full-stage-3 bound: median relative error below 1e-4, cosine above
  0.995.
"""

from unittest import mock

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import stage2_int8 as jstage2_int8
from mhentropy_tpu_torch.models import stage2_int8_cuda
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

TEST_GEOM = (8, 16, 32, 2, 32)


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


def _sites(key, stage, g):
    """tests/test_stage2_int8.py's sites."""
    sites = {}
    for j in range(g.n_blocks):
        ks = jax.random.split(jax.random.fold_in(key, j), 4)
        cin = g.cin if j == 0 else g.cout
        sites[f"layer{stage}_{j}/conv1"] = _rand_site(ks[0], (1, 1, cin, g.width))
        sites[f"layer{stage}_{j}/conv2"] = _rand_site(ks[1], (3, 3, g.width, g.width))
        sites[f"layer{stage}_{j}/conv3"] = _rand_site(ks[2], (1, 1, g.width, g.cout))
        if j == 0:
            sites[f"layer{stage}_0/downsample_conv"] = _rand_site(ks[3], (1, 1, g.cin, g.cout))
    sites[f"layer{stage}_0/downsample_conv"]["inv_sa"] = sites[f"layer{stage}_0/conv1"]["inv_sa"]
    return sites


def _torch_sites(sites):
    return {k: {n: torch.from_numpy(np.array(v)) for n, v in s.items()} for k, s in sites.items()}


def test_plain_matches_jax_kernel_at_the_test_geometry(monkeypatch):
    monkeypatch.setitem(jstage2_int8.GEOMS, 9, jstage2_int8.StageGeom(*TEST_GEOM))
    monkeypatch.setitem(stage2_int8_cuda.GEOMS, 9, stage2_int8_cuda.StageGeom(*TEST_GEOM))
    g = stage2_int8_cuda.GEOMS[9]
    sites = _sites(jax.random.key(0), 9, g)
    x = jax.random.normal(jax.random.key(1), (2, g.w_in, g.w_in, g.cin), jnp.float32)
    ref = np.asarray(jstage2_int8.stage_forward_q(x, sites, stage=9, out_dtype=jnp.float32))
    packed = stage2_int8_cuda.pack(_torch_sites(sites), 9)
    xt = torch.from_numpy(np.array(x))
    got = stage2_int8_cuda.stage_plain(xt, packed)
    assert got.shape == ref.shape == (2, g.w_in // 2, g.w_in // 2, g.cout)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)
    # The CPU route of the wrapper is the plain version, in the asked dtype.
    for dtype in (torch.float32, torch.bfloat16):
        out = stage2_int8_cuda.stage_forward_q(xt, packed, 9, out_dtype=dtype)
        assert out.dtype == dtype
        torch.testing.assert_close(out, got.to(dtype), rtol=0, atol=0)


def _real_geometry_errors(monkeypatch, stage, n_blocks):
    g = stage2_int8_cuda.GEOMS[stage]
    assert tuple(g) == tuple(jstage2_int8.GEOMS[stage])
    g = g._replace(n_blocks=n_blocks)
    monkeypatch.setitem(jstage2_int8.GEOMS, 9, jstage2_int8.StageGeom(*g))
    monkeypatch.setitem(stage2_int8_cuda.GEOMS, 9, g)
    sites = _sites(jax.random.key(2), 9, g)
    x = jax.random.normal(jax.random.key(3), (1, g.w_in, g.w_in, g.cin), jnp.float32)
    ref = np.asarray(jstage2_int8.stage_forward_q(x, sites, stage=9, out_dtype=jnp.float32))
    got = stage2_int8_cuda.stage_plain(torch.from_numpy(np.array(x)),
                                       stage2_int8_cuda.pack(_torch_sites(sites), 9)).numpy()
    assert got.shape == ref.shape == (1, g.w_in // 2, g.w_in // 2, g.cout)
    rel = np.abs(got - ref) / (np.abs(ref) + 1.0)
    cos = float((got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref) + 1e-9))
    return rel, cos


@pytest.mark.parametrize("stage,n_blocks", [(2, 4), (3, 3)])
def test_plain_tracks_jax_kernel_at_the_real_geometry(monkeypatch, stage, n_blocks):
    rel, cos = _real_geometry_errors(monkeypatch, stage, n_blocks)
    assert np.median(rel) < 1e-5, np.median(rel)
    assert (rel > 0.01).mean() < 0.002, (rel > 0.01).mean()
    assert cos > 0.9999, cos


def test_plain_tracks_jax_kernel_over_the_full_stage_3(monkeypatch):
    rel, cos = _real_geometry_errors(monkeypatch, 3, 6)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert cos > 0.995, cos


def test_pack_layout_and_sites_gate():
    g = stage2_int8_cuda.GEOMS[2]
    sites = _torch_sites(_sites(jax.random.key(4), 2, g))
    assert stage2_int8_cuda.sites_ok(sites, 2) and not stage2_int8_cuda.sites_ok(sites, 3)
    packed = stage2_int8_cuda.pack(sites, 2)
    assert len(packed) == g.n_blocks
    b0, b1 = packed[0], packed[1]
    assert b0.w1.shape == (128, 256) and b1.w1.shape == (128, 512) and b1.wd is None
    assert b0.wd.shape == (512, 256) and b0.w2.shape == (128, 1152) and b0.w3.shape == (512, 128)
    # Tap t of the packed 3x3 is HWIO[dy + 1, dx + 1] transposed.
    torch.testing.assert_close(b1.w2[:, 128 * 5:128 * 6], sites["layer2_1/conv2"]["w8"][1, 2].T)
    # conv1 carries conv2's requantise factor, conv2 conv3's; conv3 none.
    torch.testing.assert_close(
        b1.s1, sites["layer2_1/conv1"]["scale"] * sites["layer2_1/conv2"]["inv_sa"])
    torch.testing.assert_close(
        b1.b2, sites["layer2_1/conv2"]["bias"] * sites["layer2_1/conv3"]["inv_sa"])
    torch.testing.assert_close(b1.s3, sites["layer2_1/conv3"]["scale"])
    torch.testing.assert_close(b1.inv_in, sites["layer2_1/conv1"]["inv_sa"].reshape(1))
    for name in ("layer2_3/conv2", "layer2_0/downsample_conv"):
        partial = dict(sites)
        del partial[name]
        assert not stage2_int8_cuda.sites_ok(partial, 2)


@pytest.mark.parametrize("shape,dtype,stage,train", [
    ((1, 64, 64, 256), torch.float32, 2, False), ((2, 32, 32, 512), torch.bfloat16, 3, False),
    ((1, 64, 64, 256), torch.int8, 2, False), ((1, 64, 64, 256), torch.float32, 3, False),
    ((1, 32, 64, 256), torch.float32, 2, False), ((64, 64, 256), torch.float32, 2, False),
    ((1, 64, 64, 256), torch.float32, 2, True), ((1, 64, 64, 256), torch.float32, 4, False)])
def test_supported_is_the_jax_gate(shape, dtype, stage, train):
    x = torch.zeros(shape, dtype=dtype)
    jx = jnp.zeros(shape, {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                           torch.int8: jnp.int8}[dtype])
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        want = jstage2_int8.supported(jx, stage, train)
    assert stage2_int8_cuda.supported(x, stage, train) == want
