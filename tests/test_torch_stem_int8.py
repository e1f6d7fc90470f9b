"""The port's W8A8 stem (models/stem_int8_cuda.py) against the JAX package's
(models/stem_int8.py), on the JAX test's random weights and images.

* prepare_stem_site: the int8 weights equal, the f32 scales within rel 1e-6
  (the same f32 ops).
* stem_plain against `stem_int8.xla_reference`, the reference's own parity
  definition, at (1, 64, 256, 3) and (2, 8, 256, 3): the integer sums are
  exact on both sides, so rtol 1e-5 / atol 1e-4 (tests/test_stem_int8.py's
  bound) covers the f32 epilogue.
* supported: the JAX gate's cases, its backend clause aside.
* pack's kernel operand wq: its layout, and contracted with a plain im2col
  in the kernel's K order, stem_plain's result exactly; the kernel's band
  planner and column tiles.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import stem_int8 as jstem_int8
from mhentropy_tpu_torch.models import stem_int8_cuda
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)


def _params(key):
    """tests/test_stem_int8.py's weights."""
    ks = jax.random.split(key, 5)
    kernel = jax.random.normal(ks[0], (7, 7, 3, 64)) * 0.1
    bn_p = {"scale": 1.0 + jax.random.normal(ks[1], (64,)) * 0.2,
            "bias": jax.random.normal(ks[2], (64,)) * 0.1}
    bn_s = {"mean": jax.random.normal(ks[3], (64,)) * 0.1,
            "var": 1.0 + jax.random.uniform(ks[4], (64,)) * 0.5}
    return kernel, bn_p, bn_s


def _torch_site(site):
    return {k: torch.from_numpy(np.array(v)) for k, v in site.items()}


def _port_modules(kernel, bn_p, bn_s):
    conv_w = torch.from_numpy(np.array(kernel)).permute(3, 2, 0, 1).contiguous()
    bn = torch.nn.BatchNorm2d(64).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(bn_p["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(bn_p["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.array(bn_s["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.array(bn_s["var"])))
    return conv_w, bn


def test_prepare_stem_site_matches_jax():
    kernel, bn_p, bn_s = _params(jax.random.key(0))
    image = jax.random.normal(jax.random.key(9), (1, 64, 256, 3)) * 1.5
    amax = jnp.max(jnp.abs(image), axis=(0, 1, 2))
    ref = jstem_int8.prepare_stem_site(kernel, bn_p, bn_s, amax)
    conv_w, bn = _port_modules(kernel, bn_p, bn_s)
    got = stem_int8_cuda.prepare_stem_site(conv_w, bn, torch.from_numpy(np.array(amax)))
    assert set(got) == set(ref) == {"w8", "inv_a", "scale", "bias"}
    assert got["w8"].dtype == torch.int8 and got["w8"].shape == (7, 7, 3, 64)
    np.testing.assert_array_equal(got["w8"].numpy(), np.asarray(ref["w8"]))
    for name in ("inv_a", "scale", "bias"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("shape,seed", [((1, 64, 256, 3), 0), ((2, 8, 256, 3), 1)])
def test_stem_plain_matches_xla_reference(shape, seed):
    kernel, bn_p, bn_s = _params(jax.random.key(seed))
    image = jax.random.normal(jax.random.key(9 + seed), shape) * 1.5
    site = jstem_int8.prepare_stem_site(kernel, bn_p, bn_s,
                                        jnp.max(jnp.abs(image), axis=(0, 1, 2)))
    ref = np.asarray(jstem_int8.xla_reference(image, site))
    tsite = _torch_site(site)
    got = stem_int8_cuda.stem_plain(torch.from_numpy(np.array(image)), tsite)
    assert got.shape == ref.shape == (shape[0], shape[1] // 4, 64, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # The CPU route of the wrapper is the plain version, in the asked dtype.
    packed = stem_int8_cuda.pack(tsite)
    for dtype in (torch.float32, torch.bfloat16):
        out = stem_int8_cuda.stem_forward_q(torch.from_numpy(np.array(image)), packed,
                                            out_dtype=dtype)
        assert out.dtype == dtype
        torch.testing.assert_close(out, got.to(dtype), rtol=0, atol=0)


def test_pack_layout():
    kernel, bn_p, bn_s = _params(jax.random.key(2))
    site = _torch_site(jstem_int8.prepare_stem_site(kernel, bn_p, bn_s, jnp.ones(3)))
    site["scale"][::3] *= -1  # BN's gamma may be negative
    packed = stem_int8_cuda.pack(site)
    wq = packed["wq"]
    assert wq.shape == (64, 224) and wq.dtype == torch.int8 and wq.is_contiguous()
    # wq[f, ky * 32 + kx * 3 + c] = w8[ky, kx, c, f] times the sign of
    # scale[f]; each run's taps 21-31 are zero. The kernel reads wq alone.
    sign = torch.where(site["scale"] < 0, -1, 1)
    assert (sign < 0).any() and (sign > 0).any()
    for ky, kx, c, f in ((0, 0, 0, 0), (3, 6, 2, 17), (6, 4, 1, 63), (2, 1, 0, int(sign.argmin()))):
        assert wq[f, ky * 32 + kx * 3 + c] == site["w8"][ky, kx, c, f] * sign[f]
    assert not wq.reshape(64, 7, 32)[:, :, 21:].any()
    assert set(packed) == {"w8", "wq", "inv_a", "scale", "bias"}


@pytest.mark.parametrize("shape,seed", [((1, 64, 256, 3), 3), ((2, 37, 50, 3), 4)])
def test_packed_operand_contracts_to_stem_plain(shape, seed):
    """pack's wq against a plain im2col in the kernel's K order: conv (i, j)'s
    K byte ky * 32 + t is padded-image byte 3 (2 j + kx) + c of row 2 i + ky
    for t = 3 kx + c < 24 (t = 21-23: the next pixel), t = 24-31 random. The
    exact integer sum, pooled first (its affine with |scale| is
    non-decreasing), then the affine, gives stem_plain's result."""
    kernel, bn_p, bn_s = _params(jax.random.key(seed))
    image = jax.random.normal(jax.random.key(20 + seed), shape) * 1.5
    site = _torch_site(jstem_int8.prepare_stem_site(kernel, bn_p, bn_s,
                                                    jnp.max(jnp.abs(image), axis=(0, 1, 2))))
    site["scale"][1::4] *= -1  # BN's gamma may be negative
    x = torch.from_numpy(np.array(image))
    xq = torch.clamp(torch.round(x * site["inv_a"]), -127, 127)
    b, h, w, _ = xq.shape
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = torch.nn.functional.pad(xq, (0, 0, 3, 5, 3, 3))  # 3 rows each side; cols 3 left, 5 right
    gen = torch.Generator().manual_seed(seed)
    cols = torch.cat([t for ky in range(7) for t in (
        torch.cat([xp[:, ky:ky + 2 * hc - 1:2, kx:kx + 2 * wc - 1:2] for kx in range(8)], -1),
        torch.randint(-127, 128, (b, hc, wc, 8), generator=gen).float())], -1)  # (b, hc, wc, 224)
    acc = cols.double() @ stem_int8_cuda.pack(site)["wq"].T.double()
    pooled = torch.nn.functional.max_pool2d(acc.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    got = torch.relu(pooled.permute(0, 2, 3, 1).float() * site["scale"].abs() + site["bias"])
    torch.testing.assert_close(got, stem_int8_cuda.stem_plain(x, site), rtol=0, atol=0)


def test_plan_band_and_col_tiles():
    """The kernel's blocks: one wave of 128 on 132 SMs at B = 32 and 8 (bands
    of 32 and 8 conv rows), even bands, one column tile up to W = 256."""
    assert stem_int8_cuda.plan_band(32, 128, 1, 132) == 32
    assert stem_int8_cuda.plan_band(8, 128, 1, 132) == 8
    assert stem_int8_cuda.plan_band(1, 128, 1, 132) == 2
    assert stem_int8_cuda.plan_band(1, 1, 1, 132) == 2
    assert all(stem_int8_cuda.plan_band(b, r, 1, 132) % 2 == 0
               for b in (1, 3, 64) for r in (1, 19, 36))
    assert [stem_int8_cuda.col_tiles(wp) for wp in (1, 64, 65, 127, 128)] == [1, 1, 2, 2, 3]


@pytest.mark.parametrize("shape,filters,train", [
    ((2, 256, 256, 3), 64, False), ((1, 64, 256, 3), 64, False), ((1, 8, 256, 3), 64, False),
    ((1, 4, 256, 3), 64, False), ((1, 66, 256, 3), 64, False), ((1, 64, 128, 3), 64, False),
    ((1, 64, 256, 4), 64, False), ((64, 256, 3), 64, False), ((1, 64, 256, 3), 32, False),
    ((1, 64, 256, 3), 64, True)])
def test_supported_is_the_jax_gate(shape, filters, train):
    x = np.zeros(shape, np.float32)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        want = jstem_int8.supported(jnp.asarray(x), filters, train)
    assert stem_int8_cuda.supported(torch.from_numpy(x), filters, train) == want
