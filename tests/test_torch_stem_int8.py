"""The port's W8A8 stem (models/stem_int8_cuda.py) against the JAX package's
(models/stem_int8.py), on the JAX test's random weights and images.

* prepare_stem_site: the int8 weights equal, the f32 scales within rel 1e-6
  (the same f32 ops).
* stem_plain against `stem_int8.xla_reference`, the reference's own parity
  definition, at (1, 64, 256, 3) and (2, 8, 256, 3): the integer sums are
  exact on both sides, so rtol 1e-5 / atol 1e-4 (tests/test_stem_int8.py's
  bound) covers the f32 epilogue.
* supported: the JAX gate's cases, its backend clause aside.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import stem_int8 as jstem_int8
from mhentropy_tpu_torch.models import stem_int8_cuda


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
    wk = stem_int8_cuda.pack(site)["wk"]
    assert wk.shape == (7, 64, 24) and wk.dtype == torch.int8 and wk.is_contiguous()
    # wk[ky, f, kx * 3 + c] = w8[ky, kx, c, f]; the three pad taps are zero.
    for ky, kx, c, f in ((0, 0, 0, 0), (3, 6, 2, 17), (6, 4, 1, 63)):
        assert wk[ky, f, kx * 3 + c] == site["w8"][ky, kx, c, f]
    assert not wk[:, :, 21:].any()


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
