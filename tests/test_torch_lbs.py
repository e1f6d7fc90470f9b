"""The port's LBS blend and MANO forward against the JAX package's.

The plain blend against `lbs_pallas.lbs_blend` (Pallas in interpret mode)
within rtol / atol 1e-5, the JAX test's own bound; `mano_forward` and the
vertices of `sample_hypotheses` (default mods) within 1e-4 (mm, and bone
lengths for the normalised vertices), well inside ROADMAP's 0.02 mm budget.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import lbs_pallas
from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu_torch.convert import from_jax
from mhentropy_tpu_torch.core import lbs_cuda, mano
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


@pytest.mark.parametrize("v,j,rows", [(778, 16, 100), (1500, 24, 100)])
def test_plain_blend_matches_pallas(v, j, rows):
    rng = np.random.RandomState(0)
    w = np.abs(rng.randn(v, j)).astype(np.float32)
    rot = rng.randn(3, 3, j, rows).astype(np.float32)
    trans = rng.randn(3, j, rows).astype(np.float32)
    vp = rng.randn(3, v, rows).astype(np.float32)
    ref = np.asarray(lbs_pallas.lbs_blend(*map(jnp.asarray, (w, rot, trans, vp)), tile=128))
    before = lbs_cuda.launches
    got = lbs_cuda.lbs_blend(*map(torch.from_numpy, (w, rot, trans, vp)))
    assert lbs_cuda.launches == before  # CPU tensors take the plain version
    assert got.shape == (3, v, rows)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_mano_forward_matches_jax():
    rng = np.random.RandomState(1)
    theta = (rng.randn(4, 48) * 0.3).astype(np.float32)
    beta = (rng.randn(4, 10) * 0.5).astype(np.float32)
    v_ref, j_ref = jmano.mano_forward(jmano.synthetic_mano_model(0), jnp.asarray(theta),
                                      jnp.asarray(beta))
    v, j = mano.mano_forward(mano.synthetic_mano_model(0), torch.from_numpy(theta),
                             torch.from_numpy(beta))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-4)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), atol=1e-4)


def test_sample_hypotheses_verts_match_jax():
    """Default mods ("xyz", "uv", "verts"); the base noise is JAX's draw."""
    b, n, img, temp = 2, 3, 64, 0.8
    jcfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(16, 16), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=1),
        feat_dim=16, image_size=img)
    params, stats = jmhent.init(jax.random.key(0), jcfg)
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    image = np.random.RandomState(2).randn(b, img, img, 3).astype(np.float32)
    key = jax.random.key(3)
    ref = jmhent.sample_hypotheses(jmano.synthetic_mano_model(0), params, stats, jcfg,
                                   jnp.asarray(image), key, n=n, temp=temp)
    noise = np.array(jax.random.normal(key, (n * b, 45)) * temp)

    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(16, 16), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=1),
        feat_dim=16, image_size=img)
    net = mhent.MHEnt(cfg)
    net.load_state_dict(from_jax(params, stats), strict=True)
    with torch.inference_mode():
        out = mhent.sample_hypotheses(mano.synthetic_mano_model(0), net.eval(),
                                      torch.from_numpy(image), n=n, temp=temp,
                                      base_noise=torch.from_numpy(noise))
    assert out["verts"].shape == (n, b, 778 * 3)
    np.testing.assert_allclose(out["verts"].numpy(), np.asarray(ref["verts"]), atol=1e-4)
    np.testing.assert_array_equal(out["faces"].numpy(), np.asarray(ref["faces"]))
