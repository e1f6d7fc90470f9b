"""The port's MANO decode, rotations and camera vs the JAX package.

Both packages build `synthetic_mano_model(0)` from the same numpy seed (the
constants must be equal exactly); θ (B, 48) and β (B, 10) come from numpy.
Joints within 0.02 mm (the reference's MANO budget), verts too when asked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import camera as jcamera
from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.core import rotations as jrot
from mhentropy_tpu_torch.core import camera, mano, rotations
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

MM_TOL = 0.02


@pytest.fixture(scope="module")
def models():
    return jmano.synthetic_mano_model(0), mano.synthetic_mano_model(0)


def _pose(seed, b=5):
    rng = np.random.RandomState(seed)
    theta = (rng.randn(b, 48) * 0.5).astype(np.float32)
    beta = (rng.randn(b, 10) * 0.5).astype(np.float32)
    return theta, beta


def test_synthetic_model_constants_equal(models):
    jm, tm = models
    for name in jmano.ManoModel._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)


@pytest.mark.parametrize("skeidx", ["RHD", "BigHand", "FreiHand"])
def test_mano_decode_matches_jax(models, skeidx):
    jm, tm = models
    theta, beta = _pose(1)
    ref = jmano.mano_decode(jm, jnp.asarray(theta), jnp.asarray(beta), skeidx=skeidx)
    ours = mano.mano_decode(tm, torch.from_numpy(theta), torch.from_numpy(beta),
                            skeidx=skeidx, with_mesh=True)
    for key in ("joints", "mano_joints", "mesh"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=MM_TOL,
                                   err_msg=key)


def test_mesh_only_when_asked(models):
    _, tm = models
    theta, beta = _pose(2)
    fold = mano.fold_keypoints(tm)
    out = mano.mano_decode(tm, torch.from_numpy(theta), torch.from_numpy(beta), fold=fold)
    assert "mesh" not in out and out["joints"].shape == (5, 21, 3)
    with pytest.raises(ValueError, match="skeidx"):
        mano.mano_decode(tm, torch.from_numpy(theta), torch.from_numpy(beta), skeidx="rhd")


def test_batch_rodrigues_matches_jax():
    aa = np.random.RandomState(3).randn(7, 16, 3).astype(np.float32)
    aa[0, 0] = 0.0  # the eps-smoothed zero rotation
    np.testing.assert_allclose(rotations.batch_rodrigues(torch.from_numpy(aa)).numpy(),
                               np.asarray(jrot.batch_rodrigues(jnp.asarray(aa))), atol=1e-6)


@pytest.mark.parametrize("inv_norm", [True, False])
def test_camera_matches_jax(inv_norm):
    rng = np.random.RandomState(4)
    pose = rng.randn(3, 21, 3).astype(np.float32)
    scale = np.exp(rng.randn(3, 1)).astype(np.float32)
    trans = rng.randn(3, 2).astype(np.float32)
    jn, jroot, jbone = jcamera.batch_normalize_pose3d(jnp.asarray(pose), 12, 11, return_st=True)
    tn, troot, tbone = camera.batch_normalize_pose3d(torch.from_numpy(pose), 12, 11,
                                                     return_st=True)
    for a, b in ((tn, jn), (troot, jroot), (tbone, jbone)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    ref = jcamera.orth_project(jn, jnp.asarray(scale), jnp.asarray(trans), 64, inv_norm=inv_norm)
    ours = camera.orth_project(tn, torch.from_numpy(scale), torch.from_numpy(trans), 64,
                               inv_norm=inv_norm)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
