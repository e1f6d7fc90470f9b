"""The port's SMPL body model and 6D rotations against the JAX package's
(core/smpl.py, core/rotations.py).

The fixture's arrays are equal (the same RandomState draws); the forwards
agree within 2e-5 m (0.02 mm) on the fixture at n_verts = 256 and at SMPL's
6,890; `load_smpl_pkl` reads a pickle that the test writes as both packages
read it.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from mhentropy_tpu.core import rotations as jrot
from mhentropy_tpu.core import smpl as jsmpl
from mhentropy_tpu_torch.core import lbs_cuda, rotations, smpl
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

ATOL_M = 2e-5  # 0.02 mm


@pytest.fixture(scope="module", params=[256, 6890])
def models(request):
    return (jsmpl.synthetic_smpl_model(0, n_verts=request.param),
            smpl.synthetic_smpl_model(0, n_verts=request.param))


def test_rotmat_from_6d_matches_jax_columns():
    x6d = np.random.RandomState(0).randn(5, 24, 6).astype(np.float32)
    want = np.asarray(jrot.rotmat_from_6d(jnp.asarray(x6d)))
    got = rotations.rotmat_from_6d(torch.from_numpy(x6d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # Columns: the first column is a1 normalised.
    a1 = x6d[..., :3] / np.linalg.norm(x6d[..., :3], axis=-1, keepdims=True)
    np.testing.assert_allclose(got[..., :, 0], a1, atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def test_synthetic_fixture_equals_jax(models):
    jm, m = models
    for name in jsmpl.SmplModel._fields:
        np.testing.assert_array_equal(getattr(m, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)


def _pose(b, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, 72) * 0.4).astype(np.float32),
            (rng.randn(b, 10) * 0.5).astype(np.float32),
            (rng.randn(b, 3) * 0.2).astype(np.float32))


def test_smpl_forward_matches_jax(models):
    jm, m = models
    aa, betas, transl = _pose(4, 1)
    rotmats = np.asarray(jrot.batch_rodrigues(jnp.asarray(aa.reshape(4, 24, 3))))
    v_ref, j_ref = jsmpl.smpl_forward(jm, jnp.asarray(rotmats), jnp.asarray(betas),
                                      transl=jnp.asarray(transl))
    before = lbs_cuda.launches
    v, j = smpl.smpl_forward(m, torch.from_numpy(rotmats), torch.from_numpy(betas),
                             transl=torch.from_numpy(transl))
    assert lbs_cuda.launches == before  # CPU tensors take the plain blend
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=ATOL_M, rtol=0)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), atol=ATOL_M, rtol=0)
    none, j2 = smpl.smpl_forward(m, torch.from_numpy(rotmats), torch.from_numpy(betas),
                                 transl=torch.from_numpy(transl), with_mesh=False)
    assert none is None and torch.equal(j2, j)


def test_smpl_forward_axis_angle_and_6d_match_jax(models):
    jm, m = models
    aa, betas, transl = _pose(3, 2)
    v_ref, j_ref = jsmpl.smpl_forward_axis_angle(jm, jnp.asarray(aa), jnp.asarray(betas))
    v, j = smpl.smpl_forward_axis_angle(m, torch.from_numpy(aa), torch.from_numpy(betas))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=ATOL_M, rtol=0)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), atol=ATOL_M, rtol=0)
    p6d = np.random.RandomState(3).randn(3, 144).astype(np.float32)
    v_ref, j_ref = jsmpl.smpl_forward_6d(jm, jnp.asarray(p6d), jnp.asarray(betas),
                                         transl=jnp.asarray(transl))
    v, j = smpl.smpl_forward_6d(m, torch.from_numpy(p6d), torch.from_numpy(betas),
                                transl=torch.from_numpy(transl))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=ATOL_M, rtol=0)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), atol=ATOL_M, rtol=0)


def test_load_smpl_pkl_matches_jax(tmp_path):
    """The fields SMPL pickles carry: a sparse J_regressor and 300 shape
    directions, of which both packages keep 10."""
    rng = np.random.RandomState(4)
    v = 64
    data = {"v_template": rng.randn(v, 3), "shapedirs": rng.randn(v, 3, 300),
            "posedirs": rng.randn(v, 3, 207),
            "J_regressor": scipy.sparse.csc_matrix(rng.rand(24, v) * (rng.rand(24, v) > 0.9)),
            "weights": rng.rand(v, 24), "f": rng.randint(0, v, (30, 3)).astype(np.uint32)}
    path = tmp_path / "SMPL_TEST.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)
    want = jsmpl.load_smpl_pkl(str(path))
    got = smpl.load_smpl_pkl(str(path))
    assert got.shapedirs.shape == (v, 3, 10) and got.faces.dtype == torch.int32
    for name in jsmpl.SmplModel._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
