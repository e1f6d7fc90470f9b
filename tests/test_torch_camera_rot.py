"""The port's perspective and crop conversions (core/camera.py) and rotation
helpers (core/rotations.py) against the JAX package's, on seeded numpy
inputs, at 1e-5 (f32 on both sides: the same formulas, evaluated in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import camera as jcamera
from mhentropy_tpu.core import rotations as jrotations
from mhentropy_tpu_torch.core import camera, rotations
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

B, K = 5, 21
TOL = 1e-5


def _close(got, want, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


def _inputs(seed=0):
    """A crop target as the loaders emit it: intrinsics, root, bone length,
    crop centre and size, hand sides of both kinds, a rotation inverse."""
    rng = np.random.RandomState(seed)
    f = rng.uniform(250, 350, B)
    cam = np.zeros((B, 3, 3), np.float32)
    cam[:, 0, 0], cam[:, 1, 1] = f, f * rng.uniform(0.95, 1.05, B)
    cam[:, 0, 2], cam[:, 1, 2] = rng.uniform(140, 180, (2, B))
    cam[:, 2, 2] = 1.0
    angle = rng.uniform(0, 2 * np.pi, B)
    rot = np.zeros((B, 3, 3))
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = (np.cos(angle), -np.sin(angle),
                                                              np.sin(angle), np.cos(angle))
    rot[:, :2, 2] = rng.uniform(-20, 20, (B, 2))
    rot[:, 2, 2] = 1.0
    target = {
        "camera": cam,
        "bone_length": rng.uniform(0.02, 0.04, B).astype(np.float32),
        "pose3d_root": np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B),
                                 rng.uniform(0.4, 0.6, B)], 1).astype(np.float32),
        "crop_center": rng.uniform(100, 220, (B, 2)).astype(np.float32),
        "crop_size": rng.uniform(40, 90, B).astype(np.float32),
        "hand_side": np.array([0, 1, 0, 1, 1], np.float32),
        "rot_mat_inv": np.linalg.inv(np.transpose(rot, (0, 2, 1)))[:, :, :2].astype(np.float32),
    }
    pose = (rng.randn(B, K, 3) * 1.5).astype(np.float32)
    return rng, target, pose


def _port(target):
    return {k: torch.from_numpy(np.array(v)) for k, v in target.items()}


def _jax(target):
    return {k: jnp.asarray(v) for k, v in target.items()}


def test_perspective_round_trip_matches_jax():
    rng, target, _ = _inputs(0)
    xyz = np.stack([rng.uniform(-0.1, 0.1, (B, K)), rng.uniform(-0.1, 0.1, (B, K)),
                    rng.uniform(0.4, 0.6, (B, K))], -1).astype(np.float32)
    k = target["camera"]
    uvd = camera.xyz_to_uvd(torch.from_numpy(xyz), torch.from_numpy(k))
    _close(uvd.numpy(), jcamera.xyz_to_uvd(jnp.asarray(xyz), jnp.asarray(k)), "xyz_to_uvd")
    back = camera.uvd_to_xyz(uvd, torch.from_numpy(k))
    _close(back.numpy(), jcamera.uvd_to_xyz(jnp.asarray(uvd.numpy()), jnp.asarray(k)),
           "uvd_to_xyz")
    _close(back.numpy(), xyz, "round trip")


def test_relocate_and_crop_to_original_uv_match_jax():
    rng, target, _ = _inputs(1)
    uv = rng.uniform(0, 320, (B, K, 2)).astype(np.float32)
    scale = (256 / (target["crop_size"] * 2)).astype(np.float32)
    got = camera.relocate_uv(torch.from_numpy(uv), torch.from_numpy(target["crop_center"]), 256,
                             torch.from_numpy(scale))
    _close(got.numpy(), jcamera.relocate_uv(jnp.asarray(uv), jnp.asarray(target["crop_center"]),
                                            256, jnp.asarray(scale)), "relocate_uv")
    args = [target[k] for k in ("crop_center", "crop_size", "hand_side")]
    got = camera.crop_to_original_uv(torch.from_numpy(uv), *map(torch.from_numpy, args), 256)
    _close(got.numpy(), jcamera.crop_to_original_uv(jnp.asarray(uv), *map(jnp.asarray, args),
                                                    256), "crop_to_original_uv")


@pytest.mark.parametrize("side_2d", [False, True])
@pytest.mark.parametrize("uv_norm", [False, True])
def test_xyz_to_crop_and_crop_to_xyz_match_jax(side_2d, uv_norm):
    """Both hand-side encodings ((B,) flags and (B, 2) one-hots) and both uv
    conventions; the pose goes in flattened (B, 3K) as the heads emit it."""
    _, target, pose = _inputs(2)
    if side_2d:
        target["hand_side"] = np.stack([target["hand_side"], 1 - target["hand_side"]], 1)
    uv, d = camera.xyz_to_crop(torch.from_numpy(pose.reshape(B, -1)), _port(target))
    juv, jd = jcamera.xyz_to_crop(jnp.asarray(pose.reshape(B, -1)), _jax(target))
    _close(uv.numpy(), juv, "xyz_to_crop uv")
    _close(d.numpy(), jd, "xyz_to_crop depth")
    uv_in = uv.numpy() / 256 * 2 - 1 if uv_norm else uv.numpy()
    got = camera.crop_to_xyz(torch.from_numpy(uv_in), d, _port(target), uv_norm=uv_norm)
    want = jcamera.crop_to_xyz(jnp.asarray(uv_in), jnp.asarray(d.numpy()), _jax(target),
                               uv_norm=uv_norm)
    _close(got[0].numpy(), want[0], "crop_to_xyz uv")
    _close(got[1].numpy(), want[1], "crop_to_xyz xyz")


def test_project_rotmat_matches_jax():
    """Noisy rotations and reflections (det -1) project to the same
    rotation in both packages, with determinant +1."""
    rng = np.random.RandomState(3)
    rots = np.asarray(jrotations.batch_rodrigues(jnp.asarray(rng.randn(16, 3))))
    mats = rots + rng.randn(16, 3, 3) * 0.05
    mats[::4] *= -1.0
    mats = mats.astype(np.float32)
    got = rotations.project_rotmat(torch.from_numpy(mats))
    _close(got.numpy(), jrotations.project_rotmat(jnp.asarray(mats)), "project_rotmat")
    np.testing.assert_allclose(torch.linalg.det(got).numpy(), 1.0, atol=1e-5)


def test_posemap_axisang_matches_jax():
    rng = np.random.RandomState(4)
    pose = (rng.randn(B, 48) * 0.7).astype(np.float32)
    pose[0, :3] = 0.0  # the zero rotation stays smooth through the + eps norm
    pose_map, rots = rotations.posemap_axisang(torch.from_numpy(pose))
    jmap, jrots = jrotations.posemap_axisang(jnp.asarray(pose))
    assert pose_map.shape == (B, 16 * 9) and rots.shape == (B, 16, 3, 3)
    _close(pose_map.numpy(), jmap, "pose_map")
    _close(rots.numpy(), jrots, "rot_mats")
