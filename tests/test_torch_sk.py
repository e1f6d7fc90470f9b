"""The port's SK preprocessing and canonical frame (data/sk.py) against the
JAX package's, on the same seeded inputs.

Both are host numpy (and cv2) on the same formulas, so every output is held
equal exactly, the SK scene's full preprocessing included (its point
cloud's draw from one seeded RandomState on each side).
"""

import numpy as np
import pytest

from mhentropy_tpu.data import sk as jsk
from mhentropy_tpu_torch.data import sk

pytest.importorskip("cv2")


def _sample_sk_scene(seed=0):
    """A hand about 520 mm deep, +-45 mm across, in both views (the scene of
    tests/test_sk_canonical_parity.py)."""
    rng = np.random.RandomState(seed)
    k_d = np.array([[480.0, 0, 320.0], [0, 480.0, 240.0], [0, 0, 1.0]])
    k_rgb = np.array([[500.0, 0, 322.0], [0, 500.0, 238.0], [0, 0, 1.0]])
    translation = np.array([[8.0], [-5.0], [3.0]])
    kp = np.array([[0, 0, 520.0]]).T + rng.uniform(-45, 45, (3, 21))
    image = rng.randint(0, 255, (480, 640, 3)).astype(np.uint8)
    depth = np.full((480, 640), 1000.0)
    depth[200:290, 280:370] = 520.0 + rng.uniform(-25, 25, (90, 90))
    return image, depth, kp, k_rgb, k_d, np.eye(3), translation


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["canonical_trafo", "flip_right_hand", "convert_kp", "imcrop",
                                  "depth2mask", "view_correction_sk"])
def test_function_matches_jax(name):
    rng = np.random.RandomState(1)
    cases = {
        "canonical_trafo": [(rng.randn(5, 21, 3),), (rng.randn(21, 3),)],
        "flip_right_hand": [(rng.randn(3, 21, 3), np.array([True, False, True])),
                            (rng.randn(21, 3), True),
                            (rng.randn(2, 21, 3), np.array([True, False])[:, None, None])],
        "convert_kp": [(rng.randn(21, 3),)],
        "imcrop": [(rng.randint(0, 255, (480, 640, 3)).astype(np.uint8), c, h)
                   for c, h in (((320.0, 240.0), 60.0), ((30.0, 20.0), 80.0),
                                ((620.0, 470.0), 50.0))]
                  + [(rng.uniform(0, 1000, (480, 640)), (30.0, 20.0), 80.0)],
        "depth2mask": [(rng.uniform(300, 800, (480, 640)), (400, 650), c, h)
                       for c, h in (((320.0, 240.0), 70.0), ((10.0, 10.0), 50.0))],
        "view_correction_sk": [((300.0, 200.0),
                                np.array([[480.0, 0, 320.0], [0, 480.0, 231.0], [0, 0, 1.0]]),
                                rng.randn(50, 3), rng.randn(21, 3))],
    }[name]
    for args in cases:
        _equal(getattr(sk, name)(*args), getattr(jsk, name)(*args))


def test_preprocess_sample_sk_matches_jax():
    scene = _sample_sk_scene()
    got = sk.preprocess_sample_sk(*scene, rng=np.random.RandomState(11))
    want = jsk.preprocess_sample_sk(*scene, rng=np.random.RandomState(11))
    _equal(got, want)
    assert got["heatmaps"].shape == (64, 64, 21) and got["image_crop"].shape == (256, 256, 3)
    # The canonical frame's invariants on the port: root at the origin,
    # the middle finger's MCP on the y axis.
    out, _ = sk.canonical_trafo(got["pose3d"])
    np.testing.assert_allclose(out[:, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[:, 12, [0, 2]], 0.0, atol=1e-6)


def test_constants_equal():
    np.testing.assert_array_equal(sk._SK_KP_PERM, jsk._SK_KP_PERM)
    assert sk.SK_DEPTH_RANGE_MM == jsk.SK_DEPTH_RANGE_MM
