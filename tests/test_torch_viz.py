"""The port's utils/viz.py: JAX's tests/test_utils_extra.py `test_viz_outputs`
and `test_viewer_and_argutils` on the port's viz and logging, headless;
`generate_random_hand` against the JAX package's (the port's MANO on the
same seeded draws: joints and vertices within 0.02 mm, the MANO budget);
the plots' lines against the JAX module's on the same axes."""

import os

import numpy as np
import pytest

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.utils import viz as jviz
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.utils import viz
from mhentropy_tpu_torch.utils.logging import print_args, save_args

MM_TOL = 0.02


@pytest.fixture
def agg():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    return matplotlib


def test_viz_outputs(agg, tmp_path):
    pytest.importorskip("imageio")
    rng = np.random.RandomState(0)
    uv = rng.uniform(20, 230, (21, 2))
    img = rng.rand(256, 256, 3).astype(np.float32)
    p1 = viz.viz_2djoints(img, uv[None], os.path.join(tmp_path, "j.png"))
    assert os.path.getsize(p1) > 0
    verts = rng.randn(50, 3).astype(np.float32)
    faces = rng.randint(0, 50, (30, 3))
    p2 = viz.export_mano_mesh(verts, faces, os.path.join(tmp_path, "m.obj"))
    assert os.path.getsize(p2) > 0
    j2 = jviz.export_mano_mesh(verts, faces, os.path.join(tmp_path, "jm.obj"))
    assert open(p2).read() == open(j2).read()
    p3 = viz.export_pose3d_gif(rng.randn(21, 3).astype(np.float32),
                               os.path.join(tmp_path, "p.gif"), frames=4)
    assert os.path.getsize(p3) > 0


def test_gif_export_names_imageio_when_absent(agg, tmp_path, monkeypatch):
    """Without imageio the GIF export raises and writes nothing."""
    import builtins

    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name.split(".")[0] == "imageio":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    path = os.path.join(tmp_path, "p.gif")
    with pytest.raises(ImportError, match="imageio"):
        viz.export_pose3d_gif(np.zeros((21, 3), np.float32), path, frames=2)
    assert not os.path.exists(path)


def test_viewer_and_argutils(agg, tmp_path):
    model = mano.synthetic_mano_model(0)
    hand = viz.generate_random_hand(model, batch_size=2, ncomps=6, seed=1)
    assert hand["verts"].shape == (2, 778, 3) and hand["joints"].shape == (2, 21, 3)
    want = jviz.generate_random_hand(jmano.synthetic_mano_model(0), batch_size=2, ncomps=6,
                                     seed=1)
    for k in ("verts", "joints"):
        np.testing.assert_allclose(hand[k], np.asarray(want[k]), atol=MM_TOL, err_msg=k)
    np.testing.assert_array_equal(hand["faces"], np.asarray(want["faces"]))
    p1 = str(tmp_path / "hand.png")
    viz.display_hand(hand, mano_faces=hand["faces"], path=p1, show=False)
    assert os.path.getsize(p1) > 0
    p2 = str(tmp_path / "scene.png")
    viz.show_scene([(hand["verts"][0], hand["faces"]), (hand["verts"][1], hand["faces"])],
                   path=p2)
    assert os.path.getsize(p2) > 0
    print_args({"lr": 1e-4, "mode": "eval"})
    save_args({"lr": 1e-4}, str(tmp_path / "run"), verbose=False)
    assert (tmp_path / "run" / "opt.txt").exists() and (tmp_path / "run" / "opt.pkl").exists()


def test_plots_draw_what_jax_draws(agg):
    """plot_pose2d / plot_pose3d / cam_equal_aspect_3d put the same lines,
    points and limits on an axis as the JAX module's."""
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(3)
    uv, xyz = rng.uniform(20, 230, (21, 2)), rng.randn(21, 3)
    fig = plt.figure()
    axes = [fig.add_subplot(2, 2, 1), fig.add_subplot(2, 2, 2),
            fig.add_subplot(2, 2, 3, projection="3d"), fig.add_subplot(2, 2, 4, projection="3d")]
    for ax2, ax3, mod in ((axes[0], axes[2], jviz), (axes[1], axes[3], viz)):
        mod.plot_pose2d(ax2, uv, image=rng.rand(8, 8, 3) * 2 - 1)
        mod.plot_pose3d(ax3, xyz)
        mod.cam_equal_aspect_3d(ax3, xyz, flip_x=True)
    for a, b in ((axes[0], axes[1]), (axes[2], axes[3])):
        assert len(a.lines) == len(b.lines) == 5
        for la, lb in zip(a.lines, b.lines):
            np.testing.assert_array_equal(np.asarray(la.get_data()), np.asarray(lb.get_data()))
            assert la.get_color() == lb.get_color()
    assert axes[2].get_xlim() == axes[3].get_xlim() and axes[2].get_zlim() == axes[3].get_zlim()
    np.testing.assert_array_equal(viz.mesh_axis_tsfm(xyz), jviz.mesh_axis_tsfm(xyz))
    plt.close(fig)
    assert viz.COLORS_GT == jviz.COLORS_GT and viz.COLORS_PRED == jviz.COLORS_PRED
