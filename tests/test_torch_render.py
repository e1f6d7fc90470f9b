"""The port's splatting renderer (core/render.py) and the "m" / "depth"
mods of `mhent.decode` against the JAX package.

Inputs come from numpy seeds; both sides compute in f32 (the JAX products at
Precision.HIGH, f32-exact on the CPU). Tolerances:

* silhouette, depth and `render_mods` at B = 3, V = 778, S = 64: 1e-5
  absolute (the sums over 778 vertices in another order; measured 1.2e-7
  for the silhouette, 1.1e-6 for depths of about +-2);
* the silhouette's gradient w.r.t. the vertices: 1e-5 of its largest entry
  (measured 2e-7);
* `decode(mods=("uv", "m", "depth"))` on the synthetic MANO: xyz, verts
  and uv within 1e-5 (normalised units; measured 1.2e-6), the mask and
  depth within 1e-4 (measured 4.2e-6: the mesh's own f32 differences,
  moved through the splats' slopes of about 20 per unit of uv).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.core import render as jrender
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu_torch.core import camera, mano, render
from mhentropy_tpu_torch.models import mhent
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

B, V, S = 3, 778, 64
TOL = 1e-5
DECODE_TOL = {"xyz": 1e-5, "verts": 1e-5, "uv": 1e-5, "mask": 1e-4, "depth": 1e-4}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    uv = rng.uniform(-0.6, 0.6, (B, V, 2)).astype(np.float32)
    z = (rng.randn(B, V) * 0.5).astype(np.float32)
    verts = (rng.randn(B, V, 3) * 0.5).astype(np.float32)
    logs_t = np.concatenate([np.log(rng.uniform(0.3, 0.5, (B, 1))),
                             rng.randn(B, 2) * 0.1], 1).astype(np.float32)
    return uv, z, verts, logs_t


@pytest.mark.parametrize("fn", ["silhouette", "depth", "render_mods"])
def test_splats_match_jax(fn):
    uv, z, verts, logs_t = _inputs()
    t = torch.from_numpy
    if fn == "silhouette":
        want = {"mask": jrender.splat_silhouette(jnp.asarray(uv), mask_size=S)}
        got = {"mask": render.splat_silhouette(t(uv), mask_size=S)}
    elif fn == "depth":
        want = {"depth": jrender.splat_depth(jnp.asarray(uv), jnp.asarray(z), mask_size=S)}
        got = {"depth": render.splat_depth(t(uv), t(z), mask_size=S)}
    else:
        want = jrender.render_mods(jnp.asarray(verts), jnp.asarray(logs_t), mods=("m", "depth"),
                                   mask_size=S)
        got = render.render_mods(t(verts), t(logs_t), mods=("m", "depth"), mask_size=S)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (B, S, S) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=TOL,
                                   err_msg=k)
    if "depth" in want:  # both leave the same pixels at the background
        np.testing.assert_array_equal(got["depth"].numpy() == 0.0,
                                      np.asarray(want["depth"]) == 0.0)


def test_silhouette_gradient_matches_jax():
    uv, *_ = _inputs(1)
    want = np.asarray(jax.grad(lambda v: jrender.splat_silhouette(v, S).sum())(jnp.asarray(uv)))
    x = torch.from_numpy(uv).requires_grad_()
    render.splat_silhouette(x, S).sum().backward()
    err = np.abs(x.grad.numpy() - want).max()
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    assert err <= TOL * np.abs(want).max(), err


def test_silhouette_covers_vertices_and_is_differentiable():
    """JAX's tests/test_render.py property on the port."""
    rng = np.random.RandomState(0)
    uv = torch.from_numpy(rng.uniform(-0.2, 0.2, (2, 100, 2)).astype(np.float32))
    m = render.splat_silhouette(uv, mask_size=64)
    assert m.shape == (2, 64, 64) and m.min() >= 0.0 and m.max() <= 1.0
    assert m[:, 28:36, 28:36].mean() > 0.8 and m[:, :4, :4].max() < 0.05
    uv.requires_grad_()
    render.splat_silhouette(uv, 64).sum().backward()
    assert torch.isfinite(uv.grad).all() and uv.grad.abs().max() > 0


def test_depth_prefers_closer_vertices_per_pixel():
    """JAX's tests/test_render.py properties on the port: at one pixel the
    nearer of two vertices wins, uncovered pixels are the background, and
    two separated vertices each give their own pixel its depth (a softmin
    per pixel, not over all vertices)."""
    depth = render.splat_depth(torch.zeros(1, 2, 2), torch.tensor([[0.2, 0.8]]), mask_size=32)
    assert abs(float(depth[0, 16, 16]) - 0.2) < 0.05 and float(depth[0, 0, 0]) == 0.0
    uv = torch.tensor([[[-0.5, -0.5], [0.5, 0.5]]])
    depth = render.splat_depth(uv, torch.tensor([[0.2, 3.0]]), mask_size=32)
    assert abs(float(depth[0, 8, 8]) - 0.2) < 0.05
    assert abs(float(depth[0, 24, 24]) - 3.0) < 0.05


def test_render_mods_through_the_camera():
    """The mods splat the vertices where the uv head's projection puts
    them: render_mods equals the splats of camera.orth_project(inv_norm=
    False), and the mask reaches 1 (JAX's test_render_mods_through_camera)."""
    rng = np.random.RandomState(1)
    verts = torch.from_numpy((rng.randn(3, 200, 3) * 0.5).astype(np.float32))
    logs_t = torch.cat([torch.full((3, 1), float(np.log(0.4))), torch.zeros(3, 2)], 1)
    out = render.render_mods(verts, logs_t, mods=("m", "depth"))
    assert out["mask"].shape == out["depth"].shape == (3, 64, 64)
    assert float(out["mask"].max()) > 0.5
    uv = camera.orth_project(verts, torch.exp(logs_t[:, :1]), logs_t[:, 1:], inv_norm=False)
    torch.testing.assert_close(out["mask"], render.splat_silhouette(uv), rtol=0, atol=0)
    torch.testing.assert_close(out["depth"], render.splat_depth(uv, verts[..., 2]), rtol=0,
                               atol=0)
    assert set(render.render_mods(verts, logs_t)) == {"mask"}


def test_decode_mask_depth_mods_match_jax():
    rng = np.random.RandomState(2)
    th_bt = np.concatenate([rng.randn(B, 48) * 0.5, rng.randn(B, 10) * 0.02], 1)
    logs_t = np.concatenate([np.log(rng.uniform(0.3, 0.5, (B, 1))), rng.randn(B, 2) * 0.1], 1)
    th_bt, logs_t = th_bt.astype(np.float32), logs_t.astype(np.float32)
    mods = ("uv", "m", "depth")
    want = jmhent.decode(jmano.synthetic_mano_model(0), jmhent.MHEntConfig(),
                         jnp.asarray(th_bt), jnp.asarray(logs_t), mods=mods)
    model = mano.synthetic_mano_model(0)
    got = mhent.decode(model, mhent.MHEntConfig(), torch.from_numpy(th_bt),
                       torch.from_numpy(logs_t), mods=mods)
    assert set(got) == {"xyz", "bone", "verts", "uv", "mask", "depth"}
    assert got["mask"].shape == got["depth"].shape == (B, 64, 64)
    assert float(got["mask"].max()) > 0.5
    for k, tol in DECODE_TOL.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=tol,
                                   err_msg=k)
    # The plain blend gives the operator's mesh (on the CPU the operator
    # runs the same einsums).
    plain = mhent.decode(model, mhent.MHEntConfig(), torch.from_numpy(th_bt),
                         torch.from_numpy(logs_t), mods=mods, lbs_kernel=False)
    for k in got:
        torch.testing.assert_close(plain[k], got[k], rtol=0, atol=0)
