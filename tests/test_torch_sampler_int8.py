"""The port's int8 RealNVP sampler against the JAX package's
(flows/pallas_sampler_int8.py).

Weights move with `realnvp_state_dict` and the quantised tree with
`flowq_from_jax`; the base and calibration noise are the draws JAX made.
Calibration amaxes and the prepared tree agree to 1e-6 relative (the same
f32 ops on the same inputs); x within 2e-5 and log q within 1e-4, the JAX
tests' own kernel-vs-emulation bounds, against both the JAX emulation and
the Pallas kernel in interpret mode.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.flows import pallas_sampler_int8 as jq8
from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu_torch.convert import flowq_from_jax, realnvp_state_dict
from mhentropy_tpu_torch.flows import cuda_sampler_int8 as q8
from mhentropy_tpu_torch.flows import cuda_sampler, realnvp
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

D = 45


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _setup(num_steps=2, cond_dim=32, h_dim=64, b=4, gain=20.0, seed=0):
    """The JAX tests' flow: near-identity init scaled up by `gain`."""
    cfg = jrealnvp.RealNVPConfig(dim=D, cond_dim=cond_dim, h_dim=h_dim, num_steps=num_steps)
    params = jrealnvp.init_params(jax.random.key(seed), cfg)
    params = jax.tree.map(lambda v: v * gain if v is not None and v.ndim == 3 else v, params)
    params = params._replace(masks=jnp.asarray(jrealnvp.default_masks(D, num_steps)))
    feat = jax.random.normal(jax.random.key(seed + 1), (b, cond_dim))
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=D, cond_dim=cond_dim, h_dim=h_dim,
                                                 num_steps=num_steps))
    flow.load_state_dict(realnvp_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return cfg, params, feat, flow.eval()


def _rel_close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(1e-30, np.abs(b).max()))


def test_calibration_and_prepare_match_jax():
    cfg, params, feat, flow = _setup()
    n = 32
    key = jax.random.key(17)
    b = feat.shape[0]
    z0 = jax.random.normal(key, (n * b, D)) * 0.8
    cproj = jrealnvp.cond_cache(params, cfg, jrealnvp.make_cond(params, cfg, feat))
    act = jq8.collect_act_maxabs(params, cfg, z0, jnp.tile(cproj, (1, 1, n, 1)))
    jtree = jq8.quantize_sampler(params, cfg, feat, key, n=n, temp=0.8)

    with torch.no_grad():
        feat_t = torch.from_numpy(np.array(feat))
        cp = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat_t)).repeat(1, 1, n, 1)
        got_act = q8.collect_act_maxabs(flow, torch.from_numpy(np.array(z0)), cp)
        tree = q8.quantize_sampler(flow, feat_t, torch.from_numpy(np.array(z0)))
    for k in ("a0", "s_h1", "s_h2", "t_h1", "t_h2"):
        _rel_close(got_act[k].numpy(), act[k], 1e-6)
    want = flowq_from_jax(jtree, dim=D)
    for name in q8.FlowQTree._fields[:-1]:
        got, ref = getattr(tree, name), getattr(want, name)
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        if got.dtype == torch.int8:  # the same f32 division and rounding
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
        else:
            _rel_close(got.numpy(), ref.numpy(), 1e-6)


@pytest.mark.parametrize("emulate", [True, False])
def test_sample_fused_q_matches_jax(emulate):
    """emulate=False runs the Pallas kernel in interpret mode."""
    cfg, params, feat, flow = _setup()
    jtree = jq8.quantize_sampler(params, cfg, feat, jax.random.key(2))
    n, key, temp = 16, jax.random.key(5), 0.8
    x_ref, lp_ref = jq8.sample_fused_q(params, cfg, jtree, key, feat, n, temp=temp,
                                       return_log_prob=True, images_per_tile=2,
                                       emulate=emulate)
    z0 = np.asarray(jax.random.normal(key, (n * feat.shape[0], D)) * temp)
    tree = flowq_from_jax(jtree, dim=D)
    with torch.no_grad():
        x, lp = q8.sample_fused_q(flow, tree, torch.from_numpy(np.array(feat)), n,
                                  torch.from_numpy(z0))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=2e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), atol=1e-4)


def test_zero_weight_flow_is_exact_identity():
    """All coupling weights zero: x = z0 whatever the scales, and log q is
    the base density."""
    cfg, params, feat, _ = _setup(num_steps=1, h_dim=32, gain=1.0)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=D, cond_dim=32, h_dim=32, num_steps=1))
    with torch.no_grad():
        for p in flow.parameters():
            p.zero_()
        feat_t = torch.from_numpy(np.array(feat))
        tree = q8.quantize_sampler(flow, feat_t, torch.randn(32 * 4, D))
        z0 = torch.randn(8 * 4, D) * 0.7
        x, lp = q8.sample_fused_q(flow, tree, feat_t, 8, z0)
    torch.testing.assert_close(x, z0, rtol=0, atol=1e-6)
    base = -0.5 * (z0 ** 2).sum(-1) - 0.5 * D * np.log(2 * np.pi)
    torch.testing.assert_close(lp, base, rtol=0, atol=1e-4)


def test_shape_gate_and_kernel_layout():
    assert q8.shape_ok(realnvp.RealNVPConfig(dim=45))
    assert not q8.shape_ok(realnvp.RealNVPConfig(dim=200))
    assert not q8.shape_ok(realnvp.RealNVPConfig(dim=3))
    _, _, feat, flow = _setup(num_steps=1, h_dim=32)
    with torch.no_grad():
        tree = q8.quantize_sampler(flow, torch.from_numpy(np.array(feat)), torch.randn(128, D))
    k = tree.kernel
    assert tree.masks.shape[-1] == 64 and k.w0.shape == (2, 2, 32, 64)
    torch.testing.assert_close(k.w1[1, 0], tree.s_w1[1].T)
    torch.testing.assert_close(k.w2[0, 1], tree.t_w2[0].T)
    torch.testing.assert_close(k.e2[1, 1], tree.t_e2[1, 0])


# The int8 kernel's launch plan (`cuda_sampler.plan` with the s8 alignment,
# as `launch_plan` runs it), on a model of its shared-memory layout.
SMEM_LIMIT = 227 * 1024  # shared memory a CTA may use on the H100
WAVE = 15  # clusters of 8 an H100 holds at once (the occupancy query on the card)
# The main path's row counts: the B = 8 request, the bench's int8_serving
# step (B = 32, N = 100) and the int8 eval batch (B = 64, N = 200); and
# ragged ones.
PLAN_ROWS = [1600, 3200, 12800, 200, 1, 111, 651]


def kernel_smem_q(tile_rows, dp, h, cluster):
    """A model of the S8 kernel's shared memory a CTA (`Layout<S8>`, which
    the C entry `mhent_realnvp_sample_q_smem` gives `plan` on the card): the
    weight ring (2 slots of max(H / C, Dp) n rows of 256 + 16 bytes), the
    full h1 (unpadded, swizzled), the h2 slice and xq (rows padded by 16
    bytes), the s32 partial s- and t-net outputs, each row's image, x and
    the log-det of the rows the CTA owns, and h1's arrival mbarrier; -1
    where that does not fit."""
    ns = h // cluster
    ring = 2 * max(ns, dp) * (256 + 16)
    per_row = h + (ns + 16) + (dp + 16) + 2 * dp * 4 + 4
    n = ring + tile_rows * per_row + tile_rows // cluster * (dp * 4 + 4) + 8
    return n if n <= SMEM_LIMIT else -1


@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_int8_plan_covers_every_row_once_within_the_card_limits(rows):
    """Tiles of whole m16 row tiles cover the rows exactly once, a CTA asks
    for at most 227 KB of shared memory, and where one wave of clusters can
    hold the rows it does."""
    pl = cuda_sampler.plan(rows, 512, 64, WAVE, kernel_smem_q, q8.D_ALIGN)
    assert pl.tile_rows % 16 == 0 and 16 <= pl.tile_rows <= 128 and pl.cluster == 8
    assert (pl.tiles - 1) * pl.tile_rows < rows <= pl.tiles * pl.tile_rows
    assert 0 < pl.smem == kernel_smem_q(pl.tile_rows, 64, 512, 8) <= SMEM_LIMIT
    if rows <= WAVE * 128:
        assert pl.tiles <= WAVE


def test_int8_plan_at_the_main_path_row_counts():
    """The largest tile (128 rows, 191,048 bytes a CTA) fits; 1,600 rows take
    one wave of 15 tiles, 3,200 two waves, 12,800 seven of the largest."""
    assert kernel_smem_q(128, 64, 512, 8) == 191048
    for rows, want in ((1600, (112, 8, 15)), (3200, (112, 8, 29)), (12800, (128, 8, 100))):
        assert cuda_sampler.plan(rows, 512, 64, WAVE, kernel_smem_q, q8.D_ALIGN)[:3] == want


@pytest.mark.parametrize("h,cluster", [(512, 8), (256, 8), (128, 4), (64, 2), (32, 1)])
def test_int8_cluster_gives_each_cta_whole_k_steps(h, cluster):
    assert cuda_sampler.check_shape(h, 64, q8.D_ALIGN) == cluster and (h // cluster) % 32 == 0


@pytest.mark.parametrize("h,dp", [(1024, 64), (48, 64), (16, 64), (512, 96), (512, 48)])
def test_int8_plan_refuses_a_shape_the_kernel_does_not_take(h, dp):
    with pytest.raises(ValueError, match="no kernel shape"):
        cuda_sampler.plan(1600, h, dp, WAVE, kernel_smem_q, q8.D_ALIGN)


def test_shape_gate_is_the_kernels():
    """The quantised sampler takes the flows its kernel takes: D <= 64 and a
    hidden width that splits over a cluster in 32-column slices."""
    assert q8.shape_ok(realnvp.RealNVPConfig(dim=64, h_dim=512))
    assert not q8.shape_ok(realnvp.RealNVPConfig(dim=65, h_dim=512))
    assert not q8.shape_ok(realnvp.RealNVPConfig(dim=45, h_dim=1024))
    assert not q8.shape_ok(realnvp.RealNVPConfig(dim=45, h_dim=48))
