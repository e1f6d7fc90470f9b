"""The port's RealNVP flow and fused-sampler wrapper vs the JAX package.

The JAX side runs the Pallas sampler's transform in interpret mode (as
tests/test_pallas_sampler.py does); the port side runs the wrapper's plain
version on the CPU. Inputs come from numpy seeds; tolerance 1e-4 (the
tests/test_flows.py anchor). The CUDA kernel is held to the plain version
on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.flows import pallas_sampler as ps
from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu_torch.convert import realnvp_state_dict
from mhentropy_tpu_torch.flows import cuda_sampler, realnvp
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

TOL = 1e-4
CFG = dict(dim=45, cond_dim=32, h_dim=64, num_steps=2)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _jax_flow(seed=0):
    """JAX RealNVP params with random weights of O(1) effect (the init's
    near-identity flow would make the comparison vacuous)."""
    cfg = jrealnvp.RealNVPConfig(**CFG)
    params = jrealnvp.init_params(jax.random.key(seed), cfg)
    rng = np.random.RandomState(seed)
    fields = {}
    for name, v in params._asdict().items():
        if v is None or name == "masks" or not hasattr(v, "shape"):
            continue
        fan_in = v.shape[-2] if v.ndim == 3 else v.shape[-1]
        fields[name] = jnp.asarray(
            rng.uniform(-1, 1, v.shape).astype(np.float32) / np.sqrt(fan_in))
    return cfg, params._replace(**fields)


def _port_flow(params):
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(**CFG))
    flow.load_state_dict(realnvp_state_dict(params), strict=True)
    return flow.eval()


def _np(t):
    return t.detach().numpy()


def test_cond_cache_matches_jax():
    cfg, params = _jax_flow()
    feat = np.random.RandomState(1).randn(3, 32).astype(np.float32)
    ref = jrealnvp.cond_cache(params, cfg, jrealnvp.make_cond(params, cfg, jnp.asarray(feat)))
    flow = _port_flow(params)
    ours = realnvp.cond_cache(flow, realnvp.make_cond(flow, torch.from_numpy(feat)))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=TOL)


def test_plain_transform_matches_pallas_kernel_transform(interpret_mode):
    """B=3, N=5: neither the image tile nor the 8-row tile is full."""
    cfg, params = _jax_flow()
    rng = np.random.RandomState(2)
    b, n = 3, 5
    feat = rng.randn(b, 32).astype(np.float32)
    z0 = (rng.randn(b, n, 45) * 0.8).astype(np.float32)
    cproj = jrealnvp.cond_cache(params, cfg, jnp.asarray(feat))
    x_ref, ld_ref = ps._kernel_transform(params, cfg, jnp.asarray(z0), cproj, 2)

    flow = _port_flow(params)
    packed = cuda_sampler.pack(flow, dtype=torch.float32)
    cp = realnvp.cond_cache(flow, torch.from_numpy(feat))
    x, ld = cuda_sampler.transform(packed, torch.from_numpy(z0), cp)
    assert x.shape == (b, n, 45) and ld.shape == (b, n)
    np.testing.assert_allclose(_np(x), np.asarray(x_ref), atol=TOL)
    np.testing.assert_allclose(_np(ld), np.asarray(ld_ref), atol=TOL)


def test_sample_matches_jax_sample_with_same_noise():
    cfg, params = _jax_flow(3)
    b, n, temp = 2, 4, 0.8
    feat = np.random.RandomState(4).randn(b, 32).astype(np.float32)
    key = jax.random.key(5)
    cproj = jrealnvp.cond_cache(params, cfg, jnp.asarray(feat))
    x_ref, lp_ref = jrealnvp.sample(params, cfg, key, n * b, cproj=jnp.tile(cproj, (1, 1, n, 1)),
                                    temp=temp, return_log_prob=True)
    z0 = torch.from_numpy(np.array(jax.random.normal(key, (n * b, 45)) * temp))

    flow = _port_flow(params)
    cp = realnvp.cond_cache(flow, torch.from_numpy(feat)).repeat(1, 1, n, 1)
    x, lp = realnvp.sample(flow, z0, cproj=cp)
    np.testing.assert_allclose(_np(x), np.asarray(x_ref), atol=TOL)
    np.testing.assert_allclose(_np(lp), np.asarray(lp_ref), atol=TOL)


def test_sample_fused_orders_rows_like_the_flow():
    """The wrapper regroups hypothesis-major rows image-major and back: its
    plain path must equal realnvp.sample on the tiled cache (1e-5, f32)."""
    _, params = _jax_flow(6)
    flow = _port_flow(params)
    rng = np.random.RandomState(7)
    b, n = 3, 6
    feat = torch.from_numpy(rng.randn(b, 32).astype(np.float32))
    z0 = torch.from_numpy(rng.randn(n * b, 45).astype(np.float32))
    x, lp = cuda_sampler.sample_fused(flow, cuda_sampler.pack(flow, torch.float32), feat, n, z0)
    cp = realnvp.cond_cache(flow, feat).repeat(1, 1, n, 1)
    x_ref, lp_ref = realnvp.sample(flow, z0, cproj=cp)
    np.testing.assert_allclose(_np(x), _np(x_ref), atol=1e-5)
    np.testing.assert_allclose(_np(lp), _np(lp_ref), atol=1e-5)


def test_draw_without_gradients_reuses_the_pack_until_a_weight_changes():
    """sample_fused_diff without gradients (the eval's reverse-KL term)
    draws on `packed_now`: the autograd route's draw bit for bit, one pack
    while the weights stay, a new one after an optimizer step moves them
    (and the draw follows the new weights, 1e-5 of the autograd route's)."""
    _, params = _jax_flow(8)
    flow = _port_flow(params)
    rng = np.random.RandomState(9)
    b, n = 3, 5
    feat = torch.from_numpy(rng.randn(b, 32).astype(np.float32))
    z0 = torch.from_numpy(rng.randn(n * b, 45).astype(np.float32))
    want = cuda_sampler.sample_fused_diff(flow, feat, n, z0)
    with torch.inference_mode():
        got = cuda_sampler.sample_fused_diff(flow, feat, n, z0)
        first = cuda_sampler.packed_now(flow)
    for g, w in zip(got, want):
        assert torch.equal(g, w.detach())
    before = got[0]
    with torch.no_grad():
        assert cuda_sampler.packed_now(flow) is first
    opt = torch.optim.SGD(flow.parameters(), lr=0.1)
    (want[0].square().sum() + want[1].sum()).backward()
    opt.step()
    with torch.no_grad():
        assert cuda_sampler.packed_now(flow) is not first
        got = cuda_sampler.sample_fused_diff(flow, feat, n, z0)
    want = cuda_sampler.sample_fused_diff(flow, feat, n, z0)
    assert not torch.equal(got[0], before)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5)


def test_pack_pads_with_pass_through_dims():
    _, params = _jax_flow()
    packed = cuda_sampler.pack(_port_flow(params))
    assert packed.masks.shape == (4, 48) and packed.w0.shape == (4, 2, 48, 64)
    assert packed.w2.shape == (4, 2, 64, 48) and packed.w1.dtype == torch.bfloat16
    assert torch.all(packed.masks[:, 45:] == 1)
    assert torch.all(packed.w0[:, :, 45:] == 0) and torch.all(packed.w2[..., 45:] == 0)


def test_wrapper_takes_plain_path_only_on_cpu():
    """CPU tensors run the plain version without counting a launch; any
    other non-CUDA device raises instead of falling back."""
    _, params = _jax_flow()
    flow = _port_flow(params)
    packed = cuda_sampler.pack(flow)
    z0 = torch.zeros(2, 3, 45)
    cp = torch.zeros(4, 4, 2, 64)
    before = cuda_sampler.launches
    cuda_sampler.transform(packed, z0, cp)
    assert cuda_sampler.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sampler.transform(packed, z0.to("meta"), cp.to("meta"))


# The main path's row counts: a served request (B = 1, N = 200), the eval's
# f32 reverse-KL draw (B = 64, N = 10), a B = 8 request, the bench step
# (B = 32, N = 100) and the eval batch (B = 64, N = 200); and ragged ones.
PLAN_ROWS = [200, 640, 1600, 3200, 12800, 1, 111, 651]
WAVE = 15  # clusters of 8 an H100 holds at once (the occupancy query on the card)
SMEM_LIMIT = 227 * 1024  # shared memory a CTA may use on the H100


def kernel_smem(f32: bool):
    """A model of the kernels' shared memory a CTA (csrc/realnvp_cluster.cuh
    `Layout`, which the C entries `mhent_realnvp_sample[_f32]_smem` give
    `plan` on the card): the weight ring (2 chunks of 128 K-rows of bf16 or
    64 of f32), the full h1 (unpadded, swizzled), the h2 slice, x_m, two f32
    partial outputs, each row's image, x and the log-det of the rows the CTA
    owns, and h1's arrival mbarrier; -1 where that does not fit."""
    size, chunk_k = (4, 64) if f32 else (2, 128)

    def a_pitch(w):
        return w * size + 16

    def b_pitch(w):
        return (w + 8) * 4 if f32 else a_pitch(w)

    def smem(tile_rows, dp, h, cluster):
        ns = h // cluster
        ring = 2 * chunk_k * max(b_pitch(ns), b_pitch(dp))
        per_row = h * size + a_pitch(ns) + a_pitch(dp) + 2 * dp * 4 + 4
        n = ring + tile_rows * per_row + tile_rows // cluster * (dp * 4 + 4) + 8
        return n if n <= SMEM_LIMIT else -1

    return smem


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_plan_covers_every_row_once_within_the_card_limits(rows, f32):
    """Tiles of whole m16 row tiles cover the rows exactly once (the last
    one ragged, never empty), the grid fits its limit, a CTA asks for at
    most 227 KB of shared memory, and where one wave of clusters can hold
    the rows it does."""
    smem = kernel_smem(f32)
    pl = cuda_sampler.plan(rows, 512, 48, WAVE, smem)
    assert pl.tile_rows % 16 == 0 and 16 <= pl.tile_rows <= cuda_sampler.MAX_TILE_ROWS
    assert (pl.tiles - 1) * pl.tile_rows < rows <= pl.tiles * pl.tile_rows
    assert pl.cluster == 8 and pl.tiles * pl.cluster < 2 ** 31
    assert 0 < pl.smem == smem(pl.tile_rows, 48, 512, 8) <= SMEM_LIMIT
    r_max = cuda_sampler.max_tile_rows(48, 512, 8, smem)
    if rows <= WAVE * r_max:
        assert pl.tiles <= WAVE
    assert r_max == cuda_sampler.MAX_TILE_ROWS or smem(r_max + 16, 48, 512, 8) == -1


def test_plan_spreads_small_row_counts_over_the_card():
    """A B = 1 request fills 13 clusters of 8 CTAs (104 of 132 SMs), where
    one block of 32 rows an image used 7; the f32 train draw 14."""
    bf16, f32 = kernel_smem(False), kernel_smem(True)
    assert cuda_sampler.plan(200, 512, 48, WAVE, bf16)[:3] == (16, 8, 13)
    assert cuda_sampler.plan(640, 512, 48, WAVE, f32)[:3] == (48, 8, 14)
    assert cuda_sampler.plan(1600, 512, 48, WAVE, bf16)[:3] == (112, 8, 15)


@pytest.mark.parametrize("h,cluster", [(512, 8), (384, 8), (256, 8), (128, 8), (64, 4),
                                       (32, 2), (48, 1), (16, 1)])
def test_cluster_size_gives_each_cta_whole_n16_tiles(h, cluster):
    assert cuda_sampler.check_shape(h, 48) == cluster
    ns = h // cluster
    assert ns % 16 == 0 and ns <= cuda_sampler.MAX_SLICE


@pytest.mark.parametrize("h,dp", [(1024, 48), (640, 48), (40, 48), (8, 48), (512, 80)])
def test_plan_refuses_a_shape_the_kernels_do_not_take(h, dp):
    with pytest.raises(ValueError, match="no kernel shape"):
        cuda_sampler.plan(200, h, dp, WAVE, kernel_smem(False))
