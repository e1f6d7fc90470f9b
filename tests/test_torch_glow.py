"""The port's ConditionalGlow and its fused sampler's plain version against
the JAX package's (flows/glow.py, flows/pallas_glow_sampler.py).

* forward, inverse, log_prob and sample_and_log_prob on weights moved by
  `convert.glow_from_jax`: f32 on both sides, rtol 1e-4 / atol 2e-5 for x
  and 1e-4 for log q, the JAX sampler test's own bounds.
* `cuda_glow_sampler.sample_and_log_prob_fused` on a CPU tensor (its plain
  version, `transform_plain`) against the Pallas kernel in interpret mode:
  with f32 weights at the same bounds; with bf16 weights within 1e-3: both
  round the same operands to bf16, but the JAX bf16 dot and the port's f32
  product of rounded operands sum in another order, which can move an
  activation's bf16 rounding.
* The module's state_dict keys are the nflows fork's, pinned in
  tests/golden_glow_state_dict_keys.json, and `load_prohmr_smpl_flow` loads
  a checkpoint that the test writes.
"""

import json
import os

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.flows import glow as jglow
from mhentropy_tpu.flows import pallas_glow_sampler as jpgs
from mhentropy_tpu_torch.convert import glow_config_of, glow_from_jax, load_prohmr_smpl_flow
from mhentropy_tpu_torch.flows import cuda_glow_sampler, glow
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
# (features, hidden, layers, context): the MHEnt Glow's D = 45, the ProHMR D = 144.
CASES = [(45, 64, 4, 32), (144, 64, 2, 16)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _setup(features, hidden, num_layers, context, seed=0):
    """JAX params with non-degenerate actnorm and LU (as the JAX test's
    _setup), and the same weights in the port's module."""
    cfg = jglow.GlowConfig(features=features, hidden=hidden, num_layers=num_layers,
                           num_blocks=2, context_features=context)
    params = jglow.init_params(jax.random.key(seed), cfg)
    k = jax.random.key(seed + 1)
    d = features
    for layer in params:
        k, k1, k2, k3, k4 = jax.random.split(k, 5)
        layer["actnorm"] = {"log_scale": jax.random.normal(k1, (d,)) * 0.2,
                            "shift": jax.random.normal(k2, (d,)) * 0.3}
        n_tri = (d - 1) * d // 2
        layer["linear"]["lower_entries"] = jax.random.normal(k3, (n_tri,)) * 0.3 / np.sqrt(d)
        layer["linear"]["upper_entries"] = jax.random.normal(k4, (n_tri,)) * 0.3 / np.sqrt(d)
    params = jax.tree.map(np.asarray, params)
    flow = glow.ConditionalGlow(glow.GlowConfig(*cfg))
    flow.load_state_dict(glow_from_jax(params), strict=True)
    return cfg, params, flow.eval()


@pytest.mark.parametrize("case", CASES)
def test_glow_matches_jax(case):
    cfg, params, flow = _setup(*case)
    b, n = 3, 5
    rng = np.random.RandomState(1)
    ctx = rng.randn(b, cfg.context_features).astype(np.float32)
    noise = (rng.randn(n * b, cfg.features) * 0.8).astype(np.float32)
    ctx_rows = np.tile(ctx, (n, 1))
    jcache = jglow._tile_cache(jglow._ctx_cache(params, jnp.asarray(ctx)), n)
    x_ref, ld_ref = jglow.forward(params, cfg, jnp.asarray(noise), jcache)
    z_ref, ldi_ref = jglow.inverse(params, cfg, x_ref, jcache)
    lp_ref = jglow.log_prob(params, x_ref, jnp.asarray(ctx_rows), cfg=cfg)
    xs_ref, lps_ref = jglow.sample_and_log_prob(params, jnp.asarray(ctx), jax.random.key(2), n,
                                                cfg=cfg, noise=jnp.asarray(noise))
    with torch.no_grad():
        cache = glow._tile_cache(glow._ctx_cache(flow, torch.from_numpy(ctx)), n)
        x, ld = glow.forward(flow, torch.from_numpy(noise), cache)
        z, ldi = glow.inverse(flow, torch.from_numpy(np.asarray(x_ref)), cache)
        lp = glow.log_prob(flow, torch.from_numpy(np.asarray(x_ref)), torch.from_numpy(ctx_rows))
        xs, lps = glow.sample_and_log_prob(flow, torch.from_numpy(ctx), n,
                                           noise=torch.from_numpy(noise))
    for got, want in ((x, x_ref), (z, z_ref), (xs, xs_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)
    for got, want in ((ld, ld_ref), (ldi, ldi_ref), (lp, lp_ref), (lps, lps_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # The inverse undoes the forward.
    np.testing.assert_allclose(z.numpy(), noise, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,n", [(3, 5), (4, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_sampler_matches_pallas_interpret(case, b, n, dtype):
    cfg, params, flow = _setup(*case, seed=3)
    rng = np.random.RandomState(4)
    ctx = rng.randn(b, cfg.context_features).astype(np.float32)
    noise = (rng.randn(n * b, cfg.features) * 0.8).astype(np.float32)
    x_ref, lp_ref = jpgs.sample_and_log_prob_fused(
        params, jnp.asarray(ctx), jax.random.key(5), n, cfg=cfg, noise=jnp.asarray(noise),
        images_per_tile=2, weight_dtype=getattr(jnp, dtype))
    before = cuda_glow_sampler.launches
    with torch.no_grad():
        packed = cuda_glow_sampler.pack(flow, dtype=getattr(torch, dtype))
        x, lp = cuda_glow_sampler.sample_and_log_prob_fused(
            flow, packed, torch.from_numpy(ctx), n, torch.from_numpy(noise))
    assert cuda_glow_sampler.launches == before  # CPU tensors take the plain version
    assert x.shape == (n * b, cfg.features) and lp.shape == (n * b,)
    tol = {"float32": (1e-4, 2e-5, 1e-4), "bfloat16": (1e-3, 1e-3, 1e-3)}[dtype]
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=tol[0], atol=tol[1])
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), rtol=tol[0], atol=tol[2])


def test_pack_folds_like_jax():
    """The packed operands equal pack_glow_weights' (D padded to 16 here,
    to 128 lanes there; the extra lanes hold zeros)."""
    cfg, params, flow = _setup(45, 64, 4, 32, seed=6)
    jp, jdp, jld = jpgs.pack_glow_weights(params, cfg, dtype=jnp.float32)
    p = cuda_glow_sampler.pack(flow, dtype=torch.float32)
    dp = p.mask_tr.shape[1]
    assert dp == 48 and p.big.shape == (4, 4, 64, 64)
    np.testing.assert_allclose(p.big.numpy().reshape(16, 64, 64), np.asarray(jp["big"]),
                               rtol=1e-6, atol=0)
    for name in ("w_in", "lu_inv_t"):
        want = np.asarray(jp[name])
        np.testing.assert_allclose(getattr(p, name).numpy(), want[:, :dp, :dp] if name ==
                                   "lu_inv_t" else want[:, :dp], rtol=1e-5, atol=1e-6)
    for name in ("w_shift", "w_scale"):
        np.testing.assert_allclose(getattr(p, name).numpy(), np.asarray(jp[name])[..., :dp],
                                   rtol=1e-6, atol=0)
    for name in ("b_shift", "b_scale", "mask_tr", "lu_bias", "an_shift", "an_scale"):
        np.testing.assert_allclose(getattr(p, name).numpy(), np.asarray(jp[name])[:, 0, :dp],
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(p.ld_const), float(jld), rtol=1e-5)


def test_state_dict_keys_are_the_forks():
    with open(os.path.join(HERE, "golden_glow_state_dict_keys.json")) as f:
        golden = json.load(f)
    flow = glow.ConditionalGlow(glow.GlowConfig(features=144, hidden=32, num_layers=4,
                                                num_blocks=2, context_features=16))
    assert sorted(flow.state_dict()) == sorted(golden)


def test_load_prohmr_smpl_flow_round_trips(tmp_path):
    """A ProHMR-style checkpoint (the flow under `flow.`, beside other
    modules, inside "state_dict") loads by name; another geometry raises."""
    cfg, params, flow = _setup(144, 64, 2, 16, seed=7)
    sd = {f"flow.{k}": v for k, v in flow.state_dict().items()}
    sd["backbone.conv1.weight"] = torch.zeros(2, 2)
    path = tmp_path / "smpl_flow.pt"
    torch.save({"state_dict": sd}, path)
    got = load_prohmr_smpl_flow(str(path), glow.GlowConfig(*cfg))
    assert got.cfg == glow.GlowConfig(*cfg) and not got.training
    for k, v in flow.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    assert glow_config_of(flow.state_dict()) == glow.GlowConfig(*cfg)
    with pytest.raises(ValueError, match="geometry"):
        load_prohmr_smpl_flow(str(path), glow.GlowConfig(*cfg)._replace(hidden=128))
    torch.save({"other": torch.zeros(1)}, tmp_path / "none.pt")
    with pytest.raises(ValueError, match="no ConditionalGlow"):
        load_prohmr_smpl_flow(str(tmp_path / "none.pt"))


def test_training_parts_raise_naming_the_roadmap():
    """The training parts these refusals once named are ported
    (tests/test_torch_glow_train.py holds them to JAX): a use_batch_norm
    Glow builds with the fork's BatchNorm names, and a module in train mode
    samples as in eval mode unless the call says train=True. What the
    sampler kernel does not take still raises: one block, or BatchNorm."""
    bn = glow.ConditionalGlow(glow.GlowConfig(features=12, hidden=16, num_layers=2,
                                              context_features=4, use_batch_norm=True))
    assert "_transform._transforms.2.transform_net.blocks.1.batch_norm_layers.1.running_var" \
        in bn.state_dict()
    flow = glow.ConditionalGlow(glow.GlowConfig(features=12, hidden=16, num_layers=2,
                                                context_features=4))
    noise = torch.randn(6, 12, generator=torch.Generator().manual_seed(0))
    ctx = torch.randn(2, 4, generator=torch.Generator().manual_seed(1))
    want = glow.sample_and_log_prob(flow.eval(), ctx, 3, noise=noise)
    got = glow.sample_and_log_prob(flow.train(), ctx, 3, noise=noise)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for cfg in (flow.cfg._replace(num_blocks=1), bn.cfg):
        with pytest.raises(ValueError, match="num_blocks"):
            cuda_glow_sampler.pack(glow.ConditionalGlow(cfg))


def test_pack_kmajor_copies_hold_jaxs_weights():
    """The kernel's K-major copies (out, in) hold pack_glow_weights' big,
    w_in and [w_shift | w_scale], transposed (D padded to 16 here)."""
    cfg, params, flow = _setup(45, 64, 4, 32, seed=6)
    jp, _, _ = jpgs.pack_glow_weights(params, cfg, dtype=jnp.float32)
    p = cuda_glow_sampler.pack(flow, dtype=torch.float32)
    dp = p.mask_tr.shape[1]
    assert p.big_t.shape == (4, 4, 64, 64) and p.w_in_t.shape == (4, 64, dp)
    assert p.w_ss_t.shape == (4, 2 * dp, 64)
    np.testing.assert_allclose(p.big_t.numpy().reshape(16, 64, 64),
                               np.asarray(jp["big"]).transpose(0, 2, 1), rtol=1e-6, atol=0)
    np.testing.assert_allclose(p.w_in_t.numpy(), np.asarray(jp["w_in"])[:, :dp].transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-6)
    ss = np.concatenate([np.asarray(jp["w_shift"])[..., :dp], np.asarray(jp["w_scale"])[..., :dp]],
                        axis=-1)
    np.testing.assert_allclose(p.w_ss_t.numpy(), ss.transpose(0, 2, 1), rtol=1e-6, atol=0)
    bf = cuda_glow_sampler.pack(flow)
    for name in ("big_t", "w_in_t", "w_ss_t"):
        assert getattr(bf, name).dtype == torch.bfloat16 and getattr(bf, name).is_contiguous()
