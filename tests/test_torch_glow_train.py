"""The port's ConditionalGlow in train mode against the JAX package's
(flows/glow.py): the coupling nets' BatchNorm, dropout, `ddi` and
`bn_stats_update`, and the weights' and Adam moments' conversion.

Weights move with `convert.glow_from_jax`; inputs are numpy-seeded. Both
sides compute in f32 (JAX at HIGH precision), so the outputs are held to
1e-4 (the JAX Glow tests' own bound) and the statistics that `ddi` and
`bn_stats_update` write to 1e-5. Dropout draws from a torch.Generator,
which cannot replay jax.random: the parity tests run at dropout 0, and the
draws are checked by their statistics (the kept share within 3 sigma of a
binomial's, the kept values scaled by 1 / (1 - p)) and by seeded repeats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mhentropy_tpu.flows import glow as jglow
from mhentropy_tpu_torch.convert import glow_config_of, glow_from_jax, load_prohmr_smpl_flow
from mhentropy_tpu_torch.flows import glow

D, H, LAYERS, CTX = 12, 32, 3, 8


def _setup(use_batch_norm, seed=0, d=D):
    """JAX params with non-degenerate actnorm, LU and (with BN) affine and
    running statistics, and the same weights in the port's module."""
    cfg = jglow.GlowConfig(features=d, hidden=H, num_layers=LAYERS, num_blocks=2,
                           context_features=CTX, use_batch_norm=use_batch_norm)
    params = jax.tree.map(np.asarray, jglow.init_params(jax.random.key(seed), cfg))
    rng = np.random.RandomState(seed + 1)
    n_tri = (d - 1) * d // 2
    for layer in params:
        layer["actnorm"] = {"log_scale": rng.randn(d).astype(np.float32) * 0.2,
                            "shift": rng.randn(d).astype(np.float32) * 0.3}
        for k in ("lower_entries", "upper_entries"):
            layer["linear"][k] = (rng.randn(n_tri) * 0.3 / np.sqrt(d)).astype(np.float32)
        for blk in layer["coupling"]["blocks"]:
            blk["l1"] = {"w": (rng.randn(H, H) / np.sqrt(H)).astype(np.float32),
                         "b": (rng.randn(H) * 0.1).astype(np.float32)}
            for j in (0, 1):
                if f"bn{j}" in blk:
                    blk[f"bn{j}"] = {"scale": rng.uniform(0.5, 1.5, H).astype(np.float32),
                                     "bias": (rng.randn(H) * 0.1).astype(np.float32),
                                     "mean": (rng.randn(H) * 0.2).astype(np.float32),
                                     "var": rng.uniform(0.5, 2.0, H).astype(np.float32)}
    flow = glow.ConditionalGlow(glow.GlowConfig(*cfg))
    flow.load_state_dict(glow_from_jax(params), strict=True)
    return cfg, params, flow


def _inputs(cfg, rows, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, cfg.features).astype(np.float32),
            rng.randn(rows, cfg.context_features).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _bn_stats(flow):
    return {k: v.clone() for k, v in flow.state_dict().items() if "running" in k}


@pytest.mark.parametrize("use_batch_norm", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_glow_matches_jax_in_train_and_eval_mode(use_batch_norm, train):
    """inverse, forward, log_prob and sample_and_log_prob at dropout 0; a
    forward in either mode leaves the BatchNorms' running statistics as
    they were (JAX's `_batch_norm` never updates them)."""
    cfg, params, flow = _setup(use_batch_norm)
    b, n = 5, 4
    x, ctx = _inputs(cfg, n * b)
    ctx_b = ctx[:b]
    noise = np.random.RandomState(3).randn(n * b, cfg.features).astype(np.float32)
    jcache = jglow._tile_cache(jglow._ctx_cache(params, jnp.asarray(ctx_b)), n)
    z_ref, ldi_ref = jglow.inverse(params, cfg, jnp.asarray(x), jcache, train=train)
    x_ref, ld_ref = jglow.forward(params, cfg, jnp.asarray(noise), jcache, train=train)
    lp_ref = jglow.log_prob(params, jnp.asarray(x), jnp.asarray(np.tile(ctx_b, (n, 1))), cfg=cfg,
                            train=train)
    xs_ref, lps_ref = jglow.sample_and_log_prob(params, jnp.asarray(ctx_b), jax.random.key(4),
                                                n, cfg=cfg, noise=jnp.asarray(noise),
                                                train=train)
    before = _bn_stats(flow)
    cache = glow._tile_cache(glow._ctx_cache(flow, torch.from_numpy(ctx_b)), n)
    z, ldi = glow.inverse(flow, torch.from_numpy(x), cache, train=train)
    xf, ld = glow.forward(flow, torch.from_numpy(noise), cache, train=train)
    lp = glow.log_prob(flow, torch.from_numpy(x), torch.from_numpy(np.tile(ctx_b, (n, 1))),
                       train=train)
    xs, lps = glow.sample_and_log_prob(flow, torch.from_numpy(ctx_b), n,
                                       noise=torch.from_numpy(noise), train=train)
    for got, want in ((z, z_ref), (ldi, ldi_ref), (xf, x_ref), (ld, ld_ref), (lp, lp_ref),
                      (xs, xs_ref), (lps, lps_ref)):
        _close(got, want, 1e-4)
    after = _bn_stats(flow)
    assert len(after) == (8 * LAYERS if use_batch_norm else 0)  # 2 blocks x 2 BNs x 2
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    if use_batch_norm and train:  # batch statistics: not the eval-mode result
        z_eval, _ = glow.inverse(flow, torch.from_numpy(x), cache)
        assert not torch.allclose(z_eval, z, atol=1e-3)


@pytest.mark.parametrize("use_batch_norm", [False, True])
def test_ddi_and_bn_stats_update_match_jax(use_batch_norm):
    """`ddi` writes JAX's actnorm values and sets `initialized`;
    `bn_stats_update` moves the running statistics as JAX's (a flow
    without BatchNorm is left as it is); both at 1e-5."""
    cfg, params, flow = _setup(use_batch_norm, seed=5)
    x, ctx = _inputs(cfg, 40, seed=6)
    x = x * 1.7 + 0.4
    updated = want = jglow.bn_stats_update(params, cfg, jnp.asarray(x), jnp.asarray(ctx),
                                           momentum=0.1)
    before = {k: v.clone() for k, v in flow.state_dict().items()}
    glow.bn_stats_update(flow, torch.from_numpy(x), torch.from_numpy(ctx), momentum=0.1)
    got = flow.state_dict()
    for i, layer in enumerate(want):
        for k, blk in enumerate(layer["coupling"]["blocks"]):
            for j in (0, 1):
                if f"bn{j}" not in blk:
                    continue
                q = f"_transform._transforms.{3 * i + 2}.transform_net.blocks.{k}." \
                    f"batch_norm_layers.{j}"
                _close(got[f"{q}.running_mean"], blk[f"bn{j}"]["mean"], 1e-5)
                _close(got[f"{q}.running_var"], blk[f"bn{j}"]["var"], 1e-5)
                assert not torch.equal(got[f"{q}.running_var"], before[f"{q}.running_var"])
    changed = [k for k in got if not torch.equal(got[k], before[k])]
    assert all("running" in k for k in changed) and bool(changed) == use_batch_norm

    want = jglow.ddi(updated, cfg, jnp.asarray(x), jnp.asarray(ctx))
    for i in range(LAYERS):  # glow_from_jax sets the flag; DDI sets it again
        flow.step(i)[0].initialized.fill_(False)
    glow.ddi(flow, torch.from_numpy(x), torch.from_numpy(ctx))
    for i, layer in enumerate(want):
        an = flow.step(i)[0]
        assert bool(an.initialized)
        _close(an.log_scale, layer["actnorm"]["log_scale"], 1e-5)
        _close(an.shift, layer["actnorm"]["shift"], 1e-5)
    # After DDI the data's first actnorm output is standardised.
    y = torch.from_numpy(x) * torch.exp(flow.step(0)[0].log_scale) + flow.step(0)[0].shift
    _close(y.mean(0), np.zeros(cfg.features), 1e-5)
    _close(y.std(0), np.ones(cfg.features), 1e-5)


def test_dropout_keeps_its_share_scaled_and_repeats_with_its_seed():
    p, shape = 0.2, (400, 512)
    t = torch.rand(shape) + 0.5
    g = torch.Generator().manual_seed(7)
    out = glow.dropout(t, p, g)
    kept = out != 0
    n = t.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / n), share
    torch.testing.assert_close(out[kept], t[kept] / (1 - p), rtol=1e-6, atol=0)
    assert torch.equal(glow.dropout(t, p, torch.Generator().manual_seed(7)), out)
    assert not torch.equal(glow.dropout(t, p, torch.Generator().manual_seed(8)), out)
    # Through the flow: on only in train mode, and seeded draws repeat.
    cfg = glow.GlowConfig(features=D, hidden=H, num_layers=2, context_features=CTX, dropout=p)
    flow = glow.ConditionalGlow(cfg)
    flow.init_params(torch.Generator().manual_seed(0))
    for blk in (m for m in flow.modules() if isinstance(m, glow.ResidualBlock)):
        torch.nn.init.normal_(blk.linear_layers[1].weight, std=0.3)
    ctx = torch.randn(3, CTX, generator=torch.Generator().manual_seed(1))
    noise = torch.randn(12, D, generator=torch.Generator().manual_seed(2))

    def draw(seed, train):
        return glow.sample_and_log_prob(flow, ctx, 4, noise=noise, train=train,
                                        generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(3, True), draw(3, True), draw(4, True)
    e1, e2 = draw(3, False), draw(4, False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.allclose(a[0], c[0])
    assert all(torch.equal(u, v) for u, v in zip(e1, e2))
    assert not torch.allclose(a[0], e1[0])
    flow.train()  # the module's mode is not the functions' train argument
    assert all(torch.equal(u, v) for u, v in zip(draw(5, False), e1))


def test_bn_glow_checkpoint_loads_by_name(tmp_path):
    """A use_batch_norm Glow both ways: glow_from_jax's names are the
    fork's (batch_norm_layers.{0,1}, running statistics and counter), and
    load_prohmr_smpl_flow detects and loads such a checkpoint."""
    cfg, params, flow = _setup(True, seed=8, d=24)
    sd = flow.state_dict()
    assert "_transform._transforms.2.transform_net.blocks.1.batch_norm_layers.0.running_var" in sd
    assert glow_config_of(sd) == glow.GlowConfig(*cfg)
    path = tmp_path / "bn_flow.pt"
    torch.save({"state_dict": {f"flow.{k}": v for k, v in sd.items()}}, path)
    got = load_prohmr_smpl_flow(str(path), glow.GlowConfig(*cfg))
    assert got.cfg.use_batch_norm
    for k, v in sd.items():
        assert torch.equal(got.state_dict()[k], v), k


def test_glow_adam_moments_follow_the_params():
    """The optax Adam moments of a Glow, as engine.make_optimizer's chain
    holds them, map onto the port's parameter names (the running
    statistics, no parameters in the port, left out)."""
    from mhentropy_tpu.train import engine as jengine
    from mhentropy_tpu_torch.convert import opt_state_from_jax
    from mhentropy_tpu_torch.models import mhent

    cfg, params, flow = _setup(False, seed=9, d=45)
    enc = {"backbone": {}, "l1": {"w": np.zeros((4, CTX), np.float32),
                                  "b": np.zeros(CTX, np.float32)},
           "l2": {"w": np.zeros((4, CTX), np.float32), "b": np.zeros(CTX, np.float32)}}
    head = {"l0": {"w": np.zeros((CTX, CTX), np.float32), "b": np.zeros(CTX, np.float32)},
            "l1": {"w": np.zeros((CTX, 16), np.float32), "b": np.zeros(16, np.float32)}}
    tree = {"encoder": enc, "flow": params, "det_head": head}
    opt = jengine.make_optimizer(1e-3, [10], 5)
    grads = jax.tree.map(lambda v: np.random.RandomState(v.size % 97).randn(*v.shape)
                         .astype(np.float32), tree)
    state = opt.init(tree)
    _, state = jax.jit(opt.update)(grads, state, tree)
    moments = opt_state_from_jax(jax.tree.map(np.asarray, state))
    assert moments["count"] == 1
    names = {f"q_z_giv_i.{k}" for k, _ in flow.named_parameters()}
    got = {k for k in moments["state"] if k.startswith("q_z_giv_i.")}
    assert got == names
    adam = next(s for s in state[1] if isinstance(s, optax.ScaleByAdamState))
    lin = "q_z_giv_i._transform._transforms.5.transform_net.blocks.1.linear_layers.0.weight"
    np.testing.assert_array_equal(moments["state"][lin]["exp_avg"].numpy(),
                                  np.asarray(adam.mu["flow"][1]["coupling"]["blocks"][1]["l0"]
                                             ["w"]).T)
    an = "q_z_giv_i._transform._transforms.3.log_scale"
    np.testing.assert_array_equal(moments["state"][an]["exp_avg_sq"].numpy(),
                                  np.asarray(adam.nu["flow"][1]["actnorm"]["log_scale"]))
    assert mhent.MHEntConfig().glow_dropout == 0.2
