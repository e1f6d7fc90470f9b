"""The port's RealNVP density side and the rest of its priors against the
JAX package's.

Weights come from a numpy seed at O(1) scale (the package's own init starts
near the identity, where a wrong layer would hide) and move with
`convert.realnvp_state_dict`; inputs come from numpy seeds, and each JAX
draw is made in JAX and handed to the port as its noise. Values and
gradients are held to 1e-4 of the largest reference value (the flows'
budget, tests/test_flows.py). log_prob sums the rows of an image, so the
per-joint flows are also compared row by row: each row passed as an image
of its own, with the conditioning projections of its row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.flows import priors as jpriors
from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu_torch.convert import realnvp_state_dict
from mhentropy_tpu_torch.flows import priors, realnvp
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

TOL = 1e-4
B, K = 3, 21


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _o1(params, seed):
    """Every weight and bias redrawn at O(1) scale (U(-1, 1) / sqrt(fan_in));
    the masks kept."""
    rng = np.random.RandomState(seed)

    def draw(v, fan_in):
        return (rng.uniform(-1, 1, np.shape(v)) / np.sqrt(fan_in)).astype(np.float32)

    out = {}
    for name, v in params._asdict().items():
        if name == "masks" or v is None:
            out[name] = None if v is None else np.asarray(v)
        elif name in ("part_ws", "part_bs"):
            out[name] = tuple(draw(w, np.shape(params.part_ws[i])[0]) for i, w in enumerate(v))
        else:
            fan_in = np.shape(v)[-2] if np.ndim(v) >= 2 and not name.startswith("kemb_b") \
                else np.shape(v)[-1]
            out[name] = draw(v, fan_in)
    return params._replace(**out)


def _flows(seed=0, **cfg):
    """The JAX params at O(1) scale and the port's flow holding them."""
    jcfg = jrealnvp.RealNVPConfig(**cfg)
    params = _o1(jrealnvp.init_params(jax.random.key(seed), jcfg), seed + 1)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(**cfg))
    flow.load_state_dict(realnvp_state_dict(params), strict=True)
    return jcfg, jax.tree.map(jnp.asarray, params), flow


# The per-joint cases: each row a joint of K = 21, B = 3 images.
CASES = {
    "dim45_cond": dict(dim=45, cond_dim=16, h_dim=32, num_steps=2),
    "dim3_x": dict(dim=3, h_dim=16, num_steps=2, joint_n=K, tsfm_on="x"),
    "dim3_z": dict(dim=3, h_dim=16, num_steps=2, joint_n=K, tsfm_on="z"),
    "dim3_cond": dict(dim=3, cond_dim=4, h_dim=16, num_steps=2, joint_n=K),
    "dim3_kemb_add": dict(dim=3, cond_dim=63, h_dim=16, num_steps=2, joint_n=K, kemb=True),
    "dim3_kemb_cat_x": dict(dim=3, cond_dim=8, h_dim=16, num_steps=2, joint_n=K, kemb=True,
                            tsfm_on="x"),
    "dim3_partitioner": dict(dim=3, cond_dim=3, h_dim=16, num_steps=2, joint_n=K,
                             cond_mapping_dims=((10, 2 * K), (6, K))),
    "dim2_cond_z": dict(dim=2, cond_dim=5, h_dim=16, num_steps=1, joint_n=K, tsfm_on="z"),
}


def _feat_width(cfg: dict) -> int:
    """The (B, F) image feature each case's make_cond takes."""
    if not cfg.get("cond_dim"):
        return 0
    if cfg["dim"] not in (2, 3) or cfg.get("kemb"):
        return cfg["cond_dim"]
    if cfg.get("cond_mapping_dims"):
        return max(i for i, _ in cfg["cond_mapping_dims"])
    return cfg["cond_dim"] * cfg["joint_n"]


def _inputs(cfg: dict, seed: int):
    rng = np.random.RandomState(seed)
    width = cfg["dim"] * (K if cfg["dim"] in (2, 3) else 1)
    x = rng.randn(B, width).astype(np.float32)
    f = _feat_width(cfg)
    feat = rng.randn(B, f).astype(np.float32) if f else None
    mu = (rng.randn(B, width) * 0.5).astype(np.float32)
    logvar = (rng.randn(B, width) * 0.5).astype(np.float32)
    # Visibility codes 0 / 1 / 2: only a row's first entry counts.
    vis = rng.randint(0, 3, (B, width)).astype(np.float32)
    return x, feat, mu, logvar, vis


def _cproj(jcfg, params, flow, feat):
    if not jcfg.effective_cond_dim():
        return None, None
    jc = jrealnvp.cond_cache(params, jcfg, jrealnvp.make_cond(params, jcfg, jnp.asarray(feat)))
    tc = realnvp.cond_cache(flow, realnvp.make_cond(flow, _t(feat)))
    return jc, tc


@pytest.mark.parametrize("case", sorted(CASES))
def test_density_and_sample_match_jax(case):
    """make_cond's cache, inverse, log_prob (with and without visibility
    weights, per image and per row) and sample(return_log_prob=True) with
    the actnorm statistics."""
    cfg = CASES[case]
    jcfg, params, flow = _flows(3, **cfg)
    x, feat, mu, logvar, vis = _inputs(cfg, 4)
    d = cfg["dim"]
    per_joint = d in (2, 3)
    jc, tc = _cproj(jcfg, params, flow, feat)
    if tc is not None:
        _close(tc.detach().numpy(), jc, name="cond_cache")
    else:
        rows = B * (K if per_joint else 1)
        assert realnvp.cond_cache(flow, torch.zeros(rows, 1)).shape == (2 * cfg["num_steps"], 4,
                                                                        rows, 1)

    rows = x.reshape(-1, d)
    z_ref, ld_ref = jrealnvp.inverse(params, jcfg, jnp.asarray(rows), jc)
    with torch.no_grad():
        z, ld = realnvp.inverse(flow, _t(rows), tc)
    _close(z.numpy(), z_ref, name="inverse z")
    _close(ld.numpy(), ld_ref, name="inverse logdet")

    kw = dict(mu=mu, logvar=logvar) if cfg.get("tsfm_on") else {}
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: _t(v) for k, v in kw.items()}
    jf = None if feat is None else jnp.asarray(feat)
    tf = None if feat is None else _t(feat)
    for weights in ((None, vis) if per_joint else (None,)):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else _t(weights)
        ref = jrealnvp.log_prob(params, jcfg, jnp.asarray(x), feat=jf, weights=jw, **jkw)
        with torch.no_grad():
            got = realnvp.log_prob(flow, _t(x), feat=tf, weights=tw, **tkw)
        _close(got.numpy(), ref, name=f"log_prob weights={weights is not None}")
        if per_joint:  # row by row: each row an image
            r = x.reshape(-1, d).shape[0]
            rkw = {k: v.reshape(r, d) for k, v in kw.items()}
            ref_rows = jrealnvp.log_prob(
                params, jcfg, jnp.asarray(x.reshape(r, d)), cproj=jc,
                weights=None if jw is None else jw.reshape(r, d),
                **{k: jnp.asarray(v) for k, v in rkw.items()})
            with torch.no_grad():
                got_rows = realnvp.log_prob(
                    flow, _t(x.reshape(r, d)), cproj=tc,
                    weights=None if tw is None else tw.reshape(r, d),
                    **{k: _t(v) for k, v in rkw.items()})
            _close(got_rows.numpy(), ref_rows, name="log_prob per row")
            if weights is not None:
                zero = vis.reshape(-1, d)[:, 0] == 0
                assert zero.any() and np.all(got_rows.numpy()[zero] == 0)

    n_rows = rows.shape[0]
    key = jax.random.key(5)
    x_ref, lp_ref = jrealnvp.sample(params, jcfg, key, n_rows, feat=jf, temp=0.7,
                                    return_log_prob=True, **jkw)
    z0 = _t(jax.random.normal(key, (n_rows, d)) * 0.7)
    with torch.no_grad():
        xs, lp = realnvp.sample(flow, z0, feat=tf, **tkw)
        x_only = realnvp.sample(flow, z0, feat=tf, return_log_prob=False, **tkw)
    _close(xs.numpy(), x_ref, name="sample x")
    _close(lp.numpy(), lp_ref, name="sample log q")
    assert torch.equal(x_only, xs)
    if cfg.get("tsfm_on"):
        # The draw's log q is the density of what it drew (actnorm included).
        with torch.no_grad():
            back = realnvp.log_prob(flow, xs.reshape(B, -1), feat=tf, **tkw)
        _close(back.numpy(), lp.reshape(B, -1).sum(1).numpy(), tol=1e-3, name="log q vs log p")


@pytest.mark.parametrize("case", ["dim45_cond", "dim3_kemb_cat_x", "dim3_partitioner"])
def test_log_prob_gradients_match_jax(case):
    """d log_prob / d every flow parameter (the joint embedding and the
    partitioner included), against jax.grad, with visibility weights on the
    per-joint flows."""
    cfg = CASES[case]
    jcfg, params, flow = _flows(6, **cfg)
    x, feat, mu, logvar, vis = _inputs(cfg, 7)
    per_joint = cfg["dim"] in (2, 3)
    kw = dict(mu=mu, logvar=logvar) if cfg.get("tsfm_on") else {}
    w_out = np.random.RandomState(8).randn(B).astype(np.float32)

    def loss(p):
        lp = jrealnvp.log_prob(p, jcfg, jnp.asarray(x), feat=jnp.asarray(feat),
                               weights=jnp.asarray(vis) if per_joint else None,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        return jnp.sum(lp * w_out)

    grads = realnvp_state_dict(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    lp = realnvp.log_prob(flow, _t(x), feat=_t(feat), weights=_t(vis) if per_joint else None,
                          **{k: _t(v) for k, v in kw.items()})
    (lp * _t(w_out)).sum().backward()
    names = [n for n, _ in flow.named_parameters()]
    assert any(n.startswith(("kemb", "cond_mapping")) for n in names) or case == "dim45_cond"
    for name, p in flow.named_parameters():
        want = np.asarray(grads[name], np.float64)
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= TOL * max(np.abs(want).max(), 1e-6), (name, err, np.abs(want).max())


def test_dim45_weights_all_ones_match_none_else_raise():
    """A whole-pose flow takes visibility weights only as all ones (tests/
    test_flows.py:85's rule); anything else raises, as in JAX."""
    cfg = CASES["dim45_cond"]
    jcfg, params, flow = _flows(9, **cfg)
    x, feat, *_ = _inputs(cfg, 10)
    with torch.no_grad():
        lp_none = realnvp.log_prob(flow, _t(x), feat=_t(feat))
        lp_ones = realnvp.log_prob(flow, _t(x), feat=_t(feat), weights=torch.ones(B, 45))
    torch.testing.assert_close(lp_ones, lp_none)
    _close(lp_none.numpy(), jrealnvp.log_prob(params, jcfg, jnp.asarray(x),
                                              feat=jnp.asarray(feat)))
    bad = torch.ones(B, 45)
    bad[0, 0] = 0.0
    with pytest.raises(NotImplementedError, match="dim 2/3"):
        realnvp.log_prob(flow, _t(x), feat=_t(feat), weights=bad)
    with pytest.raises(NotImplementedError):
        jrealnvp.log_prob(params, jcfg, jnp.asarray(x), feat=jnp.asarray(feat),
                          weights=jnp.asarray(bad.numpy()))


@pytest.mark.parametrize("tsfm_on", ["x", "z"])
def test_actnorm_with_mu_and_no_logvar(tsfm_on):
    """mu without logvar: a shift, log-det 0, both directions and log_prob."""
    rng = np.random.RandomState(11)
    x, mu = rng.randn(6, 3).astype(np.float32), rng.randn(6, 3).astype(np.float32)
    z, ld = realnvp._actnorm(_t(x), _t(mu), None, reverse=True)
    z_ref, ld_ref = jrealnvp._actnorm(jnp.asarray(x), jnp.asarray(mu), None, reverse=True)
    _close(z.numpy(), z_ref)
    assert ld.shape == (6,) and not ld.any() and not np.asarray(ld_ref).any()
    _close(realnvp._actnorm(z, _t(mu), None, reverse=False).numpy(), x)
    cfg = dict(dim=3, h_dim=16, num_steps=1, joint_n=2, tsfm_on=tsfm_on)
    jcfg, params, flow = _flows(12, **cfg)
    xs, mus = x.reshape(3, 6), mu.reshape(3, 6)
    with torch.no_grad():
        got = realnvp.log_prob(flow, _t(xs), mu=_t(mus))
    _close(got.numpy(), jrealnvp.log_prob(params, jcfg, jnp.asarray(xs), mu=jnp.asarray(mus)))


@pytest.mark.parametrize("dim", [63, 64, 8])
def test_timestep_embedding_matches_jax(dim):
    t = np.arange(21).repeat(3)
    got = realnvp.timestep_embedding(torch.from_numpy(t), dim)
    _close(got.numpy(), jrealnvp.timestep_embedding(jnp.asarray(t), dim), tol=1e-5)


def test_priors_match_jax():
    """laplace_sample on JAX's Laplace draws, LogDist, categorical_log_prob,
    categorical_sample on JAX's Gumbel draws (equal to jax.random.categorical
    from the same key) and gaussian_kl."""
    rng = np.random.RandomState(13)
    mu = rng.randn(4, 5).astype(np.float32)
    key = jax.random.key(14)
    e = jax.random.laplace(key, mu.shape, jnp.float32)
    _close(priors.laplace_sample(_t(mu), 0.3, e=_t(e)).numpy(),
           jpriors.laplace_sample(key, jnp.asarray(mu), 0.3), tol=1e-6)
    x = rng.uniform(0.2, 3.0, (6, 3)).astype(np.float32)
    _close(priors.LogDist(0.5, 1.5).log_prob(_t(x)).numpy(),
           jpriors.LogDist(0.5, 1.5).log_prob(jnp.asarray(x)), tol=1e-6)
    logits = (rng.randn(7, 9) * 2).astype(np.float32)
    _close(priors.categorical_log_prob(_t(logits)).numpy(),
           jpriors.categorical_log_prob(jnp.asarray(logits)), tol=1e-6)
    for temp in (1.0, 0.5):
        g = jax.random.gumbel(key, logits.shape, jnp.float32)
        want = np.asarray(jpriors.categorical_sample(key, jnp.asarray(logits), temp))
        got = priors.categorical_sample(_t(logits), temp, gumbel=_t(g)).numpy()
        np.testing.assert_array_equal(got, want)
    std = rng.uniform(0.3, 2.0, (4, 5)).astype(np.float32)
    _close(priors.gaussian_kl(_t(mu), _t(std), 0.8).numpy(),
           jpriors.gaussian_kl(jnp.asarray(mu), jnp.asarray(std), 0.8), tol=1e-6)
    # The generator draws: a standard Laplace and a categorical in range.
    g = torch.Generator().manual_seed(0)
    draws = priors.laplace_sample(torch.zeros(20000), 1.0, generator=g)
    assert abs(draws.abs().mean().item() - 1.0) < 0.05 and torch.isfinite(draws).all()
    idx = priors.categorical_sample(_t(logits), generator=g)
    assert idx.shape == (7,) and int(idx.min()) >= 0 and int(idx.max()) < 9
