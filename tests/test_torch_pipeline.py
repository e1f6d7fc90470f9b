"""The port's GPipe schedule over the RealNVP coupling stack
(mhentropy_tpu_torch/parallel/pipeline.py) in a 4-rank gloo group (pp = 4,
one coupling a stage, 2 microbatches) on the CPU, against JAX's sequential
flow and tests/test_pipeline.py's properties (:28-123).

The flow is tests/test_pipeline.py's (dim 45, cond 32, hidden 32, 2 steps:
4 couplings), JAX's init carried by `convert.realnvp_state_dict`; rows,
features and the sampler's key are JAX's. Tolerances: values 1e-5 of
their largest entry (JAX's own pipelined forward is 1e-6 from its scan;
across the frameworks the f32 products round apart by a few 1e-7),
gradients 1e-5 of each tensor's largest entry (tests/test_pipeline.py's).
One train step with the draw pipelined (engine.make_train_step(pipe=True))
against the port's 1-process step: loss 1e-5 relative, the global
gradient 1e-4 of each tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.flows import realnvp as jrealnvp
from mhentropy_tpu_torch.convert import realnvp_state_dict
from mhentropy_tpu_torch.flows import realnvp
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.parallel import mesh as mesh_lib
from tests import torch_dist

ROWS, N_MICRO, TEMP = 8, 2, 0.8


def _close(got, want, share, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= share * max(np.abs(want).max(), 1e-12), (name, err, np.abs(want).max())


def _grads_sd(grads) -> dict:
    sd = realnvp_state_dict(jax.tree.map(np.asarray, grads))
    return {k: v for k, v in sd.items() if k != "mask"}


@pytest.fixture(scope="module")
def setup():
    cfg = jrealnvp.RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2)
    params = jrealnvp.init_params(jax.random.key(0), cfg)
    x = jax.random.normal(jax.random.key(1), (ROWS, 45))
    feat = jax.random.normal(jax.random.key(2), (ROWS, 32))
    key = jax.random.key(5)
    # One MHEnt train step with the draw pipelined over the 4 couplings.
    mcfg = torch_dist.small_cfg(32, steps=2)
    image, target = torch_dist.numpy_batch(4)
    pipe_inputs = dict(cfg=mcfg, state=mhent.init(mcfg, seed=0).state_dict(), lr=1e-3,
                       image=image, target=target,
                       noise=np.random.RandomState(4).randn(1, 2 * 4, 45).astype(np.float32))
    pcfg = realnvp.RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2)
    inputs = dict(flow_cfg=pcfg, flow_state=realnvp_state_dict(jax.tree.map(np.asarray, params)),
                  x=np.array(x), feat=np.array(feat), n_micro=N_MICRO,
                  z0=np.array(jax.random.normal(key, (ROWS, 45))) * TEMP,
                  pipe_inputs=pipe_inputs)
    # The group runs while this process computes the references.
    group = torch_dist.Group(4, ["pipeline", "pipe_step"], inputs)
    cproj = jrealnvp.cond_cache(params, cfg, jrealnvp.make_cond(params, cfg, feat))

    def loss_inv(p):
        z, ld = jrealnvp.inverse(p, cfg, x, cproj)
        return jnp.sum(z ** 2) + jnp.sum(ld ** 2)

    def loss_sample(p):
        s, lp = jrealnvp.sample(p, cfg, key, ROWS, feat=feat, temp=TEMP, return_log_prob=True)
        return jnp.sum(s ** 2) + jnp.sum(lp ** 2)

    want = {"inverse": jrealnvp.inverse(params, cfg, x, cproj),
            "forward": jrealnvp.forward(params, cfg, x, cproj),
            "log_prob": jrealnvp.log_prob(params, cfg, x, feat=feat),
            "sample": jrealnvp.sample(params, cfg, key, ROWS, feat=feat, temp=TEMP,
                                      return_log_prob=True),
            "inverse_grads": _grads_sd(jax.grad(loss_inv)(params)),
            "sample_grads": _grads_sd(jax.grad(loss_sample)(params))}
    want = jax.tree.map(np.asarray, want)
    one = torch_dist.train_once(pipe_inputs)
    return want, group.results(), one, inputs


@pytest.mark.parametrize("name", ["inverse", "forward", "sample"])
def test_pipelined_values_match_jax(setup, name):
    want, got, _, _ = setup
    for g, w, part in zip(got["pipeline"][name], want[name], ("x", "logdet")):
        _close(g.numpy(), w, 1e-5, f"{name} {part}")


def test_pipelined_log_prob_matches_jax(setup):
    want, got, _, _ = setup
    _close(got["pipeline"]["log_prob"].numpy(), want["log_prob"], 1e-5)


def test_pipelined_sample_without_grad_equals_with(setup):
    _, got, _, _ = setup
    assert torch.equal(got["pipeline"]["sample_no_grad"], got["pipeline"]["sample"][0])


@pytest.mark.parametrize("name", ["inverse_grads", "sample_grads"])
def test_pipelined_gradients_match_jax(setup, name):
    """The backward runs the reverse schedule; the stages' gradients summed
    over 'pipe' are the sequential flow's."""
    want, got, _, _ = setup
    g = got["pipeline"][name]
    assert set(g) == set(want[name])
    for k, w in want[name].items():
        _close(g[k].numpy(), w, 1e-5, k)


def test_pipelined_matches_the_port_sequential_flow(setup):
    _, got, _, inputs = setup
    flow = realnvp.RealNVP(inputs["flow_cfg"])
    flow.load_state_dict(inputs["flow_state"])
    x, feat = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["feat"])
    with torch.no_grad():
        cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
        z, ld = realnvp.inverse(flow, x, cproj)
    _close(got["pipeline"]["inverse"][0].numpy(), z.numpy(), 1e-6)
    _close(got["pipeline"]["inverse"][1].numpy(), ld.numpy(), 1e-6)


def test_pipelined_train_step_matches_one_process(setup):
    _, got, one, _ = setup
    g, w = got["pipe_step"], one
    for k in w["aux"][0]:
        assert abs(g["aux"][0][k] - w["aux"][0][k]) <= 1e-5 * abs(w["aux"][0][k]), k
    assert set(g["grads"]) >= set(w["grads"])
    for k, v in w["grads"].items():
        _close(g["grads"][k].numpy(), v.numpy(), 1e-4, k)


def test_pipeline_refusals():
    """As JAX's sample_q_z(pipeline=): not for a non-realnvp regressor, and
    not with the int8 draw."""
    mesh = mesh_lib.make_mesh()
    cfg = torch_dist.small_cfg(32)
    glow_net = mhent.init(cfg._replace(regressor="glow", glow_hidden=16, glow_layers=2), seed=0)
    feat = torch.zeros(2, 32)
    with pytest.raises(NotImplementedError, match="glow"):
        mhent.sample_q_z(glow_net, feat, 2, differentiable=True, pipeline=(mesh, 2))
    net = mhent.init(cfg, seed=0)
    with pytest.raises(NotImplementedError, match="flow_q"):
        mhent.sample_q_z(net, feat, 2, flow_q=object(), pipeline=(mesh, 2))
