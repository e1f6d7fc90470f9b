"""The port's train-mode BatchNorm (models/bn_cuda.py) against the JAX
package's: `bn_pallas.FusedTrainBN` with its Pallas sums in interpret mode
(the fixture of tests/test_bn_pallas.py) and flax's nn.BatchNorm.

On the CPU the port's sums are their plain versions; the card's kernels are
held to those by tests/test_torch_cuda.py. The port runs in its three
forms: mode "stats" and "full" on the plain sums, and the plain statistics
(kernels off). Tolerances:

* f32: outputs within 5e-6 and running statistics within 2e-5 relative
  (the flax formulas in f32, sums taken in another order); gradients within
  1e-4 relative (the tests/test_bn_pallas.py budget);
* bf16 input: outputs within 2e-2, one bf16 ulp at the largest values, where
  f32 statistics summed in another order land a value on the other side of
  a rounding boundary (tests/test_bn_pallas.py observed one element in 131k).
"""

import flax.linen as nn
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import bn_pallas
from mhentropy_tpu_torch.models import bn_cuda, resnet
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

FORMS = [("stats", True), ("full", True), ("stats", False)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(bn_pallas, "_backend_ok", lambda: True)


def _pair(dtype, mode):
    fused = bn_pallas.FusedTrainBN(momentum=0.9, epsilon=1e-5, dtype=dtype, mode=mode)
    ref = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=dtype)
    return fused, ref


def _port_bn(v, c):
    bn = resnet.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.asarray(v["params"]["scale"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.asarray(v["batch_stats"]["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.asarray(v["batch_stats"]["var"])))
    return bn


def _nchw(x, dtype):
    """NHWC numpy / JAX -> the port's channels-last NCHW tensor."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode,kernels", FORMS)
@pytest.mark.parametrize("shape,dtype", [
    ((4, 8, 8, 128), jnp.float32),
    ((4, 8, 8, 64), jnp.bfloat16),
    ((2, 16, 16, 256), jnp.bfloat16),
    ((3, 5, 5, 21), jnp.float32),  # the TPU kernel refused it; the port's takes any C
])
def test_train_forward_and_stats_match_jax(shape, dtype, mode, kernels):
    x = (jax.random.normal(jax.random.key(0), shape) * 2 + 0.5).astype(dtype)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    ys, stats = {}, {}
    for name, mod in zip(("fused", "flax"), _pair(dtype, mode)):
        v = mod.init(jax.random.key(1), x)
        v = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, v)
        ys[name], m = mod.apply(v, x, mutable=["batch_stats"])
        stats[name] = m["batch_stats"]
    bn = _port_bn(v, shape[-1]).train()
    xt = _nchw(x, tdtype)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    y = bn_cuda.batch_norm_train(xt, bn, mode, kernels)
    assert y.dtype == tdtype and y.is_contiguous(memory_format=torch.channels_last)
    atol = 5e-6 if dtype == jnp.float32 else 2e-2
    for name in ("fused", "flax"):
        np.testing.assert_allclose(_nhwc(y), np.asarray(ys[name], np.float32), atol=atol,
                                   err_msg=name)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats[name]["mean"]),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats[name]["var"]),
                                   rtol=2e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode,kernels", FORMS)
@pytest.mark.parametrize("shape", [(4, 8, 8, 128), (3, 5, 5, 21)])
def test_train_gradients_match_jax(shape, mode, kernels):
    x = jax.random.normal(jax.random.key(2), shape)
    w = jax.random.normal(jax.random.key(3), shape)
    grads = {}
    for name, mod in zip(("fused", "flax"), _pair(None, mode)):
        v = mod.init(jax.random.key(1), x)
        v = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, v)

        def loss(params, xx, mod=mod, v=v):
            y, _ = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                             mutable=["batch_stats"])
            return jnp.sum(y * w)

        grads[name] = jax.grad(loss, argnums=(0, 1))(v["params"], x)
    bn = _port_bn(v, shape[-1]).train()
    xt = _nchw(x, torch.float32).requires_grad_()
    (bn_cuda.batch_norm_train(xt, bn, mode, kernels) * _nchw(w, torch.float32)).sum().backward()
    for name, (gp, gx) in grads.items():
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_mean_var_cotangents_match_jax():
    """A loss of y and of the batch mean and variance themselves, through
    the port's two Functions against bn_pallas.train_bn and stats_sums_diff:
    the mean / var cotangent terms of the backward."""
    shape = (2, 4, 4, 128)
    x = jax.random.normal(jax.random.key(4), shape)
    w = jax.random.normal(jax.random.key(5), shape)
    scale = jnp.linspace(0.5, 1.5, shape[-1])
    bias = jnp.linspace(-0.2, 0.2, shape[-1])
    m = x.size // shape[-1]

    def loss_full(xx, sc, bi):
        y, mean, var = bn_pallas.train_bn(xx, sc, bi, 1e-5, jnp.float32)
        return jnp.sum(y * w) + jnp.sum(mean) + jnp.sum(var * var)

    def loss_stats(xx):
        s, ss = bn_pallas.stats_sums_diff(xx)
        mean = s / m
        var = jnp.maximum(0.0, ss / m - mean * mean)
        return jnp.sum(mean * mean) + jnp.sum(var * var)

    gx, gs, gb = jax.grad(loss_full, argnums=(0, 1, 2))(x, scale, bias)
    gx_stats = jax.grad(loss_stats)(x)

    xt = _nchw(x, torch.float32).requires_grad_()
    st = torch.from_numpy(np.asarray(scale)).requires_grad_()
    bt = torch.from_numpy(np.asarray(bias)).requires_grad_()
    y, mean, var = bn_cuda.TrainBN.apply(xt, st, bt, 1e-5)
    ((y * _nchw(w, torch.float32)).sum() + mean.sum() + (var * var).sum()).backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=1e-4, atol=1e-5)

    xt = _nchw(x, torch.float32).requires_grad_()
    s, ss = bn_cuda.StatsSums.apply(xt.float(), xt)
    mean = s / m
    var = torch.clamp(ss / m - mean * mean, min=0.0)
    ((mean * mean).sum() + (var * var).sum()).backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_stats), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("shape", [(3, 5, 5, 21), (7, 130), (1, 1, 1, 3)])
def test_plain_sums_are_the_f64_sums(shape):
    """The plain versions, channels-last 4-D or (M, C) rows, against numpy
    in float64: f32 accumulation, 1e-5 of the sum of absolute values."""
    rng = np.random.RandomState(6)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    if len(shape) == 4:
        xt, dyt = _nchw(x, torch.float32), _nchw(dy, torch.float32)
    else:
        xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    c = shape[-1]
    xr, dyr = x.reshape(-1, c).astype(np.float64), dy.reshape(-1, c).astype(np.float64)
    got = bn_cuda.stats_sums(xt) + bn_cuda.grad_sums(dyt, xt)
    want = (xr.sum(0), (xr * xr).sum(0), dyr.sum(0), (dyr * xr).sum(0))
    scales = (np.abs(xr).sum(0), (xr * xr).sum(0), np.abs(dyr).sum(0), np.abs(dyr * xr).sum(0))
    for g, w_, sc in zip(got, want, scales):
        assert g.dtype == torch.float32 and g.shape == (c,)
        assert np.all(np.abs(g.numpy() - w_) <= 1e-5 * sc + 1e-6)


def test_train_bn_refuses_an_unknown_mode():
    bn = resnet.BatchNorm2d(4).train()
    with pytest.raises(ValueError, match="'stats' or 'full'"):
        bn_cuda.batch_norm_train(torch.zeros(2, 4, 3, 3), bn, "ful")
    with pytest.raises(ValueError, match="'stats' or 'full'"):
        resnet.resnet18(bn_mode="Full")
