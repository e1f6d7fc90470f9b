"""The GEMM probe's plain versions (`int8_gemm_probe.plain_s8` /
`plain_bf16`, which the CPU path of `gemm_s8` / `gemm_bf16` runs) against
the JAX probe's two Pallas kernels (tools/mosaic_int8_probe.py
`make_kernels`), run in interpret mode on the CPU at the probe's fixed
(32768, 640) x (640, 512), on the same numpy-seeded integer operands.

Tolerances: the s8 side sums integers exactly on both sides: equal. The
bf16 side sums the same bf16 operands in f32 in another order and rounds
once to bf16: within one bf16 rounding (2^-8) of the largest output.
"""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu_torch import int8_gemm_probe
from tools import mosaic_int8_probe
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.fixture(scope="module")
def operands():
    m, k, n = int8_gemm_probe.SHAPE
    rng = np.random.RandomState(0)
    x = rng.randint(-127, 127, (m, k)).astype(np.int8)
    w = rng.randint(-127, 127, (n, k)).astype(np.int8)  # the port's (N, K) layout
    return x, w


def test_shape_is_the_jax_probes(interpret):
    shape, _, _ = mosaic_int8_probe.make_kernels()
    assert shape == int8_gemm_probe.SHAPE


@pytest.mark.parametrize("side", ["s8", "bf16"])
def test_plain_matches_jax_kernel(interpret, operands, side):
    x, w = operands
    _, f_bf16, f_int8 = mosaic_int8_probe.make_kernels()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if side == "s8":
        ref = np.asarray(f_int8(jnp.asarray(x), jnp.asarray(w.T)))
        got = int8_gemm_probe.gemm_s8(xt, wt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        ref = np.asarray(f_bf16(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w.T, jnp.bfloat16)),
                         np.float32)
        got = int8_gemm_probe.gemm_bf16(xt.to(torch.bfloat16), wt.to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= 2.0 ** -8 * np.abs(ref).max(), err
