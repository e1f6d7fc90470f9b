"""The port's stem (folded BN, plain version) vs the JAX stem's oracle.

The oracle is the XLA conv + BN + ReLU + maxpool that
tests/test_stem_pallas.py (:26-33) holds the Pallas stem to; the Pallas stem
itself is W-locked to 256 and too slow to interpret here. f32 on the CPU,
tolerance 1e-4. The CUDA kernel is held to the plain version on the card
by tests/test_torch_cuda.py.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu_torch.models import resnet, stem_cuda

TOL = 1e-4


def _xla_reference(image, kernel, scale, bias, mean, var, eps=1e-5):
    y = jax.lax.conv_general_dilated(
        image, kernel, (2, 2), [(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    y = (y - mean) * jax.lax.rsqrt(var + eps) * scale + bias
    y = jnp.maximum(y, 0.0)
    return nn.max_pool(y, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])


def _rand_stem(seed):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        kernel=(rng.randn(7, 7, 3, 64) * 0.1).astype(f32),
        scale=(1.0 + rng.randn(64) * 0.2).astype(f32),
        bias=(rng.randn(64) * 0.1).astype(f32),
        mean=(rng.randn(64) * 0.1).astype(f32),
        var=(1.0 + rng.rand(64) * 0.5).astype(f32),
    )


def _fold(p, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    return stem_cuda.fold(t["kernel"].permute(3, 2, 0, 1), t["scale"], t["bias"],
                          t["mean"], t["var"], dtype=dtype)


@pytest.mark.parametrize("shape", [(2, 32, 48, 3), (1, 33, 29, 3)])
def test_plain_stem_matches_jax_oracle(shape):
    """(1, 33, 29): odd sizes put the last pool window on the edge."""
    p = _rand_stem(0)
    image = np.random.RandomState(1).randn(*shape).astype(np.float32)
    ref = _xla_reference(jnp.asarray(image), *(jnp.asarray(p[k]) for k in
                                               ("kernel", "scale", "bias", "mean", "var")))
    ours = stem_cuda.stem_forward(torch.from_numpy(image), *_fold(p))
    assert tuple(ours.shape) == ref.shape == (shape[0], *stem_cuda.out_hw(*shape[1:3]), 64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_fold_layout():
    w, b = _fold(_rand_stem(2), dtype=torch.bfloat16)
    assert w.shape == (147, 64) and w.dtype == torch.bfloat16 and w.is_contiguous()
    assert b.shape == (64,) and b.dtype == torch.float32


def test_resnet_stem_on_cpu_is_the_module_path():
    """On the CPU the backbone never reaches the kernel wrappers."""
    net = resnet.resnet18().eval()
    before = stem_cuda.launches
    with torch.no_grad():
        out = net(torch.randn(1, 32, 32, 3))
    assert out.shape == (1, 512) and stem_cuda.launches == before


def test_wrapper_raises_off_cpu_and_cuda():
    w, b = _fold(_rand_stem(3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        stem_cuda.stem_forward(torch.zeros(1, 16, 16, 3, device="meta"), w, b)
