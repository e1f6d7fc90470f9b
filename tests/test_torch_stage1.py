"""The port's stage 1 (folded BN, plain version) vs the JAX Pallas stage 1.

The JAX side runs `stage1_forward(compute_dtype=f32)` in interpret mode at
the JAX test's shape (tests/test_stage1_pallas.py:76); the port side runs the
wrapper's plain version on the CPU. Tolerance 2e-4, as in that test. The CUDA
kernel is held to the plain version on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import stage1_pallas
from mhentropy_tpu_torch.models import resnet, stage1_cuda

TOL = 2e-4


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _rand_bn(rng, n):
    return {
        "scale": (1.0 + rng.randn(n) * 0.2).astype(np.float32),
        "bias": (rng.randn(n) * 0.1).astype(np.float32),
        "mean": (rng.randn(n) * 0.1).astype(np.float32),
        "var": (1.0 + rng.rand(n) * 0.5).astype(np.float32),
    }


def _rand_blocks(seed):
    """The JAX test's block layout (HWIO kernels), drawn with numpy."""
    rng = np.random.RandomState(seed)
    blocks = []
    for j in range(3):
        cin = 64 if j == 0 else 256
        blk = {
            "conv1": (rng.randn(1, 1, cin, 64) * 0.1).astype(np.float32),
            "bn1": _rand_bn(rng, 64),
            "conv2": (rng.randn(3, 3, 64, 64) * 0.1).astype(np.float32),
            "bn2": _rand_bn(rng, 64),
            "conv3": (rng.randn(1, 1, 64, 256) * 0.1).astype(np.float32),
            "bn3": _rand_bn(rng, 256),
        }
        if j == 0:
            blk["ds_conv"] = (rng.randn(1, 1, 64, 256) * 0.1).astype(np.float32)
            blk["ds_bn"] = _rand_bn(rng, 256)
        blocks.append(blk)
    return blocks


def _port_layer1(blocks):
    layer1 = torch.nn.Sequential(resnet.Bottleneck(64, 64), resnet.Bottleneck(256, 64),
                                 resnet.Bottleneck(256, 64))

    def load(conv, bn, k, p):
        conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(p["mean"]))
        bn.running_var.copy_(torch.from_numpy(p["var"]))

    with torch.no_grad():
        for mod, blk in zip(layer1, blocks):
            for i in (1, 2, 3):
                load(getattr(mod, f"conv{i}"), getattr(mod, f"bn{i}"), blk[f"conv{i}"],
                     blk[f"bn{i}"])
            if "ds_conv" in blk:
                load(mod.downsample[0], mod.downsample[1], blk["ds_conv"], blk["ds_bn"])
    return layer1.eval()


def test_plain_stage1_matches_pallas_stage1(interpret_mode):
    blocks = _rand_blocks(1)
    x = np.random.RandomState(0).randn(2, 8, 64, 64).astype(np.float32)
    ref = stage1_pallas.stage1_forward(
        jnp.asarray(x), jax.tree.map(jnp.asarray, blocks),
        compute_dtype=jnp.float32, out_dtype=jnp.float32)
    folded = stage1_cuda.fold(_port_layer1(blocks), dtype=torch.float32)
    ours = stage1_cuda.stage1_forward(torch.from_numpy(x), folded)
    assert tuple(ours.shape) == ref.shape == (2, 8, 64, 256)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hw", [(5, 7), (16, 40)])
def test_folded_plain_matches_the_modules(hw):
    """Folding BN into the GEMMs (and block 0's downsample bias into conv3's)
    is exact up to f32 reassociation: 1e-4 against the unfused modules."""
    layer1 = _port_layer1(_rand_blocks(2))
    x = torch.from_numpy(np.random.RandomState(3).randn(2, *hw, 64).astype(np.float32))
    ours = stage1_cuda.stage1_plain(x, stage1_cuda.fold(layer1, dtype=torch.float32))
    with torch.no_grad():
        ref = layer1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)


def test_fold_layout():
    folded = stage1_cuda.fold(_port_layer1(_rand_blocks(4)))
    assert [f.w1.shape for f in folded] == [(64, 64), (256, 64), (256, 64)]
    assert folded[0].wd.shape == (64, 256) and folded[1].wd is None
    assert all(f.w2.shape == (9, 64, 64) and f.w2.dtype == torch.bfloat16 for f in folded)
    assert all(f.b3.dtype == torch.float32 for f in folded)


def test_wrapper_raises_off_cpu_and_cuda():
    folded = stage1_cuda.fold(_port_layer1(_rand_blocks(5)))
    with pytest.raises(ValueError, match="unsupported device"):
        stage1_cuda.stage1_forward(torch.zeros(1, 8, 8, 64, device="meta"), folded)
