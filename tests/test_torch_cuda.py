"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device; on the
card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports neither JAX nor the JAX package, so it runs where only the
port is installed. Tolerances: the kernels round activations to bf16 between
products, so the max-abs error is held to a share of the output's range, as
in chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

from mhentropy_tpu_torch.core import lbs_cuda
from mhentropy_tpu_torch.flows import cuda_sampler, cuda_sampler_int8, realnvp
from mhentropy_tpu_torch.models import resnet, stage1_cuda, stage1_int8_cuda, stem_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand_bn(bn, g):
    n = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
        bn.bias.copy_(0.1 * torch.randn(n, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(n, generator=g))
        bn.running_var.copy_(1.0 + 0.5 * torch.rand(n, generator=g))


def _within(out, ref, share):
    return (out.float() - ref).abs().max().item() <= share * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 37, 50, 3)])
def test_stem_kernel_matches_plain(dev, shape):
    g = torch.Generator().manual_seed(0)
    conv = torch.randn(64, 3, 7, 7, generator=g) * math.sqrt(2 / 147)
    bn = torch.nn.BatchNorm2d(64)
    _rand_bn(bn, g)
    w, b = (t.to(dev) for t in stem_cuda.fold(conv, bn.weight, bn.bias, bn.running_mean,
                                               bn.running_var))
    image = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    before = stem_cuda.launches
    out = stem_cuda.stem_forward(image, w, b)
    assert stem_cuda.launches == before + 1
    assert _within(out, stem_cuda.stem_plain(image.float(), w.float(), b), 2e-2)


@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (1, 13, 37, 64)])
def test_stage1_kernel_matches_plain(dev, shape):
    g = torch.Generator().manual_seed(1)
    layer1 = torch.nn.Sequential(resnet.Bottleneck(64, 64), resnet.Bottleneck(256, 64),
                                 resnet.Bottleneck(256, 64))
    for m in layer1.modules():
        if isinstance(m, torch.nn.Conv2d):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * math.sqrt(2 / m.weight[0].numel()))
        elif isinstance(m, torch.nn.BatchNorm2d):
            _rand_bn(m, g)
    folded = [stage1_cuda.FoldedBlock(*(None if t is None else t.to(dev) for t in f))
              for f in stage1_cuda.fold(layer1)]
    x = torch.relu(torch.randn(shape, generator=g)).to(dev, torch.bfloat16)
    before = stage1_cuda.launches
    out = stage1_cuda.stage1_forward(x, folded)
    assert stage1_cuda.launches == before + 3
    assert _within(out, stage1_cuda.stage1_plain(x.float(), folded), 3e-2)


def test_sampler_kernel_matches_plain(dev):
    """N = 37 leaves the last 32-row tile partly empty."""
    torch.manual_seed(2)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=128, num_steps=2))
    flow = flow.to(dev).eval()
    b, n = 3, 37
    with torch.inference_mode():
        cp = realnvp.cond_cache(flow, torch.randn(b, 64, device=dev)).contiguous()
        z0 = torch.randn(b, n, 45, device=dev)
        packed = cuda_sampler.pack(flow)
        before = cuda_sampler.launches
        x, ld = cuda_sampler.transform(packed, z0, cp)
        assert cuda_sampler.launches == before + 1
        x_ref, ld_ref = cuda_sampler.transform_plain(packed, z0, cp)
    assert _within(x, x_ref, 1e-2) and _within(ld, ld_ref, 1e-2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    w, b = stem_cuda.fold(torch.randn(64, 3, 7, 7), torch.ones(64), torch.zeros(64),
                          torch.zeros(64), torch.ones(64))
    with pytest.raises(ValueError, match="bfloat16"):
        stem_cuda.stem_forward(torch.zeros(1, 16, 16, 3, device=dev), w.to(dev), b.to(dev))


def test_model_path_launches_each_kernel_and_matches_plain_path(dev):
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.models.encoder import EncoderConfig

    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet50", n_latent=(64, 64)),
        flow=realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=64, num_steps=1),
        feat_dim=64, image_size=64)
    net = mhent.prepare(mhent.init(cfg, seed=0), dev)
    model = mano.synthetic_mano_model(0, device=dev)
    image = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32))
    noise = torch.randn(8, 45, device=dev) * 0.8
    counts = (stem_cuda.launches, stage1_cuda.launches, cuda_sampler.launches)
    with torch.inference_mode():
        kern = mhent.sample_hypotheses(model, net, image.to(dev), n=4, mods=("xyz", "uv"),
                                       base_noise=noise)
        assert (stem_cuda.launches, stage1_cuda.launches, cuda_sampler.launches) == (
            counts[0] + 1, counts[1] + 3, counts[2] + 1)
        net.set_kernels(False)
        plain = mhent.sample_hypotheses(model, net, image.to(dev), n=4, mods=("xyz", "uv"),
                                        base_noise=noise)
    assert (kern["xyz"] - plain["xyz"]).abs().max() <= 1e-2


@pytest.mark.parametrize("rows", [100, 1001, 12800])
def test_lbs_blend_kernel_matches_plain(dev, rows):
    """MANO sizes (V = 778, J = 16); 1001 rows leave the last 32-row tile
    ragged, 12,800 is the eval shape (N = 200, B = 64). f32 throughout: the
    two differ by summation order only."""
    g = torch.Generator().manual_seed(3)
    w = torch.rand(778, 16, generator=g)
    w = (w / w.sum(1, keepdim=True)).to(dev)
    rot = torch.randn(3, 3, 16, rows, generator=g).to(dev)
    trans = torch.randn(3, 16, rows, generator=g).to(dev) * 0.05
    vposed = torch.randn(3, 778, rows, generator=g).to(dev) * 0.05
    before = lbs_cuda.launches
    out = lbs_cuda.lbs_blend(w, rot, trans, vposed)
    assert lbs_cuda.launches == before + 1
    ref = lbs_cuda.lbs_blend_plain(w, rot, trans, vposed)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


def _int8_sites(g, dev):
    def site(shape):
        cout = shape[-1]
        return {"w8": torch.randint(-90, 90, shape, generator=g, dtype=torch.int8).to(dev),
                "scale": (torch.rand(cout, generator=g) * 1.8e-3 + 2e-4).to(dev),
                "bias": (torch.randn(cout, generator=g) * 0.05).to(dev),
                "inv_sa": (torch.rand((), generator=g) * 50 + 30).to(dev)}

    sites = {}
    for j in range(3):
        cin = 64 if j == 0 else 256
        sites[f"layer1_{j}/conv1"] = site((1, 1, cin, 64))
        sites[f"layer1_{j}/conv2"] = site((3, 3, 64, 64))
        sites[f"layer1_{j}/conv3"] = site((1, 1, 64, 256))
    sites["layer1_0/downsample_conv"] = site((1, 1, 64, 256))
    sites["layer1_0/downsample_conv"]["inv_sa"] = sites["layer1_0/conv1"]["inv_sa"]
    return sites


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 13, 37, 64), (8, 64, 64, 64)])
def test_stage1_int8_kernel_matches_plain(dev, shape):
    """The integer products are exact and every epilogue op is rounded the
    same way in both, so the kernel's bf16 output is the plain f32 result
    rounded to bf16, up to a rare requantise tie."""
    g = torch.Generator().manual_seed(4)
    packed = stage1_int8_cuda.pack(_int8_sites(g, dev))
    x = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    before = stage1_int8_cuda.launches
    out = stage1_int8_cuda.stage1_forward_q(x, packed)
    assert stage1_int8_cuda.launches == before + 3 and out.dtype == torch.bfloat16
    ref = stage1_int8_cuda.stage1_plain(x, packed)
    exact = (out == ref.to(torch.bfloat16)).float().mean().item()
    assert exact > 0.999, exact
    assert _within(out, ref, 1e-2)


@pytest.mark.parametrize("b,n,h,steps", [(3, 37, 128, 2), (8, 200, 512, 6)])
def test_int8_sampler_kernel_matches_plain(dev, b, n, h, steps):
    """O(1) torch-default weights. The integer products are exact; exp and
    tanh may differ in the last ulp, which can move a requantised value by
    one step, so the bound is a share of the output's range."""
    torch.manual_seed(5)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=h, num_steps=steps))
    flow = flow.to(dev).eval()
    with torch.inference_mode():
        feat = torch.randn(b, 64, device=dev)
        tree = cuda_sampler_int8.quantize_sampler(flow, feat, torch.randn(32 * b, 45, device=dev))
        cq = cuda_sampler_int8.cond_q(flow, tree, feat)
        z0 = torch.randn(b, n, 45, device=dev) * 0.8
        before = cuda_sampler_int8.launches
        x, ld = cuda_sampler_int8.transform_q(tree, z0, cq)
        assert cuda_sampler_int8.launches == before + 1
        x_ref, ld_ref = cuda_sampler_int8.xla_forward_q(
            tree, torch.nn.functional.pad(z0, (0, tree.masks.shape[-1] - 45)), cq)
    assert _within(x, x_ref[..., :45], 1e-2) and _within(ld, ld_ref, 1e-2)


@pytest.mark.parametrize("shape,k,stride", [((2, 9, 7, 16), 3, 2), ((1, 3, 3, 24), 1, 1)])
def test_int8_conv_on_the_card_is_the_exact_integer_sum(dev, shape, k, stride):
    """Stages 2-4 of the int8 encoder: torch._int_mm on an int8 im2col, rows
    padded past its m > 16 rule (9 rows in the second case), equal to the
    CPU's exact f64 convolution."""
    from mhentropy_tpu_torch.models import quant

    g = torch.Generator().manual_seed(6)
    xq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (k, k, shape[-1], 32), generator=g, dtype=torch.int8)
    pad = k // 2
    want = quant._int_conv(xq, w8, stride, pad)
    got = quant._int_conv(xq.to(dev), w8.to(dev), stride, pad)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
