"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device; on the
card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports neither JAX nor the JAX package, so it runs where only the
port is installed. Tolerances: the kernels round activations to bf16 between
products, so the max-abs error is held to a share of the output's range, as
in chip_smoke.py. The BN sums, the f32 sampler and the LBS blend are f32 on both
sides: their bounds are f32 rounding in another summation order. The Glow
sampler and its plain version round the same operands to bf16. The int8
stem, the int8 stage 2/3 kernel and the GEMM probe sum integers exactly and
round every epilogue op as their plain versions do: their f32 outputs are
equal, their bf16 outputs within a bf16 rounding (2^-7 of the largest).
The stem and stage-1 probes use their modules' stated tolerances
(`stem_cost_attrib.tolerance`, `stage1_probe.tolerance`).
"""

import math

import numpy as np
import pytest
import torch

from mhentropy_tpu_torch import int8_gemm_probe, stage1_probe, stem_cost_attrib, stem_probe
from mhentropy_tpu_torch.core import lbs_cuda
from mhentropy_tpu_torch.flows import cuda_glow_sampler, cuda_sampler, cuda_sampler_int8, glow
from mhentropy_tpu_torch.flows import realnvp
from mhentropy_tpu_torch.models import (bn_cuda, resnet, stage1_cuda, stage1_int8_cuda,
                                        stage2_int8_cuda, stem_cuda, stem_int8_cuda)

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


# (32, 256, 256, 3): the bench's batch; (1, 37, 50, 3) and (2, 33, 31, 3):
# the last 8 x 8 pooled tile ragged in one or both axes.
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 37, 50, 3), (2, 224, 224, 3),
                                   (32, 256, 256, 3), (2, 33, 31, 3)])
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


# (32, 64, 64, 64): the bench's batch; (1, 13, 37, 64), (3, 9, 17, 64) and
# 56 x 56: H or W not a multiple of the 8 x 16 tile; (1, 8, 16, 64): one
# tile, fewer than the SMs; (64, 64, 64, 64): 2,048 tiles, 15-16 a block.
@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (1, 13, 37, 64), (2, 56, 56, 64),
                                   (32, 64, 64, 64), (3, 9, 17, 64), (1, 8, 16, 64),
                                   (64, 64, 64, 64)])
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


# Row counts that leave the last cluster tile ragged (3 x 37, 5 x 100) and
# tiles that straddle images (every case with N < the tile's rows); a B = 1
# request (13 tiles of 16 rows), the B = 8 request, the bench step and the
# eval batch (tiles of 112 rows, 1 to 8 waves); H = 128 (16 columns a CTA)
# and 512 (64), and 64 (a cluster of 4) as the model tests run it.
@pytest.mark.parametrize("b,n,h,steps", [(3, 37, 128, 2), (3, 37, 512, 6), (1, 200, 512, 6),
                                         (5, 100, 512, 6), (1, 200, 128, 2), (2, 10, 64, 1),
                                         (8, 200, 512, 6), (32, 100, 512, 6),
                                         (64, 200, 512, 6)])
def test_sampler_kernel_matches_plain(dev, b, n, h, steps):
    torch.manual_seed(2)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=h, num_steps=steps))
    flow = flow.to(dev).eval()
    with torch.inference_mode():
        cp = realnvp.cond_cache(flow, torch.randn(b, 64, device=dev)).contiguous()
        z0 = torch.randn(b, n, 45, device=dev)
        packed = cuda_sampler.pack(flow)
        before = cuda_sampler.launches
        x, ld = cuda_sampler.transform(packed, z0, cp)
        assert cuda_sampler.launches == before + 1
        x_ref, ld_ref = cuda_sampler.transform_plain(packed, z0, cp)
    assert _within(x, x_ref, 1e-2) and _within(ld, ld_ref, 1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h", [1024, 40])
def test_sampler_raises_on_an_h_the_kernels_do_not_take(dev, dtype, h):
    """H = 1024 would give each of 8 CTAs 128 columns (64 at most); 40 is
    no multiple of 16. Neither launches nor falls back to the plain flow."""
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=h, num_steps=1))
    flow = flow.to(dev).eval()
    with torch.inference_mode():
        cp = realnvp.cond_cache(flow, torch.randn(2, 64, device=dev)).contiguous()
        packed = cuda_sampler.pack(flow, dtype=dtype)
        before = (cuda_sampler.launches, cuda_sampler.launches_f32)
        with pytest.raises(ValueError, match="no kernel shape"):
            cuda_sampler.transform(packed, torch.randn(2, 5, 45, device=dev), cp)
    assert (cuda_sampler.launches, cuda_sampler.launches_f32) == before


# The launch plans (tile rows, cluster, tiles, shared memory a CTA) that
# tests/test_torch_sampler.py's model of the kernels' layout gives at 15
# clusters a wave (L = 12, H = 512, Dp = 48); the card's occupancy query and
# the kernels' own layout must give the same.
CARD_PLANS = {False: {200: (16, 8, 13, 63952), 1600: (112, 8, 15, 226432),
                      3200: (112, 8, 29, 226432), 12800: (112, 8, 115, 226432)},
              True: {640: (48, 8, 14, 178016), 651: (48, 8, 14, 178016)}}


@pytest.mark.parametrize("f32", [False, True])
def test_sampler_plan_shared_memory_is_the_kernels(dev, f32):
    """The card's launch plans at the main path's row counts are the ones
    the CPU-tested plan gives on a model of the kernels' layout; the C
    entry refuses a tile past the largest (112 rows bf16, 64 f32) and a
    shape the kernels do not take."""
    from mhentropy_tpu_torch import ext

    lib = ext.load()
    fn = lib.mhent_realnvp_sample_f32_smem if f32 else lib.mhent_realnvp_sample_smem
    for rows, want in CARD_PLANS[f32].items():
        assert tuple(cuda_sampler.launch_plan(dev.index or 0, rows, 512, 48, f32)) == want
    r_max = 64 if f32 else 112
    assert all(0 < fn(r, 48, 512, 8) <= 227 * 1024 for r in range(16, r_max + 1, 16))
    assert fn(r_max + 16, 48, 512, 8) == -1
    assert fn(24, 48, 512, 8) == -1 and fn(16, 48, 1024, 8) == -1


# The int8 kernel's launch plans that tests/test_torch_sampler_int8.py's
# model of its layout gives at 15 clusters a wave (L = 12, H = 512, Dp = 64).
CARD_PLANS_INT8 = {1600: (112, 8, 15, 171520), 3200: (112, 8, 29, 171520),
                   12800: (128, 8, 100, 191048)}


def test_int8_sampler_plan_shared_memory_is_the_kernels(dev):
    """The card's int8 launch plans at the main path's row counts are the
    CPU-tested plan's on the model of the kernel's layout; the C entry
    refuses a tile past the largest (128 rows) and a shape it does not
    take."""
    from mhentropy_tpu_torch import ext

    fn = ext.load().mhent_realnvp_sample_q_smem
    for rows, want in CARD_PLANS_INT8.items():
        assert tuple(cuda_sampler_int8.launch_plan(dev.index or 0, rows, 512, 64)) == want
    assert all(0 < fn(r, 64, 512, 8) <= 227 * 1024 for r in range(16, 129, 16))
    assert fn(144, 64, 512, 8) == -1
    assert fn(24, 64, 512, 8) == -1 and fn(16, 48, 512, 8) == -1 and fn(16, 64, 1024, 8) == -1


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    w, b = stem_cuda.fold(torch.randn(64, 3, 7, 7), torch.ones(64), torch.zeros(64),
                          torch.zeros(64), torch.ones(64))
    with pytest.raises(ValueError, match="bfloat16"):
        stem_cuda.stem_forward(torch.zeros(1, 16, 16, 3, device=dev), w.to(dev), b.to(dev))


def test_stage1_entry_refuses_what_it_does_not_take(dev):
    """The C entry takes cin 64 with a downsample or 256 without, and
    returns cudaErrorInvalidValue (1) for anything else, launching nothing."""
    from mhentropy_tpu_torch import ext

    lib = ext.load()
    buf = torch.zeros(1 << 20, dtype=torch.bfloat16, device=dev)
    p = buf.data_ptr()
    stream = ext.stream_of(buf)
    for cin, wd in ((128, p), (256, p), (64, None), (64, p)):
        err = lib.mhent_stage1_block(p, p, p, p, p, p, wd, p, p, 1, 8, 16, cin, stream)
        assert (err == 0) == (cin == 64 and wd is not None), (cin, wd, err)
    torch.cuda.synchronize()


def test_stage1_int8_entry_refuses_what_it_does_not_take(dev):
    """Block 0 needs its downsample and input factor, blocks 1-2 the
    quantised input, blocks 0-1 the quantised output and the next block's
    factor; without one the entry returns cudaErrorInvalidValue (1) and
    launches nothing."""
    from mhentropy_tpu_torch import ext

    lib = ext.load()
    p = torch.zeros(1 << 20, dtype=torch.int8, device=dev).data_ptr()
    stream = ext.stream_of(torch.zeros(1, device=dev))
    for block, missing in ((0, "wd"), (0, "inv_in"), (0, "out_q"), (1, "xq"), (1, "inv_next"),
                           (2, "xq"), (3, None)):
        ptrs = {k: (None if k == missing else p) for k in ("xq", "inv_in", "wd", "inv_next",
                                                            "out_q")}
        err = lib.mhent_stage1_int8_block(
            p, ptrs["xq"], ptrs["inv_in"], p, p, p, p, p, p, p, p, p, ptrs["wd"], p, p,
            ptrs["inv_next"], p, ptrs["out_q"], 1, 8, 16, block, stream)
        assert err == 1, (block, missing, err)
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("rows", [100, 1001, 3199, 12800])
def test_lbs_blend_kernel_matches_plain(dev, rows):
    """MANO sizes (V = 778, J = 16); 1001 and 3,199 rows leave the last
    32-row tile ragged, 12,800 is the eval shape (N = 200, B = 64). f32
    throughout: the two differ by summation order only."""
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


# The serving request (B = 8), the bench step (B = 32) and the eval batch
# (B = 64) at 64 x 64, the ProHMR 56 x 56, and ragged tiles.
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 13, 37, 64), (8, 64, 64, 64),
                                   (8, 56, 56, 64), (32, 64, 64, 64), (64, 64, 64, 64)])
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


def _int8_flow(b, h, steps, dev, seed=5):
    """An O(1) torch-default flow calibrated on its own trajectory, its
    pre-scaled cond cache for b images, and the tree."""
    torch.manual_seed(seed)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=h, num_steps=steps))
    flow = flow.to(dev).eval()
    feat = torch.randn(b, 64, device=dev)
    tree = cuda_sampler_int8.quantize_sampler(flow, feat, torch.randn(32 * b, 45, device=dev))
    return tree, cuda_sampler_int8.cond_q(flow, tree, feat)


# The B = 8 request, the bench step (32 x 100) and the eval batch (64 x
# 200), and ragged row counts (3 x 37, 7 x 93), at H = 128 (a cluster of 4,
# 32 columns a CTA) and 512 (8, 64).
@pytest.mark.parametrize("h,steps", [(128, 2), (512, 6)])
@pytest.mark.parametrize("b,n", [(3, 37), (7, 93), (8, 200), (32, 100), (64, 200)])
def test_int8_sampler_kernel_matches_plain(dev, b, n, h, steps):
    """O(1) torch-default weights. The integer products are exact; exp and
    tanh may differ in the last ulp, which can move a requantised value by
    one step, so the bound is a share of the output's range."""
    with torch.inference_mode():
        tree, cq = _int8_flow(b, h, steps, dev)
        z0 = torch.randn(b, n, 45, device=dev) * 0.8
        before = cuda_sampler_int8.launches
        x, ld = cuda_sampler_int8.transform_q(tree, z0, cq)
        assert cuda_sampler_int8.launches == before + 1
        x_ref, ld_ref = cuda_sampler_int8.xla_forward_q(
            tree, torch.nn.functional.pad(z0, (0, tree.masks.shape[-1] - 45)), cq)
    assert _within(x, x_ref[..., :45], 1e-2) and _within(ld, ld_ref, 1e-2)


@pytest.mark.parametrize("kernel", ["int8_sampler", "stage1_int8"])
def test_int8_kernels_repeat_bit_for_bit(dev, kernel):
    """Each kernel twice on the same inputs gives the same bits: the integer
    sums are exact and the partial sums go in rank order, so a difference
    could only be a cluster or shared-memory race."""
    with torch.inference_mode():
        if kernel == "int8_sampler":
            tree, cq = _int8_flow(64, 512, 6, dev)
            z0 = torch.randn(64, 200, 45, device=dev) * 0.8
            runs = [cuda_sampler_int8.transform_q(tree, z0, cq) for _ in range(2)]
        else:
            g = torch.Generator().manual_seed(4)
            packed = stage1_int8_cuda.pack(_int8_sites(g, dev))
            x = torch.randn((32, 64, 64, 64), generator=g).to(dev, torch.bfloat16)
            runs = [(stage1_int8_cuda.stage1_forward_q(x, packed),) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h", [1024, 48])
def test_int8_sampler_raises_on_an_h_the_kernel_does_not_take(dev, h):
    """H = 1024 would give each of 8 CTAs 128 columns (64 at most); 48 is no
    multiple of the s8 k-step. Neither launches nor falls back."""
    with torch.inference_mode():
        tree, cq = _int8_flow(2, h, 1, dev)
        before = cuda_sampler_int8.launches
        with pytest.raises(ValueError, match="no kernel shape"):
            cuda_sampler_int8.transform_q(tree, torch.randn(2, 5, 45, device=dev), cq)
    assert cuda_sampler_int8.launches == before


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


@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 8, 64), torch.bfloat16), ((4, 4, 4, 2048), torch.bfloat16),
    ((3, 5, 5, 21), torch.float32), ((3, 3, 3, 20), torch.bfloat16),
    ((5, 7, 3, 24), torch.float32)])
def test_bn_sums_kernels_match_plain(dev, shape, dtype):
    """Any (M, C): 16-byte loads where C allows, one channel a load where it
    does not (21, 20 bf16). f32 sums in another order: each channel within
    1e-5 of its sum of absolute values. The kernel repeats itself bit for
    bit (no atomics)."""
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev, dtype).permute(0, 3, 1, 2)
    dy = torch.randn(shape, generator=g).to(dev, dtype).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    before = (bn_cuda.stats_launches, bn_cuda.grad_launches)
    got = bn_cuda.stats_sums(x) + bn_cuda.grad_sums(dy, x)
    assert (bn_cuda.stats_launches, bn_cuda.grad_launches) == (before[0] + 1, before[1] + 1)
    want = bn_cuda.stats_sums_plain(x) + bn_cuda.grad_sums_plain(dy, x)
    xf, dyf = x.float(), dy.float()
    scales = [xf.abs().sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), dyf.abs().sum((0, 2, 3)),
              (dyf * xf).abs().sum((0, 2, 3))]
    for a, b, sc in zip(got, want, scales):
        assert a.shape == (shape[-1],) and a.dtype == torch.float32
        assert bool(((a - b).abs() <= 1e-5 * sc + 1e-6).all())
    again = bn_cuda.stats_sums(x) + bn_cuda.grad_sums(dy, x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    rows = x.permute(0, 2, 3, 1).reshape(-1, shape[-1])
    assert all(torch.equal(a, b) for a, b in zip(bn_cuda.stats_sums(rows), got[:2]))


def test_bn_sums_refuse_a_layout_they_would_have_to_copy(dev):
    x = torch.randn(2, 16, 4, 4, device=dev)  # NCHW-contiguous, not channels_last
    with pytest.raises(ValueError, match="channels_last"):
        bn_cuda.stats_sums(x)
    with pytest.raises(ValueError, match="channels_last"):
        bn_cuda.grad_sums(x, x)


@pytest.mark.parametrize("mode", ["stats", "full"])
def test_train_bn_kernels_match_plain_statistics(dev, mode):
    """batch_norm_train with the kernels against flax's plain statistics on
    the card: outputs, running statistics and gradients, f32."""
    g = torch.Generator().manual_seed(8)
    x0 = (torch.randn(4, 6, 6, 64, generator=g) * 2 + 0.5).to(dev).permute(0, 3, 1, 2)
    w = torch.randn(4, 64, 6, 6, generator=g).to(dev)
    results = []
    for kernels in (True, False):
        bn = resnet.BatchNorm2d(64).to(dev)
        with torch.no_grad():
            bn.weight.add_(0.1)
            bn.bias.add_(0.1)
        x = x0.clone().requires_grad_()
        y = bn_cuda.batch_norm_train(x, bn, mode, kernels)
        (y * w).sum().backward()
        results.append((y, bn.running_mean, bn.running_var, x.grad, bn.weight.grad, bn.bias.grad))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# 30 and 111 rows leave the last cluster tile ragged; 640 is the train draw
# (14 tiles of 48 rows across images); 651 is ragged at that size.
@pytest.mark.parametrize("b,n,h,steps", [(3, 10, 128, 2), (64, 10, 512, 6), (3, 37, 128, 2),
                                         (1, 200, 512, 6), (5, 100, 512, 6), (7, 93, 512, 6),
                                         (4, 10, 64, 1)])
def test_f32_sampler_kernel_matches_plain(dev, b, n, h, steps):
    """f32 weights at O(1) scale. f32 on both sides (3xTF32 products in the
    kernel): within 1e-5 of the output's range."""
    torch.manual_seed(9)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=h, num_steps=steps))
    flow = flow.to(dev).eval()
    with torch.inference_mode():
        cp = realnvp.cond_cache(flow, torch.randn(b, 64, device=dev)).contiguous()
        z0 = torch.randn(b, n, 45, device=dev)
        packed = cuda_sampler.pack(flow, dtype=torch.float32)
        before = cuda_sampler.launches_f32
        x, ld = cuda_sampler.transform(packed, z0, cp)
        assert cuda_sampler.launches_f32 == before + 1
        x_ref, ld_ref = cuda_sampler.transform_plain(packed, z0, cp)
    assert _within(x, x_ref, 1e-5) and _within(ld, ld_ref, 1e-5)


def test_sample_fused_diff_gradients_match_plain_autograd(dev):
    """The Function (kernel forward, plain-flow backward) against autograd
    through the plain f32 flow, same noise: values and gradients to the
    flow's parameters, the features and the noise."""
    torch.manual_seed(10)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=128, num_steps=2))
    flow = flow.to(dev)
    b, n = 4, 10
    feat0 = torch.randn(b, 64, device=dev)
    noise0 = torch.randn(n * b, 45, device=dev)
    w = torch.randn(n * b, 45, device=dev)
    outs = []
    for fused in (True, False):
        flow.zero_grad()
        feat = feat0.clone().requires_grad_()
        noise = noise0.clone().requires_grad_()
        if fused:
            x, lp = cuda_sampler.sample_fused_diff(flow, feat, n, noise)
        else:
            cp = realnvp.cond_cache(flow, feat).repeat(1, 1, n, 1)
            x, lp = realnvp.sample(flow, noise, cproj=cp)
        ((x * w).sum() + lp.sum()).backward()
        outs.append([x.detach(), lp.detach(), feat.grad, noise.grad]
                    + [p.grad.clone() for p in flow.parameters()])
    for a, b_ in zip(*outs):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["stats", "full"])
def test_reverse_kld_train_launches_the_training_kernels(dev, mode):
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.models.encoder import EncoderConfig

    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(64, 64), fused_train_bn=mode),
        flow=realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=64, num_steps=1),
        feat_dim=64, image_size=64, n_train_hypotheses=3)
    net = mhent.prepare(mhent.init(cfg, seed=0), dev, masters=True).train()
    model = mano.synthetic_mano_model(0, device=dev)
    rng = np.random.RandomState(0)
    y = {"crop_uv": torch.from_numpy(rng.rand(2, 42).astype(np.float32) * 2 - 1).to(dev),
         "pose3d": torch.from_numpy(rng.randn(2, 63).astype(np.float32) * 0.3).to(dev),
         "vis": torch.ones(2, 21, device=dev)}
    image = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32)).to(dev)
    before = (bn_cuda.stats_launches, bn_cuda.grad_launches, cuda_sampler.launches_f32)
    out = mhent.reverse_kld(model, net, y, image, base_noise=torch.randn(6, 45, device=dev),
                            train=True)
    (-out["log_p"].mean()).backward()
    n_bn = sum(isinstance(m, resnet.BatchNorm2d) for m in net.modules())
    assert (bn_cuda.stats_launches - before[0], bn_cuda.grad_launches - before[1],
            cuda_sampler.launches_f32 - before[2]) == (n_bn, n_bn if mode == "full" else 0, 1)
    assert all(torch.isfinite(p.grad).all() for p in net.parameters() if p.grad is not None)


@pytest.mark.parametrize("rows", [1001, 3199, 3200])
def test_lbs_blend_kernel_takes_smpl(dev, rows):
    """SMPL's V = 6,890 and J = 24: fourteen vertex tiles, the last ragged;
    3,200 rows is the ProHMR shape (B = 32, N = 100), 3,199 leaves the last
    row tile ragged."""
    g = torch.Generator().manual_seed(4)
    w = torch.rand(6890, 24, generator=g)
    w = (w / w.sum(1, keepdim=True)).to(dev)
    rot = torch.randn(3, 3, 24, rows, generator=g).to(dev)
    trans = torch.randn(3, 24, rows, generator=g).to(dev) * 0.05
    vposed = torch.randn(3, 6890, rows, generator=g).to(dev) * 0.5
    before = lbs_cuda.launches
    out = lbs_cuda.lbs_blend(w, rot, trans, vposed)
    assert lbs_cuda.launches == before + 1
    torch.testing.assert_close(out, lbs_cuda.lbs_blend_plain(w, rot, trans, vposed),
                               rtol=1e-5, atol=1e-6)


def test_lbs_blend_raises_with_the_shapes_past_its_joint_limit(dev):
    """150 joints still fit one vertex beside 32 rows' transforms (the
    header's limit); 151 raise, naming the shapes."""
    def args(j):
        return (torch.zeros(10, j, device=dev), torch.zeros(3, 3, j, 4, device=dev),
                torch.zeros(3, j, 4, device=dev), torch.zeros(3, 10, 4, device=dev))

    assert lbs_cuda.lbs_blend(*args(150)).shape == (3, 10, 4)
    with pytest.raises(ValueError, match="151 joints"):
        lbs_cuda.lbs_blend(*args(151))


@pytest.mark.parametrize("v,j,rows", [(1000, 150, 37), (778, 75, 100), (5, 149, 3)])
def test_lbs_blend_kernel_matches_plain_at_large_joint_counts(dev, v, j, rows):
    """Vertex tiles shrunk by the joints' staging: 3 vertices a tile at
    J = 150 (the limit), below 392 from J = 75 at MANO's V, an odd J; random
    values, f32 on both sides."""
    g = torch.Generator().manual_seed(9)
    w = torch.rand(v, j, generator=g)
    w = (w / w.sum(1, keepdim=True)).to(dev)
    args = (w, torch.randn(3, 3, j, rows, generator=g).to(dev),
            torch.randn(3, j, rows, generator=g).to(dev) * 0.05,
            torch.randn(3, v, rows, generator=g).to(dev) * 0.5)
    torch.testing.assert_close(lbs_cuda.lbs_blend(*args), lbs_cuda.lbs_blend_plain(*args),
                               rtol=1e-5, atol=1e-6)


def _o1_glow(cfg, seed, dev):
    torch.manual_seed(seed)
    flow = glow.ConditionalGlow(cfg)  # torch-default Linears: O(1) outputs
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for i in range(cfg.num_layers):
            an, lin, _ = flow.step(i)
            an.log_scale.copy_(0.1 * torch.randn(cfg.features, generator=g))
            an.shift.copy_(0.1 * torch.randn(cfg.features, generator=g))
            for p in (lin.lower_entries, lin.upper_entries):
                p.copy_(0.3 / math.sqrt(cfg.features) * torch.randn(p.shape, generator=g))
    return flow.to(dev).eval()


@pytest.mark.parametrize("d,h,c,b,n", [(144, 1024, 2048, 4, 100), (45, 512, 512, 8, 200),
                                       (12, 64, 8, 3, 37), (144, 1024, 2048, 7, 93),
                                       (45, 512, 512, 2, 20), (250, 128, 16, 2, 33),
                                       (12, 192, 8, 3, 37), (45, 512, 512, 64, 100),
                                       (45, 512, 512, 64, 200)])
def test_glow_sampler_kernel_matches_plain(dev, d, h, c, b, n):
    """The ProHMR widths, the MHEnt Glow shape, a ragged small one (3 x 37
    rows, D = 12 padded to 16), ProHMR's widths at ragged rows (7 x 93), 40
    rows (below one 64-row tile) at H = 512 with Dp = 48, the widest Dp
    (256: three coupling stages, eight chunks a warpgroup), an H that is no
    multiple of the GEMM's 128 columns, 6,400 rows (400 tiles: the
    persistent CTAs walk more than one) and the glow MHEnt's eval batch,
    12,800 rows (B = 64, N = 200)."""
    flow = _o1_glow(glow.GlowConfig(d, h, 4, 2, c), 5, dev)
    with torch.inference_mode():
        packed = cuda_glow_sampler.pack(flow)
        ctx = cuda_glow_sampler.pack_context(flow, torch.randn(b, c, device=dev))
        z0 = torch.randn(b, n, d, device=dev)
        before = cuda_glow_sampler.launches
        x, ld = cuda_glow_sampler.transform(packed, z0, ctx)
        assert cuda_glow_sampler.launches == before + 1
        x_ref, ld_ref = cuda_glow_sampler.transform_plain(packed, z0, ctx)
    assert _within(x, x_ref, 1e-2) and _within(ld, ld_ref, 1e-2)


def test_glow_sampler_raises_on_what_the_kernel_does_not_take(dev):
    flow = _o1_glow(glow.GlowConfig(12, 64, 2, 2, 8), 6, dev)
    ctx = cuda_glow_sampler.pack_context(flow, torch.randn(2, 8, device=dev)).detach()
    z0 = torch.randn(2, 5, 12, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_glow_sampler.transform(cuda_glow_sampler.pack(flow, dtype=torch.float32), z0, ctx)
    with pytest.raises(ValueError, match="multiple of 64"):
        narrow = _o1_glow(glow.GlowConfig(12, 32, 2, 2, 8), 6, dev)
        cuda_glow_sampler.transform(cuda_glow_sampler.pack(narrow), z0,
                                    cuda_glow_sampler.pack_context(narrow, ctx.new_zeros(2, 8)))


def test_prohmr_path_launches_each_kernel_and_matches_plain_path(dev):
    from mhentropy_tpu_torch import eval_prohmr
    from mhentropy_tpu_torch.models import prohmr

    model, net = eval_prohmr.build(dev)
    image, gt = eval_prohmr.synthetic_batch(model, net, 2)
    noise = torch.randn(16, 144, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    counts = (stem_cuda.launches, stage1_cuda.launches, cuda_glow_sampler.launches,
              lbs_cuda.launches)
    kern, mets = eval_prohmr.evaluate(model, net, image, gt, 8, noise=noise)
    assert (stem_cuda.launches, stage1_cuda.launches, cuda_glow_sampler.launches,
            lbs_cuda.launches) == (counts[0] + 1, counts[1] + 3, counts[2] + 1, counts[3] + 1)
    assert kern["verts"].shape == (8, 2, 6890, 3)
    assert all(torch.isfinite(v).all() for v in mets.values())
    net.set_kernels(False)
    plain, _ = eval_prohmr.evaluate(model, net, image, gt, 8, noise=noise)
    assert cuda_glow_sampler.launches == counts[2] + 1
    # bf16 Glow operands against the f32 flow: chip_smoke.PROHMR_TOL's bound.
    assert (kern["joints3d"] - plain["joints3d"]).abs().max() <= 0.12
    assert prohmr.multi_hypothesis_metrics(plain, {"joints3d": gt})["mpjpe_bh"].isfinite().all()


def _glow_mhent(dev, masters=False, dtype="bfloat16", blocks=2):
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.models.encoder import EncoderConfig

    cfg = mhent.MHEntConfig(encoder=EncoderConfig(backbone="resnet50", n_latent=(64, 64),
                                                  dtype=dtype),
                            regressor="glow", glow_hidden=64, glow_layers=2,
                            glow_blocks=blocks, feat_dim=64, image_size=64,
                            n_train_hypotheses=2)
    return mhent.prepare(mhent.init(cfg, seed=0), dev, masters=masters)


def test_glow_mhent_eval_step_launches_the_glow_kernel_and_matches_plain(dev):
    """The glow MHEnt's eval step: stem 1, stage 1 3 and the Glow kernel 1
    (the hypotheses' draw; the reverse-KL draw is the plain Glow in train
    mode, with dropout), no RealNVP sampler; its hypotheses against the
    plain path's (bf16 Glow operands: 1e-2, as the RealNVP model path)."""
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.train import engine

    net = _glow_mhent(dev)
    model = mano.synthetic_mano_model(0, device=dev)
    image = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32))
    image = image.to(dev)
    noise = torch.randn(8, 45, device=dev) * 0.8
    counters = (stem_cuda, stage1_cuda, cuda_glow_sampler, cuda_sampler)
    counts = [m.launches for m in counters]
    with torch.inference_mode():
        kern = mhent.sample_hypotheses(model, net, image, n=4, mods=("xyz", "uv"),
                                       base_noise=noise)
        assert [m.launches for m in counters] == [counts[0] + 1, counts[1] + 3, counts[2] + 1,
                                                   counts[3]]
        net.set_kernels(False)
        plain = mhent.sample_hypotheses(model, net, image, n=4, mods=("xyz", "uv"),
                                        base_noise=noise)
        net.set_kernels(True)
    assert (kern["xyz"] - plain["xyz"]).abs().max() <= 1e-2
    from mhentropy_tpu_torch.data import synthetic

    data = synthetic.make_dataset(mano.synthetic_mano_model(0), n=2, image_size=64, seed=0)
    img, target = next(synthetic.batches(data, 2, device=dev))
    step = engine.make_eval_step(model, net, 4, 0.8,
                                 generator=torch.Generator(device=dev).manual_seed(0))
    f32 = cuda_sampler.launches_f32
    counts = [m.launches for m in counters]
    mets = step(img, target, torch.randn(4, 45, device=dev), noise)
    assert [m.launches for m in counters] == [counts[0] + 1, counts[1] + 3, counts[2] + 1,
                                               counts[3]]
    assert cuda_sampler.launches_f32 == f32
    assert all(bool(torch.isfinite(v)) for v in mets.values())


@pytest.mark.parametrize("blocks", [1, 3])
def test_glow_mhent_raises_for_a_glow_the_kernel_does_not_take(dev, blocks):
    """A glow MHEnt whose Glow the kernel does not take (glow_blocks != 2)
    raises on the card with kernels on, naming set_kernels(False), and
    draws through the plain Glow with them off."""
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import mhent

    net = _glow_mhent(dev, blocks=blocks)
    assert net.packed_flow is None
    model = mano.synthetic_mano_model(0, device=dev)
    image = torch.rand(2, 64, 64, 3, device=dev)
    launches = cuda_glow_sampler.launches
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="set_kernels"):
            mhent.sample_hypotheses(model, net, image, n=4, mods=("xyz",))
        net.set_kernels(False)
        out = mhent.sample_hypotheses(model, net, image, n=4, mods=("xyz",))
    assert cuda_glow_sampler.launches == launches
    assert bool(torch.isfinite(out["xyz"]).all())


def test_glow_mhent_train_step_runs_the_bn_sums_and_a_plain_glow(dev, monkeypatch):
    """A glow MHEnt train step on the card: the BN-sum kernels (53 a
    resnet50 forward), no sampler kernel of any kind; from the same weights,
    noise and dropout masks, in f32 with TF32 off, the loss and the running
    statistics the step leaves against the plain path's (1e-3 and 1e-4 of
    each tensor's largest value: the sums' order only). With TF32
    convolutions the sums' rounding flips TF32 roundings downstream, as
    bf16's do: the statistics then came out 1.3e-4 of the largest apart and
    the loss 1.2 % (8 % in bf16), which chip_smoke.py's B = 64 step bounds
    at 1e-2."""
    import copy

    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.train import engine

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    base = _glow_mhent(dev, masters=True, dtype="float32")
    model = mano.synthetic_mano_model(0, device=dev)
    data = synthetic.make_dataset(mano.synthetic_mano_model(0), n=4, image_size=64, seed=0)
    image, target = next(synthetic.batches(data, 4, device=dev))
    noise = torch.randn(8, 45, device=dev)
    losses, stats = {}, {}
    for kernels in (True, False):
        net = copy.deepcopy(base).train()
        net.set_kernels(kernels)
        step = engine.make_train_step(model, net, engine.make_optimizer(net, 1e-4, [10], 1),
                                      generator=torch.Generator(device=dev).manual_seed(1))
        counts = (bn_cuda.stats_launches, cuda_glow_sampler.launches, cuda_sampler.launches,
                  cuda_sampler.launches_f32)
        losses[kernels] = step(image, target, noise)["loss"].item()
        after = (bn_cuda.stats_launches, cuda_glow_sampler.launches, cuda_sampler.launches,
                 cuda_sampler.launches_f32)
        assert after == ((counts[0] + 53) if kernels else counts[0],) + counts[1:]
        stats[kernels] = {k: v for k, v in net.state_dict().items() if "running" in k}
    for k, v in stats[False].items():
        assert (stats[True][k] - v).abs().max() <= 1e-4 * v.abs().max(), k
    assert math.isfinite(losses[True])
    assert abs(losses[True] - losses[False]) <= 1e-3 * abs(losses[False])


def test_prohmr_nll_loss_backward_on_the_card(dev):
    """ProHMR's nll_loss in train mode (the mode plus one draw), forward and
    backward at a small geometry: finite gradients everywhere, the BN-sum
    kernels in the encoder, and the loss against the plain path's."""
    from mhentropy_tpu_torch import eval_prohmr
    from mhentropy_tpu_torch.core import smpl
    from mhentropy_tpu_torch.models import prohmr

    model = smpl.synthetic_smpl_model(0, n_verts=256, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    target = {"pose_6d": torch.randn(2, 144, generator=g, device=dev) * 0.3,
              "betas": torch.zeros(2, 10, device=dev),
              "keypoints3d": torch.randn(2, 24, 3, generator=g, device=dev) * 0.2,
              "keypoints2d": torch.randn(2, 24, 2, generator=g, device=dev) * 0.3}
    image = torch.rand(2, 32, 32, 3, generator=g, device=dev)
    noise = torch.randn(2, 144, generator=g, device=dev)
    losses = {}
    for kernels in (True, False):
        net = prohmr.init(eval_prohmr.tiny_config(), seed=0).to(dev)
        net.encoder.res.place(torch.float32, masters=True)
        net.train()
        net.set_kernels(kernels)
        before = bn_cuda.stats_launches
        out = prohmr.nll_loss(model, net, image, target, noise=noise)
        loss = (-out["log_p"].mean() + out["betas_l2"].mean() + out["kp3d_l1"].mean()
                + out["kp2d_l1"].mean())
        loss.backward()
        assert (bn_cuda.stats_launches > before) == kernels
        assert all(bool(torch.isfinite(p.grad).all()) for p in net.parameters()
                   if p.grad is not None)
        losses[kernels] = loss.item()
    assert abs(losses[True] - losses[False]) <= 1e-2 * abs(losses[False])


def _within_bf16(out, ref):
    return (out.float() - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


@pytest.mark.parametrize("shape", [(2, 64, 256, 3), (1, 37, 50, 3), (8, 256, 256, 3)])
def test_stem_int8_kernel_matches_plain(dev, shape):
    g = torch.Generator().manual_seed(30)
    conv = torch.randn(64, 3, 7, 7, generator=g) * math.sqrt(2 / 147)
    bn = torch.nn.BatchNorm2d(64).eval()
    _rand_bn(bn, g)
    image = (torch.randn(shape, generator=g) * 1.5).to(dev)
    site = stem_int8_cuda.prepare_stem_site(conv.to(dev), bn.to(dev),
                                            image.abs().amax(dim=(0, 1, 2)))
    packed = stem_int8_cuda.pack(site)
    ref = stem_int8_cuda.stem_plain(image, site)
    before = stem_int8_cuda.launches
    out32 = stem_int8_cuda.stem_forward_q(image, packed, out_dtype=torch.float32)
    out16 = stem_int8_cuda.stem_forward_q(image, packed)
    assert stem_int8_cuda.launches == before + 2 and out16.dtype == torch.bfloat16
    torch.testing.assert_close(out32, ref, rtol=0, atol=0)
    assert _within_bf16(out16, ref)


def _stem_int8_site(g, dev, image):
    """A calibrated site whose BN gamma is negative at every third filter."""
    conv = torch.randn(64, 3, 7, 7, generator=g) * math.sqrt(2 / 147)
    bn = torch.nn.BatchNorm2d(64).eval()
    _rand_bn(bn, g)
    with torch.no_grad():
        bn.weight[::3] *= -1
    return stem_int8_cuda.prepare_stem_site(conv.to(dev), bn.to(dev),
                                            image.abs().amax(dim=(0, 1, 2)))


def _stem_int8_holds(image, site, bulk=None):
    """Both output types through the kernel (`bulk` picks its path): f32
    equal to stem_plain, bf16 within a bf16 rounding; one launch a call."""
    packed = stem_int8_cuda.pack(site)
    ref = stem_int8_cuda.stem_plain(image, site)
    before = stem_int8_cuda.launches
    out32 = stem_int8_cuda._stem_kernel(image, packed, torch.float32, bulk)
    out16 = stem_int8_cuda._stem_kernel(image, packed, torch.bfloat16, bulk)
    assert stem_int8_cuda.launches == before + 2
    torch.testing.assert_close(out32, ref, rtol=0, atol=0)
    assert _within_bf16(out16, ref)


# The kernel's band and copy edges: (1, 256, 256, 3) bands of two conv rows;
# (3, 256, 256, 3) bands of four; (2, 72, 256, 3) a ragged last band; (2,
# 64, 224, 3) a 2,688-byte row pitch on the bulk path; (1, 40, 260, 3) two
# column tiles on the load path.
@pytest.mark.parametrize("shape", [(1, 256, 256, 3), (3, 256, 256, 3), (2, 72, 256, 3),
                                   (2, 64, 224, 3), (1, 40, 260, 3)])
def test_stem_int8_kernel_band_and_copy_edges(dev, shape):
    g = torch.Generator().manual_seed(34)
    image = (torch.randn(shape, generator=g) * 1.5).to(dev)
    _stem_int8_holds(image, _stem_int8_site(g, dev, image))


@pytest.mark.parametrize("shape", [(2, 64, 256, 3), (2, 64, 224, 3)])
def test_stem_int8_kernel_load_path_on_aligned_rows(dev, shape):
    """The load path, forced where the bulk path would run, gives the same
    exact output."""
    g = torch.Generator().manual_seed(35)
    image = (torch.randn(shape, generator=g) * 1.5).to(dev)
    _stem_int8_holds(image, _stem_int8_site(g, dev, image), bulk=False)


def test_stem_int8_kernel_pooled_row_across_a_band_boundary(dev):
    """An image zero but for the input rows under the conv rows i0 - 1 .. i0 +
    1 of the second band: the pooled row i0 / 2 that straddles it."""
    shape = (8, 256, 256, 3)
    band = stem_int8_cuda.plan_band(8, 128, 1, torch.cuda.get_device_properties(dev)
                                    .multi_processor_count)
    g = torch.Generator().manual_seed(36)
    image = torch.zeros(shape)
    rows = slice(2 * (band - 1) - 3, 2 * (band + 1) + 4)
    image[:, rows] = torch.randn(image[:, rows].shape, generator=g) * 1.5
    image = image.to(dev)
    _stem_int8_holds(image, _stem_int8_site(g, dev, image))


@pytest.mark.parametrize("bulk", [True, False])
def test_stem_int8_kernel_at_the_quantisers_edges(dev, bulk):
    """x * inv_a exactly at k + 0.5 (rounded half to even, as torch.round) and
    at +-127.5, +-128.5 (clipped), weights at +-127, scales of both signs:
    the kernel equals stem_plain."""
    g = torch.Generator().manual_seed(37)
    inv_a = torch.tensor([1.0, 0.5, 4.0])
    k = torch.randint(-131, 131, (2, 64, 256, 3), generator=g).float() + 0.5
    k.view(-1)[:8] = torch.tensor([127.5, -127.5, 128.5, -128.5, 126.5, -126.5, 0.5, -0.5])
    site = {"w8": torch.where(torch.rand(7, 7, 3, 64, generator=g) < 0.5, 127, -127)
                  .to(torch.int8),
            "inv_a": inv_a, "scale": (torch.rand(64, generator=g) - 0.5) * 2e-4,
            "bias": torch.randn(64, generator=g) * 0.1}
    site = {n: t.to(dev) for n, t in site.items()}
    _stem_int8_holds((k / inv_a).to(dev), site, bulk=bulk)


def _stage_sites(g, stage, dev, signed=False):
    """Random sites of one stage; `signed`: per-channel scales of both signs
    and zero biases."""
    geom = stage2_int8_cuda.GEOMS[stage]

    def site(shape):
        cout = shape[-1]
        scale = torch.rand(cout, generator=g) * 1.8e-3 + 2e-4
        bias = torch.randn(cout, generator=g) * 0.05
        if signed:
            scale = torch.where(torch.rand(cout, generator=g) < 0.5, -scale, scale)
            bias = torch.zeros(cout)
        return {"w8": torch.randint(-90, 90, shape, generator=g, dtype=torch.int8).to(dev),
                "scale": scale.to(dev), "bias": bias.to(dev),
                "inv_sa": (torch.rand((), generator=g) * 50 + 30).to(dev)}

    sites = {}
    for j in range(geom.n_blocks):
        cin = geom.cin if j == 0 else geom.cout
        sites[f"layer{stage}_{j}/conv1"] = site((1, 1, cin, geom.width))
        sites[f"layer{stage}_{j}/conv2"] = site((3, 3, geom.width, geom.width))
        sites[f"layer{stage}_{j}/conv3"] = site((1, 1, geom.width, geom.cout))
    sites[f"layer{stage}_0/downsample_conv"] = site((1, 1, geom.cin, geom.cout))
    sites[f"layer{stage}_0/downsample_conv"]["inv_sa"] = sites[f"layer{stage}_0/conv1"]["inv_sa"]
    return sites


@pytest.mark.parametrize("stage,b,signed", [
    *(pytest.param(stage, b, False, id=f"{stage}-{b}")
      for stage, b in [(2, 1), (2, 8), (3, 2), (3, 8), (2, 32), (3, 32), (3, 1)]),
    pytest.param(2, 2, True, id="2-2-signed")])
def test_stage_int8_kernel_matches_plain(dev, stage, b, signed):
    """Every shipped batch, a ragged grid (stage 3 at B = 1: 256 output
    pixels), and per-channel scales of both signs with zero biases (an
    epilogue reordered for speed shows there)."""
    g = torch.Generator().manual_seed(31)
    geom = stage2_int8_cuda.GEOMS[stage]
    packed = stage2_int8_cuda.pack(_stage_sites(g, stage, dev, signed), stage)
    x = torch.randn((b, geom.w_in, geom.w_in, geom.cin), generator=g).to(dev)
    xb = x.to(torch.bfloat16)
    before = stage2_int8_cuda.launches
    out32 = stage2_int8_cuda.stage_forward_q(x, packed, stage, out_dtype=torch.float32)
    out16 = stage2_int8_cuda.stage_forward_q(xb, packed, stage)
    assert stage2_int8_cuda.launches == before + 2 * geom.n_blocks
    assert out16.dtype == torch.bfloat16
    assert out16.shape == (b, geom.w_in // 2, geom.w_in // 2, geom.cout)
    torch.testing.assert_close(out32, stage2_int8_cuda.stage_plain(x, packed), rtol=0, atol=0)
    assert _within_bf16(out16, stage2_int8_cuda.stage_plain(xb, packed))


def test_int8_stage_and_stem_raise_on_what_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(32)
    packed = stage2_int8_cuda.pack(_stage_sites(g, 2, dev), 2)
    with pytest.raises(ValueError, match="x must be"):
        stage2_int8_cuda.stage_forward_q(torch.zeros(1, 32, 32, 256, device=dev), packed, 2)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        stage2_int8_cuda.stage_forward_q(torch.zeros(1, 64, 64, 256, device=dev,
                                                     dtype=torch.int8), packed, 2)
    with pytest.raises(ValueError, match="packed blocks"):
        stage2_int8_cuda.stage_forward_q(torch.zeros(1, 64, 64, 256, device=dev), packed[:2], 2)
    site = {"w8": torch.zeros(7, 7, 3, 64, dtype=torch.int8, device=dev),
            "inv_a": torch.ones(3, device=dev), "scale": torch.ones(64, device=dev),
            "bias": torch.zeros(64, device=dev)}
    with pytest.raises(ValueError, match="float32"):
        stem_int8_cuda.stem_forward_q(torch.zeros(1, 16, 16, 3, device=dev,
                                                  dtype=torch.bfloat16),
                                      stem_int8_cuda.pack(site))


@pytest.mark.parametrize("m,k,n", [(256, 128, 128), (384, 640, 384), int8_gemm_probe.SHAPE])
def test_gemm_probe_kernels_match_plain(dev, m, k, n):
    x8, w8, xb, wb = int8_gemm_probe.operands(m, k, n, dev)
    before = (int8_gemm_probe.launches_s8, int8_gemm_probe.launches_bf16)
    got = int8_gemm_probe.check(x8, w8, xb, wb)
    assert (int8_gemm_probe.launches_s8, int8_gemm_probe.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    assert got["ok"] and got["max_abs_err_s8"] == 0, got
    with pytest.raises(ValueError, match="multiples"):
        int8_gemm_probe.gemm_s8(x8[:100], w8)


def test_opt_in_int8_path_launches_the_int8_stem_and_stage_kernels(dev):
    """A resnet50 at 256 px with int8_stem and pallas_mid at q_from = 0:
    the int8 stem once, the stage kernel once a bottleneck of stages 2 and
    3, the int8 stage 1 three times, and no bf16 stem; the features close to
    the default int8 spec's."""
    from mhentropy_tpu_torch.models import quant
    from mhentropy_tpu_torch.models.encoder import Encoder, EncoderConfig

    torch.manual_seed(33)
    enc = Encoder(EncoderConfig(backbone="resnet50", n_latent=(32, 32))).to(dev).eval()
    enc.res.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    enc.res.fold_kernel_weights()
    image = torch.rand((2, 256, 256, 3), device=dev) * 2 - 1
    feats = {}
    with torch.inference_mode():
        for label, kw in (("opt_in", {"int8_stem": True, "pallas_mid": True}), ("default", {})):
            spec = quant.QuantSpec(backbone="resnet50", q_from=0, **kw)
            qt = quant.prepare(spec, enc.res, quant.calibrate(spec, enc.res, image))
            counts = (stem_int8_cuda.launches, stage2_int8_cuda.launches,
                      stage1_int8_cuda.launches, stem_cuda.launches)
            feats[label] = quant.backbone_forward(spec, qt, image)
            after = (stem_int8_cuda.launches, stage2_int8_cuda.launches,
                     stage1_int8_cuda.launches, stem_cuda.launches)
            want = (1, 10, 3, 0) if label == "opt_in" else (0, 0, 3, 1)
            assert tuple(a - c for a, c in zip(after, counts)) == want, (label, after, counts)
    a, b = feats["opt_in"], feats["default"]
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    assert torch.isfinite(a).all() and cos > 0.99, cos


@pytest.mark.parametrize("phase", stem_probe.PHASES)
@pytest.mark.parametrize("b,rows", [(2, 32), (32, 128)])
def test_stem_probe_cut_matches_plain(dev, phase, b, rows):
    planes, a = stem_probe.inputs(b, dev, dtype=torch.bfloat16)
    g, bb, s = stem_probe.epilogue_operands(dev)
    before = stem_cost_attrib.launches
    out = stem_cost_attrib.attrib_forward(planes, a, g, bb, s, phase, rows)
    assert stem_cost_attrib.launches == before + 1
    ref = stem_probe.phase_plain(phase, planes, a, g, bb, s, rows)
    assert out.shape == ref.shape == (b, 64, 128)
    assert (out - ref).abs().max().item() <= stem_cost_attrib.tolerance(phase, ref)


@pytest.mark.parametrize("b,rows", [(2, 32), (32, 128)])
def test_stem_probe_envelope_matches_plain(dev, b, rows):
    planes, a = stem_probe.inputs(b, dev)
    before = stem_probe.launches
    out = stem_probe.stem_probe(planes, a, rows)
    assert stem_probe.launches == before + 1
    ref = stem_probe.phase_plain("gemm", planes, a, conv_rows=rows)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_stem_probe_refuses_what_it_does_not_take(dev):
    planes, a = stem_probe.inputs(1, dev)
    for rows in (24, 16, 136):  # not a multiple of 16; below 32; beyond the planes' rows
        with pytest.raises(ValueError, match="conv_rows"):
            stem_probe.stem_probe(planes, a, rows)
    with pytest.raises(ValueError, match="planes"):
        stem_probe.stem_probe(planes[:, :, :, :64].contiguous(), a)
    with pytest.raises(ValueError, match="full cut"):
        stem_probe.probe_forward(planes, a, phase="full")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("phase", stem_probe.PHASES)
@pytest.mark.parametrize("b,rows", [(3, 48), (3, 64), (48, 48)])
def test_stem_probe_cut_matches_plain_at_band_edges(dev, dtype, phase, b, rows):
    """Band edges on f32 and bf16 planes: B = 3 at 48 and 64 conv rows runs
    bands of 16, B = 48 at 48 conv rows bands of 32, the second one ragged
    (16 rows), on the H100's 132 SMs (`stem_probe.plan_band`)."""
    planes, a = stem_probe.inputs(b, dev, seed=5, dtype=dtype)
    g, bb, s = stem_probe.epilogue_operands(dev)
    out = stem_probe.probe_forward(planes, a, g, bb, s, phase, rows)
    ref = stem_probe.phase_plain(phase, planes, a, g, bb, s, rows)
    assert out.shape == ref.shape == (b, 64, 128)
    assert (out - ref).abs().max().item() <= stem_cost_attrib.tolerance(phase, ref)


def test_stem_probe_full_cut_pools_across_a_band_boundary(dev):
    """B = 2 at 64 conv rows runs bands of 16: pooled row 16 takes conv rows
    31 (the second band's last) to 33. Planes zero but for the rows under
    that boundary (plane rows 63-69, read by conv rows 28-34), so that the
    output is that pooled row's and its neighbours' alone."""
    planes, a = stem_probe.inputs(2, dev, seed=6, dtype=torch.bfloat16)
    planes[:, :, :63] = 0
    planes[:, :, 70:] = 0
    g, bb, s = stem_probe.epilogue_operands(dev)
    out = stem_probe.probe_forward(planes, a, g, bb, s, "full", 64)
    ref = stem_probe.phase_plain("full", planes, a, g, bb, s, 64)
    empty = stem_probe.phase_plain("full", torch.zeros_like(planes), a, g, bb, s, 64)
    assert (ref - empty).abs().max().item() > 0
    assert (out - ref).abs().max().item() <= stem_cost_attrib.tolerance("full", ref)


@pytest.mark.parametrize("variant", ["a", "b"])
@pytest.mark.parametrize("b,h,w", [(32, 64, 64), (2, 16, 16), (2, 32, 48), (2, 16, 24),
                                   (2, 24, 16), (1, 12, 40)])
def test_stage1_probe_matches_plain(dev, variant, b, h, w):
    wa = stage1_probe.weights_a(dev)
    x = stage1_probe.input_a(b, dev, hw=h * w)
    if variant == "a":
        fwd, plain, ws = stage1_probe.forward_a, stage1_probe.plain_a, wa
    else:
        x = x.transpose(1, 2).contiguous()
        fwd, plain, ws = stage1_probe.forward_b, stage1_probe.plain_b, stage1_probe.to_b(wa)
    before = getattr(stage1_probe, f"launches_{variant}")
    out = fwd(x, ws, h, w)
    assert getattr(stage1_probe, f"launches_{variant}") == before + 3
    ref = plain(x, ws, w)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= stage1_probe.tolerance(ref)


def test_stage1_probe_refuses_what_it_does_not_take(dev):
    wa = stage1_probe.weights_a(dev)
    wb = stage1_probe.to_b(wa)
    for h, w in ((16, 20), (8, 12)):  # B's 16-byte halo chunks need W % 8 == 0; A takes any W
        x = stage1_probe.input_a(1, dev, hw=h * w)
        with pytest.raises(ValueError, match="W a multiple of 8"):
            stage1_probe.forward_b(x.transpose(1, 2).contiguous(), wb, h, w)
        ref = stage1_probe.plain_a(x, wa, w)
        out = stage1_probe.forward_a(x, wa, h, w)
        assert (out.float() - ref.float()).abs().max().item() <= stage1_probe.tolerance(ref)
    with pytest.raises(ValueError, match="x must be"):
        stage1_probe.forward_a(stage1_probe.input_a(1, dev).float(), wa)
    with pytest.raises(ValueError, match="w1 must be"):
        stage1_probe.forward_b(stage1_probe.input_a(1, dev).transpose(1, 2).contiguous(), wa)


def test_rle_path_launches_the_encoder_kernels_and_matches_plain(dev):
    """The RLE mode's resnet50 on the card: eval mode launches the stem (1)
    and stage 1 (3) kernels and agrees with the plain path on the same
    weights and draws (bf16 kernels against cuDNN: log p within 2e-2 of its
    largest value, the draws within 0.1); train mode launches the BN sums,
    one a BatchNorm, and its gradients are finite."""
    from mhentropy_tpu_torch.models import rle
    from mhentropy_tpu_torch.models.encoder import EncoderConfig

    cfg = rle.RLEConfig(encoder=EncoderConfig(backbone="resnet50", n_latent=(63, 63)),
                        flow=realnvp.RealNVPConfig(dim=3, h_dim=32, num_steps=2, joint_n=21,
                                                   tsfm_on="x"),
                        nf_res="rle", image_size=64)
    net = rle.prepare(rle.init(cfg, seed=0), dev, masters=True)
    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32)).to(dev)
    y = {"pose3d": torch.from_numpy(rng.randn(2, 63).astype(np.float32) * 0.3).to(dev)}
    g = torch.Generator(device=dev).manual_seed(0)
    draws = (torch.randn(2, 63, generator=g, device=dev),
             torch.randn(10, 42, 3, generator=g, device=dev) * 0.8)
    before = (stem_cuda.launches, stage1_cuda.launches)
    with torch.inference_mode():
        kern = rle.loss_and_predict(net, image, y, *draws)
        assert (stem_cuda.launches, stage1_cuda.launches) == (before[0] + 1, before[1] + 3)
        net.set_kernels(False)
        plain = rle.loss_and_predict(net, image, y, *draws)
    assert (stem_cuda.launches, stage1_cuda.launches) == (before[0] + 1, before[1] + 3)
    lp, ref = kern["log_p"], plain["log_p"]
    assert torch.isfinite(lp).all() and (lp - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert (kern["xyz"] - plain["xyz"]).abs().max() <= 0.1
    net.set_kernels(True)
    net.train()
    n_bn = sum(isinstance(m, resnet.BatchNorm2d) for m in net.modules())
    before = bn_cuda.stats_launches
    out = rle.loss_and_predict(net, image, y, *draws, train=True)
    (-out["log_p"].mean()).backward()
    assert bn_cuda.stats_launches == before + n_bn == before + 53
    assert all(torch.isfinite(p.grad).all() for p in net.parameters() if p.grad is not None)


def test_det_path_launches_the_lbs_kernel_and_matches_plain(dev):
    """The det MHEnt's sample_hypotheses with the mesh on the card: stem 1,
    stage 1 3, LBS 1 and no sampler launch (it has no flow); its hypotheses
    against the plain path's (bone-normalised xyz and verts within 4e-2, uv
    within 5 px, chip_smoke.SLICE_TOL's bounds)."""
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.models.encoder import EncoderConfig

    cfg = mhent.MHEntConfig(encoder=EncoderConfig(backbone="resnet50", n_latent=(64, 64)),
                            regressor="det", feat_dim=64, image_size=64)
    net = mhent.prepare(mhent.init(cfg, seed=0), dev)
    model = mano.synthetic_mano_model(0, device=dev)
    image = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    counts = lambda: (stem_cuda.launches, stage1_cuda.launches, lbs_cuda.launches,  # noqa: E731
                      cuda_sampler.launches, cuda_sampler.launches_f32)
    before = counts()
    with torch.inference_mode():
        kern = mhent.sample_hypotheses(model, net, image, n=4)
        assert tuple(a - b for a, b in zip(counts(), before)) == (1, 3, 1, 0, 0)
        net.set_kernels(False)
        blend, lbs_cuda.lbs_blend = lbs_cuda.lbs_blend, lbs_cuda.lbs_blend_plain
        try:
            plain = mhent.sample_hypotheses(model, net, image, n=4)
        finally:
            lbs_cuda.lbs_blend = blend
    assert counts()[:3] == (before[0] + 1, before[1] + 3, before[2] + 1)
    assert torch.equal(kern["xyz"][0], kern["xyz"][3])
    for k, tol in (("xyz", 4e-2), ("uv", 5.0), ("verts", 4e-2)):
        assert torch.isfinite(kern[k]).all() and (kern[k] - plain[k]).abs().max() <= tol, k


def test_loader_fed_train_step_launches_the_training_kernels_and_matches_plain(dev, tmp_path):
    """A FreiHAND-format tree (data/fixtures.py, read through the decode
    cache, so no image library is needed) batched by data.common onto the
    card: u8 images and the pixel-noise factors arrive on the device, and
    one train step from the same weights, batch and noise launches the BN
    sums (one a BatchNorm) and the f32 sampler (1), and its loss agrees
    with the plain path's within chip_smoke.TRAIN_LOSS_TOL (1e-2 relative,
    bf16 backbone)."""
    import copy

    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.data import common, fixtures, freihand
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.models.encoder import EncoderConfig
    from mhentropy_tpu_torch.train import engine

    common.set_decode_cache(str(tmp_path / "dc"))
    try:
        fixtures.write_freihand(str(tmp_path / "fh"), 10, cache=True)
        ds = freihand.load(str(tmp_path / "fh"), heavy_fields=set(), image_u8=True,
                           device_st=True)
        image, target = next(common.prefetch(common.batches(
            ds, 4, shuffle=True, seed=0, pad_remainder=True, device=dev)))
    finally:
        common.set_decode_cache(None)
    assert image.device.type == "cuda" and image.dtype == torch.uint8
    assert target["_pixel_noise"].device.type == "cuda" and "st" not in target
    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(64, 64)),
        flow=realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=64, num_steps=1),
        feat_dim=64, image_size=224, n_train_hypotheses=3, ds="freihand")
    base = mhent.init(cfg, seed=0)
    model = mano.synthetic_mano_model(0, device=dev)
    noise = torch.randn(12, 45, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    out = {}
    for kernels in (True, False):
        net = mhent.prepare(copy.deepcopy(base), dev, masters=True).train()
        net.set_kernels(kernels)
        before = (bn_cuda.stats_launches, cuda_sampler.launches_f32)
        step = engine.make_train_step(model, net, engine.make_optimizer(net, 1e-4, [5], 2))
        loss = float(step(image, target, noise)["loss"])
        out[kernels] = (loss, bn_cuda.stats_launches - before[0],
                        cuda_sampler.launches_f32 - before[1])
    n_bn = sum(isinstance(m, resnet.BatchNorm2d) for m in net.modules())
    assert out[True][1:] == (n_bn, 1) and out[False][1:] == (0, 0)
    assert math.isfinite(out[True][0])
    assert abs(out[True][0] - out[False][0]) <= 1e-2 * abs(out[False][0]), out


# The serving kernels as operators (mhentropy_tpu_torch/ops.py): each at a
# main-path shape (configs/ho3d.yaml's B = 8, N = 200 request, 256 px).
OPS = ["stem", "stage1", "realnvp_sample", "lbs_blend", "stage1_int8", "realnvp_sample_q",
       "glow_sample", "stem_int8", "stage2_int8"]


def _op_args(name, dev):
    from mhentropy_tpu_torch import ops

    g = torch.Generator().manual_seed(31)
    if name == "stem":
        conv = torch.randn(64, 3, 7, 7, generator=g) * math.sqrt(2 / 147)
        bn = torch.nn.BatchNorm2d(64)
        _rand_bn(bn, g)
        w, b = (t.to(dev) for t in stem_cuda.fold(conv, bn.weight, bn.bias, bn.running_mean,
                                                   bn.running_var))
        return (torch.randn(8, 256, 256, 3, generator=g).to(dev, torch.bfloat16), w, b)
    if name == "stage1":
        layer1 = resnet.resnet50().layer1.eval()
        for m in layer1.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                _rand_bn(m, g)
        folded = stage1_cuda.fold(layer1.to(dev))
        return (torch.randn(8, 64, 64, 64, generator=g).to(dev, torch.bfloat16),
                ops.flatten(folded))
    if name == "realnvp_sample":
        torch.manual_seed(31)
        flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=512, h_dim=512,
                                                     num_steps=6)).to(dev).eval()
        with torch.no_grad():
            cproj = realnvp.cond_cache(flow, realnvp.make_cond(
                flow, torch.randn(8, 512, device=dev))).float().contiguous()
            packed = cuda_sampler.pack(flow)
        return (torch.randn(8, 200, 45, device=dev) * 0.8, cproj, *packed[:7])
    if name == "lbs_blend":
        w = torch.rand(778, 16, generator=g)
        return tuple(t.to(dev) for t in (w / w.sum(1, keepdim=True),
                                         torch.randn(3, 3, 16, 1600, generator=g),
                                         torch.randn(3, 16, 1600, generator=g),
                                         torch.randn(3, 778, 1600, generator=g)))
    if name == "stage1_int8":
        return (torch.randn(8, 64, 64, 64, generator=g).to(dev, torch.bfloat16),
                ops.flatten(stage1_int8_cuda.pack(_int8_sites(g, dev))))
    if name == "realnvp_sample_q":
        with torch.no_grad():
            tree, cq = _int8_flow(8, 512, 6, dev)
        return (torch.randn(8, 200, 45, device=dev) * 0.8, cq, *tree.kernel)
    if name == "glow_sample":
        flow = _o1_glow(glow.GlowConfig(45, 512, 4, 2, 512), 31, dev)
        with torch.no_grad():
            packed = cuda_glow_sampler.pack(flow)
            ctx = cuda_glow_sampler.pack_context(flow, torch.randn(8, 512, device=dev))
        return (torch.randn(8, 200, 45, device=dev) * 0.8, ctx,
                *(getattr(packed, f) for f in cuda_glow_sampler.KERNEL_FIELDS))
    if name == "stem_int8":
        image = torch.rand(8, 256, 256, 3, generator=g).to(dev) * 2 - 1
        packed = stem_int8_cuda.pack(_stem_int8_site(g, dev, image))
        return (image, packed["wq"], packed["inv_a"], packed["scale"], packed["bias"], True)
    if name == "stage2_int8":
        packed = stage2_int8_cuda.pack(_stage_sites(g, 2, dev), 2)
        return (torch.randn(8, 64, 64, 256, generator=g).to(dev, torch.bfloat16),
                ops.flatten(packed), 2, True)
    raise KeyError(name)


@pytest.mark.parametrize("name", OPS)
def test_operator_passes_opcheck_on_the_card(dev, name):
    """Schema, fake implementation (shapes, dtypes, strides against the
    kernel's outputs) and AOT dispatch, on the CUDA implementation."""
    torch.library.opcheck(getattr(torch.ops.mhent, name).default, _op_args(name, dev))


@pytest.mark.parametrize("int8", [False, True])
def test_exported_sampler_launches_the_kernels_and_matches_live(dev, int8):
    """The loaded artifact launches the live call's kernels as often as the
    live call (float: stem 1, stage 1 3, sampler 1, LBS 1; int8 at q_from 0:
    int8 stage 1 3 and the int8 sampler in their place) and gives its
    outputs; it refuses CPU inputs."""
    from mhentropy_tpu_torch import export
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import mhent, quant
    from mhentropy_tpu_torch.models.encoder import EncoderConfig

    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet50", n_latent=(64, 64)),
        flow=realnvp.RealNVPConfig(dim=45, cond_dim=64, h_dim=64, num_steps=1),
        feat_dim=64, image_size=64)
    net = mhent.prepare(mhent.init(cfg, seed=0), dev)
    model = mano.synthetic_mano_model(0, device=dev)
    image = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)).to(dev) * 2 - 1
    noise = torch.randn(8, 45, device=dev) * 0.8
    mods = ("xyz", "uv", "verts")
    q = None
    if int8:
        with torch.no_grad():
            q = quant.quantize_sampler_into(*quant.quantize_encoder(net.feat_extractor, image,
                                                                    q_from=0),
                                            net, image, temp=1.0)
    live = export.make_sample_fn(model, net, 4, 0.8, mods, quant=q)
    sampler = export.load_sampler(export.export_sampler(model, net, 2, n=4, temp=0.8, mods=mods,
                                                        quant=q))
    assert sampler.device == "cuda"
    counters = {"stem": stem_cuda, "stage1": stage1_cuda, "sampler": cuda_sampler,
                "lbs": lbs_cuda, "stage1_int8": stage1_int8_cuda, "sampler_int8": cuda_sampler_int8}
    outs, counts = {}, {}
    with torch.no_grad():
        for side, fn in (("live", live), ("loaded", sampler.call)):
            before = {k: m.launches for k, m in counters.items()}
            outs[side] = fn(image, noise)
            torch.cuda.synchronize()
            counts[side] = {k: m.launches - before[k] for k, m in counters.items()}
    want = ({"stem": 1, "stage1": 0, "sampler": 0, "lbs": 1, "stage1_int8": 3, "sampler_int8": 1}
            if int8 else
            {"stem": 1, "stage1": 3, "sampler": 1, "lbs": 1, "stage1_int8": 0, "sampler_int8": 0})
    assert counts["live"] == want and counts["loaded"] == want, counts
    for m in mods:
        assert _within(outs["loaded"][m], outs["live"][m].float(), 1e-3), m
    with pytest.raises(ValueError, match="exported for cuda"):
        sampler.call(image.cpu(), noise.cpu())
