"""Times the RealNVP sampler kernels, int8 stage 1, the Glow sampler, the
LBS blend, the GEMM, stage-1 and stem probes, the W8A8 stem and the W8A8
stage-2/3 kernel of one checkout of the port at the main path's (and the
probes') shapes, so that two trees can be compared on one card in turns.

    python mhentropy_tpu_torch/sampler_ab.py [--root DIR] [--label NAME] [--out FILE]
        [--tiles] [--kinds realnvp,stage1,glow,lbs,gemm_probe,stage1_probe,stem_probe,stem_int8,
        stage2_int8,request]

`--root` is the checkout whose `mhentropy_tpu_torch` is imported (default:
the one holding this file), so the same script times an older tree's
kernels through that tree's own wrappers (`cuda_sampler.pack`, `transform`,
`cuda_sampler_int8.transform_q`, `stage1_int8_cuda.stage1_forward_q`,
`cuda_glow_sampler.pack` / `pack_context` / `transform`, `lbs_cuda.lbs_blend`,
`int8_gemm_probe`, `stage1_probe`, `stem_probe`, `stem_cost_attrib`,
`stem_int8_cuda.prepare_stem_site` / `pack` / `stem_forward_q`,
`stage2_int8_cuda.stage_forward_q`, `quant.calibrate` / `prepare` /
`walk_stage`): run
it on the parent tree and on this one in turns (parent, this, this, parent)
within one call. Each shape prints one JSON line: the kernel's median ms of
RUNS windows as CUDA-graph replays and eagerly, with [min, max], its
max-abs error against the tree's plain version, and the card's name and
power limit. `--out` appends the lines to a file. Shapes (L = 12, H = 512,
D = 45): the bf16 draw at B x N = 1 x 200, 8 x 200, 32 x 100 and 64 x 200,
the f32 draw at 64 x 10 and 7 x 93, the int8 draw at 8 x 200, 32 x 100 and
64 x 200 (an O(1) flow calibrated on its own trajectory); int8 stage 1 on
random int8 sites at (B, 64, 64, 64) for B = 8, 32, 64 and (B, 56, 56, 64)
for B = 8, 32, and the bf16 stage-1 kernel on a He-initialised stage 1 with
random BN at the same shapes (its yardstick); the Glow sampler at
GLOW_SHAPES (ProHMR's 3,200 rows at D = 144, H = 1,024 and the MHEnt Glow's
1,600 rows at D = 45, H = 512, 4 layers, an O(1) flow), with `torch.matmul`
on one (rows, H) x (H, H) bf16 product beside each as its per-stage
yardstick; the LBS blend at LBS_SHAPES (MANO's V = 778, J = 16 at 12,800
rows and SMPL's V = 6,890, J = 24 at 3,200) on random skinning weights and
transforms; the GEMM probe's s8 and bf16 sides at its (32768, 640, 512),
with `torch._int_mm` and `torch.matmul` (bf16) beside them; the stage-1
probe's variants A and B at B = 32, 64 x 64, with cuDNN's stage 1 and the
bf16 stage-1 kernel beside them; the stem probe's envelope (f32 planes)
and its four cuts (bf16 planes) at B = 32, 128 conv rows, with cuDNN's stem
and the stem kernel at (32, 256, 256, 3) beside them; the W8A8 stem at (B,
256, 256, 3) for B = 8 and 32 on a calibrated site (He-initialised conv,
random BN with a negative gamma at every third filter), bf16 out, with the
bf16 stem kernel on the same images and the stem probe's full cut at B = 32
beside it; the W8A8 stages 2 and 3 at B = 8 and 32 on sites calibrated
(int8_stem, pallas_mid, q_from 1) through a He-initialised resnet50 with
random BN on random 256 px images, bf16 in and out, stage 2's input that
of the float stem and stage-1 kernels, with the same stage's `torch._int_mm`
walk (`quant.walk_stage`, the route pallas_mid=False runs) beside each and,
at B = 8, the device kernels of one forward of each stage (a trace).
`request` times the float request through the tree's `serve.InferenceServer`
on configs/ho3d.yaml (fresh seeded weights, N = 200, u8 images) at B = 1 and
8: ms a request host to host (`predict`, the results copied back), RUNS
windows of REQUEST_WINDOW_S, the card's busy share not traced (the cost of
the wrappers' dispatch shows here, not in a kernel's time). `--kinds` picks the
families (default: all). Runs only on a CUDA card. It times with the tree's own
`profile_step` helpers (`cuda_ms`, `graphed`, `card_line`), so both trees
need that module. `--tiles` (this tree only)
also times the int8 draw at every tile size its kernel takes, through the C
entry, with the clusters of that tile the card holds at once: the
measurement behind `cuda_sampler_int8.launch_plan`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

BF16_SHAPES = ((1, 200), (8, 200), (32, 100), (64, 200))
F32_SHAPES = ((64, 10), (7, 93))
INT8_SHAPES = ((8, 200), (32, 100), (64, 200))
STAGE1_INT8_SHAPES = ((8, 64), (32, 64), (64, 64), (8, 56), (32, 56))  # (B, post-stem side)
# chip_smoke.py's GLOW_SHAPES: ProHMR's (bench_prohmr's B = 32, N = 100) and
# the MHEnt Glow regressor's.
GLOW_SHAPES = {"prohmr": {"d": 144, "h": 1024, "c": 2048, "b": 32, "n": 100},
               "mhent_glow": {"d": 45, "h": 512, "c": 512, "b": 8, "n": 200}}
LBS_SHAPES = {"mano": {"v": 778, "j": 16, "rows": 12800},  # eval: N = 200, B = 64
              "smpl": {"v": 6890, "j": 24, "rows": 3200}}  # ProHMR: N = 100, B = 32
KINDS = ("realnvp", "stage1", "glow", "lbs", "gemm_probe", "stage1_probe", "stem_probe",
         "stem_int8", "stage2_int8", "request")
REQUEST_BATCHES = (1, 8)
REQUEST_WINDOW_S = 1.0
STEM_INT8_BATCHES = (8, 32)  # chip_smoke.py's MID_BATCHES
RUNS = 3
WINDOW_S = 0.5


def int8_sites(torch, g, dev):
    """Random calibrated-looking stage-1 sites: int8 HWIO weights, f32 scale,
    bias and input factor (tests/test_torch_cuda.py's)."""
    def site(shape):
        cout = shape[-1]
        return {"w8": torch.randint(-90, 90, shape, generator=g, dtype=torch.int8).to(dev),
                "scale": (torch.rand(cout, generator=g) * 1.8e-3 + 2e-4).to(dev),
                "bias": (torch.randn(cout, generator=g) * 0.05).to(dev),
                "inv_sa": (torch.rand((), generator=g) * 50 + 30).to(dev)}

    sites = {}
    for j in range(3):
        sites[f"layer1_{j}/conv1"] = site((1, 1, 64 if j == 0 else 256, 64))
        sites[f"layer1_{j}/conv2"] = site((3, 3, 64, 64))
        sites[f"layer1_{j}/conv3"] = site((1, 1, 64, 256))
    sites["layer1_0/downsample_conv"] = site((1, 1, 64, 256))
    sites["layer1_0/downsample_conv"]["inv_sa"] = sites["layer1_0/conv1"]["inv_sa"]
    return sites


def int8_tiles(torch, ext, tree, cq, z0, timed):
    """The int8 draw of z0 at every tile size (a multiple of 16 rows) whose
    CTA fits, clusters of 8, through `mhent_realnvp_sample_q`."""
    lib = ext.load()
    k = tree.kernel
    b, n, d = z0.shape
    n_layers, dp = k.masks.shape
    h = k.w1.shape[-1]
    x = torch.empty_like(z0)
    ld = torch.empty((b, n), device=z0.device)
    for r in range(16, 129, 16):
        if lib.mhent_realnvp_sample_q_smem(r, dp, h, 8) < 0:
            continue

        def call(r=r):
            ext.check(lib.mhent_realnvp_sample_q(
                z0.data_ptr(), cq.data_ptr(), k.masks.data_ptr(), k.qm.data_ptr(),
                k.w0.data_ptr(), k.w1.data_ptr(), k.w2.data_ptr(), k.e0.data_ptr(),
                k.e1.data_ptr(), k.e2.data_ptr(), k.b2.data_ptr(), x.data_ptr(), ld.data_ptr(),
                b, n, d, dp, h, n_layers, r, 8, ext.stream_of(z0)), "mhent_realnvp_sample_q")

        timed(f"int8_tile_{r}_clusters_{lib.mhent_realnvp_sample_q_clusters(r, dp, h, 8)}",
              (b, n), b * n, call, None)


def realnvp_cases(torch, timed, dev, tiles: bool) -> None:
    """The bf16, f32 and int8 RealNVP draws at their shapes."""
    from mhentropy_tpu_torch import ext
    from mhentropy_tpu_torch.flows import cuda_sampler, cuda_sampler_int8, realnvp

    torch.manual_seed(3)
    flow = realnvp.RealNVP(realnvp.RealNVPConfig(dim=45, cond_dim=512, h_dim=512,
                                                 num_steps=6)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    for dtype, shapes in ((torch.bfloat16, BF16_SHAPES), (torch.float32, F32_SHAPES)):
        packed = cuda_sampler.pack(flow, dtype=dtype)
        for b, n in shapes:
            with torch.inference_mode():
                feat = torch.randn((b, 512), generator=g, device=dev)
                z0 = torch.randn((b, n, 45), generator=g, device=dev) * 0.8
                cproj = realnvp.cond_cache(flow, feat).contiguous()
                x, ld = cuda_sampler.transform(packed, z0, cproj)
                x_ref, ld_ref = cuda_sampler.transform_plain(packed, z0, cproj)
                err = max((x - x_ref).abs().max().item(), (ld - ld_ref).abs().max().item())
                timed(str(dtype).removeprefix("torch."), (b, n), b * n,
                      lambda: cuda_sampler.transform(packed, z0, cproj), err)

    with torch.inference_mode():
        feat = torch.randn((8, 512), generator=g, device=dev)
        tree = cuda_sampler_int8.quantize_sampler(
            flow, feat, torch.randn((32 * 8, 45), generator=g, device=dev) * 0.8)
        for b, n in INT8_SHAPES:
            feat = torch.randn((b, 512), generator=g, device=dev)
            cq = cuda_sampler_int8.cond_q(flow, tree, feat)
            z0 = torch.randn((b, n, 45), generator=g, device=dev) * 0.8
            x, ld = cuda_sampler_int8.transform_q(tree, z0, cq)
            z0p = torch.nn.functional.pad(z0, (0, tree.masks.shape[-1] - 45))
            x_ref, ld_ref = cuda_sampler_int8.xla_forward_q(tree, z0p, cq)
            err = max((x - x_ref[..., :45]).abs().max().item(),
                      (ld - ld_ref).abs().max().item())
            timed("int8", (b, n), b * n,
                  lambda: cuda_sampler_int8.transform_q(tree, z0, cq), err)
            if tiles:
                int8_tiles(torch, ext, tree, cq, z0, timed)


def stage1_cases(torch, timed, dev) -> None:
    """int8 stage 1 on random sites and the bf16 stage-1 kernel on a
    He-initialised stage 1 with random BN (its yardstick), at their shapes."""
    from mhentropy_tpu_torch.models import resnet, stage1_cuda, stage1_int8_cuda

    gs = torch.Generator().manual_seed(4)
    layer1 = torch.nn.Sequential(resnet.Bottleneck(64, 64), resnet.Bottleneck(256, 64),
                                 resnet.Bottleneck(256, 64))
    with torch.no_grad():
        for m in layer1.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gs)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.num_features, generator=gs))
                m.bias.copy_(0.1 * torch.randn(m.num_features, generator=gs))
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gs))
                m.running_var.copy_(1.0 + 0.5 * torch.rand(m.num_features, generator=gs))
    folded = [stage1_cuda.FoldedBlock(*(None if t is None else t.to(dev) for t in blk))
              for blk in stage1_cuda.fold(layer1)]
    with torch.inference_mode():
        packed = stage1_int8_cuda.pack(int8_sites(torch, gs, dev))
        for b, side in STAGE1_INT8_SHAPES:
            x = torch.relu(torch.randn((b, side, side, 64), generator=gs)).to(dev, torch.bfloat16)
            out = stage1_int8_cuda.stage1_forward_q(x, packed)
            err = (out.float() - stage1_int8_cuda.stage1_plain(x, packed)).abs().max().item()
            timed("stage1_int8", (b, side, side, 64), b * side * side,
                  lambda: stage1_int8_cuda.stage1_forward_q(x, packed), err)

        for b, side in STAGE1_INT8_SHAPES:
            x = torch.relu(torch.randn((b, side, side, 64), generator=gs)).to(dev, torch.bfloat16)
            timed("stage1_bf16", (b, side, side, 64), b * side * side,
                  lambda: stage1_cuda.stage1_forward(x, folded), None)


def o1_glow(torch, glow, cfg, seed: int, dev):
    """A ConditionalGlow with O(1) outputs (chip_smoke.py's o1_glow)."""
    torch.manual_seed(seed)
    flow = glow.ConditionalGlow(cfg)
    g = torch.Generator().manual_seed(seed)
    d = cfg.features
    with torch.no_grad():
        for i in range(cfg.num_layers):
            an, lin, _ = flow.step(i)
            an.log_scale.copy_(0.1 * torch.randn(d, generator=g))
            an.shift.copy_(0.1 * torch.randn(d, generator=g))
            for p in (lin.lower_entries, lin.upper_entries):
                p.copy_(0.3 / d ** 0.5 * torch.randn(p.shape, generator=g))
    return flow.to(dev).eval()


def glow_cases(torch, timed, dev):
    """Each GLOW_SHAPES shape through the tree's own pack, pack_context and
    transform; torch.matmul on one hidden product beside it."""
    from mhentropy_tpu_torch.flows import cuda_glow_sampler as cgs
    from mhentropy_tpu_torch.flows import glow

    for label, s in GLOW_SHAPES.items():
        cfg = glow.GlowConfig(features=s["d"], hidden=s["h"], num_layers=4, num_blocks=2,
                              context_features=s["c"])
        flow = o1_glow(torch, glow, cfg, 14, dev)
        b, n = s["b"], s["n"]
        g = torch.Generator(device=dev).manual_seed(14)
        with torch.inference_mode():
            packed = cgs.pack(flow)
            ctx = cgs.pack_context(flow, torch.randn((b, s["c"]), generator=g, device=dev))
            z0 = torch.randn((b, n, s["d"]), generator=g, device=dev)
            x, ld = cgs.transform(packed, z0, ctx)
            x_ref, ld_ref = cgs.transform_plain(packed, z0, ctx)
            err = max((x - x_ref).abs().max().item(), (ld - ld_ref).abs().max().item())
            timed(f"glow_{label}", (b, n), b * n, lambda: cgs.transform(packed, z0, ctx), err)
            a = torch.randn((b * n, s["h"]), generator=g, device=dev).to(torch.bfloat16)
            w = packed.big[0, 0]
            timed(f"glow_{label}_matmul", (b * n, s["h"], s["h"]), b * n,
                  lambda: torch.matmul(a, w), None)
        del flow, packed


def lbs_cases(torch, timed, dev):
    """Each LBS_SHAPES shape through the tree's lbs_cuda.lbs_blend, on
    normalised random skinning weights and random transforms."""
    from mhentropy_tpu_torch.core import lbs_cuda

    g = torch.Generator(device=dev).manual_seed(5)
    for label, s in LBS_SHAPES.items():
        v, j, rows = s["v"], s["j"], s["rows"]
        w = torch.rand((v, j), generator=g, device=dev)
        args = (w / w.sum(1, keepdim=True),
                torch.randn((3, 3, j, rows), generator=g, device=dev),
                torch.randn((3, j, rows), generator=g, device=dev) * 0.05,
                torch.randn((3, v, rows), generator=g, device=dev) * 0.5)
        with torch.inference_mode():
            out = lbs_cuda.lbs_blend(*args)
            err = (out - lbs_cuda.lbs_blend_plain(*args)).abs().max().item()
            timed(f"lbs_{label}", (v, j, rows), rows, lambda: lbs_cuda.lbs_blend(*args), err)


def gemm_probe_cases(torch, timed, dev):
    """Both sides of the tree's GEMM probe at its shape, with torch._int_mm
    and torch.matmul in bf16 on the same operands beside them."""
    from mhentropy_tpu_torch import int8_gemm_probe as probe

    m, k, n = probe.SHAPE
    x8, w8, xb, wb = probe.operands(m, k, n, dev)
    err = (probe.gemm_s8(x8, w8).long() - probe.plain_s8(x8, w8).long()).abs().max().item()
    timed("gemm_probe_s8", (m, k, n), m, lambda: probe.gemm_s8(x8, w8), err)
    err = (probe.gemm_bf16(xb, wb).float() - probe.plain_bf16(xb, wb).float()).abs().max().item()
    timed("gemm_probe_bf16", (m, k, n), m, lambda: probe.gemm_bf16(xb, wb), err)
    w8_kn, wb_kn = w8.T.contiguous(), wb.T.contiguous()
    timed("gemm_library_s8", (m, k, n), m, lambda: torch._int_mm(x8, w8_kn), None)
    timed("gemm_library_bf16", (m, k, n), m, lambda: torch.matmul(xb, wb_kn), None)


def stage1_probe_cases(torch, timed, dev):
    """Both variants of the tree's stage-1 probe at B = 32, 64 x 64, with
    cuDNN's stage 1 and the shipped stage-1 kernel beside them."""
    from mhentropy_tpu_torch import stage1_probe as probe
    from mhentropy_tpu_torch.models import stage1_cuda

    b = probe.B
    wa = probe.weights_a(dev)
    wb = probe.to_b(wa)
    xa = probe.input_a(b, dev)
    xb = xa.transpose(1, 2).contiguous()
    for label, fwd, plain, x, ws in (("a", probe.forward_a, probe.plain_a, xa, wa),
                                     ("b", probe.forward_b, probe.plain_b, xb, wb)):
        err = (fwd(x, ws).float() - plain(x, ws).float()).abs().max().item()
        timed(f"stage1_probe_{label}", tuple(x.shape), b * probe.H * probe.W,
              lambda: fwd(x, ws), err)
    x, folded = probe.yardsticks(b, dev)
    with torch.inference_mode():
        timed("stage1_cudnn", tuple(x.shape), b * probe.H * probe.W,
              lambda: stage1_cuda.stage1_plain(x, folded), None)
        timed("stage1_bf16", tuple(x.shape), b * probe.H * probe.W,
              lambda: stage1_cuda.stage1_forward(x, folded), None)


def stem_probe_cases(torch, timed, dev):
    """The tree's stem-probe envelope and its four cuts at B = 32, 128 conv
    rows, with cuDNN's stem and the stem kernel at (32, 256, 256, 3)."""
    from mhentropy_tpu_torch import stem_cost_attrib, stem_probe as probe
    from mhentropy_tpu_torch.models import stem_cuda

    b, rows = probe.B, probe.CONV_ROWS
    planes32, a = probe.inputs(b, dev)
    err = (probe.stem_probe(planes32, a) - probe.phase_plain("gemm", planes32, a)).abs().max()
    timed("stem_probe_envelope", tuple(planes32.shape), rows, lambda: probe.stem_probe(planes32, a),
          err.item())
    planes, a = probe.inputs(b, dev, dtype=torch.bfloat16)
    g, bb, s = probe.epilogue_operands(dev)
    for phase in probe.PHASES:
        def call(phase=phase):
            return stem_cost_attrib.attrib_forward(planes, a, g, bb, s, phase, rows)

        err = (call() - probe.phase_plain(phase, planes, a, g, bb, s, rows)).abs().max().item()
        timed(f"stem_probe_{phase}", tuple(planes.shape), rows, call, err)
    image, w, scale, shift = probe.cudnn_stem_operands(b, dev)
    wf, bias = stem_cuda.fold(w.cpu(), scale.cpu(), shift.cpu(), torch.zeros(probe.FILTERS),
                              torch.ones(probe.FILTERS))
    wf, bias = wf.to(dev), bias.to(dev)
    with torch.inference_mode():
        timed("stem_cudnn", tuple(image.shape), b, lambda: probe.cudnn_stem(image, w, scale, shift),
              None)
        timed("stem_kernel", tuple(image.shape), b, lambda: stem_cuda.stem_forward(image, wf, bias),
              None)


def stem_int8_cases(torch, timed, dev):
    """The tree's W8A8 stem at each STEM_INT8_BATCHES batch against its plain
    version; the bf16 stem kernel on the same images, and at B = 32 the stem
    probe's full cut, beside it."""
    from mhentropy_tpu_torch import stem_cost_attrib, stem_probe as probe
    from mhentropy_tpu_torch.models import stem_cuda, stem_int8_cuda

    g = torch.Generator().manual_seed(7)
    conv = torch.randn((64, 3, 7, 7), generator=g) * (2 / 147) ** 0.5
    bn = torch.nn.BatchNorm2d(64).eval()
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.2 * torch.randn(64, generator=g))
        bn.weight[::3] *= -1
        bn.bias.copy_(0.1 * torch.randn(64, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(64, generator=g))
        bn.running_var.copy_(1.0 + 0.5 * torch.rand(64, generator=g))
    wf, bias = (t.to(dev) for t in stem_cuda.fold(conv, bn.weight, bn.bias, bn.running_mean,
                                                   bn.running_var))
    with torch.inference_mode():
        for b in STEM_INT8_BATCHES:
            image = (torch.randn((b, 256, 256, 3), generator=g) * 1.5).to(dev)
            site = stem_int8_cuda.prepare_stem_site(conv.to(dev), bn.to(dev),
                                                    image.abs().amax(dim=(0, 1, 2)))
            packed = stem_int8_cuda.pack(site)
            out = stem_int8_cuda.stem_forward_q(image, packed)
            err = (out.float() - stem_int8_cuda.stem_plain(image, site)).abs().max().item()
            timed("stem_int8", tuple(image.shape), b,
                  lambda: stem_int8_cuda.stem_forward_q(image, packed), err)
            image_bf16 = image.to(torch.bfloat16)
            timed("stem_bf16_kernel", tuple(image.shape), b,
                  lambda: stem_cuda.stem_forward(image_bf16, wf, bias), None)
        planes, a = probe.inputs(probe.B, dev, dtype=torch.bfloat16)
        gg, bb, s = probe.epilogue_operands(dev)
        timed("stem_probe_full", tuple(planes.shape), probe.CONV_ROWS,
              lambda: stem_cost_attrib.attrib_forward(planes, a, gg, bb, s, "full",
                                                      probe.CONV_ROWS), None)


def he_resnet50(torch, dev, seed: int):
    """A resnet50 backbone with He-initialised convs and random BN, prepared
    as the served one is (chip_smoke.py's)."""
    from mhentropy_tpu_torch.models import resnet

    g = torch.Generator().manual_seed(seed)
    res = resnet.resnet50()
    with torch.no_grad():
        for m in res.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(1.0 + 0.5 * torch.rand(n, generator=g))
    res = res.eval().to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    res.fold_kernel_weights()
    return res


def stage2_int8_cases(torch, timed, dev, label):
    """The tree's W8A8 stages 2 and 3 at each STEM_INT8_BATCHES batch on
    calibrated sites, each against its plain version, with the same stage's
    `_int_mm` walk beside it; at B = 8 the device kernels a forward."""
    from mhentropy_tpu_torch import profile_step
    from mhentropy_tpu_torch.models import quant, stage1_cuda, stage2_int8_cuda, stem_cuda

    res = he_resnet50(torch, dev, 20)
    g = torch.Generator(device=dev).manual_seed(20)
    spec = quant.QuantSpec(backbone="resnet50", q_from=1, int8_stem=True, pallas_mid=True)
    walk_spec = spec._replace(pallas_mid=False)
    with torch.inference_mode():
        for b in STEM_INT8_BATCHES:
            images = torch.randn((b, 256, 256, 3), generator=g, device=dev)
            qtree = quant.prepare(spec, res, quant.calibrate(spec, res, images))
            x = stem_cuda.stem_forward(images.to(torch.bfloat16).contiguous(), *res.folded[0])
            x = stage1_cuda.stage1_forward(x, res.folded[1])
            for stage in (2, 3):
                packed = qtree[f"stage{stage}"]
                out = stage2_int8_cuda.stage_forward_q(x, packed, stage)
                err = (out.float() - stage2_int8_cuda.stage_plain(x, packed)).abs().max().item()
                call = lambda x=x, packed=packed, stage=stage: (  # noqa: E731
                    stage2_int8_cuda.stage_forward_q(x, packed, stage))
                timed("stage2_int8", tuple(x.shape), b, call, err)
                if b == STEM_INT8_BATCHES[0]:
                    events = profile_step.device_events(profile_step.profile(call, 1))
                    print(json.dumps({"label": label, "kernel": "stage2_int8",
                                      "stage": stage, "shape": list(x.shape),
                                      "device_kernels_a_forward": len(events),
                                      "c_calls_a_forward": len(packed)}), flush=True)
                timed("stage2_int8_walk", tuple(x.shape), b,
                      lambda x=x, stage=stage: quant.walk_stage(walk_spec, res, qtree["sites"], x,
                                                                stage - 1), None)
                x = out
            del images, qtree


def request_cases(torch, dev, root: str, emit) -> None:
    """The tree's float InferenceServer on configs/ho3d.yaml: ms a request
    (host to host) at each of REQUEST_BATCHES."""
    import numpy as np

    from mhentropy_tpu_torch import serve
    from mhentropy_tpu_torch.utils.config import load_cfg

    server = serve.InferenceServer(load_cfg(os.path.join(root, "configs", "ho3d.yaml")),
                                   max_batch=max(REQUEST_BATCHES), device=dev, seed=0)
    server.warmup()
    rng = np.random.RandomState(0)
    for b in REQUEST_BATCHES:
        imgs = rng.randint(0, 256, (b, server.image_size, server.image_size, 3)).astype(np.uint8)
        server.predict(imgs)
        runs, count = [], 0
        for _ in range(RUNS):
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < REQUEST_WINDOW_S:
                server.predict(imgs)
                n += 1
            runs.append((time.perf_counter() - t0) * 1e3 / n)
            count += n
        emit({"dtype": "request", "shape": [b, server.n_hypo], "rows": b * server.n_hypo,
              "ms": statistics.median(runs), "ms_min_max": [min(runs), max(runs)],
              "requests": count})

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help=f"comma-separated families to time, of {', '.join(KINDS)}")
    args = ap.parse_args(argv)
    kinds = args.kinds.split(",")
    if not set(kinds) <= set(KINDS):
        ap.error(f"--kinds takes {', '.join(KINDS)}, not {args.kinds}")
    here = os.path.dirname(os.path.abspath(__file__))  # run as a file: not a package root
    sys.path[:] = [os.path.abspath(args.root)] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    if not torch.cuda.is_available():
        print("sampler_ab: no CUDA device; it times the kernels on the card", file=sys.stderr)
        return 1
    from mhentropy_tpu_torch import ext, profile_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = profile_step.card_line()
    t0 = time.perf_counter()
    ext.load()
    build_s = time.perf_counter() - t0
    lines = []

    def timed(kind, shape, rows, call, err):
        replay = profile_step.graphed(call)
        times = {"graph_ms": [], "ms": []}
        for _ in range(RUNS):
            times["graph_ms"].append(profile_step.cuda_ms(replay, WINDOW_S))
            times["ms"].append(profile_step.cuda_ms(call, WINDOW_S))
        line = {"label": args.label, "root": os.path.abspath(args.root), "dtype": kind,
                "shape": list(shape), "rows": rows,
                **{k: statistics.median(v) for k, v in times.items()},
                **{f"{k}_min_max": [min(v), max(v)] for k, v in times.items()},
                "max_abs_err": err, "build_s": build_s, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)

    if "realnvp" in kinds:
        realnvp_cases(torch, timed, dev, args.tiles)
    if "stage1" in kinds:
        stage1_cases(torch, timed, dev)
    if "glow" in kinds:
        glow_cases(torch, timed, dev)
    if "lbs" in kinds:
        lbs_cases(torch, timed, dev)
    if "gemm_probe" in kinds:
        gemm_probe_cases(torch, timed, dev)
    if "stage1_probe" in kinds:
        stage1_probe_cases(torch, timed, dev)
    if "stem_probe" in kinds:
        stem_probe_cases(torch, timed, dev)
    if "stem_int8" in kinds:
        stem_int8_cases(torch, timed, dev)
    if "stage2_int8" in kinds:
        stage2_int8_cases(torch, timed, dev, args.label)
    if "request" in kinds:
        def emit(fields):
            line = {"label": args.label, "root": os.path.abspath(args.root), **fields,
                    "build_s": build_s, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)

        request_cases(torch, dev, args.root, emit)

    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
