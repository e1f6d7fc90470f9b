"""Times the RealNVP sampler kernels and int8 stage 1 of one checkout of the
port at the main path's shapes, so that two trees can be compared on one
card in turns.

    python mhentropy_tpu_torch/sampler_ab.py [--root DIR] [--label NAME] [--out FILE] [--tiles]

`--root` is the checkout whose `mhentropy_tpu_torch` is imported (default:
the one holding this file), so the same script times an older tree's
kernels through that tree's own wrappers (`cuda_sampler.pack`, `transform`,
`cuda_sampler_int8.transform_q`, `stage1_int8_cuda.stage1_forward_q`): run
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
random BN at the same shapes (its yardstick). Runs only on a CUDA card. It
times with the tree's own `profile_step` helpers (`cuda_ms`, `graphed`,
`card_line`), so both trees need that module. `--tiles` (this tree only)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiles", action="store_true")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))  # run as a file: not a package root
    sys.path[:] = [os.path.abspath(args.root)] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    if not torch.cuda.is_available():
        print("sampler_ab: no CUDA device; it times the kernels on the card", file=sys.stderr)
        return 1
    from mhentropy_tpu_torch import ext, profile_step
    from mhentropy_tpu_torch.flows import cuda_sampler, cuda_sampler_int8, realnvp
    from mhentropy_tpu_torch.models import resnet, stage1_cuda, stage1_int8_cuda

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
            if args.tiles:
                int8_tiles(torch, ext, tree, cq, z0, timed)

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

    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
