"""Probe: ResNet-50 stage 1 in a pixel-major and a channel-major layout on
the card (`csrc/stage1_probe.cu`), against cuDNN's stage 1 and the shipped
stage-1 kernel (`csrc/stage1.cu`).

Port of tools/stage1_probe.py (`_probe_variant_a` :49, `_probe_variant_b`
:170): three bottlenecks on (B, 64, 64, 64) -> 256 channels with no BN and no
bias (the weights are real data standing for folded ones), in two layouts:

- A, pixel-major: x (B, HW, 64), weights [in, out]: w1a (1, 64, 64), w1
  (2, 256, 64), wp (3, 5, 128, 64), w3 (3, 64, 256), wd (1, 64, 256);
- B, channel-major: x (B, 64, HW), every weight transposed ([out, in]).

Per block k (x the block input, `prev` block k - 1's output):

    h1  = bf16(relu(x @ w1a[0]))  (k = 0)  or  bf16(relu(prev @ w1[k - 1]))
    acc = sum over the 4.5 tap pairs p of [tap_a | tap_b] @ wp[k, p]
          (the 3x3 with zero padding; a tap is h1 at the flat offset
          W dy + dx, masked where the column leaves the image; the tenth
          tap slot is zero, so wp[:, 4, 64:, :] never matters)
    h2  = bf16(relu(acc))
    out = bf16(relu(h2 @ w3[k] + res)),  res = x @ wd[0] (f32, k = 0) or prev

B is A with every operand transposed. The weights are taken in the JAX
layouts, so the tests hand the same numpy arrays to both packages.

    python -m mhentropy_tpu_torch.stage1_probe [check|time] [--device cpu]

checks both variants against their plain versions at B = 32 (`check`: one
forward each, three launches), and with `time` (the default; on the card)
prints one JSON line a side (cuDNN's stage 1: the port's `stage1_cuda.stage1_plain`,
bf16 eval-BN convolutions; the shipped stage-1 kernel's three launches; A;
B): ms a call by CUDA events, eager and as a CUDA-graph replay, and the
device ms a call from a `profile_step` trace. CPU tensors take the plain
versions; CUDA tensors launch the kernel (one launch a bottleneck), and
anything it does not take raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext

B, H, W, C0, CMID, COUT = 32, 64, 64, 64, 64, 256
TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
PAIRS = [(0, 1), (2, 3), (4, 5), (6, 7), (8, None)]
# Variant A's weight shapes (the JAX probe's); B's swap the last two axes.
SHAPES = {"w1a": (1, C0, CMID), "w1": (2, COUT, CMID), "wp": (3, 5, 2 * CMID, CMID),
          "w3": (3, CMID, COUT), "wd": (1, C0, COUT)}
NAMES = tuple(SHAPES)

# Kernel launches since the counts were last reset (one a bottleneck).
launches_a = 0
launches_b = 0


def weights_a(device=None, seed: int = 0) -> dict:
    """Variant A's weights (bf16, the JAX shapes), normal * 0.05 as the JAX
    probe draws them."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(s, generator=g) * 0.05).to(device, torch.bfloat16)
            for k, s in SHAPES.items()}


def to_b(wa: dict) -> dict:
    """Variant B's weights: each of A's with its last two axes swapped."""
    return {k: v.transpose(-1, -2).contiguous() for k, v in wa.items()}


def input_a(b: int, device=None, seed: int = 1, hw: int = H * W) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, hw, C0), generator=g) * 0.1).to(device, torch.bfloat16)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _taps(h1: torch.Tensor, w: int, axis: int) -> list:
    """The nine taps of h1 along its flat pixel axis (1 for A, 2 for B):
    the pixel at offset W dy + dx, zero outside the image and where the
    column + dx leaves [0, W)."""
    hw = h1.shape[axis]
    pad = w + 1
    padding = (0, 0, pad, pad) if axis == 1 else (pad, pad)
    xpad = F.pad(h1, padding)
    col = torch.arange(hw, device=h1.device) % w
    shape = (1, hw, 1) if axis == 1 else (1, 1, hw)
    out = []
    for dy, dx in TAPS:
        d = w * dy + dx
        v = xpad.narrow(axis, pad + d, hw)
        if dx == -1:
            v = v * (col > 0).reshape(shape)
        elif dx == 1:
            v = v * (col < w - 1).reshape(shape)
        out.append(v)
    return out


def plain_a(x: torch.Tensor, wa: dict, w: int = W) -> torch.Tensor:
    """Variant A op by op: (B, HW, 64) -> (B, HW, 256) bf16; f32 products of
    the bf16 operands, rounded to bf16 where the JAX kernel rounds."""
    x0 = x.float()
    ws = {k: v.float() for k, v in wa.items()}
    prev = None
    for k in range(3):
        src = x0 if k == 0 else prev
        h1 = _bf16(torch.relu(src @ (ws["w1a"][0] if k == 0 else ws["w1"][k - 1])))
        taps = _taps(h1, w, 1) + [torch.zeros_like(h1)]
        acc = 0
        for p, (ta, tb) in enumerate(PAIRS):
            pair = torch.cat([taps[ta], taps[tb if tb is not None else 9]], -1)
            acc = acc + pair @ ws["wp"][k, p]
        h2 = _bf16(torch.relu(acc))
        res = x0 @ ws["wd"][0] if k == 0 else prev
        prev = _bf16(torch.relu(h2 @ ws["w3"][k] + res))
    return prev.to(torch.bfloat16)


def plain_b(x: torch.Tensor, wb: dict, w: int = W) -> torch.Tensor:
    """Variant B op by op: (B, 64, HW) -> (B, 256, HW) bf16, weights [out, in]."""
    x0 = x.float()
    ws = {k: v.float() for k, v in wb.items()}
    prev = None
    for k in range(3):
        src = x0 if k == 0 else prev
        h1 = _bf16(torch.relu((ws["w1a"][0] if k == 0 else ws["w1"][k - 1]) @ src))
        taps = _taps(h1, w, 2) + [torch.zeros_like(h1)]
        acc = 0
        for p, (ta, tb) in enumerate(PAIRS):
            pair = torch.cat([taps[ta], taps[tb if tb is not None else 9]], 1)
            acc = acc + ws["wp"][k, p] @ pair
        h2 = _bf16(torch.relu(acc))
        res = ws["wd"][0] @ x0 if k == 0 else prev
        prev = _bf16(torch.relu(ws["w3"][k] @ h2 + res))
    return prev.to(torch.bfloat16)


def forward_a(x: torch.Tensor, wa: dict, h: int = H, w: int = W) -> torch.Tensor:
    """Variant A: the plain version for CPU tensors, the kernel for CUDA ones."""
    if x.device.type == "cpu":
        return plain_a(x, wa, w)
    return _stage(x, wa, h, w, channel_major=False)


def forward_b(x: torch.Tensor, wb: dict, h: int = H, w: int = W) -> torch.Tensor:
    """Variant B: the plain version for CPU tensors, the kernel for CUDA ones."""
    if x.device.type == "cpu":
        return plain_b(x, wb, w)
    return _stage(x, wb, h, w, channel_major=True)


def _stage(x, ws: dict, h: int, w: int, channel_major: bool) -> torch.Tensor:
    global launches_a, launches_b
    name = "stage-1 probe " + ("B" if channel_major else "A")
    ext.require(x.is_cuda and all(v.device == x.device for v in ws.values()),
                f"{name}: tensors must be on one CUDA device")
    want = (x.shape[0], C0, h * w) if channel_major else (x.shape[0], h * w, C0)
    ext.require(x.dim() == 3 and tuple(x.shape) == want and x.dtype == torch.bfloat16
                and x.is_contiguous(), f"{name}: x must be contiguous bf16 {want}, got "
                f"{x.dtype} {tuple(x.shape)}")
    ext.require(h >= 1 and w >= 1 and (w % 8 == 0 or not channel_major),
                f"{name}: H and W must be positive" + (" and W a multiple of 8 (the "
                "kernel's 16-byte halo chunks)" if channel_major else "") + f", got H={h} W={w}")
    for k, s in SHAPES.items():
        s = s[:-2] + s[:-3:-1] if channel_major else s
        v = ws[k]
        ext.require(tuple(v.shape) == s and v.dtype == torch.bfloat16 and v.is_contiguous(),
                    f"{name}: {k} must be contiguous bf16 {s}, got {v.dtype} {tuple(v.shape)}")
    lib = ext.load()
    out_shape = (x.shape[0], COUT, h * w) if channel_major else (x.shape[0], h * w, COUT)
    prev = x
    for k in range(3):
        out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
        w1 = ws["w1a"][0] if k == 0 else ws["w1"][k - 1]
        wd = ws["wd"][0].data_ptr() if k == 0 else None
        err = lib.mhent_stage1_probe_block(prev.data_ptr(), w1.data_ptr(), ws["wp"][k].data_ptr(),
                                           ws["w3"][k].data_ptr(), wd, out.data_ptr(),
                                           x.shape[0], h, w, C0 if k == 0 else COUT,
                                           int(channel_major), ext.stream_of(x))
        ext.check(err, "mhent_stage1_probe_block")
        if channel_major:
            launches_b += 1
        else:
            launches_a += 1
        prev = out
    return prev


def flops(b: int, h: int = H, w: int = W) -> int:
    """The stage's products (stage1_pallas.flops :263): block 0 64 -> 64 ->
    64 -> 256 and the 64 -> 256 downsample, blocks 1-2 256 -> 64 -> 64 -> 256."""
    per_pixel = (C0 * CMID + 9 * CMID * CMID + CMID * COUT + C0 * COUT) + 2 * (
        COUT * CMID + 9 * CMID * CMID + CMID * COUT)
    return 2 * b * h * w * per_pixel


def tolerance(ref: torch.Tensor) -> float:
    """Both sides round h1, h2 and each block's output to bf16 after f32 sums
    taken in different orders, so a value near a rounding boundary can land
    one bf16 ulp away and move what follows: within 2^-6 (two bf16 ulps) of
    the largest output."""
    return 2.0 ** -6 * ref.float().abs().max().item()


def yardsticks(b: int, device, seed: int = 2):
    """cuDNN's stage 1 and the shipped stage-1 kernel at (b, 64, 64, 64):
    (NHWC input, folded weights) of a He-initialised layer1 with random BN."""
    import math

    from mhentropy_tpu_torch.models import resnet, stage1_cuda

    g = torch.Generator().manual_seed(seed)
    layer1 = torch.nn.Sequential(resnet.Bottleneck(64, 64), resnet.Bottleneck(256, 64),
                                 resnet.Bottleneck(256, 64))
    with torch.no_grad():
        for m in layer1.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * math.sqrt(2.0 / m.weight[0].numel()))
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(1.0 + 0.5 * torch.rand(m.num_features, generator=g))
    folded = [stage1_cuda.FoldedBlock(*(None if t is None else t.to(device) for t in blk))
              for blk in stage1_cuda.fold(layer1)]
    x = torch.relu(torch.randn((b, H, W, C0), generator=g)).to(device, torch.bfloat16)
    return x, folded


def main(argv=None) -> dict:
    from mhentropy_tpu_torch import stem_probe
    from mhentropy_tpu_torch.models import stage1_cuda
    from mhentropy_tpu_torch.train.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", nargs="?", default="time", choices=("check", "time"),
                    help="check: one forward of each variant against its plain version; "
                         "time: also the timings and yardsticks")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--batch", type=int, default=B)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    timed = args.mode == "time" and dev.type == "cuda"
    wa = weights_a(dev)
    wb = to_b(wa)
    xa = input_a(args.batch, dev)
    xb = xa.transpose(1, 2).contiguous()
    ok, lines = True, []
    for label, fn, plain in (("A pixel-major", lambda: forward_a(xa, wa),
                              lambda: plain_a(xa, wa)),
                             ("B channel-major", lambda: forward_b(xb, wb),
                              lambda: plain_b(xb, wb))):
        out, ref = fn(), plain()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(ref)
        ok &= err <= tol
        lines.append({"metric": f"stage-1 probe {label}", "shape": list(out.shape),
                      "max_abs_err": err, "tol": tol,
                      **(stem_probe.time_call(fn) if timed else {})})
    if timed:
        x, folded = yardsticks(args.batch, dev)
        lines.append({"metric": "cuDNN stage 1 (bf16, eval BN)", "shape": list(x.shape),
                      **stem_probe.time_call(lambda: stage1_cuda.stage1_plain(x, folded))})
        lines.append({"metric": "stage-1 kernel (csrc/stage1.cu, 3 launches)",
                      "shape": list(x.shape),
                      **stem_probe.time_call(lambda: stage1_cuda.stage1_forward(x, folded))})
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for line in lines:
        print(json.dumps({**line, "device": card}), flush=True)
    return {"ok": ok, "lines": lines}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
