"""Probe: a ResNet stem as one tensor-core GEMM over an im2col matrix, on the
card (`csrc/stem_probe.cu`), against cuDNN's stem and the shipped stem
kernel (`csrc/stem.cu`).

Port of tools/stem_probe.py (`probe_kernel_step` :32): the cost envelope of
a fused stem at B = 32, 256 px, 64 filters, built from 21 rolled and masked
parity-plane taps, an im2col copy into a (152, 16384) K-major matrix Bm and
one (64, 152) x (152, 16384) bf16 GEMM. As in the JAX tool, the operands are
real data but the tap-to-weight correspondence is arbitrary: it times the
work and is not wired to conv semantics. For each image, with `_SPECS[t] =
(plane_t, shift_t)`:

    R[t, r, j]             = bf16(x[plane_t, r, j - shift_t]), 0 outside [0, 128)
    Bm[7 t + k, 128 i + j] = R[t, 2 i + 1 + k, j]     k < 7, i < conv_rows
    acc                    = a[0] @ Bm                 f32 sums over K = 152
    out[f, j]              = sum_i acc[f, 128 i + j]   (64, 128) f32

The JAX kernel never writes Bm's rows 147-151, so its output is undefined
unless `a[..., 147:] = 0`; here those rows are zero (as
tools/stem_cost_attrib.py:58 writes them), so they contribute nothing
whatever `a` holds there. `PHASES` are the cuts of tools/stem_cost_attrib.py
(rolls, im2col, gemm, full; see `phase_plain`), which
`mhentropy_tpu_torch.stem_cost_attrib` times; this envelope is the gemm cut
on f32 planes. The kernel gives each block a band of consecutive conv rows
of one image (`plan_band`) and streams the band's planes through shared
memory once.

    python -m mhentropy_tpu_torch.stem_probe [check|time] [--device cpu]

checks the kernel against its plain version at B = 32 (`check`: one launch,
one JSON line), and with `time` (the default; on the card) prints one JSON
line a side (the envelope kernel, cuDNN's conv 7x7/2 + BN + ReLU + maxpool
as `probe_xla_step` :109 builds it, and the shipped stem kernel at the same
shape): ms a call by CUDA events (eager, and as a CUDA-graph replay) and
the device time a call from a `profile_step` trace. CPU tensors take the
plain versions; CUDA tensors launch the kernel, and anything it does not
take raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext

B, IMG, FILTERS = 32, 256, 64
ROWS = IMG + 8  # padded plane rows
LANES = 128
TAPS21 = 21
KDIM = 152  # 147 taps padded to the TPU's sublane multiple
CONV_ROWS = 128
PHASES = ("rolls", "im2col", "gemm", "full")
ROW_MULTIPLE = 16  # conv_rows and the kernel's bands are multiples; conv_rows >= 32
BAND_OVERHEAD = 4  # a block's start, in conv rows: its first plane rows and the straddling row

# (kx, c) -> (plane = column parity * 3 + c, lane shift): col = 2j + kx - 3
# (models/stem_pallas.py:45, kept here so the port imports nothing of JAX).
_SPECS = [((kx + 1) % 2 * 3 + c, (4 - kx) // 2) for kx in range(7) for c in range(3)]

# Kernel launches of the envelope since the count was last reset.
launches = 0


def inputs(b: int, device, seed: int = 0, dtype=torch.float32) -> tuple:
    """(planes (b, 6, ROWS, 128) in dtype, a (1, 64, 152) bf16 with
    a[..., 147:] = 0) from a seed."""
    g = torch.Generator().manual_seed(seed)
    planes = torch.rand((b, 6, ROWS, LANES), generator=g).to(dtype)
    a = torch.randn((1, FILTERS, KDIM), generator=g)
    a[..., TAPS21 * 7:] = 0
    return planes.to(device), a.to(device, torch.bfloat16)


def epilogue_operands(device, seed: int = 1) -> tuple:
    """The full cut's (g, b) BN tiles (1, 64, 128) f32 and selection-product
    operand s (1, 64, 128) bf16, random from a seed (the JAX tool uses ones,
    zeros and a 0/1 selection)."""
    gen = torch.Generator().manual_seed(seed)
    g = 0.5 + torch.rand((1, FILTERS, LANES), generator=gen)
    bb = 0.1 * torch.randn((1, FILTERS, LANES), generator=gen)
    s = torch.randn((1, FILTERS, LANES), generator=gen).to(torch.bfloat16)
    return g.to(device), bb.to(device), s.to(device)


def taps_plain(planes: torch.Tensor) -> torch.Tensor:
    """R (B, 21, rows, 128): each (kx, c) group's plane shifted by its lane
    shift, zero where the source lane leaves [0, 128), rounded to bf16 (held
    in f32)."""
    out = []
    for plane, shift in _SPECS:
        v = torch.zeros_like(planes[:, plane], dtype=torch.float32)
        src = planes[:, plane].float()
        if shift >= 0:
            v[..., shift:] = src[..., :LANES - shift]
        else:
            v[..., :LANES + shift] = src[..., -shift:]
        out.append(v.to(torch.bfloat16).float())
    return torch.stack(out, 1)


def im2col_plain(r: torch.Tensor, conv_rows: int) -> torch.Tensor:
    """Bm (B, 152, conv_rows * 128): Bm[7 t + k, 128 i + j] = R[t, 2 i + 1 + k, j];
    rows 147-151 zero."""
    cols = torch.stack([r[:, :, 1 + k:1 + k + 2 * conv_rows:2] for k in range(7)], 2)
    bm = cols.reshape(r.shape[0], TAPS21 * 7, conv_rows * LANES)
    return F.pad(bm, (0, 0, 0, KDIM - TAPS21 * 7))


def phase_plain(phase: str, planes, a, g=None, bb=None, s=None,
                conv_rows: int = CONV_ROWS) -> torch.Tensor:
    """The cut `phase` of tools/stem_cost_attrib.py's body (:32-106), op by
    op, -> (B, 64, 128) f32:

    rolls  sum_t R[t, :64, :]
    im2col Bm[0:64, :128] + Bm[64:128, :128] + Bm[88:152, :128]
    gemm   sum_i acc[:, 128 i : 128 i + 128]
    full   BN (acc * g + b) and ReLU, the max over conv rows 2p-1..2p+1 and
           over columns j-1..j+1 (-inf beyond the edges), rounded to bf16;
           sum_p s @ max^T, padded from 64 to 128 columns.
    """
    r = taps_plain(planes)
    if phase == "rolls":  # summed in tap order from 0, as the kernel and the JAX body do
        total = torch.zeros_like(r[:, 0, :FILTERS])
        for t in range(TAPS21):
            total = total + r[:, t, :FILTERS]
        return total
    bm = im2col_plain(r, conv_rows)
    if phase == "im2col":
        return bm[:, 0:64, :LANES] + bm[:, 64:128, :LANES] + bm[:, KDIM - 64:KDIM, :LANES]
    acc = (a[0].float() @ bm).reshape(planes.shape[0], FILTERS, conv_rows, LANES)
    if phase == "gemm":
        return acc.sum(2)
    if phase != "full":
        raise ValueError(f"stem probe: phase {phase!r} is not one of {PHASES}")
    y = torch.relu(acc * g[0][:, None, :].float() + bb[0][:, None, :].float())
    m = torch.maximum(y[:, :, 0::2], y[:, :, 1::2])  # rows 2p, 2p + 1
    m[:, :, 1:] = torch.maximum(m[:, :, 1:], y[:, :, 1:-1:2])  # row 2p - 1
    neg = torch.full_like(m[..., :1], float("-inf"))
    left = torch.cat([neg, m[..., :-1]], -1)
    right = torch.cat([m[..., 1:], neg], -1)
    mm = torch.maximum(torch.maximum(left, m), right).to(torch.bfloat16).float()
    total = (s[0].float() @ mm.permute(0, 2, 3, 1)).sum(1)  # (B, 64 s-rows, 64 filters)
    return F.pad(total, (0, LANES - FILTERS))


def plan_band(b: int, conv_rows: int, sms: int) -> int:
    """Conv rows a block: the multiple of ROW_MULTIPLE that minimises waves
    x (band + BAND_OVERHEAD) for b x ceil(conv_rows / band) blocks, one an
    SM on `sms` SMs (ties: the larger band). 32 at B = 32 and 128 conv rows
    on 132 SMs (128 blocks), 16 at 64 conv rows."""
    def cost(band):
        waves = -(-b * -(-conv_rows // band) // sms)
        return waves * (band + BAND_OVERHEAD), -band

    return min(range(ROW_MULTIPLE, conv_rows + 1, ROW_MULTIPLE), key=cost)


def probe_forward(planes, a, g=None, bb=None, s=None, phase: str = "gemm",
                  conv_rows: int = CONV_ROWS) -> torch.Tensor:
    """The cut `phase` of the stem body on (B, 6, rows, 128) f32 or bf16
    planes -> (B, 64, 128) f32: the plain version for CPU tensors, the
    kernel for CUDA tensors (no launch count: the wrappers count)."""
    if phase not in PHASES:
        raise ValueError(f"stem probe: phase {phase!r} is not one of {PHASES}")
    if planes.device.type == "cpu":
        return phase_plain(phase, planes, a, g, bb, s, conv_rows)
    return _launch(planes, a, g, bb, s, phase, conv_rows)


def stem_probe(planes: torch.Tensor, a: torch.Tensor, conv_rows: int = CONV_ROWS):
    """The envelope of tools/stem_probe.py: the gemm cut on f32 planes."""
    global launches
    ext.require(planes.dtype == torch.float32,
                f"stem probe: the envelope takes f32 planes, got {planes.dtype}")
    out = probe_forward(planes, a, phase="gemm", conv_rows=conv_rows)
    if planes.is_cuda:
        launches += 1
    return out


def _launch(planes, a, g, bb, s, phase: str, conv_rows: int) -> torch.Tensor:
    dev = planes.device
    ext.require(planes.is_cuda, f"stem probe: unsupported device {dev}")
    ext.require(planes.dtype in (torch.float32, torch.bfloat16) and planes.is_contiguous()
                and planes.dim() == 4 and planes.shape[1] == 6 and planes.shape[3] == LANES,
                f"stem probe: planes must be contiguous f32 or bf16 (B, 6, rows, 128), got "
                f"{planes.dtype} {tuple(planes.shape)}")
    rows = planes.shape[2]
    ext.require(conv_rows % ROW_MULTIPLE == 0 and conv_rows >= 2 * ROW_MULTIPLE
                and 2 * conv_rows + 6 <= rows,
                f"stem probe: conv_rows must be a multiple of {ROW_MULTIPLE}, at least "
                f"{2 * ROW_MULTIPLE} and at most (rows - 6) / 2, got {conv_rows} for {rows} rows")
    band = plan_band(planes.shape[0], conv_rows,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    ext.require(a.shape == (1, FILTERS, KDIM) and a.dtype == torch.bfloat16 and a.is_contiguous()
                and a.device == dev, "stem probe: a must be contiguous bf16 (1, 64, 152) there")
    if phase == "full":
        ext.require(all(t is not None and t.shape == (1, FILTERS, LANES) and t.is_contiguous()
                        and t.device == dev for t in (g, bb, s))
                    and g.dtype == bb.dtype == torch.float32 and s.dtype == torch.bfloat16,
                    "stem probe: the full cut needs g, b (1, 64, 128) f32 and s bf16 there")
    out = torch.zeros((planes.shape[0], FILTERS, LANES), dtype=torch.float32, device=dev)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    err = ext.load().mhent_stem_probe(planes.data_ptr(), a.data_ptr(), ptr(g), ptr(bb), ptr(s),
                                      out.data_ptr(), planes.shape[0], rows, conv_rows,
                                      PHASES.index(phase), int(planes.dtype == torch.bfloat16),
                                      band, ext.stream_of(planes))
    ext.check(err, "mhent_stem_probe")
    return out


def flops(b: int, conv_rows: int = CONV_ROWS) -> int:
    """The GEMM's flops at K = 152, as the JAX probe counts them."""
    return 2 * b * FILTERS * KDIM * conv_rows * LANES


def cudnn_stem_operands(b: int, device, seed: int = 3) -> tuple:
    """probe_xla_step's operands: a (b, 256, 256, 3) bf16 image, (64, 3, 7, 7)
    weights and BN scale and bias, for cuDNN's stem and the stem kernel."""
    g = torch.Generator().manual_seed(seed)
    image = torch.rand((b, IMG, IMG, 3), generator=g).to(device, torch.bfloat16)
    w = (torch.randn((FILTERS, 3, 7, 7), generator=g) * 0.05).to(device)
    return image, w, torch.ones(FILTERS, device=device), torch.zeros(FILTERS, device=device)


def cudnn_stem(image, w, scale, shift):
    """conv 7x7/2 (cuDNN, bf16) + BN + ReLU + maxpool 3x3/2: the library
    yardstick, timed beside the probe and used nowhere in the port."""
    y = F.conv2d(image.permute(0, 3, 1, 2), w.to(torch.bfloat16), stride=2, padding=3)
    y = torch.relu(y * scale.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None])
    return F.max_pool2d(y, 3, stride=2, padding=1)


def time_call(fn) -> dict:
    """ms a call on the card by CUDA events, eager and as a CUDA-graph
    replay, and the device ms a call from a profile_step trace of ten calls."""
    from mhentropy_tpu_torch import profile_step

    events = profile_step.device_events(profile_step.profile(fn, 10))
    return {"ms": profile_step.cuda_ms(fn), "graph_ms": profile_step.cuda_ms(
                profile_step.graphed(fn)),
            "device_ms": sum(d for _, _, d in events) / 1e6 / 10}


def main(argv=None) -> dict:
    from mhentropy_tpu_torch.models import stem_cuda
    from mhentropy_tpu_torch.train.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", nargs="?", default="time", choices=("check", "time"),
                    help="check: one call against the plain version; time: also the timings")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--batch", type=int, default=B)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    timed = args.mode == "time" and dev.type == "cuda"
    planes, a = inputs(args.batch, dev)
    out = stem_probe(planes, a)
    ref = phase_plain("gemm", planes, a)
    err = (out - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item()
    lines = [{"metric": "stem probe envelope (im2col + one GEMM, K = 152)",
              "shape": list(planes.shape), "max_abs_err": err, "tol": tol}]
    if timed:
        lines[0].update(time_call(lambda: stem_probe(planes, a)))
        image, w, scale, shift = cudnn_stem_operands(args.batch, dev)
        lines.append({"metric": "cuDNN stem + bn + relu + pool (bf16)",
                      "shape": list(image.shape),
                      **time_call(lambda: cudnn_stem(image, w, scale, shift))})
        wf, bias = stem_cuda.fold(w.cpu(), scale.cpu(), shift.cpu(), torch.zeros(FILTERS),
                                  torch.ones(FILTERS))
        wf, bias = wf.to(dev), bias.to(dev)
        lines.append({"metric": "stem kernel (csrc/stem.cu)", "shape": list(image.shape),
                      **time_call(lambda: stem_cuda.stem_forward(image, wf, bias))})
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for line in lines:
        print(json.dumps({**line, "device": card}), flush=True)
    return {"ok": err <= tol, "lines": lines}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
