"""Where a tensor-core stem's time goes: the four cuts of one kernel body,
timed on the card (`csrc/stem_probe.cu`).

Port of tools/stem_cost_attrib.py (`make_step` :32): the body of
`mhentropy_tpu_torch.stem_probe` (taps, im2col, GEMM, the BN / ReLU /
maxpool / selection-product epilogue) cut after each part,

    rolls   the 21 rolled, masked taps only
    im2col  + the copy into the (152, conv_rows * 128) im2col matrix
    gemm    + the (64, 152) x (152, conv_rows * 128) GEMM
    full    + the epilogue (`stem_probe.phase_plain` says what each returns)

on bf16 planes (the envelope takes f32 ones; the kernel takes either type).
The differences between successive cuts attribute the cost. Each cut's
output reads only part of what it built, so each is also timed at half the
conv rows: a cut whose work the compiler kept takes about half the time.

    python -m mhentropy_tpu_torch.stem_cost_attrib [check|time] [--device cpu]

prints one JSON line a cut and conv-row count: its error against the plain
version (`check`: one launch a line), and with `time` (the default; on the
card) `kernel_us_per_step` (device
time a call from a `profile_step` trace of 30 calls, as the JAX tool reads
its trace) and ms a call eager and as a CUDA-graph replay. CPU tensors take the plain versions; CUDA
tensors launch the kernel, and anything it does not take raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from mhentropy_tpu_torch import ext, stem_probe

PHASES = stem_probe.PHASES
CONV_ROWS = (stem_probe.CONV_ROWS, stem_probe.CONV_ROWS // 2)

# Kernel launches since the count was last reset, every cut together.
launches = 0


def attrib_forward(planes, a, g, bb, s, phase: str,
                   conv_rows: int = stem_probe.CONV_ROWS) -> torch.Tensor:
    """The cut `phase` on bf16 planes (B, 6, rows, 128) -> (B, 64, 128) f32."""
    global launches
    ext.require(planes.dtype == torch.bfloat16,
                f"stem cost attribution: takes bf16 planes, got {planes.dtype}")
    out = stem_probe.probe_forward(planes, a, g, bb, s, phase, conv_rows)
    if planes.is_cuda:
        launches += 1
    return out


def tolerance(phase: str, ref: torch.Tensor) -> float:
    """rolls and im2col sum bf16 values in the plain version's order: equal.
    gemm: f32 sums in another order, within 1e-5 of the largest output.
    full: the max is rounded to bf16 after f32 sums in another order, which
    can move a rounding by one bf16 ulp: within 2^-7 of the largest output."""
    scale = ref.abs().max().item()
    return {"rolls": 0.0, "im2col": 0.0, "gemm": 1e-5 * scale, "full": 2.0 ** -7 * scale}[phase]


def main(argv=None) -> dict:
    from mhentropy_tpu_torch.train.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", nargs="?", default="time", choices=("check", "time"),
                    help="check: one call a cut against the plain version; time: also timed")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--batch", type=int, default=stem_probe.B)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    timed = args.mode == "time" and cuda
    planes, a = stem_probe.inputs(args.batch, dev, dtype=torch.bfloat16)
    g, bb, s = stem_probe.epilogue_operands(dev)
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ok, lines = True, []
    for rows in CONV_ROWS:
        for phase in PHASES:
            out = attrib_forward(planes, a, g, bb, s, phase, rows)
            ref = stem_probe.phase_plain(phase, planes, a, g, bb, s, rows)
            err = (out - ref).abs().max().item()
            tol = tolerance(phase, ref)
            ok &= err <= tol
            line = {"phase": phase, "conv_rows": rows, "max_abs_err": err, "tol": tol,
                    "device": card}
            if timed:
                t = stem_probe.time_call(lambda: attrib_forward(planes, a, g, bb, s, phase, rows))
                line.update(kernel_us_per_step=t["device_ms"] * 1e3, **t)
            lines.append(line)
            print(json.dumps(line), flush=True)
    return {"ok": ok, "lines": lines}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
