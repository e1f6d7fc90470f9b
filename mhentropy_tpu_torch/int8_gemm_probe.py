"""Probe: the card's s8 tensor-core GEMM against its bf16 one, both written
by hand (`csrc/int8_gemm_probe.cu`).

Port of tools/mosaic_int8_probe.py (`make_kernels` :23): the same GEMM,
(32768, 640) x (640, 512), once as s8 x s8 -> s32 and once as bf16 x bf16
-> bf16 (f32 sums), on the same integer operands. It asks how fast the
s8 path is beside the bf16 path, the question the int8 kernels rest on.

    python -m mhentropy_tpu_torch.int8_gemm_probe [lower|time] [--device cpu]

`lower` builds both kernels, runs each once and holds it against its plain
version (the s8 side exactly; the bf16 side within one bf16 rounding of
the output); `time` also times both by CUDA events over three windows of
whole calls, alternating (bench_prohmr's timing), with `torch._int_mm` and
`torch.matmul` in bf16 as the library yardsticks. Prints one JSON line.
The weight operand is stored (N, K), as the stage kernels store theirs.
CPU tensors take the plain versions; CUDA tensors launch the kernels, and
anything they do not take raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from mhentropy_tpu_torch import bench_prohmr, ext

SHAPE = (32768, 640, 512)  # M, K, N of the JAX probe
TILE = 128  # the kernels' M and N tile

# Kernel launches since the counts were last reset; nothing else touches them.
launches_s8 = 0
launches_bf16 = 0


def operands(m: int, k: int, n: int, device, seed: int = 0):
    """Random s8 operands in [-127, 127) and their bf16 copies (exact)."""
    g = torch.Generator().manual_seed(seed)
    x8 = torch.randint(-127, 127, (m, k), generator=g, dtype=torch.int8).to(device)
    w8 = torch.randint(-127, 127, (n, k), generator=g, dtype=torch.int8).to(device)
    return x8, w8, x8.to(torch.bfloat16), w8.to(torch.bfloat16)


def gemm_s8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32."""
    if x.device.type == "cpu":
        return plain_s8(x, w)
    return _launch(x, w, torch.int8, torch.int32, "mhent_gemm_probe_s8")


def gemm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 x (N, K) bf16 -> (M, N) bf16, f32 sums."""
    if x.device.type == "cpu":
        return plain_bf16(x, w)
    return _launch(x, w, torch.bfloat16, torch.bfloat16, "mhent_gemm_probe_bf16")


def plain_s8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f64 products of the integers (exact), as int32."""
    return (x.double() @ w.double().T).to(torch.int32)


def plain_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 products of the bf16 operands, rounded to bf16."""
    return (x.float() @ w.float().T).to(torch.bfloat16)


def _launch(x, w, in_dtype, out_dtype, fn: str) -> torch.Tensor:
    global launches_s8, launches_bf16
    ext.require(x.is_cuda and w.device == x.device,
                f"gemm probe: tensors must be on one CUDA device, got {x.device}, {w.device}")
    ext.require(x.dtype == in_dtype and w.dtype == in_dtype and x.is_contiguous()
                and w.is_contiguous(), f"gemm probe: operands must be contiguous {in_dtype}, "
                f"got {x.dtype}, {w.dtype}")
    ext.require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[1],
                f"gemm probe: shapes {tuple(x.shape)} x {tuple(w.shape)}^T do not chain")
    m, k = x.shape
    n = w.shape[0]
    ext.require(m % TILE == 0 and n % TILE == 0 and (k * x.element_size()) % 64 == 0,
                f"gemm probe: M, N must be multiples of {TILE} and K of {64 // x.element_size()}"
                f", got M={m} K={k} N={n}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = getattr(ext.load(), fn)(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                                  ext.stream_of(x))
    ext.check(err, fn)
    if in_dtype == torch.int8:
        launches_s8 += 1
    else:
        launches_bf16 += 1
    return out


def check(x8, w8, xb, wb) -> dict:
    """One call of each side against its plain version: the s8 side's
    max-abs error (must be 0) and the bf16 side's, with its tolerance of one
    bf16 rounding (2^-8 of the largest output)."""
    o8 = gemm_s8(x8, w8)
    ob = gemm_bf16(xb, wb)
    r8 = plain_s8(x8, w8)
    rb = (xb.float() @ wb.float().T)
    err8 = (o8.long() - r8.long()).abs().max().item()
    errb = (ob.float() - rb).abs().max().item()
    tolb = rb.abs().max().item() * 2.0 ** -8
    return {"max_abs_err_s8": err8, "max_abs_err_bf16": errb, "tol_bf16": tolb,
            "ok": err8 == 0 and errb <= tolb}


def main(argv=None) -> dict:
    from mhentropy_tpu_torch.train.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", nargs="?", default="lower", choices=("lower", "time"))
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    m, k, n = SHAPE
    x8, w8, xb, wb = operands(m, k, n, dev)
    out = {"metric": "int8 vs bf16 GEMM probe", "shape": [m, k, n],
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu", **check(x8, w8, xb, wb)}
    if args.mode == "time":
        fns = {"s8": lambda: gemm_s8(x8, w8), "bf16": lambda: gemm_bf16(xb, wb)}
        if cuda:  # the library yardsticks, timed here only
            w8_kn, wb_kn = w8.T.contiguous(), wb.T.contiguous()
            fns["library_s8"] = lambda: torch._int_mm(x8, w8_kn)
            fns["library_bf16"] = lambda: torch.matmul(xb, wb_kn)
        runs = bench_prohmr.alternate(fns, cuda)
        out.update({f"{k}_ms": statistics.median(v) for k, v in runs.items()})
        out["ms_min_max"] = {k: [min(v), max(v)] for k, v in runs.items()}
        out["ratio_bf16_over_s8"] = out["bf16_ms"] / out["s8_ms"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
