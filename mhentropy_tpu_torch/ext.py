"""Build and load the port's CUDA kernels.

The kernels under `csrc/` are compiled by `nvcc` into one shared library
with a plain C interface and bound with `ctypes` (no PyTorch headers, so a
build takes seconds, not minutes). Each source compiles in its own `nvcc`
process, all started together, and one more links them. The build runs at
first use and is keyed by a hash of the sources and flags:
`_build/libmhent_<hash>.so` is reused until a source changes. Nothing here
runs at import time.

Every C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()`; `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: (argtypes); every function returns the cudaError_t as int.
_SIGNATURES = {
    "mhent_stem_forward": [_P, _P, _P, _P, _I, _I, _I, _P],
    "mhent_stage1_block": [_P] * 9 + [_I, _I, _I, _I, _P],
    "mhent_realnvp_sample": [_P] * 11 + [_I] * 8 + [_P],
    "mhent_realnvp_sample_smem": [_I] * 4,
    "mhent_realnvp_sample_clusters": [_I] * 4,
    "mhent_lbs_blend": [_P] * 5 + [_I] * 3 + [_P],
    "mhent_lbs_vertex_tile": [_I, _I],
    "mhent_stage1_int8_block": [_P] * 18 + [_I] * 4 + [_P],
    "mhent_realnvp_sample_q": [_P] * 13 + [_I] * 8 + [_P],
    "mhent_realnvp_sample_q_smem": [_I] * 4,
    "mhent_realnvp_sample_q_clusters": [_I] * 4,
    "mhent_realnvp_sample_f32": [_P] * 11 + [_I] * 8 + [_P],
    "mhent_realnvp_sample_f32_smem": [_I] * 4,
    "mhent_realnvp_sample_f32_clusters": [_I] * 4,
    "mhent_bn_stats_sums": [_P] * 4 + [_I] * 4 + [_P],
    "mhent_bn_grad_sums": [_P] * 5 + [_I] * 4 + [_P],
    "mhent_glow_sample": [_P] * 22 + [_I] * 6 + [_P],
    "mhent_stem_int8_forward": [_P] * 6 + [_I] * 4 + [_P],
    "mhent_stage2_int8_block": [_P] * 21 + [_I] * 9 + [_P],
    "mhent_gemm_probe_s8": [_P] * 3 + [_I] * 3 + [_P],
    "mhent_gemm_probe_bf16": [_P] * 3 + [_I] * 3 + [_P],
    "mhent_stem_probe": [_P] * 6 + [_I] * 5 + [_P],
    "mhent_stage1_probe_block": [_P] * 6 + [_I] * 5 + [_P],
}


class KernelLibrary:
    """The loaded shared library and what its build printed."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; thread-safe."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = _build_and_load()
        return _loaded


def _build_and_load() -> KernelLibrary:
    out = BUILD_DIR / f"libmhent_{_digest()}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sources():
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            log += text
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        if not failed:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                              f"{proc.stdout}{proc.stderr}")
            else:
                os.replace(tmp, out)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("\n".join(failed))
    return KernelLibrary(out, time.perf_counter() - t0, log)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Argument check that survives `python -O` (unlike assert)."""
    if not cond:
        raise ValueError(msg)
