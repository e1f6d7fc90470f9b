"""Times variants of the GEMM probe, stage-1 probe and stem probe kernels and
of the W8A8 stem on the card, each the committed source with textual
substitutions, built by `nvcc` into a library of its own: where each
kernel's time goes (loads only, products only, no output stores, no layout
transpose) and the ring depths and warp counts the kernels chose.

    python -m mhentropy_tpu_torch.kernel_variants [--kinds gemm,stage1,stem,stem_int8]
        [--out FILE]

Each variant prints one JSON line: ms a call by CUDA events (the median of
three windows of `profile_step.cuda_ms`, eager), the max-abs difference of
its output from the plain version (a variant that drops work gives a wrong
output by design), and the card's name and power limit. The GEMM variants
run at the probe's (32768, 640, 512), s8 and bf16; the stage-1 variants run
the probe's three launches at B = 32, 64 x 64, both layouts; the stem
variants run each cut at B = 32, 128 conv rows on bf16 planes and the
envelope (the gemm cut on f32 planes); the W8A8 stem variants run at B = 8
and 32, 256 x 256, bf16 out, on both of its paths, as CUDA-graph replays.
Runs only on a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys

import torch

from mhentropy_tpu_torch import ext

_GEMM_RINGS = """  static constexpr int A_STAGES = 6;
  static constexpr int B_STAGES = 3;
  static constexpr int RING = 2;"""
_GEMM_STORE = ("        tma_store(&tm_out, out_smem + (wg * D::RING + slot) * SLAB, "
               "n0 + q * kSlabCols,\n                  m0 + 64 * wg);")
_GEMM_NO_LOADS = [("""      mbar_wait(a_full + 8 * sa, pa);
      mbar_wait(b_full + 8 * sb, pb);""", ""),
                  ("  if (warp >= kConsumerWarps) {  // producers",
                   "  if (warp >= kConsumerWarps) {  return;  // producers")]


_STEM_RING = "  static constexpr int kSlots = 6;"
_STEM_GROUPS = "constexpr int kBuilderGroups = 2;"


def _stem(slots: int, groups: int) -> list:
    return [(_STEM_RING, f"  static constexpr int kSlots = sizeof(TIn) == 2 ? {slots} : 6;"),
            (_STEM_GROUPS, f"constexpr int kBuilderGroups = {groups};")]


# stage2_int8.cu's output rows by TMA bulk copies: the writers fence the
# tiles for the async proxy before the barrier, each of the first `rows`
# threads copies a row, and the CTA waits for the copies' reads at its end.
_S2_BULK_STORES = [
    ("  unsigned char* out = static_cast<unsigned char*>(dst);\n",
     "  unsigned char* out = static_cast<unsigned char*>(dst);\n"
     "  for (int r = threadIdx.x; r < rows; r += T)\n"
     '    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n" ::"l"('
     "out + r * dst_pitch), \"r\"(smem_u32(src + r * src_pitch)), \"r\"(row_bytes) : \"memory\");\n"
     "  bulk_commit();\n  if (rows >= 0) return;\n"),
    ("    }\n    __syncthreads();\n    store_rows<C::T>(smem, C::P_S8,",
     "    }\n    fence_proxy_async();\n    __syncthreads();\n    store_rows<C::T>(smem, C::P_S8,"),
    ("    }\n    __syncthreads();\n    if (p.out_bf16)",
     "    }\n    fence_proxy_async();\n    __syncthreads();\n    if (p.out_bf16)"),
    ("p.q_next + out_at, (size_t)p.N, BN, rows_valid);\n  }\n}\n",
     "p.q_next + out_at, (size_t)p.N, BN, rows_valid);\n  }\n  bulk_wait_read<0>();\n}\n"),
]


def _rings(a: int, b: int, r: int) -> list:
    return [(_GEMM_RINGS, f"""  static constexpr int A_STAGES = {a};
  static constexpr int B_STAGES = {b};
  static constexpr int RING = {r};""")]


# kind -> (source, {variant: [(old, new, occurrence), ...]}); `occurrence`
# (default 0) picks which match of `old` is replaced.
VARIANTS = {
    "gemm": ("int8_gemm_probe.cu", {
        "base": [],
        # The epilogue dropped: its products go unused and are compiled out,
        # leaving the loads and the mbarrier handshakes.
        "loads_only": [("    for (int q = 0; q < kSlabs; ++q) {",
                        "    for (int q = 0; q < 0; ++q) {")],
        "no_stores": [(_GEMM_STORE, "")],
        "products_epilogue": _GEMM_NO_LOADS,
        "products_only": _GEMM_NO_LOADS + [(_GEMM_STORE, "")],
        "x6_w2_r2": _rings(6, 2, 2),
        "x8_w2_r2": _rings(8, 2, 2),
        "x5_w3_r3": _rings(5, 3, 3),
        "x7_w3_r1": _rings(7, 3, 1),
    }),
    "stage1": ("stage1_probe.cu", {
        "base": [],
        "b_no_transpose": [("          transpose_halo(s_raw, s_pix);\n", "")],
        "b_no_raw_loads": [("      cp_async16(s_raw + raw_at(hy, ch, k), src, ok);\n",
                            "      (void)src;\n")],
        "b_no_residual": [("            const uint4 res = __ldg(reinterpret_cast<const uint4*>"
                           "(p.x + o));",
                           "            const uint4 res = make_uint4(0, 0, 0, 0);")],
        "b_no_stores": [("            *reinterpret_cast<uint4*>(p.out + o) = outv;",
                         "            if (p.cin < 0) *reinterpret_cast<uint4*>(p.out + o) = outv;"),
                        ("              if (y < H && xx < W)\n"
                         "                *reinterpret_cast<uint32_t*>(p.out",
                         "              if (y < H && xx < W && p.cin < 0)\n"
                         "                *reinterpret_cast<uint32_t*>(p.out")],
        "a_no_stores": [("            *reinterpret_cast<uint4*>(p.out + o) = outv;",
                         "            if (p.cin < 0) *reinterpret_cast<uint4*>(p.out + o) = outv;",
                         1)],
    }),
    "stem": ("stem_probe.cu", {
        "base": [],
        "ring12": _stem(12, 2),
        "builders1": _stem(6, 1),
        # The consumer waits for each Bm^T and releases it without a product.
        "no_products": [("      wgmma_n128(acc, da, sw128_desc(bm), ks > 0);",
                         "      (void)da;\n      (void)bm;")],
        # gemm's band summed in the accumulators (scale-d 1 across its rows).
        "band_in_accumulator": [
            ("      wgmma_n128(acc, da, sw128_desc(bm), ks > 0);",
             "      wgmma_n128(acc, da, sw128_desc(bm), (PHASE == kGemm && l > 0) || ks > 0);"),
            ("      for (int e = 0; e < 64; ++e) sum[e] += acc[e];",
             "      for (int e = 0; e < 64; ++e) sum[e] = acc[e];")],
        # The band's sums kept, their reductions into the output not issued.
        "no_reductions": [('  asm volatile("red.global.add.v4.f32',
                           '  if (a == 1.25e-38f) asm volatile("red.global.add.v4.f32')],
    }),
    "stem_int8": ("stem_int8.cu", {
        "base": [],
        # The consumer waits for each im2col stage and releases it without a product.
        "no_products": [("      wgmma_s8_n128(acc, sw128_desc(a), sw128_desc(bm), ky > 0);",
                         "      (void)a;\n      (void)bm;")],
        # The products run, the pool, the affine and the output stores do not.
        "no_epilogue": [("    // The pool on the exact sums:", "    return;\n    //")],
        # The input rows still land (and are waited for), but are not quantised.
        "no_quantise": [("          quantise_pair(q, c0);\n", "")],
        # Each pair quantised twice: what one more quantise pass costs.
        "quantise_twice": [("          quantise_pair(q, c0);\n",
                            "          quantise_pair(q, c0);\n          quantise_pair(q, c0);\n")],
        # No im2col stage is built: the products read stale stages.
        "no_build": [("        if (bt < n_valid) {", "        if (bt < n_valid && W < 0) {")],
        # The builders only wait for the rows and hand the stages over.
        "no_quantise_no_build": [("          quantise_pair(q, c0);\n", ""),
                                 ("        if (bt < n_valid) {",
                                  "        if (bt < n_valid && W < 0) {")],
        # Without the builders' proxy fence before each stage's handover.
        "no_build_fence": [("        fence_proxy_async();\n        mbar_arrive(bm_full + 8 * st);",
                            "        mbar_arrive(bm_full + 8 * st);")],
        "pairs8": [("constexpr int kPairSlots = 4;", "constexpr int kPairSlots = 8;")],
        "ahead2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    }),
    "stage2_int8": ("stage2_int8.cu", {
        "base": [],
        # conv2's A gathered by cp.async a stage (the downsample's path), not
        # read from a band of input rows.
        "gather_conv2": [("conv<kRequant, kHalo>(c2", "conv<kRequant, kGather>(c2")],
        # conv1 and conv2 always on 64 x 128 (or 64 x 64) tiles.
        "rows64": [("    if (wave(128, 128))", "    if (false)")],
        # 128 x 128 tiles always on a ring of four stages (one CTA an SM).
        "ring4": [("      return ktiles <= 4 ? launch_conv<EPI, AMODE, 2, 128, 3>",
                   "      return ktiles <= 0 ? launch_conv<EPI, AMODE, 2, 128, 3>")],
        # Small grids packed two CTAs an SM (no shared-memory padding).
        "packed": [("constexpr int kHalfSm = 116 * 1024;", "constexpr int kHalfSm = 0;")],
        # Block 0's conv3 writes its f32 tile to a region of its own, not over
        # the drained ring.
        "down_own_tile": [
            ("  static constexpr int OFF_Q = OFF_RES + (EPI == kResidual ? BM * P_F32 : 0);",
             "  static constexpr int OFF_Q = OFF_RES + (EPI != kRequant ? BM * P_F32 : 0);"),
            ("  static constexpr int OFF_SB = OFF_Q + (EPI == kResidual ? BM * P_S8 : 0);",
             "  static constexpr int OFF_SB = OFF_Q + (EPI != kRequant ? BM * P_S8 : 0);"),
            ("    unsigned char* res = smem + (DOWN ? 0 : C::OFF_RES);\n"
             "    unsigned char* qn = smem + (DOWN ? C::OFF_QD : C::OFF_Q);",
             "    unsigned char* res = smem + C::OFF_RES;\n    unsigned char* qn = smem + C::OFF_Q;")],
        # The next kernel may start only once every CTA has stored its tile.
        "launch_late": [("  griddep_launch();\n  __syncthreads();  // the ring is drained",
                         "  __syncthreads();  // the ring is drained"),
                        ("p.q_next + out_at, (size_t)p.N, BN, rows_valid);\n  }\n}\n",
                         "p.q_next + out_at, (size_t)p.N, BN, rows_valid);\n  }\n"
                         "  griddep_launch();\n}\n")],
        # ... or once every CTA has passed its wait for the kernel ahead.
        "launch_early": [("  griddep_launch();\n  __syncthreads();  // the ring is drained",
                          "  __syncthreads();  // the ring is drained"),
                         ("  griddep_wait();\n", "  griddep_wait();\n  griddep_launch();\n")],
        # Launched without programmatic dependent launch.
        "no_pdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
        # The stages land and are waited for, the products are not issued.
        "no_products": [("    for (int kk = 0; kk < kKB / 32; ++kk) wgmma_s8(d, da + 2 * kk, "
                         "db + 2 * kk);", "    (void)da;\n    (void)db;")],
        # The output rows by TMA bulk copies, one a row (the async proxy), not
        # 16-byte stores.
        "bulk_stores": _S2_BULK_STORES,
        # The epilogue tiles are built, no output row is written.
        "no_stores": [("  for (int e = threadIdx.x; e < rows * cpr; e += T) {",
                       "  for (int e = threadIdx.x; e < rows * cpr && row_bytes < 0; e += T) {")],
    }),
}


# The W8A8 stem with clock64 stamps at its phase boundaries, in block (1, 0)
# (a band after the first): builder thread 0 at 512 + 8 it + {0: row start,
# 1: its input rows quantised, 2: its stage free, 3: the stage built and
# handed over, 4: its last input-row pair landed}; consumer thread 0 at 8 it
# + {0: the stage full, 1: its products done, 2: its epilogue done}; 1000:
# the consumer's weights loaded, 1001: the kernel's start.
_STAMP = ("if (blockIdx.x == 1 && blockIdx.y == 0 && threadIdx.x % 128 == 0) "
          "g_stamps[{}] = clock64();")
STEM_INT8_SPLIT = [
    ("namespace {\n\nconstexpr int kF = 64;",
     "__device__ long long g_stamps[1024];\nnamespace {\n\nconstexpr int kF = 64;"),
    ("  __syncthreads();\n", "  __syncthreads();\n  if (threadIdx.x == 0) { " + _STAMP.format(1001)
     + " }\n"),
    ("        const int i = start + l, q0 = l == 0 ? 0 : l + 3;\n",
     "        const int i = start + l, q0 = l == 0 ? 0 : l + 3;\n        "
     + _STAMP.format("512 + 8 * it") + "\n"),
    ("          if (BULK) mbar_wait(pair_full + 8 * (q % kPairSlots), (q / kPairSlots) & 1);\n",
     "          if (BULK) mbar_wait(pair_full + 8 * (q % kPairSlots), (q / kPairSlots) & 1);\n"
     "          " + _STAMP.format("512 + 8 * it + 4") + "\n"),
    ("        named_sync(1, 128);  // the window's rows",
     "        " + _STAMP.format("512 + 8 * it + 1")
     + "\n        named_sync(1, 128);  // the window's rows"),
    ("          mbar_wait(bm_empty + 8 * st, ((it / kStages) & 1) ^ 1);\n",
     "          mbar_wait(bm_empty + 8 * st, ((it / kStages) & 1) ^ 1);\n        "
     + _STAMP.format("512 + 8 * it + 2") + "\n"),
    ("        mbar_arrive(bm_full + 8 * st);\n",
     "        mbar_arrive(bm_full + 8 * st);\n        " + _STAMP.format("512 + 8 * it + 3") + "\n"),
    ("  named_sync(2, 128);\n  // wq's rows", "  named_sync(2, 128);\n  " + _STAMP.format(1000)
     + "\n  // wq's rows"),
    ("  auto wait_full = [&](int it) { mbar_wait(bm_full + 8 * (it % kStages), "
     "(it / kStages) & 1); };",
     "  auto wait_full = [&](int it) {\n    mbar_wait(bm_full + 8 * (it % kStages), "
     "(it / kStages) & 1);\n    " + _STAMP.format("8 * it") + "\n  };"),
    ("    mbar_arrive(bm_empty + 8 * (it % kStages));\n",
     "    mbar_arrive(bm_empty + 8 * (it % kStages));\n    " + _STAMP.format("8 * it + 1") + "\n"),
    ("row_at(i / 2), n_pool);\n    }\n  };\n",
     "row_at(i / 2), n_pool);\n    }\n    " + _STAMP.format("8 * it + 2") + "\n  };\n"),
    ("extern \"C\" int mhent_stem_int8_forward(",
     "extern \"C\" int mhent_stem_int8_stamps(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n\n"
     "extern \"C\" int mhent_stem_int8_forward("),
]


# The stage kernel with clock64 stamps at its phase boundaries, by thread 0
# of every CTA (the first STAGE2_STAMP_CTAS of a launch), for each of its
# kernels (stamp slot EPI * 3 + AMODE: conv1 0, conv2 gathered 1, conv2 from
# its band 2, conv3 3, block 0's conv3 with the downsample 6): 0 the CTA's start (globaltimer), 1 its start,
# 2 its first stages, residual rows, scale and bias requested (past the wait
# for the kernel ahead), 3 its first stage landed, 4 its products retired,
# 5 every warp's products retired (the ring drained), 6 conv3's residual tile
# landed, 7 the epilogue tiles written, 8 the output
# rows stored, 9 the end (globaltimer), 10 the SM, 11 the launch's CTAs (a
# later launch of the same kernel overwrites the first CTAs' stamps: only
# the last launch's are read).
STAGE2_STAMP_CTAS = 2048
STAGE2_INT8_SPLIT = [
    ("namespace {\n\nconstexpr int kKB",
     f"__device__ long long g_stamps[7][{STAGE2_STAMP_CTAS}][12];\n"
     "namespace {\n\nconstexpr int kKB"),
    ("  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;\n",
     "  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;\n  long long st_[12] = {};\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(st_[0]));\n  st_[1] = clock64();\n'),
    ("  int acc[C::ACC], accd[", "  st_[2] = clock64();\n  int acc[C::ACC], accd["),
    ("    mbar_wait_mma(full + 8 * stage, (v / S) & 1);\n",
     "    mbar_wait_mma(full + 8 * stage, (v / S) & 1);\n    if (v == 0) st_[3] = clock64();\n"),
    ("    mbar_wait_mma(full + 8 * stage, (v / S) & 1);\n",
     "    mbar_wait_mma(full + 8 * stage, (v / S) & 1);\n    if (v == 0) st_[3] = clock64();\n",
     1),
    ("  wgmma_wait<0>();\n  fence_regs<C::ACC>(acc);\n",
     "  wgmma_wait<0>();\n  fence_regs<C::ACC>(acc);\n  st_[4] = clock64();\n"),
    ("  __syncthreads();  // the ring is drained: the epilogue may lay its tiles over it\n",
     "  __syncthreads();  // the ring is drained: the epilogue may lay its tiles over it\n"
     "  st_[5] = clock64();\n  st_[6] = st_[5];\n"),
    ("    if (!DOWN) mbar_wait(res_bar, 0);\n",
     "    if (!DOWN) mbar_wait(res_bar, 0);\n    st_[6] = clock64();\n"),
    ("    __syncthreads();\n    store_rows<C::T>(smem, C::P_S8,",
     "    __syncthreads();\n    st_[7] = clock64();\n    store_rows<C::T>(smem, C::P_S8,"),
    ("    __syncthreads();\n    if (p.out_bf16)\n      store_rows",
     "    __syncthreads();\n    st_[7] = clock64();\n    if (p.out_bf16)\n      store_rows"),
    ("p.q_next + out_at, (size_t)p.N, BN, rows_valid);\n  }\n}\n",
     "p.q_next + out_at, (size_t)p.N, BN, rows_valid);\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    const int cta = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "    st_[8] = clock64();\n"
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(st_[9]));\n'
     "    unsigned smid;\n"
     '    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));\n'
     "    st_[10] = smid;\n"
     "    st_[11] = gridDim.x * gridDim.y;\n"
     f"    if (cta < {STAGE2_STAMP_CTAS})\n"
     "      for (int k = 0; k < 12; ++k) g_stamps[EPI * 3 + AMODE][cta][k] = st_[k];\n"
     "  }\n}\n"),
    ('extern "C" int mhent_stage2_int8_block(',
     'extern "C" int mhent_stage2_int8_stamps(void* host) {\n'
     "  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n\n"
     'extern "C" int mhent_stage2_int8_stamps_clear() {\n'
     "  void* at = nullptr;\n"
     "  cudaError_t err = cudaGetSymbolAddress(&at, g_stamps);\n"
     "  return (int)(err != cudaSuccess ? err : cudaMemset(at, 0, sizeof(g_stamps)));\n}\n\n"
     'extern "C" int mhent_stage2_int8_block('),
]
STAGE2_SPLIT_VARIANTS = ("base", "gather_conv2")
STAGE2_CONVS = {"conv1": 0, "conv2_gather": 1, "conv2": 2, "conv3": 3,
                "conv3_down": 6}  # stamp slots
STAGE2_SHAPES = ((2, 8), (3, 8), (2, 32), (3, 32))  # (stage, B)


def _substitute(text: str, old: str, new: str, occurrence: int = 0) -> str:
    at = -1
    for _ in range(occurrence + 1):
        at = text.find(old, at + 1)
        if at < 0:
            raise ValueError(f"substitution not found in the source: {old[:60]!r}")
    return text[:at] + new + text[at + len(old):]


def variant_sources(kind: str) -> dict:
    """{variant: source text} of `kind`'s kernel, every substitution
    applied to the committed source (a missing one raises)."""
    name, variants = VARIANTS[kind]
    base = (ext.CSRC / name).read_text()
    out = {}
    for variant, subs in variants.items():
        text = base
        for sub in subs:
            text = _substitute(text, *sub)
        out[variant] = text
    return out


def build(kind: str, sources: dict | None = None) -> dict:
    """{variant: ctypes library}, each built by its own nvcc, all at once
    (`sources`: {variant: text}, default `kind`'s variants)."""
    out_dir = ext.BUILD_DIR / "variants" / kind
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, text in (sources or variant_sources(kind)).items():
        src = out_dir / f"{variant}.cu"
        src.write_text(text)
        cmd = [ext._nvcc(), *ext.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-I", str(ext.CSRC), "-o", str(out_dir / f"{variant}.so"), str(src)]
        procs[variant] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind}/{variant}:\n{' '.join(cmd)}\n{log}")
        libs[variant] = ctypes.CDLL(str(out_dir / f"{variant}.so"))
    return libs


def _ms(fn) -> float:
    from mhentropy_tpu_torch import profile_step

    return statistics.median(profile_step.cuda_ms(fn, 0.25) for _ in range(3))


def gemm_cases(libs: dict, dev, emit) -> None:
    from mhentropy_tpu_torch import int8_gemm_probe as probe

    m, k, n = probe.SHAPE
    x8, w8, xb, wb = probe.operands(m, k, n, dev)
    refs = {"s8": probe.plain_s8(x8, w8).double(), "bf16": probe.plain_bf16(xb, wb).double()}
    stream = ext.stream_of(x8)
    for variant, lib in libs.items():
        for side, fn, x, w, dtype in (("s8", lib.mhent_gemm_probe_s8, x8, w8, torch.int32),
                                      ("bf16", lib.mhent_gemm_probe_bf16, xb, wb,
                                       torch.bfloat16)):
            fn.argtypes = ext._SIGNATURES[f"mhent_gemm_probe_{side}"]
            out = torch.empty((m, n), dtype=dtype, device=dev)

            def call(fn=fn, x=x, w=w, out=out):
                ext.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, stream),
                          f"gemm probe variant {variant}")

            call()
            err = (out.double() - refs[side]).abs().max().item()
            emit({"kernel": "int8_gemm_probe", "variant": variant, "side": side,
                  "shape": [m, k, n], "ms": _ms(call), "max_abs_diff": err})


def stage1_cases(libs: dict, dev, emit) -> None:
    from mhentropy_tpu_torch import stage1_probe as probe

    b, h, w = probe.B, probe.H, probe.W
    wa = probe.weights_a(dev)
    wb = probe.to_b(wa)
    xa = probe.input_a(b, dev)
    xb = xa.transpose(1, 2).contiguous()
    sides = {"a": (xa, wa, probe.plain_a(xa, wa), (b, h * w, probe.COUT)),
             "b": (xb, wb, probe.plain_b(xb, wb), (b, probe.COUT, h * w))}
    stream = ext.stream_of(xa)
    for variant, lib in libs.items():
        fn = lib.mhent_stage1_probe_block
        fn.argtypes = ext._SIGNATURES["mhent_stage1_probe_block"]
        for side, (x, ws, ref, out_shape) in sides.items():
            outs = [torch.empty(out_shape, dtype=torch.bfloat16, device=dev) for _ in range(3)]

            def call(x=x, ws=ws, outs=outs, cm=int(side == "b")):
                prev = x
                for blk in range(3):
                    w1 = ws["w1a"][0] if blk == 0 else ws["w1"][blk - 1]
                    wd = ws["wd"][0].data_ptr() if blk == 0 else None
                    ext.check(fn(prev.data_ptr(), w1.data_ptr(), ws["wp"][blk].data_ptr(),
                                 ws["w3"][blk].data_ptr(), wd, outs[blk].data_ptr(), b, h, w,
                                 probe.C0 if blk == 0 else probe.COUT, cm, stream),
                              f"stage-1 probe variant {variant}")
                    prev = outs[blk]

            call()
            err = (outs[2].float() - ref.float()).abs().max().item()
            emit({"kernel": "stage1_probe", "variant": variant, "side": side,
                  "shape": list(x.shape), "ms": _ms(call), "max_abs_diff": err})


def stem_cases(libs: dict, dev, emit) -> None:
    from mhentropy_tpu_torch import stem_probe as probe

    b, rows = probe.B, probe.CONV_ROWS
    g, bb, s = probe.epilogue_operands(dev)
    band = probe.plan_band(b, rows, torch.cuda.get_device_properties(dev).multi_processor_count)
    cases = [(phase, torch.bfloat16) for phase in probe.PHASES] + [("gemm", torch.float32)]
    operands = {dt: probe.inputs(b, dev, dtype=dt) for dt in (torch.bfloat16, torch.float32)}
    out = torch.empty((b, probe.FILTERS, probe.LANES), device=dev)
    for variant, lib in libs.items():
        fn = lib.mhent_stem_probe
        fn.argtypes = ext._SIGNATURES["mhent_stem_probe"]
        for phase, dtype in cases:
            planes, a = operands[dtype]
            stream = ext.stream_of(planes)

            def call(fn=fn, planes=planes, a=a, phase=phase, dtype=dtype):
                out.zero_()
                ext.check(fn(planes.data_ptr(), a.data_ptr(), g.data_ptr(), bb.data_ptr(),
                             s.data_ptr(), out.data_ptr(), b, planes.shape[2], rows,
                             probe.PHASES.index(phase), int(dtype == torch.bfloat16), band,
                             stream), f"stem probe variant {variant}")

            call()
            err = (out - probe.phase_plain(phase, planes, a, g, bb, s, rows)).abs().max().item()
            emit({"kernel": "stem_probe", "variant": variant, "phase": phase,
                  "planes": str(dtype).removeprefix("torch."), "shape": list(planes.shape),
                  "conv_rows": rows, "band": band, "ms": _ms(call), "max_abs_diff": err})


def stem_int8_cases(libs: dict, dev, emit) -> None:
    from mhentropy_tpu_torch import profile_step
    from mhentropy_tpu_torch.models import stem_int8_cuda as stem
    from mhentropy_tpu_torch.models.stem_cuda import out_hw

    g = torch.Generator().manual_seed(6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (8, 32):
        image = (torch.randn((b, 256, 256, 3), generator=g) * 1.5).to(dev)
        conv = (torch.randn((64, 3, 7, 7), generator=g) * (2 / 147) ** 0.5).to(dev)
        bn = torch.nn.BatchNorm2d(64).eval().to(dev)
        site = stem.prepare_stem_site(conv, bn, image.abs().amax(dim=(0, 1, 2)))
        packed = stem.pack(site)
        ref = stem.stem_plain(image, site)
        out = torch.empty((b, *out_hw(256, 256), 64), dtype=torch.bfloat16, device=dev)
        band = stem.plan_band(b, 128, 1, sms)
        for variant, lib in libs.items():
            fn = lib.mhent_stem_int8_forward
            fn.argtypes = ext._SIGNATURES["mhent_stem_int8_forward"]
            for bulk in (1, 0):
                def call(fn=fn, bulk=bulk):
                    ext.check(fn(image.data_ptr(), packed["wq"].data_ptr(),
                                 packed["inv_a"].data_ptr(), packed["scale"].data_ptr(),
                                 packed["bias"].data_ptr(), out.data_ptr(), b, 256, 256, 1, band,
                                 bulk, ext.stream_of(image)), f"int8 stem variant {variant}")

                call()
                err = (out.float() - ref).abs().max().item()
                emit({"kernel": "stem_int8", "variant": variant, "bulk": bulk,
                      "shape": list(image.shape), "band": band,
                      "graph_ms": _ms(profile_step.graphed(call)), "max_abs_diff": err})


SPLIT_VARIANTS = ("base", "no_epilogue", "no_products", "no_quantise")


def stem_int8_split(dev, emit) -> None:
    """The stamped W8A8 stem (STEM_INT8_SPLIT; the base source and the
    SPLIT_VARIANTS cuts) at B = 8 and 32, bulk path:
    block (1, 0)'s cycles a conv row in each phase, median over its rows
    (the first row, which quantises four pairs, apart), and its start."""
    from mhentropy_tpu_torch.models import stem_int8_cuda as stem
    from mhentropy_tpu_torch.models.stem_cuda import out_hw

    sources = variant_sources("stem_int8")
    sources = {name: sources[name] for name in SPLIT_VARIANTS}
    for name, text in sources.items():
        for sub in STEM_INT8_SPLIT:
            text = _substitute(text, *sub)
        sources[name] = text
    libs = build("stem_int8_split", sources)
    g = torch.Generator().manual_seed(6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (variant, lib), b in itertools.product(libs.items(), (8, 32)):
        fn = lib.mhent_stem_int8_forward
        fn.argtypes = ext._SIGNATURES["mhent_stem_int8_forward"]
        lib.mhent_stem_int8_stamps.argtypes = [ctypes.c_void_p]
        image = (torch.randn((b, 256, 256, 3), generator=g) * 1.5).to(dev)
        conv = (torch.randn((64, 3, 7, 7), generator=g) * (2 / 147) ** 0.5).to(dev)
        packed = stem.pack(stem.prepare_stem_site(conv, torch.nn.BatchNorm2d(64).eval().to(dev),
                                                  image.abs().amax(dim=(0, 1, 2))))
        out = torch.empty((b, *out_hw(256, 256), 64), dtype=torch.bfloat16, device=dev)
        band = stem.plan_band(b, 128, 1, sms)
        for _ in range(3):  # warm: the last launch's stamps are read
            ext.check(fn(image.data_ptr(), packed["wq"].data_ptr(), packed["inv_a"].data_ptr(),
                         packed["scale"].data_ptr(), packed["bias"].data_ptr(), out.data_ptr(),
                         b, 256, 256, 1, band, 1, ext.stream_of(image)), "stamped int8 stem")
        torch.cuda.synchronize()
        st = torch.zeros(1024, dtype=torch.int64)
        ext.check(lib.mhent_stem_int8_stamps(st.data_ptr()), "mhent_stem_int8_stamps")
        rows = band + 1  # block 1 also computes the straddling row
        t = st.tolist()
        bld = [[t[512 + 8 * r + k] for k in range(5)] for r in range(rows)]
        con = [[t[8 * r + k] for k in range(3)] for r in range(rows)]

        def med(xs):
            return statistics.median(xs[1:]) if len(xs) > 1 else xs[0]

        emit({"kernel": "stem_int8", "split": "clock64 cycles a conv row, block (1, 0)",
              "variant": variant, "shape": list(image.shape), "band": band, "rows": rows,
              "builder": {"pair_wait": med([r[4] - r[0] for r in bld]),
                          "quantise": med([r[1] - r[4] for r in bld]),
                          "wait_stage": med([r[2] - r[1] for r in bld]),
                          "build": med([r[3] - r[2] for r in bld]),
                          "row": med([bld[r + 1][0] - bld[r][0] for r in range(rows - 1)]),
                          "first_row": bld[0][3] - t[1001]},
              "consumer": {"wait_full": med([con[r + 1][0] - con[r - 1][2]
                                             for r in range(1, rows - 1)]),
                           "wait_products": med([con[r][1] - con[r + 1][0]
                                                 for r in range(1, rows - 1)]),
                           "epilogue": med([r[2] - r[1] for r in con]),
                           "row": med([con[r + 1][1] - con[r][1] for r in range(rows - 1)]),
                           "first_products": con[0][1] - t[1001], "weights": t[1000] - t[1001]},
              "block_cycles": con[-1][2] - t[1001]})


def stage_sites(stage: int, g, dev) -> dict:
    """Random int8 sites of one resnet50 stage (tests/test_torch_cuda.py's):
    HWIO s8 weights, f32 scale, bias and input factor."""
    from mhentropy_tpu_torch.models import stage2_int8_cuda as s2

    geom = s2.GEOMS[stage]

    def site(shape):
        cout = shape[-1]
        return {"w8": torch.randint(-90, 90, shape, generator=g, dtype=torch.int8).to(dev),
                "scale": (torch.rand(cout, generator=g) * 1.8e-3 + 2e-4).to(dev),
                "bias": (torch.randn(cout, generator=g) * 0.05).to(dev),
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


class _StageLib:
    """A variant library in the place of `ext.load()`'s, for the stage
    kernel's wrapper (which calls only `mhent_stage2_int8_block`)."""

    def __init__(self, lib):
        self._lib = lib
        fn = lib.mhent_stage2_int8_block
        fn.argtypes = ext._SIGNATURES["mhent_stage2_int8_block"]
        fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _stage_inputs(dev):
    """{(stage, B): (x bf16, packed, the plain f32 output)} at STAGE2_SHAPES."""
    from mhentropy_tpu_torch.models import stage2_int8_cuda as s2

    out = {}
    for stage, b in STAGE2_SHAPES:
        g = torch.Generator().manual_seed(31)
        geom = s2.GEOMS[stage]
        packed = s2.pack(stage_sites(stage, g, dev), stage)
        x = torch.randn((b, geom.w_in, geom.w_in, geom.cin), generator=g).to(dev)
        xb = x.to(torch.bfloat16)
        out[(stage, b)] = (xb, packed, s2.stage_plain(xb, packed))
    return out


def _run_stage(lib, stage, xb, packed):
    from mhentropy_tpu_torch.models import stage2_int8_cuda as s2

    saved = ext._loaded
    ext._loaded = _StageLib(lib)
    try:
        return s2.stage_forward_q(xb, packed, stage)
    finally:
        ext._loaded = saved


def stage2_int8_cases(libs: dict, dev, emit) -> None:
    """Each variant of the stage kernel at STAGE2_SHAPES, bf16 in and out, as
    CUDA-graph replays of the whole stage through the wrapper."""
    from mhentropy_tpu_torch import profile_step

    inputs = _stage_inputs(dev)
    for variant, lib in libs.items():
        for (stage, b), (xb, packed, ref) in inputs.items():
            call = lambda lib=lib, stage=stage, xb=xb, packed=packed: _run_stage(  # noqa: E731
                lib, stage, xb, packed)
            err = (call().float() - ref).abs().max().item()
            emit({"kernel": "stage2_int8", "variant": variant, "stage": stage,
                  "shape": list(xb.shape), "graph_ms": _ms(profile_step.graphed(call)),
                  "max_abs_diff": err})


def stage2_int8_split(dev, emit) -> None:
    """The stamped stage kernel (STAGE2_INT8_SPLIT; the base source and the
    STAGE2_SPLIT_VARIANTS) at STAGE2_SHAPES: for each convolution of the
    stage's last bottleneck (block 0's for conv3_down), the medians over
    its CTAs of each phase's cycles, a CTA's life, and the launch's span."""
    sources = variant_sources("stage2_int8")
    sources = {name: sources[name] for name in STAGE2_SPLIT_VARIANTS}
    for name, text in sources.items():
        for sub in STAGE2_INT8_SPLIT:
            text = _substitute(text, *sub)
        sources[name] = text
    libs = build("stage2_int8_split", sources)
    inputs = _stage_inputs(dev)
    phases = {"setup": (1, 2), "first_stage": (2, 3), "products": (3, 4), "drain": (4, 5),
              "residual_wait": (5, 6), "epilogue_tile": (6, 7), "stores": (7, 8), "cta": (1, 8)}
    for variant, lib in libs.items():
        lib.mhent_stage2_int8_stamps.argtypes = [ctypes.c_void_p]
        for (stage, b), (xb, packed, _) in inputs.items():
            st = torch.zeros((7, STAGE2_STAMP_CTAS, 12), dtype=torch.int64)
            _run_stage(lib, stage, xb, packed)  # warm
            torch.cuda.synchronize()
            ext.check(lib.mhent_stage2_int8_stamps_clear(), "mhent_stage2_int8_stamps_clear")
            _run_stage(lib, stage, xb, packed)
            torch.cuda.synchronize()
            ext.check(lib.mhent_stage2_int8_stamps(st.data_ptr()), "mhent_stage2_int8_stamps")
            convs = {}
            for conv, slot in STAGE2_CONVS.items():
                every = st[slot].tolist()
                rows = [r for r in every if r[9] > 0]
                if not rows:
                    continue
                last = max(rows, key=lambda r: r[0])[11]
                rows = [r for r in every[:last] if r[9] > 0 and r[11] == last]
                t0 = min(r[0] for r in rows)
                convs[conv] = {
                    "ctas": len(rows), "sms": len({r[10] for r in rows}),
                    **{k: statistics.median(r[b1] - r[a] for r in rows)
                       for k, (a, b1) in phases.items()},
                    "cta_ns": statistics.median(r[9] - r[0] for r in rows),
                    "span_ns": max(r[9] for r in rows) - t0,
                    "last_start_ns": max(r[0] for r in rows) - t0}
            emit({"kernel": "stage2_int8", "split": "clock64 cycles (medians over CTAs)",
                  "variant": variant, "stage": stage, "shape": list(xb.shape), "convs": convs})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", default="gemm,stage1,stem,stem_int8,stage2_int8",
                    help="comma-separated: gemm, stage1, stem, stem_int8, stage2_int8, "
                         "stem_int8_split, stage2_int8_split")
    ap.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = ap.parse_args(argv)
    kinds = args.kinds.split(",")
    splits = {"stem_int8_split": stem_int8_split, "stage2_int8_split": stage2_int8_split}
    if not set(kinds) <= set(VARIANTS) | set(splits):
        ap.error(f"--kinds takes {', '.join([*VARIANTS, *splits])}, not {args.kinds}")
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; it times the kernels on the card",
              file=sys.stderr)
        return 1
    from mhentropy_tpu_torch import profile_step

    dev = torch.device("cuda", 0)
    card = profile_step.card_line()
    lines = []

    def emit(line):
        line = {**line, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)

    for kind in kinds:
        if kind in splits:
            splits[kind](dev, emit)
            continue
        {"gemm": gemm_cases, "stage1": stage1_cases, "stem": stem_cases,
         "stem_int8": stem_int8_cases, "stage2_int8": stage2_int8_cases}[kind](
            build(kind), dev, emit)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
