// W8A8 ResNet-50 stages 2 and 3 for Hopper (sm_90a): one C call per
// bottleneck, each convolution an implicit GEMM of s8 x s8 -> s32 products
// on wgmma (m64nNk32, N = 64 or 128), fed by TMA and by ldmatrix from a
// band of input rows in shared memory, with the quantised eval
// path's f32 epilogue fused:
//
//   block 0: xq = clip(rint(x * inv[0]), +-127)          (bf16 / f32 stage input)
//   h1q = clip(rint(relu(acc1 * s1' + b1')), +-127)      (1x1, conv2's inv_sa folded)
//   h2q = clip(rint(relu(acc2 * s2' + b2')), +-127)      (3x3, stride 2 on block 0)
//   res = accd * sd + bd on block 0 (1x1 stride 2 on xq), else the f32 carry
//   y   = relu((acc3 * s3 + b3) + res)                   (f32 carry, or the stage's
//                                                        bf16 / f32 output)
//   next block's xq = clip(rint(y * inv[j + 1]), +-127)  (emitted beside y)
//
// Replaces mhentropy_tpu/models/stage2_int8.py::stage_forward_q (the Pallas
// `_kernel` at :81, launched at :277). The arithmetic and its order are the
// TPU kernel's: every epilogue multiply and add is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction), rint rounds half to even
// like jnp.round, the integer sums are exact, and the carry between blocks
// is f32. conv2 of the
// stride-2 block is computed at stride 2 directly: the TPU kernel's
// full-resolution conv2 and selection matmuls give the same integer sums
// at the kept pixels.
//
// What bounds it on the H100: stage 2 at B = 8 (4 bottlenecks, 64 x 64 x 256
// in, 32 x 32 x 512 out) does 21.5 GOP of s8 products, 10.9 us at the 1,979
// TOP/s int8 peak; stage 3 (6 bottlenecks, 32 x 32 x 512 in, 16 x 16 x 1024
// out) 30.6 GOP, 15.5 us. Beyond that bound, the f32 carry: a later block's
// conv3 reads it, writes it back and writes the next block's s8 input, 37.7
// MB at stage 2, B = 8 (11 us at 3.35 TB/s) and 151 MB at B = 32 (45 us);
// over a stage at B = 32 the carry and the s8 maps between convolutions put
// a byte floor of about 0.21 ms under stage 2 and 0.16 ms under stage 3.
// conv3's K is 128 or 256, so conv3 is a stream of the carry; stage 3 at
// B = 8 has only 2,048 output pixels a stride-1 conv, and its conv2 (K =
// 2,304), on tiles small enough to fill the card, re-reads its weights
// from L2 once a tile.
//
// Design: a bottleneck is three kernels, conv1, conv2 and conv3; block 0's
// conv3 also runs the downsample (its own k stages, A gathered at stride 2
// from the block input, into a second set of accumulators), so that block
// 0's f32 residual never goes through device memory; block 0 first
// quantises the stage input in a pass of its own at the memory rate. 13
// kernels a stage-2 forward, 19 a stage-3 one.
// - Each kernel is a tile of BM = 64 or 128 output pixels (one or two
//   consumer warpgroups of 64 rows) by BN = 128 (or 64) output channels,
//   K walked in 128-byte stages (four k32 wgmma each) through a ring of S
//   stages in shared memory in the 128-byte swizzle. The weights, (N, K)
//   s8 K-major as `pack` lays them out (all L2-resident), come by TMA boxes
//   of BN rows and are the wgmma B operand. The A operand of a 1x1 stride-1
//   conv (conv1, conv3) is the (M, C) s8 map as it lies, also by TMA (rows
//   past M zero-filled). The strided downsample's rows are gathered by
//   cp.async in 16-byte pieces straight into the swizzled layout.
// - conv2 (3x3, stride 1 or 2) reads each input pixel once: a tile is whole
//   output rows of one image, and its band of input rows (all channels,
//   the zero border as zero-filled copies, so no TMA coordinate is ever
//   negative) is loaded into shared memory once, one cp.async group a
//   128-channel chunk; K is walked chunk-major, and each stage's A
//   fragments come by ldmatrix from the band at the tap's shift into
//   registers (wgmma with A from registers), the next stage's loaded while
//   this one's products run. Against a K-major im2col tile gathered a
//   stage, this cuts conv2's L2 reads of its input by the nine taps' reuse.
// - A stage is refilled S - 2 stages ahead, after a block barrier that
//   follows each warpgroup's wgmma.wait_group 1, so one stage's products
//   stay in flight while the next is issued. The products are issued from
//   straight-line code, the accumulators are fenced only after the last
//   wait, and a wait that may trap retires the products first: ptxas then
//   reports no serialized wgmma (C7515 / C7517 / C7518).
// - Tiles (the host's `conv`): 128 x 128 where they give about a wave of
//   132 CTAs (a ring of three stages, two CTAs an SM, where K is at most
//   four stages), else 64 x 128, else 64 x 64 (stage 3 at B = 8). A grid of
//   at most one wave asks for more than half an SM's shared memory, so
//   that the scheduler spreads it one CTA an SM. conv3 takes 64 x 128
//   tiles and loads its one or two k stages up front (three CTAs an SM at
//   one stage).
// - Programmatic dependent launch: each kernel may start while the one
//   ahead of it finishes; it arms its barriers and reads its weights, scale
//   and bias, then waits (griddepcontrol) before it reads or writes what
//   the kernels ahead wrote.
// - The epilogue through shared memory: scale and bias are staged at the
//   start; the s32 sums are converted in registers (the quantiser on the
//   FP32 pipe: clip, then add 1.5 * 2^23) into padded, conflict-free tiles
//   over the drained ring; the CTA writes whole rows with coalesced 16-byte
//   stores. conv3's f32 residual tile is requested at the start, one bulk
//   copy a row onto an mbarrier, so that it lands while the products run;
//   the new carry (or the stage's bf16 output) and the next block's s8
//   input leave together, each carry byte read once and written once.
// - Measured slower on the card, and not kept: split K over a cluster with
//   the partial sums added through distributed shared memory (its cluster
//   barriers and remote reads cost more than the fuller grid saved); the
//   output rows by TMA bulk copies (kernel_variants.py's bulk_stores);
//   conv2's A gathered a stage like the downsample's (gather_conv2); block
//   0's quantise fused into conv1's and the downsample's loads (register
//   loads left a DRAM round trip exposed a k stage). A whole bottleneck in
//   one kernel would keep h1 and h2 on chip but leave M / tile CTAs, a
//   quarter of the card at stage 3, B = 8.
// Its times and a clock64 split of its phases are in PERF.md (row 9).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "hopper_tma.cuh"

namespace {

constexpr int kKB = 128;  // K bytes a stage: one 128-byte swizzle row, four k32 steps

// The epilogues: conv1 and conv2 requantise to s8; conv3 adds the f32
// residual (the carry) and emits the next block's s8 input; block 0's conv3
// computes its residual itself, the downsample's products in a second set of
// accumulators (its A operand gathered at stride 2 from the block input).
enum Epi { kRequant = 0, kResidual = 1, kResidualDown = 2 };

// Where a stage's A operand comes from: one TMA box of the (M, C) s8 map
// (conv1, conv3); gathered by cp.async from the s8 map at shifted or strided
// pixels (the downsample); or, for conv2, read by ldmatrix at each tap's
// shift from the tile's band of input rows, loaded once into shared memory
// (the wgmma A operand from registers).
enum AMode { kTma = 0, kGather = 1, kHalo = 2 };

struct Conv {
  const int8_t* a;        // (B, Hin, Win, Ca) s8 NHWC
  const int8_t* w;        // (N, K) s8, k = (dy * ks + dx) * Ca + c
  const float* scale;     // (N,)
  const float* bias;      // (N,)
  const float* res;       // kResidual: (M, N) f32 residual (may alias out)
  void* out;              // (M, N): s8 (kRequant), f32 or bf16 (conv3)
  int8_t* q_next;         // conv3: (M, N) s8 quantised copy for the next block, or null
  const float* inv_next;  // (1,) its quantise factor
  int Hin, Win, Ca, Ho, Wo, N, K, ks, stride, pad, M, out_bf16;
};

// One kernel configuration: NWG consumer warpgroups (64 output rows each),
// BN output channels, a ring of S stages of K. conv3 of a later block
// (kResidual), whose K is one or two stages, loads them all up front (S =
// its k stages: three CTAs an SM at one); the others refill a stage S - 2
// stages ahead.
template <int EPI, int AMODE, int NWG, int BN, int S>
struct Cfg {
  static constexpr int BM = 64 * NWG, T = 128 * NWG, ACC = BN / 2;
  static constexpr int P = EPI == kResidual ? S : S - 2;  // stages loaded ahead
  static constexpr int A_BYTES = AMODE == kHalo ? 0 : BM * kKB, B_BYTES = BN * kKB;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // Padded row pitches of the epilogue tiles (bytes): each keeps the
  // accumulator layout's stores free of bank conflicts.
  static constexpr int P_S8 = BN + 16, P_BF16 = 2 * BN + 16, P_F32 = 4 * BN + 32;
  static constexpr int RING = S * STAGE;
  // kResidual: the f32 residual tile (which lands during the products, so
  // not over the ring) and the s8 tile of the next block's input.
  static constexpr int OFF_RES = RING;
  static constexpr int OFF_Q = OFF_RES + (EPI == kResidual ? BM * P_F32 : 0);
  static constexpr int OFF_SB = OFF_Q + (EPI == kResidual ? BM * P_S8 : 0);
  // scale, bias (and the downsample's): BN floats each
  static constexpr int OFF_BAR = OFF_SB + (EPI == kResidualDown ? 16 : 8) * BN;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * (S + 1);
  // kHalo: the band of input rows after everything else, its size the
  // launch's (`halo_bytes`).
  static constexpr int OFF_HALO = (OFF_BAR + 8 * (S + 1) + 1023) & ~1023;
  // kResidualDown's output tiles over the drained ring: f32 (or bf16), s8.
  static constexpr int OFF_QD = BM * P_F32;
  static_assert(P >= 1, "the ring needs a stage in flight");
  static_assert(SMEM <= 232448, "over the block's shared memory");
  static_assert(BM * (EPI == kRequant ? P_S8 : EPI == kResidual ? P_BF16 : P_F32 + P_S8) <= RING,
                "epilogue tiles");
};

__device__ __forceinline__ float epi(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// clip(rint(v), +-127), rint half to even as jnp.round / torch.round. The
// clip goes first (it commutes with rint at these bounds, and takes a NaN to
// -127 as before), then adding 1.5 * 2^23 rounds to an integer half to even
// in the low mantissa bits: two min/max and an add at the full FP32 rate,
// where rintf and the float-to-int conversion each take the quarter-rate
// conversion pipe, which bounds the epilogue.
__device__ __forceinline__ signed char quant(float v) {
  const float c = fminf(fmaxf(v, -127.0f), 127.0f);
  return (signed char)(__float_as_int(__fadd_rn(c, 12582912.0f)) - 0x4B400000);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbar_wait for a thread whose warpgroup has wgmma in flight: on a lost
// arrival it retires them before it traps, so that ptxas need not inject a
// wait of its own (C7517), which would serialize the products.
__device__ __forceinline__ void mbar_wait_mma(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls > (1 << 22)) {
      wgmma_wait<0>();
      __trap();
    }
  }
}

// Programmatic dependent launch: the conv kernels are launched so that they
// may start before the kernel ahead of them in the stream ends. Before
// `griddep_wait` a kernel reads only its launch's constants (weights, scale,
// bias) and writes only its shared memory; past it, every earlier kernel has
// completed and its writes are visible. `griddep_launch` lets the next one
// start once every CTA of this one has issued it (after its products).
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

#define MHENT_D8(b)                                                                            \
  "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), \
      "+r"(d[b + 6]), "+r"(d[b + 7])
#define MHENT_REGS32                                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define MHENT_REGS64                                                                           \
  MHENT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
               "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
               "%62, %63"

// D (64 x BN s32; register 4 j + r of warp w of the warpgroup, lane 4 g + t
// holds row 16 w + g + 8 (r / 2), column 8 j + 2 t + r % 2) += A B^T over
// one 32-byte K step, A and B K-major s8 in shared memory.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" MHENT_REGS64 "}, %64, %65, p;\n}\n"
      : MHENT_D8(0), MHENT_D8(8), MHENT_D8(16), MHENT_D8(24), MHENT_D8(32), MHENT_D8(40),
        MHENT_D8(48), MHENT_D8(56)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" MHENT_REGS32 "}, %32, %33, p;\n}\n"
      : MHENT_D8(0), MHENT_D8(8), MHENT_D8(16), MHENT_D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// The same with A from registers: the warp's 16 rows x 32 bytes as
// ldmatrix.x4 leaves them (register i: matrix i, rows 0-7 / 8-15 of bytes
// 0-15, then of bytes 16-31).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" MHENT_REGS64
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : MHENT_D8(0), MHENT_D8(8), MHENT_D8(16), MHENT_D8(24), MHENT_D8(32), MHENT_D8(40),
        MHENT_D8(48), MHENT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" MHENT_REGS32
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : MHENT_D8(0), MHENT_D8(8), MHENT_D8(16), MHENT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

#undef MHENT_D8
#undef MHENT_REGS32
#undef MHENT_REGS64

// kHalo's band of input rows for a tile of BM output pixels (whole output
// rows of one image): R = BM / Wo output rows need (R - 1) * stride + 3
// input rows of (Wo - 1) * stride + 3 pixels (the zero border included), all
// Ca channels.
__host__ __device__ __forceinline__ int halo_rows(int bm, const Conv& p) {
  return (bm / p.Wo - 1) * p.stride + 3;
}
__host__ __device__ __forceinline__ int halo_cols(const Conv& p) { return (p.Wo - 1) * p.stride + 3; }

// `rows` rows of `row_bytes` from a shared tile (pitch `src_pitch`) to
// device memory (pitch `dst_pitch`), 16 bytes a thread a step.
template <int T>
__device__ __forceinline__ void store_rows(const unsigned char* src, int src_pitch, void* dst,
                                           size_t dst_pitch, int row_bytes, int rows) {
  unsigned char* out = static_cast<unsigned char*>(dst);
  const int cpr = row_bytes / 16;
  for (int e = threadIdx.x; e < rows * cpr; e += T) {
    const int r = e / cpr, c = e - r * cpr;
    *reinterpret_cast<uint4*>(out + r * dst_pitch + 16 * c) =
        *reinterpret_cast<const uint4*>(src + r * src_pitch + 16 * c);
  }
}

// One convolution, tile (blockIdx.y: BM output pixels, blockIdx.x: BN output
// channels). kResidualDown also runs the downsample `pd` on the same tile:
// its k stages (A gathered from pd.a) come first, into `accd`, then conv3's.
template <int EPI, int AMODE, int NWG, int BN, int S>
__global__ void __launch_bounds__(128 * NWG)
    conv_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_wd, const Conv p, const Conv pd) {
  using C = Cfg<EPI, AMODE, NWG, BN, S>;
  constexpr bool DOWN = EPI == kResidualDown;
  constexpr bool GATHERS = AMODE == kGather || DOWN;  // cp.async gathers a stage
  constexpr bool HALO = AMODE == kHalo;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1,024 bytes
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + C::OFF_BAR, res_bar = full + 8 * S;
  float* s_scale = reinterpret_cast<float*>(smem + C::OFF_SB);
  float* s_bias = s_scale + BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const int rows_valid = min(C::BM, p.M - m0);
  // k stages: the downsample's (kResidualDown) then the convolution's.
  const int kd = DOWN ? pd.K / kKB : 0, nk = kd + p.K / kKB;

  // The gather: this thread copies 16-byte piece `chunk` of rows tid / 8 +
  // T / 8 * i of each A stage.
  const Conv& gs = DOWN ? pd : p;
  const int chunk = tid & 7;
  const int8_t* a_img[4];
  int a_iy[4], a_ix[4];
  bool a_ok[4];
  if (GATHERS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + (tid >> 3) + (C::T / 8) * i;
      a_ok[i] = m < gs.M;
      const int mm = a_ok[i] ? m : 0;
      const int hw = gs.Ho * gs.Wo;
      const int bimg = mm / hw, rem = mm - bimg * hw;
      const int oy = rem / gs.Wo, ox = rem - oy * gs.Wo;
      a_img[i] = gs.a + (size_t)bimg * gs.Hin * gs.Win * gs.Ca;
      a_iy[i] = oy * gs.stride - gs.pad;
      a_ix[i] = ox * gs.stride - gs.pad;
    }
  }

  // Stage v's source: AMODE, or for kResidualDown the gather for the
  // downsample's stages and TMA for conv3's.
  auto mode = [&](int v) { return DOWN ? (v < kd ? kGather : kTma) : AMODE; };
  const CUtensorMap* map_a = &tm_a;
  // kHalo walks K chunk-major (the nine taps of 128 channels, then the next
  // 128): stage v is tap v % 9 of chunk v / 9, weight column (tap * Ca / 128
  // + chunk) * 128; the integer sums do not depend on the order.
  const int nch = p.Ca / kKB;
  auto kcol = [&](int v) { return HALO ? (v % 9) * nch + v / 9 : DOWN && v < kd ? v : v - kd; };
  // A stage's weights (and the byte count of the whole stage) ...
  auto load_w = [&](int stage, int v) {
    if (tid == 0) {
      const uint32_t sa = base + stage * C::STAGE, bar = full + 8 * stage;
      const bool down = DOWN && v < kd;
      mbar_expect_tx(bar, C::B_BYTES + (mode(v) == kTma ? C::A_BYTES : 0));
      tma_load(sa + C::A_BYTES, down ? &tm_wd : &tm_w, kcol(v) * kKB, n0, bar);
    }
  };
  // ... and its activations (kHalo: none; the band is loaded once).
  auto load_a = [&](int stage, int v) {
    if (HALO) return;
    const uint32_t sa = base + stage * C::STAGE;
    if (mode(v) == kTma) {
      if (tid == 0) tma_load(sa, map_a, (v - kd) * kKB, m0, full + 8 * stage);
      return;
    }
    const int k0 = v * kKB, tap = k0 / gs.Ca, c0 = k0 - tap * gs.Ca;
    const int dy = tap / gs.ks, dx = tap - dy * gs.ks;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 3) + (C::T / 8) * i;
      const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
      const bool ok = a_ok[i] && iy >= 0 && iy < gs.Hin && ix >= 0 && ix < gs.Win;
      const int8_t* src =
          ok ? a_img[i] + ((size_t)iy * gs.Win + ix) * gs.Ca + c0 + chunk * 16 : gs.a;
      cp_async16(sa + row * kKB + ((chunk ^ (row & 7)) << 4), src, ok);
    }
  };

  // Before the kernel ahead ends: the barriers (thread 0 arms them itself;
  // the others wait on them only after the block barrier in the k loop), the
  // first stages' weights, scale and bias. Then, past griddep_wait, the
  // first stages' activations and the residual tile (one bulk copy a row),
  // which lands while the products run.
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int s = 0; s < C::P; ++s)
    if (s < nk) load_w(s, s);
  for (int i = tid; i < BN; i += C::T) {
    s_scale[i] = p.scale[n0 + i];
    s_bias[i] = p.bias[n0 + i];
    if (DOWN) {
      s_scale[2 * BN + i] = pd.scale[n0 + i];
      s_bias[2 * BN + i] = pd.bias[n0 + i];
    }
  }
  const bool has_q = EPI != kRequant && p.q_next != nullptr;
  const float inv_next = has_q ? *p.inv_next : 0.0f;
  griddep_wait();
#pragma unroll
  for (int s = 0; s < C::P; ++s) {
    if (s < nk) load_a(s, s);
    if (GATHERS) cp_async_commit();
  }
  // kHalo: the tile's band of input rows, one 16-byte piece a copy
  // (zero-filled past the image), pixel-major with the 16-byte pieces of
  // each 128-channel chunk swizzled by the band column / stride; one
  // cp.async group a chunk, so that the first chunk's stages need not wait
  // for the others.
  const int hcols = HALO ? halo_cols(p) : 0;
  const uint32_t halo = base + C::OFF_HALO;
  if (HALO) {
    const int hw = p.Ho * p.Wo, bimg = m0 / hw, oy0 = (m0 - bimg * hw) / p.Wo;
    const int iy0 = oy0 * p.stride - p.pad, pieces = halo_rows(C::BM, p) * hcols * 8;
    const int8_t* img = p.a + (size_t)bimg * p.Hin * p.Win * p.Ca;
    for (int cc = 0; cc < nch; ++cc) {
      for (int e = tid; e < pieces; e += C::T) {
        const int pix = e >> 3, piece = e & 7;
        const int hr = pix / hcols, hc = pix - hr * hcols;
        const int iy = iy0 + hr, ix = hc - p.pad;
        const bool ok = iy >= 0 && iy < p.Hin && ix >= 0 && ix < p.Win;
        const int8_t* src =
            ok ? img + ((size_t)iy * p.Win + ix) * p.Ca + cc * kKB + piece * 16 : p.a;
        cp_async16(halo + (pix * nch + cc) * kKB + ((piece ^ ((hc / p.stride) & 7)) << 4), src,
                   ok);
      }
      cp_async_commit();
    }
  }
  if (EPI == kResidual && warp == 0) {
    if (lane == 0) mbar_expect_tx(res_bar, (uint32_t)rows_valid * BN * 4);
    __syncwarp();
    for (int r = lane; r < rows_valid; r += 32)
      bulk_load(base + C::OFF_RES + r * C::P_F32, p.res + (size_t)(m0 + r) * p.N + n0, BN * 4,
                res_bar);
  }

  int acc[C::ACC], accd[DOWN ? C::ACC : 1];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0;
  fence_regs<C::ACC>(acc);
  if constexpr (DOWN) {
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) accd[i] = 0;
    fence_regs<C::ACC>(accd);
  }
  const int wg = warp / 4;
  // Stage v: its data in, the stage S - 2 ahead requested, its products
  // issued into `d`, the previous stage's retired.
  auto step = [&](auto& d, int v) {
    const int stage = v % S;
    if (GATHERS) {
      cp_async_wait<C::P - 1>();  // this thread's pieces of stage v landed
      fence_proxy_async();        // ... and are visible to wgmma
    }
    // Every thread's pieces are in; every warpgroup has retired the
    // products of stage v - 2, whose slot the next load refills.
    __syncthreads();
    if (v + C::P < nk) {
      load_w((v + C::P) % S, v + C::P);
      load_a((v + C::P) % S, v + C::P);
    }
    if (GATHERS) cp_async_commit();
    mbar_wait_mma(full + 8 * stage, (v / S) & 1);
    const uint32_t sa = base + stage * C::STAGE;
    const uint64_t da = sw128_desc(sa + wg * 64 * kKB), db = sw128_desc(sa + C::A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKB / 32; ++kk) wgmma_s8(d, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
  };
  // kHalo: this lane's row of an x4 load is tile pixel 64 wg + 16 (warp %
  // 4) + r; stage v's A fragments (tap v % 9 of chunk v / 9, one x4 load a
  // k32 step) come by ldmatrix from the band at the tap's shift.
  const int hr_px = (64 * wg + 16 * (warp & 3) + (lane & 7) + ((lane >> 3) & 1) * 8);
  const int h_oy = hr_px / p.Wo, h_ox = hr_px - h_oy * p.Wo;
  auto frags = [&](uint32_t (&a)[kKB / 32][4], int v) {
    const int tap = v % 9, cc = v / 9, dy = tap / 3, dx = tap - dy * 3;
    const int hc = h_ox * p.stride + dx, key = (hc / p.stride) & 7;
    const uint32_t row = halo + (((h_oy * p.stride + dy) * hcols + hc) * nch + cc) * kKB;
#pragma unroll
    for (int kk = 0; kk < kKB / 32; ++kk)
      ldsm_x4(a[kk], row + (((2 * kk + (lane >> 4)) ^ key) << 4));
  };
  // kHalo's stage v: the weights' stage in, the next requested, the
  // products issued from fragments `a`; once the previous stage's products
  // have retired, stage v + 1's fragments are loaded into `an`, while these
  // run. A chunk's first stage waits for its part of the band.
  auto step_halo = [&](auto& d, uint32_t (&a)[kKB / 32][4], uint32_t (&an)[kKB / 32][4],
                       int v) {
    const int stage = v % S;
    __syncthreads();  // every warpgroup has retired stage v - 2's products
    if (v + C::P < nk) load_w((v + C::P) % S, v + C::P);
    mbar_wait_mma(full + 8 * stage, (v / S) & 1);
    const uint64_t db = sw128_desc(base + stage * C::STAGE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKB / 32; ++kk) wgmma_s8(d, a[kk], db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    if (v + 1 < nk) {
      if ((v + 1) % 9 == 0) {  // the next chunk's band
        cp_async_wait<0>();
        __syncthreads();
      }
      frags(an, v + 1);
    }
  };
  if constexpr (HALO) {
    uint32_t fa[kKB / 32][4], fb[kKB / 32][4];
    if (nch > 1) cp_async_wait<1>();  // the first chunk's band landed
    else cp_async_wait<0>();
    __syncthreads();
    frags(fa, 0);
    for (int v = 0; v < nk; v += 2) {
      step_halo(acc, fa, fb, v);
      if (v + 1 < nk) step_halo(acc, fb, fa, v + 1);
    }
  } else {
    if constexpr (DOWN)
      for (int v = 0; v < kd; ++v) step(accd, v);
    for (int v = kd; v < nk; ++v) step(acc, v);
  }
  wgmma_wait<0>();
  fence_regs<C::ACC>(acc);
  if constexpr (DOWN) fence_regs<C::ACC>(accd);
  if (GATHERS) cp_async_wait<0>();
  griddep_launch();
  __syncthreads();  // the ring is drained: the epilogue may lay its tiles over it

  // Epilogue: thread (warp, lane 4 g + t) holds rows row0 and row0 + 8 of
  // the tile, columns 8 j + 2 t, + 1; it converts them into shared tiles,
  // which the CTA then writes out by rows.
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * (warp & 3) + g;
  const size_t out_at = (size_t)m0 * p.N + n0;  // the tile's first output element
  if constexpr (EPI == kRequant) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(s_scale + c);
      const float2 bi = *reinterpret_cast<const float2*>(s_bias + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = epi(acc[4 * j + 2 * h], sc.x, bi.x);
        const float y1 = epi(acc[4 * j + 2 * h + 1], sc.y, bi.y);
        *reinterpret_cast<char2*>(smem + (row0 + 8 * h) * C::P_S8 + c) =
            make_char2(quant(fmaxf(y0, 0.0f)), quant(fmaxf(y1, 0.0f)));
      }
    }
    __syncthreads();
    store_rows<C::T>(smem, C::P_S8, static_cast<int8_t*>(p.out) + out_at, (size_t)p.N, BN,
                     rows_valid);
  } else {
    // y = relu(conv3 + residual): the residual tile in place (kResidual:
    // the new carry overwrites it), or the downsample's affine of accd and
    // an f32 tile over the ring (kResidualDown); a bf16 output goes to a
    // tile over the ring; the next block's s8 input beside it.
    unsigned char* res = smem + (DOWN ? 0 : C::OFF_RES);
    unsigned char* qn = smem + (DOWN ? C::OFF_QD : C::OFF_Q);
    if (!DOWN) mbar_wait(res_bar, 0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(s_scale + c);
      const float2 bi = *reinterpret_cast<const float2*>(s_bias + c);
      float2 scd = sc, bid = bi;
      if (DOWN) {
        scd = *reinterpret_cast<const float2*>(s_scale + 2 * BN + c);
        bid = *reinterpret_cast<const float2*>(s_bias + 2 * BN + c);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const float y0 = epi(acc[4 * j + 2 * h], sc.x, bi.x);
        const float y1 = epi(acc[4 * j + 2 * h + 1], sc.y, bi.y);
        float2* rp = reinterpret_cast<float2*>(res + row * C::P_F32 + 4 * c);
        float2 r;
        if constexpr (DOWN)
          r = make_float2(epi(accd[4 * j + 2 * h], scd.x, bid.x),
                          epi(accd[4 * j + 2 * h + 1], scd.y, bid.y));
        else
          r = *rp;
        const float o0 = fmaxf(__fadd_rn(y0, r.x), 0.0f);
        const float o1 = fmaxf(__fadd_rn(y1, r.y), 0.0f);
        if (p.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(smem + row * C::P_BF16 + 2 * c) =
              __floats2bfloat162_rn(o0, o1);
        else
          *rp = make_float2(o0, o1);
        if (has_q)
          *reinterpret_cast<char2*>(qn + row * C::P_S8 + c) =
              make_char2(quant(__fmul_rn(o0, inv_next)), quant(__fmul_rn(o1, inv_next)));
      }
    }
    __syncthreads();
    if (p.out_bf16)
      store_rows<C::T>(smem, C::P_BF16, static_cast<__nv_bfloat16*>(p.out) + out_at,
                       (size_t)p.N * 2, BN * 2, rows_valid);
    else
      store_rows<C::T>(res, C::P_F32, static_cast<float*>(p.out) + out_at, (size_t)p.N * 4,
                       BN * 4, rows_valid);
    if (has_q)
      store_rows<C::T>(qn, C::P_S8, p.q_next + out_at, (size_t)p.N, BN, rows_valid);
  }
}

// The stage input quantised with conv1's factor: 8 values a thread.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                                int8_t* __restrict__ xq, size_t n8) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float s = *inv;
  float v[8];
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float4 lo = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 hi = reinterpret_cast<const float4*>(x)[2 * i + 1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
  char4 q0 = make_char4(quant(__fmul_rn(v[0], s)), quant(__fmul_rn(v[1], s)),
                        quant(__fmul_rn(v[2], s)), quant(__fmul_rn(v[3], s)));
  char4 q1 = make_char4(quant(__fmul_rn(v[4], s)), quant(__fmul_rn(v[5], s)),
                        quant(__fmul_rn(v[6], s)), quant(__fmul_rn(v[7], s)));
  reinterpret_cast<char4*>(xq)[2 * i] = q0;
  reinterpret_cast<char4*>(xq)[2 * i + 1] = q1;
}

// A grid of at most one wave asks for more than half an SM's shared memory,
// so that the scheduler spreads it one CTA an SM instead of packing two CTAs
// on half of the SMs.
constexpr int kHalfSm = 116 * 1024;

template <int EPI, int AMODE, int NWG, int BN, int S>
int launch_conv(const Conv& p, const Conv& pd, int sms, cudaStream_t stream) {
  using C = Cfg<EPI, AMODE, NWG, BN, S>;
  CUtensorMap tm_a{}, tm_w{}, tm_wd{};
  if (!make_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.w, p.K, p.N, kKB, BN) ||
      (AMODE == kTma && !make_map_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.a, p.Ca, p.M,
                                     kKB, C::BM)) ||
      (EPI == kResidualDown &&
       !make_map_2d(&tm_wd, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, pd.w, pd.K, pd.N, kKB, BN)))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_kernel<EPI, AMODE, NWG, BN, S>;
  const dim3 grid(p.N / BN, (p.M + C::BM - 1) / C::BM);
  int need = C::SMEM;
  if (AMODE == kHalo) {
    // The band needs tiles of whole output rows of one image, at most two
    // chunks of channels (one cp.async group each), and must fit.
    need = 1024 + C::OFF_HALO + halo_rows(C::BM, p) * halo_cols(p) * p.Ca;
    if (C::BM % p.Wo != 0 || (p.Ho * p.Wo) % C::BM != 0 || p.ks != 3 || p.Ca > 2 * kKB ||
        need > 232448)
      return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)(grid.x * grid.y) <= sms ? std::max(need, kHalfSm) : need;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_a, tm_w, tm_wd, p, pd);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tiles of one convolution on `sms` SMs. conv1 and conv2: 128 x 128
// where that gives about a wave (a ring of three stages, two CTAs an SM,
// where K is at most four stages), else 64 x 128, else 64 x 64. conv3: 64 x
// 128 (the downsample fused on block 0).
template <int EPI, int AMODE>
int conv(const Conv& p, const Conv& pd, int sms, cudaStream_t stream) {
  if (p.K % kKB != 0 || p.N % 128 != 0 || p.Ca % kKB != 0 || p.M < 1 ||
      (EPI == kResidualDown && (pd.K % kKB != 0 || pd.Ca % kKB != 0 || pd.M != p.M ||
                                pd.N != p.N)))
    return (int)cudaErrorInvalidValue;
  const int ktiles = p.K / kKB;
  auto wave = [&](int bm, int bn) {
    return (long)((p.M + bm - 1) / bm) * (p.N / bn) * 10 >= (long)sms * 9;
  };
  if constexpr (EPI == kRequant) {
    if (wave(128, 128))
      return ktiles <= 4 ? launch_conv<EPI, AMODE, 2, 128, 3>(p, pd, sms, stream)
                         : launch_conv<EPI, AMODE, 2, 128, 4>(p, pd, sms, stream);
    return wave(64, 128) ? launch_conv<EPI, AMODE, 1, 128, 4>(p, pd, sms, stream)
                         : launch_conv<EPI, AMODE, 1, 64, 6>(p, pd, sms, stream);
  } else if constexpr (EPI == kResidual) {
    if (ktiles > 2) return (int)cudaErrorInvalidValue;
    return ktiles == 1 ? launch_conv<EPI, AMODE, 1, 128, 1>(p, pd, sms, stream)
                       : launch_conv<EPI, AMODE, 1, 128, 2>(p, pd, sms, stream);
  } else {
    return launch_conv<EPI, AMODE, 1, 128, 4>(p, pd, sms, stream);
  }
}

Conv make_conv(const void* a, const void* w, const void* scale, const void* bias, int B,
               int Hin, int Win, int Ca, int N, int ks, int stride, int pad) {
  Conv p{};
  p.a = static_cast<const int8_t*>(a);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.Hin = Hin;
  p.Win = Win;
  p.Ca = Ca;
  p.Ho = (Hin + 2 * pad - ks) / stride + 1;
  p.Wo = (Win + 2 * pad - ks) / stride + 1;
  p.N = N;
  p.K = ks * ks * Ca;
  p.ks = ks;
  p.stride = stride;
  p.pad = pad;
  p.M = B * p.Ho * p.Wo;
  return p;
}

}  // namespace

// One bottleneck of stage 2 or 3. H x W is the block's input size (the
// stage input's on block 0, which strides by 2; the output's after).
//   x:      block 0 only, the (B, H, W, cin) stage input, bf16 (x_bf16) or f32
//   xq:     (B, H, W, cin_j) s8 block input: block 0 writes it from x with
//           inv_in; later blocks read what the block before emitted
//   w1, s1, b1: conv1 (width, cin_j) s8, its scale and bias (conv2's inv_sa folded)
//   w2, s2, b2: conv2 (width, 9 width) s8 [out][tap * width + in] (conv3's folded)
//   w3, s3, b3: conv3 (cout, width) s8
//   wd, sd, bd: block 0's downsample (cout, cin) s8, run inside block 0's conv3
//   h1, h2: s8 scratch, (B, H, W, width) and (B, Ho, Wo, width)
//   carry:  (B, Ho, Wo, cout) f32, the residual of blocks >= 1 and this
//           block's output unless it is last
//   out:    the block's output: carry, or the stage's (bf16 if out_bf16)
//   xq_next, inv_next: the next block's s8 input and factor, or null (last)
extern "C" int mhent_stage2_int8_block(
    const void* x, void* xq, const void* inv_in, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, const void* w3,
    const void* s3, const void* b3, const void* wd, const void* sd, const void* bd, void* h1,
    void* h2, void* carry, void* out, void* xq_next, const void* inv_next, int x_bf16,
    int out_bf16, int B, int H, int W, int cin, int width, int cout, int first,
    void* stream) {
  if (B < 1 || H < 2 || W < 2 || cin % kKB != 0 || width % 128 != 0 || cout % 128 != 0 ||
      (first && (x == nullptr || wd == nullptr)) || (xq_next != nullptr && inv_next == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err, dev, sms;
  if ((err = (int)cudaGetDevice(&dev)) != 0 ||
      (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return err;
  if (first) {
    const size_t n8 = (size_t)B * H * W * cin / 8;
    const unsigned blocks = (unsigned)((n8 + 255) / 256);
    if (x_bf16)
      quantize_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(inv_in),
          static_cast<int8_t*>(xq), n8);
    else
      quantize_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(inv_in),
                                                    static_cast<int8_t*>(xq), n8);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  const int stride = first ? 2 : 1;
  Conv c1 = make_conv(xq, w1, s1, b1, B, H, W, cin, width, 1, 1, 0);
  c1.out = h1;
  if ((err = conv<kRequant, kTma>(c1, c1, sms, s)) != 0) return err;
  Conv c2 = make_conv(h1, w2, s2, b2, B, H, W, width, width, 3, stride, 1);
  c2.out = h2;
  if ((err = conv<kRequant, kHalo>(c2, c2, sms, s)) != 0) return err;
  Conv c3 = make_conv(h2, w3, s3, b3, B, c2.Ho, c2.Wo, width, cout, 1, 1, 0);
  c3.res = static_cast<const float*>(carry);
  c3.out = out;
  c3.out_bf16 = out_bf16;
  c3.q_next = static_cast<int8_t*>(xq_next);
  c3.inv_next = static_cast<const float*>(inv_next);
  if (first) {
    const Conv cd = make_conv(xq, wd, sd, bd, B, H, W, cin, cout, 1, 2, 0);
    return conv<kResidualDown, kTma>(c3, cd, sms, s);
  }
  return conv<kResidual, kTma>(c3, c3, sms, s);
}
