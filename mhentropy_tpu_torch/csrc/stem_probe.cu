// Cost probe of an im2col + tensor-core GEMM ResNet stem for Hopper (sm_90a),
// with four compile-time cuts of one kernel body (rolls, im2col, gemm, full).
//
// Replaces tools/stem_probe.py::probe_kernel_step (the Pallas kernel launched
// at :84) and tools/stem_cost_attrib.py::make_step (launched at :110). Those
// probes timed a stem written as 21 rolled/masked parity-plane taps, an
// im2col copy into a (152, 16384) K-major matrix and one (64, 152) x
// (152, 16384) bf16 GEMM, cut after each part, to find where a fused stem's
// time goes. The shipped card stem (`stem.cu`) is an implicit GEMM; this
// probe asks what the im2col formulation costs on the H100.
//
// The function, per image b, with spec t = (plane_t, shift_t) for t < 21:
//   R[t, r, j]        = bf16(x[b, plane_t, r, j - shift_t]) (0 outside [0, 128))
//   Bm[7 t + k, 128 i + j] = R[t, 2 i + 1 + k, j]   (k < 7; rows 147-159 zero)
//   acc               = a @ Bm                   (f32 sums, K padded to 160)
//   rolls:  out[f, j] = sum_t R[t, f, j]        (rows 0-63 of R)
//   im2col: out       = Bm[0:64, :128] + Bm[64:128, :128] + Bm[88:152, :128]
//   gemm:   out[f, j] = sum_i acc[f, 128 i + j]
//   full:   BN (g, b tiles) + ReLU on acc, max over conv rows 2p-1..2p+1 and
//           columns j-1..j+1, out[:, :64] = sum_p s @ bf16(max)^T.
//
// What bounds it on the H100: the GEMM is 2 * 64 * 152 * 16384 flops an
// image (10.2 GFLOP at B = 32, 10 us at the bf16 peak); the planes are 26 MB
// in f32 (8 us at 3.35 TB/s). Nothing of Bm or acc need touch device memory.
// Under those, shared memory: a conv row's Bm^T (40 KB) is written once by
// the builders and read once by the products.
//
// Design: a block owns a band of `band` consecutive conv rows of one image
// (32 at B = 32 and 128 conv rows: 128 blocks, one wave) and walks it one
// conv row (N = 128 columns) at a time, warp-specialised:
// - Planes read once a block. Builder thread 0 streams each pair of plane
//   rows (6 planes x 2 rows) into a ring slot with one 3D TMA box, 16 bytes
//   wider than a row: the tensor map's zero fill past column 127 is each
//   ring row's right margin and the next row's left one, so the taps' lane
//   shifts need no edge masks. (A bulk copy a plane row, twelve a pair, held
//   the stream to the copies' issue.)
// - Taps and im2col in one pass. Builder thread j of each of two builder
//   warpgroups (a column each) reads x[plane_t, 2 i + 1 + k, j - shift_t]
//   from the ring, rounds it to bf16 and stores 8 K-values as one 16-byte
//   chunk of Bm^T (128 columns x 160 K, K-major, 128-byte swizzle) into one
//   of two stages; the two warpgroups split a conv row's chunks.
// - Products on wgmma. The consumer warpgroup issues 10 m64n128k16 a conv
//   row, `a` (64 x 160, loaded once a block) and Bm^T both from shared
//   memory. gemm sums the band's conv rows in registers and adds the sum to
//   the output with 16-byte reductions at the band's end. (Summed in the
//   accumulators instead, across 320 k-steps, the band's sum drifted to 70 %
//   of the cut's 1e-5 tolerance: the products' accumulation truncates.)
// - full's epilogue in registers: BN (g, b from shared memory in fragment
//   order) and ReLU on the accumulators, rounded to bf16 pairs (rounding is
//   monotone, so the max of rounded values is the rounded max), the max over
//   conv rows against the carried max of the rows before, the max over
//   columns by quad shuffles, and s @ max^T as 8 m64n64k16 with the pooled
//   max as the register A operand, summed over the band's pooled rows. A band
//   after the first also computes the conv row before it, for the pooled row
//   that straddles two bands.
// - The cuts nest: rolls streams the planes and sums the taps of the plane
//   rows < 64 (its output); im2col also builds every conv row's Bm^T; gemm
//   also runs the products; full also the epilogue. Every cut reserves the
//   same shared memory (one block an SM), so a cut changes the work and not
//   the occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_tma.cuh"
#include "mma_sm80.cuh"

namespace {

constexpr int kF = 64;                // filters
constexpr int kLanes = 128;           // plane columns (conv output columns)
constexpr int kTaps = 21;             // (kx, c) groups
constexpr int kK = 152;               // a's K (147 taps + 5 zero columns)
constexpr int kKReal = 7 * kTaps;     // 147
constexpr int kChunks = 20;           // 16-byte chunks of 8 K-values: K padded to 160
constexpr int kBuilt = 19;            // chunks a conv row rebuilds (chunk 19 is all zero)
constexpr int kKSteps = 10;           // k16 steps a conv row
constexpr int kBuilderGroups = 2;     // builder warpgroups (they split a conv row's chunks)
constexpr int kBuilders = 128 * kBuilderGroups;
constexpr int kThreads = 128 + kBuilders;  // warpgroup 0: products; then the builders
constexpr int kBandMultiple = 16;

enum Phase { kRolls = 0, kIm2col = 1, kGemm = 2, kFull = 3 };

// Shared memory, in bytes from a 1,024-aligned base. Bm^T stage s holds K
// 0-127 in two 16 KB atoms (128 rows of 128 bytes each); K 128-159 of both
// stages share one atom, stage s at byte 64 s of each row.
constexpr int kAtomB = 128 * 128;
constexpr int kStageB = 2 * kAtomB;
constexpr int kOffTail = 2 * kStageB;
constexpr int kAtomA = 64 * 128;
constexpr int kOffA = kOffTail + kAtomB;    // a: 64 x 160, three atoms
constexpr int kOffS = kOffA + 3 * kAtomA;   // s: 64 x 128, two atoms
constexpr int kOffG = kOffS + 2 * kAtomA;   // g, then b: 64 x 128 f32 in fragment order
constexpr int kOffRing = kOffG + 2 * kF * kLanes * 4;

// The ring of plane-row pairs: slot s holds 128 zero bytes, then the TMA box
// (6 planes x 2 rows x kRow elements, the last 16 bytes of each row zero).
template <typename TIn>
struct Ring {
  static constexpr int kSlots = 6;  // a conv row reads 4
  static constexpr int kRow = kLanes + 16 / (int)sizeof(TIn);
  static constexpr int kRowBytes = kRow * (int)sizeof(TIn);
  static constexpr int kBoxBytes = 12 * kRowBytes;
  static constexpr int kSlotBytes = 128 + (kBoxBytes + 127) / 128 * 128;
  static constexpr int kOffBars = kOffRing + kSlots * kSlotBytes;
  static constexpr int kSmem = 1024 + kOffBars + 8 * (kSlots + 4);
  static_assert(kSmem <= 232448, "over the block's shared memory");
};

// K index kk = 7 t + k of Bm -> where its value lies in the ring: the pair
// (0-3) of the conv row's window, and the element offset from that slot's
// box (lane j adds j). Row 2 i + 1 + k is pair (1 + k) / 2, row (1 + k) % 2.
__host__ __device__ constexpr int tap_pair(int kk) { return (1 + kk % 7) / 2; }
__host__ __device__ constexpr int tap_shift(int t) {
  return t / 3 <= 4 ? (4 - t / 3) / 2 : -((t / 3 - 3) / 2);  // (4 - kx) // 2
}
__host__ __device__ constexpr int tap_plane(int t) { return ((t / 3 + 1) % 2) * 3 + t % 3; }
template <typename TIn>
__host__ __device__ constexpr int tap_offset(int t, int row) {
  return (tap_plane(t) * 2 + row) * Ring<TIn>::kRow - tap_shift(t);
}

__device__ __forceinline__ uint32_t pack_taps(float lo, float hi) { return pack_bf16(lo, hi); }
__device__ __forceinline__ uint32_t pack_taps(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ float tap_value(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float tap_value(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ void red_add4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// Byte offset of 16-byte chunk c (K 8 c .. 8 c + 7) of column n in Bm^T stage s.
__device__ __forceinline__ uint32_t bm_chunk(int s, int n, int c) {
  return c < 16 ? s * kStageB + (c / 8) * kAtomB + swz(n, c % 8, 128)
                : kOffTail + swz(n, 4 * s + c - 16, 128);
}

// Chunks C0 .. C1 - 1 of column j's Bm^T for the conv row whose 4-pair
// window starts at pair[0]: all loads first, then the 16-byte stores.
template <int C0, int C1, typename TIn>
__device__ __forceinline__ void build_chunks(const TIn* const (&pair)[4], uint32_t dst_base,
                                             int st, int j) {
  uint32_t v[4 * (C1 - C0)];
#pragma unroll
  for (int e = 0; e < 4 * (C1 - C0); ++e) {
    const int k0 = 8 * C0 + 2 * e, k1 = k0 + 1;
    if (k0 >= kKReal) {
      v[e] = 0u;
    } else {
      const TIn lo = pair[tap_pair(k0)][tap_offset<TIn>(k0 / 7, (1 + k0 % 7) % 2)];
      const TIn hi = k1 < kKReal ? pair[tap_pair(k1)][tap_offset<TIn>(k1 / 7, (1 + k1 % 7) % 2)]
                                 : TIn(0.0f);
      v[e] = pack_taps(lo, hi);
    }
  }
#pragma unroll
  for (int c = C0; c < C1; ++c) sts128(dst_base + bm_chunk(st, j, c), v + 4 * (c - C0));
}

#define MHENT_D8(b)                                                                            \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), \
      "+f"(d[b + 6]), "+f"(d[b + 7])
#define MHENT_REGS32                                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define MHENT_REGS64                                                                           \
  MHENT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
               "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "    \
               "%62, %63"

// D (64 x 128; register 4 q + r of warp w, lane 4 g + c holds row 16 w + g +
// 8 (r / 2), column 8 q + 2 c + r % 2) = scale_d * D + A B^T over one k16
// step, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" MHENT_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MHENT_D8(0), MHENT_D8(8), MHENT_D8(16), MHENT_D8(24), MHENT_D8(32), MHENT_D8(40),
        MHENT_D8(48), MHENT_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, the same fragment) += A B^T over one k16 step, A from registers
// (register r of lane 4 g + c: rows g + 8 (r % 2), columns 2 c + 8 (r / 2),
// +1, of the warp's 16 rows), B K-major in shared memory.
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" MHENT_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MHENT_D8(0), MHENT_D8(8), MHENT_D8(16), MHENT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef MHENT_D8
#undef MHENT_REGS32
#undef MHENT_REGS64

// x (through tm_x): (B, 6, rows, 128) TIn; a: (64, 152) bf16; g, bn_b:
// (64, 128) f32; s: (64, 128) bf16; out: (B, 64, 128) f32, zeroed by the
// caller. Block (band index, image).
template <int PHASE, typename TIn>
__global__ void __launch_bounds__(kThreads, 1)
    stem_probe_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __nv_bfloat16* __restrict__ a, const float* __restrict__ g,
                      const float* __restrict__ bn_b, const __nv_bfloat16* __restrict__ s,
                      float* __restrict__ out, int conv_rows, int band) {
  using RingT = Ring<TIn>;
  constexpr int kRing = RingT::kSlots;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t ring = base + kOffRing;
  const uint32_t ring_full = base + RingT::kOffBars;  // kRing barriers
  const uint32_t bm_full = ring_full + 8 * kRing;     // 2
  const uint32_t bm_empty = bm_full + 16;             // 2

  const int b = blockIdx.y, tid = threadIdx.x;
  const int i0 = blockIdx.x * band, i1 = min(i0 + band, conv_rows);
  const int start = (PHASE == kFull && i0 > 0) ? i0 - 1 : i0;  // full: the straddling row
  const int nrows = i1 - start, npairs = nrows + 3;            // pairs start .. i1 + 2
  float* outb = out + (size_t)b * kF * kLanes;

  if (tid == 0) {
    for (int q = 0; q < kRing; ++q) mbar_init(ring_full + 8 * q, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bm_full + 8 * st, 1);
      mbar_init(bm_empty + 8 * st, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid >= 128) {
    // The zero bytes before each slot's box and Bm^T's all-zero chunk 19, once.
    const int bt = tid - 128;
    const uint32_t zero[4] = {0, 0, 0, 0};
    if (bt < kRing * 8) sts128(ring + (bt / 8) * RingT::kSlotBytes + (bt % 8) * 16, zero);
    if (bt < 128) {
      sts128(base + bm_chunk(0, bt, kChunks - 1), zero);
      sts128(base + bm_chunk(1, bt, kChunks - 1), zero);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // Pair q (plane rows 2 (start + q), +1 of the image's 6 planes) into its slot.
  auto load_pair = [&](int q) {
    const uint32_t bar = ring_full + 8 * (q % kRing);
    mbar_expect_tx(bar, RingT::kBoxBytes);
    tma_load_3d(ring + (q % kRing) * RingT::kSlotBytes + 128, &tm_x, 0, 2 * (start + q), 6 * b,
                bar);
  };

  if (tid >= 128) {
    // ---- builders: thread j of each builder warpgroup owns column j ----
    const int bt = tid - 128, j = bt % 128, grp = bt / 128;
    if (bt == 0)
      for (int q = 0; q < kRing && q < npairs; ++q) load_pair(q);
    const TIn* ring_p = reinterpret_cast<const TIn*>(smem + kOffRing + 128) + j;
    for (int l = 0; l < nrows; ++l) {
      for (int q = l == 0 ? 0 : l + 3; q <= l + 3; ++q)
        mbar_wait(ring_full + 8 * (q % kRing), (q / kRing) & 1);
      const TIn* pair[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        pair[u] = ring_p + ((l + u) % kRing) * (RingT::kSlotBytes / (int)sizeof(TIn));
      const int st = l & 1;
      if (PHASE == kRolls) {
        // This band's plane rows 2 m, 2 m + 1 (m = start + l) below 64: their tap sums.
        for (int h = grp; h < 2; h += kBuilderGroups) {
          const int r = 2 * (start + l) + h;
          if (r < kF) {
            float v = 0.0f;
#pragma unroll
            for (int t = 0; t < kTaps; ++t)
              v = __fadd_rn(v, tap_value(pair[0][tap_offset<TIn>(t, h)]));
            outb[r * kLanes + j] = v;
          }
        }
      } else {
        if (PHASE >= kGemm && l >= 2) mbar_wait(bm_empty + 8 * st, ((l >> 1) & 1) ^ 1);
        // Bm^T's chunks 0-18 of column j, split between the builder warpgroups.
        constexpr int kSplit = (kBuilt + kBuilderGroups - 1) / kBuilderGroups;
        if constexpr (kBuilderGroups == 1)
          build_chunks<0, kBuilt, TIn>(pair, base, st, j);
        else if (grp == 0)
          build_chunks<0, kSplit, TIn>(pair, base, st, j);
        else
          build_chunks<kSplit, kBuilt, TIn>(pair, base, st, j);
        fence_proxy_async();
      }
      named_sync(1, kBuilders);  // every builder is done with pair l and with stage st
      if (bt == 0) {
        if (PHASE >= kGemm) mbar_arrive(bm_full + 8 * st);
        if (l + kRing < npairs) {
          fence_proxy_async();
          load_pair(l + kRing);
        }
      }
      if (PHASE == kIm2col && start + l == 0) {
        // The output reads conv row 0's Bm: rows f, 64 + f and 88 + f of column j.
        auto at = [&](int kk) {
          return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              smem + bm_chunk(st, j, kk / 8) + 2 * (kk % 8)));
        };
        for (int f = grp; f < kF; f += kBuilderGroups) {
          float v = 0.0f;
          v = __fadd_rn(v, at(f));
          v = __fadd_rn(v, at(64 + f));
          v = __fadd_rn(v, at(kK - 64 + f));
          outb[f * kLanes + j] = v;
        }
      }
    }
    return;
  }
  if (PHASE < kGemm) return;

  // ---- consumer warpgroup ----
  const int warp = tid / 32, lane = tid % 32, c4 = lane & 3;
  const int f0 = 16 * warp + lane / 4, jc = 2 * c4;  // rows f0, f0 + 8; columns 8 q + jc, +1
  // a (64 x 152 -> 160, K-major, swizzled); full: s (64 x 128) and g, b in
  // the accumulators' fragment order. Unrolled, so that the loads overlap.
#pragma unroll
  for (int e = tid; e < kF * kChunks; e += 128) {
    const int f = e / kChunks, c = e % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < kK / 8) val = *reinterpret_cast<const uint4*>(a + f * kK + 8 * c);
    sts128(base + kOffA + (c / 8) * kAtomA + swz(f, c % 8, 128),
           reinterpret_cast<const uint32_t*>(&val));
  }
  if (PHASE == kFull) {
#pragma unroll
    for (int e = tid; e < kF * 16; e += 128) {
      const int r = e / 16, c = e % 16;
      const uint4 val = *reinterpret_cast<const uint4*>(s + r * kLanes + 8 * c);
      sts128(base + kOffS + (c / 8) * kAtomA + swz(r, c % 8, 128),
             reinterpret_cast<const uint32_t*>(&val));
    }
    float4* gs = reinterpret_cast<float4*>(smem + kOffG) + warp * 16 * 32 + lane;
    float4* bs = gs + kF * kLanes / 4;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int o = f0 * kLanes + 8 * q + jc;
      const float2 g0 = *reinterpret_cast<const float2*>(g + o);
      const float2 g1 = *reinterpret_cast<const float2*>(g + o + 8 * kLanes);
      const float2 b0 = *reinterpret_cast<const float2*>(bn_b + o);
      const float2 b1 = *reinterpret_cast<const float2*>(bn_b + o + 8 * kLanes);
      gs[q * 32] = make_float4(g0.x, g0.y, g1.x, g1.y);
      bs[q * 32] = make_float4(b0.x, b0.y, b1.x, b1.y);
    }
  }
  fence_proxy_async();
  named_sync(2, 128);

  const float4* gs = reinterpret_cast<const float4*>(smem + kOffG) + warp * 16 * 32 + lane;
  const float4* bs = gs + kF * kLanes / 4;
  // full: the pooled max so far as bf16 pairs (register 2 q + h: row f0 + 8 h,
  // columns 8 q + jc, +1) and the sum of s @ max^T (the accumulators'
  // fragment of its (64 filters x 64 s-rows) transpose).
  float acc[64], tot[32], sum[64];
  uint32_t mx[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) sum[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) tot[e] = 0.0f;
  fence_regs<32>(tot);
  constexpr uint32_t kNegInf2 = 0xff80ff80u;  // two bf16 -inf

  for (int l = 0; l < nrows; ++l) {
    const int st = l & 1, i = start + l;
    mbar_wait(bm_full + 8 * st, (l >> 1) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const uint64_t da = sw128_desc(base + kOffA + (ks / 4) * kAtomA + (ks % 4) * 32);
      const uint32_t bm = ks < 8 ? base + st * kStageB + (ks / 4) * kAtomB + (ks % 4) * 32
                                 : base + kOffTail + 64 * st + (ks - 8) * 32;
      wgmma_n128(acc, da, sw128_desc(bm), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(acc);
    mbar_arrive(bm_empty + 8 * st);
    if (PHASE == kGemm) {
#pragma unroll
      for (int e = 0; e < 64; ++e) sum[e] += acc[e];
      continue;
    }

    // BN + ReLU, rounded to bf16 pairs.
    uint32_t y[32];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float4 gq = gs[q * 32], bq = bs[q * 32];
      y[2 * q] = pack_bf16(fmaxf(__fadd_rn(__fmul_rn(acc[4 * q + 0], gq.x), bq.x), 0.0f),
                           fmaxf(__fadd_rn(__fmul_rn(acc[4 * q + 1], gq.y), bq.y), 0.0f));
      y[2 * q + 1] = pack_bf16(fmaxf(__fadd_rn(__fmul_rn(acc[4 * q + 2], gq.z), bq.z), 0.0f),
                               fmaxf(__fadd_rn(__fmul_rn(acc[4 * q + 3], gq.w), bq.w), 0.0f));
    }
    if ((i & 1) == 0 || l == 0) {
      // Row 2p: the max of rows 2p-1 and 2p so far (row 0 and a band's
      // straddling row start it).
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[e] = l == 0 ? y[e] : max_bf16x2(mx[e], y[e]);
      continue;
    }
    // Row 2p + 1 completes pooled row p: the row max, then the column max
    // over j-1..j+1 by quad shuffles (-inf beyond the image), the A operand
    // of s @ max^T.
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[e] = max_bf16x2(mx[e], y[e]);
    uint32_t pa[32];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w = mx[2 * q + h];  // columns 8 q + jc (low half), +1 (high half)
        // Column 8 q + jc - 1 is the high half of lane c4 - 1's pair (of q - 1
        // for c4 = 0); column 8 q + jc + 2 the low half of lane c4 + 1's (of q + 1
        // for c4 = 3).
        const uint32_t send_l = c4 == 3 ? (q > 0 ? mx[2 * (q - 1) + h] : kNegInf2) : w;
        const uint32_t send_r = c4 == 0 ? (q < 15 ? mx[2 * (q + 1) + h] : kNegInf2) : w;
        const uint32_t from_l = __shfl_sync(0xffffffffu, send_l, (lane & ~3) | ((c4 + 3) & 3));
        const uint32_t from_r = __shfl_sync(0xffffffffu, send_r, (lane & ~3) | ((c4 + 1) & 3));
        pa[4 * (q / 2) + 2 * (q % 2) + h] =
            max_bf16x2(max_bf16x2(__byte_perm(from_l, w, 0x5432), w),
                       __byte_perm(w, from_r, 0x5432));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 8; ++kb)
      wgmma_n64_rs(tot, pa + 4 * kb,
                   sw128_desc(base + kOffS + (kb / 4) * kAtomA + (kb % 4) * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(tot);
    fence_regs<32>(pa);
    // This row starts the next pooled row.
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[e] = y[e];
  }

  if (PHASE == kGemm) {
    // Lanes c4 and c4 ^ 1 trade halves so that each adds four columns of one row.
    const bool even = (c4 & 1) == 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float t0 = __shfl_xor_sync(0xffffffffu, even ? sum[4 * q + 2] : sum[4 * q], 1);
      const float t1 = __shfl_xor_sync(0xffffffffu, even ? sum[4 * q + 3] : sum[4 * q + 1], 1);
      if (even)
        red_add4(outb + f0 * kLanes + 8 * q + jc, sum[4 * q], sum[4 * q + 1], t0, t1);
      else
        red_add4(outb + (f0 + 8) * kLanes + 8 * q + jc - 2, t0, t1, sum[4 * q + 2],
                 sum[4 * q + 3]);
    }
  } else {
    // tot[f][srow] -> out[srow][f], through s's room (its last reader is done).
    named_sync(2, 128);
    float* tt = reinterpret_cast<float*>(smem + kOffS);  // (64 s-rows, 64 filters)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) tt[(8 * q + jc + r % 2) * kF + f0 + 8 * (r / 2)] = tot[4 * q + r];
    named_sync(2, 128);
    for (int e = tid; e < kF * kF / 4; e += 128) {
      const float4 v = reinterpret_cast<const float4*>(tt)[e];
      red_add4(outb + (e / 16) * kLanes + 4 * (e % 16), v.x, v.y, v.z, v.w);
    }
  }
}

template <int PHASE, typename TIn>
cudaError_t launch(const void* x, const void* a, const void* g, const void* bn_b,
                   const void* s, void* out, int B, int rows, int conv_rows, int band,
                   cudaStream_t stream) {
  using RingT = Ring<TIn>;
  CUtensorMap tm_x;
  if (!make_map_3d(&tm_x,
                   sizeof(TIn) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   (int)sizeof(TIn), x, kLanes, rows, 6 * B, kLanes, (long long)rows * kLanes,
                   RingT::kRow, 2, 6))
    return cudaErrorInvalidValue;
  auto kernel = stem_probe_kernel<PHASE, TIn>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         RingT::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((conv_rows + band - 1) / band, B);
  kernel<<<grid, kThreads, RingT::kSmem, stream>>>(
      tm_x, static_cast<const __nv_bfloat16*>(a), static_cast<const float*>(g),
      static_cast<const float*>(bn_b), static_cast<const __nv_bfloat16*>(s),
      static_cast<float*>(out), conv_rows, band);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t dispatch(int phase, const void* x, const void* a, const void* g,
                     const void* bn_b, const void* s, void* out, int B, int rows,
                     int conv_rows, int band, cudaStream_t stream) {
  switch (phase) {
    case kRolls:
      return launch<kRolls, TIn>(x, a, g, bn_b, s, out, B, rows, conv_rows, band, stream);
    case kIm2col:
      return launch<kIm2col, TIn>(x, a, g, bn_b, s, out, B, rows, conv_rows, band, stream);
    case kGemm:
      return launch<kGemm, TIn>(x, a, g, bn_b, s, out, B, rows, conv_rows, band, stream);
    case kFull:
      return launch<kFull, TIn>(x, a, g, bn_b, s, out, B, rows, conv_rows, band, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// phase: 0 rolls, 1 im2col, 2 gemm, 3 full; in_bf16: the planes' type (else
// f32); band: conv rows a block (a multiple of 16). out (B, 64, 128) f32
// must be zero on entry.
extern "C" int mhent_stem_probe(const void* x, const void* a, const void* g, const void* bn_b,
                                const void* s, void* out, int B, int rows, int conv_rows,
                                int phase, int in_bf16, int band, void* stream) {
  if (B < 1 || conv_rows < 2 * kBandMultiple || conv_rows % kBandMultiple ||
      2 * conv_rows + 6 > rows || phase < 0 || phase > 3 || band < kBandMultiple ||
      band % kBandMultiple)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      in_bf16
          ? dispatch<__nv_bfloat16>(phase, x, a, g, bn_b, s, out, B, rows, conv_rows, band, st)
          : dispatch<float>(phase, x, a, g, bn_b, s, out, B, rows, conv_rows, band, st);
  return (int)err;
}
