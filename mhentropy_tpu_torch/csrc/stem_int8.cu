// W8A8 ResNet stem for Hopper (sm_90a): per-channel int8 quantise of the f32
// image, conv 7x7 stride 2 pad 3 (3 -> 64 channels) as an exact s32 sum of
// s8 products, the f32 dequantise + eval-BN affine, ReLU, then maxpool 3x3
// stride 2 pad 1:
//
//   xq  = clip(rint(x * inv_a[c]), +-127)
//   y   = relu(acc * scale[f] + bias[f])       (__fmul_rn, __fadd_rn: no FMA)
//   out = max over the 3x3/2 window of y       (bf16 or f32 NHWC)
//
// Replaces mhentropy_tpu/models/stem_int8.py::stem_forward_q (the Pallas
// `_kernel` at :58, launched at :170). The pool follows the affine because
// BN's gamma may be negative. rint rounds half to even, as jnp.round.
//
// What bounds it on the H100: bytes. At B = 32, 256 x 256 it must read the
// f32 image (25.2 MB) and write the bf16 output (16.8 MB): 41.9 MB, 12.5 us
// at 3.35 TB/s. Its products, 64 filters x 147 taps at each of 524,288 conv
// outputs, are 9.9 GOP, 5 us at the 1,979 TOP/s int8 peak. The contraction
// is the 147 taps of a conv output, not its 3 input channels, so the
// products fit the tensor cores once each conv column's taps lie in a row of
// an im2col tile: the stem probe's design (stem_probe.cu), in s8.
//
// Design: a block owns a band of consecutive conv rows of one image (the
// wrapper's plan_band: 32 at B = 32, 8 at B = 8; one wave of 128 blocks) and
// walks it one conv row (N = 128 conv columns) at a time, warp-specialised
// (warpgroup 1 builds, warpgroup 0 runs the products and the epilogue):
// - The image read once a block, quantised once a value. On the bulk path
//   (a row pitch and base that are multiples of 16 bytes, W <= 256) builder
//   thread 0 streams each pair of input rows (6 KB at W = 256, contiguous in
//   NHWC) with one bulk copy to an mbarrier, four pairs ahead; on the other
//   path the builders load the rows from device memory themselves. One pass
//   turns each f32 row into an s8 row, quant(x * inv_a[c]), in a ring of 16
//   rows: ring byte j is the row's value 3 (2 c0 - 4) + j, so a word is one
//   aligned float4 of the row (the bulk path loads all of a thread's float4s
//   before it converts any), and 12 bytes of zeros lie before input column
//   0. The pad is zeros written into the ring (columns outside the image,
//   rows -3..-1 and >= H): no copy addresses it.
// - im2col K-major in shared memory for s8 wgmma, one tile an input row. For
//   conv column n and kernel row ky, the 21 (kx, c) taps are 21 contiguous
//   bytes of input row 2 i - 3 + ky at ring byte 6 n + 3. So input row r's
//   tile holds, for each of the 128 columns, its 21 taps of that row (six
//   words funnelled out of seven aligned loads by byte permutes, then zeros
//   to 32 bytes: one k32 step), and conv row i's products are the seven k32
//   steps over the tiles of rows 2 i - 3 .. 2 i + 3 (K = 224, the bytes
//   past each row's 21 taps meeting zero weights). A tile is built once and
//   read by the three or four conv rows that cover its input row: a conv row
//   builds two tiles (4 KB each, 128-byte swizzle, four rows to an atom in
//   a ring of 16), not a 24 KB tile of its own, which took about twice the
//   build time. The builders run up to four conv rows ahead of the products.
// - Products on wgmma: 7 m64n128k32 .s32.s8.s8 a conv row, M = the 64
//   filters (weights (64, 224) K-major, loaded once a block), N = the 128
//   conv columns. M = filters keeps the stem probe's orientation: a thread's
//   accumulators are two filters at 32 columns, and the pool over columns
//   is one quad shuffle a value. Two accumulator sets: row i + 1's products
//   run under row i's epilogue, issued by straight-line code so that ptxas
//   keeps them asynchronous.
// - Epilogue in registers, the pool first: y = relu(acc * s + b) with each
//   op rounded is a non-decreasing function of acc where s >= 0, so the max
//   of the window's y is that function of the window's max acc, exactly.
//   pack negates the weights of the filters whose scale is negative (the
//   sums change sign, exactly) and the kernel takes |scale|. So the pool
//   runs on the exact s32 sums: the max over conv columns 2p-1..2p+1 by one
//   shuffle from the neighbouring lane, then over conv rows against the
//   carried max of the row before; and __int2float_rn, __fmul_rn, __fadd_rn
//   and ReLU run once a pooled output, not once a conv output (scale and
//   bias of the thread's two filters in registers). A finished pooled row
//   goes through a swizzled shared tile into NHWC, 64 filters contiguous a
//   pooled pixel, with 16-byte stores. A band after the first also computes
//   the conv row before it, for the pooled row that straddles two bands. No
//   selection matmul: the TPU's s @ max^T in bf16 would round the f32 output.
// - Columns: W <= 256 is one tile of 128 conv columns (columns past Wc are
//   left out of the build and are INT_MIN to the pool: every pool window
//   holds its centre). A wider image walks tiles of 128 conv columns, tile 0
//   at conv column 0 (pooled columns 0-63), tile t >= 1 at 126 t + 1
//   (pooled 63 t + 1 .. 63 t + 63), so that each pooled column's three conv
//   columns lie in one tile; those images take the load path, whose
//   products do not overlap the epilogue.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA-graph replays): about
// 0.014 ms at B = 8 and 0.037 ms at B = 32, against 0.0031 and 0.0125 for
// the bytes. A clock64 split (kernel_variants.py --kinds stem_int8_split)
// gives a conv row about 1,700 cycles, set by the consumer warpgroup: its
// epilogue (about 1,000) and the issue of the next row's products (about
// 550), while the builders spend about 500 quantising, 400 building and
// 450 waiting for a stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_tma.cuh"
#include "mma_sm80.cuh"

namespace {

constexpr int kF = 64;                 // filters
constexpr int kN = 128;                // conv columns a tile: wgmma N
constexpr int kRunB = 32;              // a kernel row's 21 (kx, c) taps, padded to one k32 step
constexpr int kK = 7 * kRunB;          // K bytes: the seven kernel rows' runs
constexpr int kThreads = 256;          // warpgroup 0: products and epilogue; 1: quantise and im2col
constexpr int kMaxBulkW = 2 * kN;      // the bulk path's widest image: one tile
constexpr int kLeftPool = 64;          // pooled columns of tile 0
constexpr int kRightPool = 63;         // pooled columns of a later tile

// The s8 ring: a row's window of a tile is input columns 2 c0 - 4 .. 2 c0 +
// 262, 800 bytes: conv column n's runs start at byte 6 n + 3 and end, as
// seven words, by byte 792.
constexpr int kRowB = 800;
constexpr int kMarginB = 12;  // the window's bytes before input column 2 c0
constexpr int kRingRows = 16;  // input rows in the s8 ring and in the im2col tiles
constexpr int kPairSlots = 4;  // bulk path: input-row pairs in flight
constexpr int kPairB = 2 * kMaxBulkW * 3 * 4;

// Shared memory, in bytes from a 1,024-aligned base. The im2col tiles: input
// row r's (128 columns x 32 bytes) at atom (r % 16) / 4, bytes 32 (r % 4) of
// each 128-byte row; the weights: kernel row ky's (64 filters x 32 bytes) at
// atom ky / 4, bytes 32 (ky % 4).
constexpr int kStages = 4;                  // conv rows the builders may run ahead
constexpr int kAtom = 128 * 128;            // 128 rows of 128 bytes
constexpr int kAtomA = 64 * 128;            // 64 rows of 128 bytes
constexpr int kOffA = kRingRows / 4 * kAtom;
constexpr int kOffT = kOffA + 2 * kAtomA;   // the pooled row's tile: 64 columns x 64 filters (f32)
constexpr int kOffIa = kOffT + 64 * kF * 4;  // inv_a in the three rotations of a float4
constexpr int kOffRing = kOffIa + 64;
constexpr int kOffPairs = kOffRing + kRingRows * kRowB;
constexpr int kOffBars = kOffPairs + kPairSlots * kPairB;
constexpr int kSmem = 1024 + kOffBars + 8 * (kPairSlots + 2 * kStages);
static_assert(kSmem <= 232448, "over the block's shared memory");
static_assert(6 * (kN - 1) + 3 + 28 <= kRowB && kRowB % 16 == 0, "ring layout");

#define MHENT_D8(b)                                                                            \
  "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), \
      "+r"(d[b + 6]), "+r"(d[b + 7])
#define MHENT_REGS64                                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// D (64 x 128 s32; register 4 q + r of warp w, lane 4 g + c holds row 16 w +
// g + 8 (r / 2), column 8 q + 2 c + r % 2) = scale_d * D + A B^T over one
// 32-byte K step, A and B K-major s8 in shared memory.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" MHENT_REGS64 "}, %64, %65, p;\n}\n"
      : MHENT_D8(0), MHENT_D8(8), MHENT_D8(16), MHENT_D8(24), MHENT_D8(32), MHENT_D8(40),
        MHENT_D8(48), MHENT_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MHENT_D8
#undef MHENT_REGS64

// clip(rint(v), +-127), rint half to even (as torch.round), in the low byte:
// one conversion that rounds, where stage2_int8.cu's quant rounds and then
// converts (the quantiser is on this kernel's critical path).
__device__ __forceinline__ uint32_t quant_s32(float v) {
  return (uint32_t)max(min(__float2int_rn(v), 127), -127);
}

// Four quantised values as one word, the first in the low byte.
__device__ __forceinline__ uint32_t pack_s8x4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// A pooled row's n_pool columns (v: the max sums, register 2 q + h is filter
// f0 + 8 h, column 4 q + c4) through the affine and ReLU and the shared
// tile, 64 filters contiguous a column (16-byte chunks swizzled by the
// column), into NHWC at dst.
template <bool OUT_BF16>
__device__ __forceinline__ void store_pooled(unsigned char* tile, const int (&v)[32],
                                             const float (&sc)[2], const float (&bi)[2], int f0,
                                             int c4, unsigned char* dst, int n_pool) {
  constexpr int kEsz = OUT_BF16 ? 2 : 4, kRowChunks = kF * kEsz / 16;
  named_sync(2, 128);  // the last row's reads of the tile are done
#pragma unroll
  for (int q = 0; q < 16; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 4 * q + c4, f = f0 + 8 * h;
      const int at = m * kF * kEsz + ((((f * kEsz) / 16) ^ (m & 7)) << 4) + (f * kEsz) % 16;
      const float y =
          fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(v[2 * q + h]), sc[h]), bi[h]), 0.0f);
      if (OUT_BF16)
        *reinterpret_cast<__nv_bfloat16*>(tile + at) = __float2bfloat16(y);
      else
        *reinterpret_cast<float*>(tile + at) = y;
    }
  }
  named_sync(2, 128);
  for (int e = threadIdx.x; e < n_pool * kRowChunks; e += 128) {
    const int m = e / kRowChunks, k = e % kRowChunks;
    *reinterpret_cast<uint4*>(dst + 16 * e) =
        *reinterpret_cast<const uint4*>(tile + m * kF * kEsz + ((k ^ (m & 7)) << 4));
  }
}

// Tile t's first conv column and first pooled column.
__host__ __device__ __forceinline__ int tile_col(int t) { return t == 0 ? 0 : 126 * t + 1; }
__host__ __device__ __forceinline__ int tile_pool(int t) { return t == 0 ? 0 : 63 * t + 1; }

// x: (B, H, W, 3) f32; wq: (64, 192) s8 [f][ky * 24 + kx * 3 + c], each row
// times the sign of its filter's scale; inv_a:
// (3,); scale, bias: (64,); out: (B, Hp, Wp, 64) bf16 or f32. Block (band
// index, image); BULK: the bulk-copy path (W <= 256, W % 4 == 0, x 16-byte
// aligned).
template <bool BULK, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads, 1)
    stem_int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                     const float* __restrict__ inv_a, const float* __restrict__ scale,
                     const float* __restrict__ bias, void* __restrict__ out, int H, int W, int Hc,
                     int Wc, int Hp, int Wp, int band, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t pair_full = base + kOffBars;           // kPairSlots barriers
  const uint32_t bm_full = pair_full + 8 * kPairSlots;  // kStages
  const uint32_t bm_empty = bm_full + 8 * kStages;      // kStages

  const int b = blockIdx.y, tid = threadIdx.x;
  const int i0 = blockIdx.x * band, i1 = min(i0 + band, Hc);
  const int start = i0 > 0 ? i0 - 1 : 0;  // a later band: the straddling row first
  const int nrows = i1 - start;

  if (tid == 0) {
    for (int q = 0; q < kPairSlots; ++q) mbar_init(pair_full + 8 * q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bm_full + 8 * st, 128);
      mbar_init(bm_empty + 8 * st, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- builders: quantise the input rows, then thread n builds column n ----
    const int bt = tid - 128;
    const float* xb = x + (size_t)b * H * W * 3;
    // Pair q holds input rows 2 (start - 2 + q), +1: a conv row i reads
    // pairs i - 2 .. i + 1 (rows 2 i - 3 .. 2 i + 3).
    const int npairs = nrows + 3;
    auto load_pair = [&](int q) {
      const int r0 = 2 * (start - 2 + q);
      const int lo = max(r0, 0), hi = min(r0 + 2, H);
      const uint32_t bar = pair_full + 8 * (q % kPairSlots);
      const uint32_t bytes = hi > lo ? (uint32_t)(hi - lo) * W * 12u : 0u;
      mbar_expect_tx(bar, bytes);
      if (bytes)
        bulk_load(base + kOffPairs + (q % kPairSlots) * kPairB + (lo - r0) * W * 12,
                  xb + (size_t)lo * W * 3, bytes, bar);
    };
    // inv_a by channel, rotated for a word whose first value is channel r;
    // the ring's rows zero (the bulk path writes their data words only).
    float4* ia_rot = reinterpret_cast<float4*>(smem + kOffIa);
    if (bt < 3)
      ia_rot[bt] = make_float4(inv_a[bt], inv_a[(bt + 1) % 3], inv_a[(bt + 2) % 3], inv_a[bt]);
    for (int e = bt; e < kRingRows * kRowB / 16; e += 128)
      reinterpret_cast<uint4*>(smem + kOffRing)[e] = make_uint4(0, 0, 0, 0);
    // Pair q's two rows into the ring, in tile c0's window: word u of row h
    // is ring bytes 4 u .. 4 u + 3, byte j the row's value 3 (2 c0 - 4) + j
    // (input column 2 c0 - 4 + j / 3, channel j % 3).
    auto quantise_pair = [&](int q, int c0) {
      const int r0 = 2 * (start - 2 + q);
      if constexpr (BULK) {
        // The rows' data words only (3 W / 4 a row, 192 at W = 256: three a
        // thread for the pair); the margins stay zero. Word u of row h is the
        // float4 4 u of the row, at ring word u + 3.
        const float* staged =
            reinterpret_cast<const float*>(smem + kOffPairs + (q % kPairSlots) * kPairB);
        const int nw = 3 * W / 4;
        constexpr int kWordsMax = 2 * (3 * kMaxBulkW / 4) / 128;
        // All loads first, then the arithmetic: the words' latencies overlap.
        float4 xv[kWordsMax], iv[kWordsMax];
        int at[kWordsMax];
#pragma unroll
        for (int k4 = 0; k4 < kWordsMax; ++k4) {
          const int v = min(bt + 128 * k4, 2 * nw - 1);
          const int h = v >= nw, u = v - h * nw;
          xv[k4] = *reinterpret_cast<const float4*>(staged + h * W * 3 + 4 * u);
          iv[k4] = ia_rot[u % 3];
          const int r = r0 + h;
          at[k4] = bt + 128 * k4 < 2 * nw ? (r & (kRingRows - 1)) * kRowB + 4 * (u + kMarginB / 4)
                                          : -1;
          if (r < 0 || r >= H) xv[k4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the pad
        }
#pragma unroll
        for (int k4 = 0; k4 < kWordsMax; ++k4) {
          const uint32_t word = pack_s8x4(
              quant_s32(__fmul_rn(xv[k4].x, iv[k4].x)), quant_s32(__fmul_rn(xv[k4].y, iv[k4].y)),
              quant_s32(__fmul_rn(xv[k4].z, iv[k4].z)), quant_s32(__fmul_rn(xv[k4].w, iv[k4].w)));
          if (at[k4] >= 0) *reinterpret_cast<uint32_t*>(smem + kOffRing + at[k4]) = word;
        }
      } else {
        // Word u of row h is ring bytes 4 u .. 4 u + 3, byte j the row's value
        // 3 (2 c0 - 4) + j (input column 2 c0 - 4 + j / 3, channel j % 3).
#pragma unroll
        for (int k4 = 0; k4 < (2 * (kRowB / 4) + 127) / 128; ++k4) {
          const int v = bt + 128 * k4;
          if (v >= 2 * (kRowB / 4)) break;
          const int h = v >= kRowB / 4, u = v - h * (kRowB / 4), r = r0 + h;
          const int e0 = 3 * (2 * c0) - kMarginB + 4 * u;  // the row's value at byte 0
          uint32_t word = 0;
          if (r >= 0 && r < H && e0 + 4 > 0 && e0 < 3 * W) {
            const float* src = xb + (size_t)r * W * 3;
            uint32_t b4[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int e = e0 + k;
              b4[k] = e >= 0 && e < 3 * W
                          ? quant_s32(__fmul_rn(__ldg(src + e),
                                                reinterpret_cast<const float*>(ia_rot)[e % 3]))
                          : 0u;
            }
            word = pack_s8x4(b4[0], b4[1], b4[2], b4[3]);
          }
          *reinterpret_cast<uint32_t*>(smem + kOffRing + (r & (kRingRows - 1)) * kRowB +
                                       4 * u) = word;
        }
      }
    };

    if (BULK && bt == 0)
      for (int q = 0; q < kPairSlots && q < npairs; ++q) load_pair(q);
    named_sync(1, 128);  // ia_rot and the ring's zeros are written
    int it = 0;  // conv rows so far, over all tiles: stage it % kStages
    for (int t = 0; t < tiles; ++t) {
      const int c0 = tile_col(t), n_valid = min(kN, Wc - c0);
      if (t > 0) named_sync(1, 128);  // the last tile's builds are done with the ring
      for (int l = 0; l < nrows; ++l, ++it) {
        const int i = start + l, q0 = l == 0 ? 0 : l + 3;
        for (int q = q0; q <= l + 3; ++q) {
          if (BULK) mbar_wait(pair_full + 8 * (q % kPairSlots), (q / kPairSlots) & 1);
          quantise_pair(q, c0);
        }
        named_sync(1, 128);  // the window's rows are in the ring, the pairs' slots read
        if (BULK && bt == 0) {
          fence_proxy_async();
          for (int q = q0; q <= l + 3; ++q)
            if (q + kPairSlots < npairs) load_pair(q + kPairSlots);
        }
        // Conv row it may reuse the tiles of rows the consumer finished with
        // at conv row it - kStages (in a new column tile: at it - 1).
        const int st = it % kStages;
        if (l == 0 && it > 0)
          mbar_wait(bm_empty + 8 * ((it - 1) % kStages), ((it - 1) / kStages) & 1);
        else if (it >= kStages)
          mbar_wait(bm_empty + 8 * st, ((it / kStages) & 1) ^ 1);
        if (bt < n_valid) {
          // Column bt's run of each new input row: ring byte 6 bt + 3 (3 mod 4
          // for an even column, 1 for an odd one), out of seven aligned words,
          // then zeros to 32 bytes.
          const int at = (6 * bt + 3) & ~3;
          const uint32_t sel = (bt & 1) ? 0x4321u : 0x6543u;
          for (int r = l == 0 ? 2 * i - 3 : 2 * i + 2; r <= 2 * i + 3; ++r) {
            const int slot = r & (kRingRows - 1);
            const uint32_t* src =
                reinterpret_cast<const uint32_t*>(smem + kOffRing + slot * kRowB + at);
            uint32_t a[7], w[8];
#pragma unroll
            for (int k = 0; k < 7; ++k) a[k] = src[k];
#pragma unroll
            for (int k = 0; k < 6; ++k) w[k] = __byte_perm(a[k], a[k + 1], sel);
            w[6] = w[7] = 0u;
            unsigned char* tile = smem + slot / 4 * kAtom;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint4*>(tile + swz(bt, 2 * (slot % 4) + h, 128)) =
                  make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
          }
        }
        fence_proxy_async();
        mbar_arrive(bm_full + 8 * st);
      }
    }
    return;
  }

  // ---- consumer warpgroup: products, epilogue, stores ----
  const int warp = tid / 32, lane = tid % 32, c4 = lane & 3;
  const int f0 = 16 * warp + lane / 4;  // the thread's filters: f0, f0 + 8
#pragma unroll
  for (int e = tid; e < kF * kK / 16; e += 128) {
    const int f = e / (kK / 16), c = e % (kK / 16);
    const uint4 v = *reinterpret_cast<const uint4*>(wq + f * kK + 16 * c);
    *reinterpret_cast<uint4*>(smem + kOffA + c / 8 * kAtomA + swz(f, c % 8, 128)) = v;
  }
  fence_proxy_async();
  named_sync(2, 128);
  // wq's rows carry scale's sign, so the affine takes |scale| (see the header).
  const float sc[2] = {fabsf(scale[f0]), fabsf(scale[f0 + 8])}, bi[2] = {bias[f0], bias[f0 + 8]};
  constexpr int kEsz = OUT_BF16 ? 2 : 4;

  // Conv row it (over all tiles: tile it / nrows, conv row start + it %
  // nrows) runs its products into one of two accumulator sets while the
  // epilogue of row it - 1 reads the other.
  int acc0[64], acc1[64];
  int run[32];  // the pooled row's max so far: register 2 q + h is filter f0 + 8 h, column 4 q + c4
  const int total = tiles * nrows;
  auto wait_full = [&](int it) { mbar_wait(bm_full + 8 * (it % kStages), (it / kStages) & 1); };
  auto products = [&](int(&acc)[64], int it) {
    const int i = start + it % nrows;
    wgmma_fence();
#pragma unroll
    for (int ky = 0; ky < 7; ++ky) {
      const int slot = (2 * i - 3 + ky) & (kRingRows - 1);
      const uint32_t a = base + kOffA + ky / 4 * kAtomA + 32 * (ky % 4);
      const uint32_t bm = base + slot / 4 * kAtom + 32 * (slot % 4);
      wgmma_s8_n128(acc, sw128_desc(a), sw128_desc(bm), ky > 0);
    }
    wgmma_commit();
  };
  auto finish = [&](int(&acc)[64], int it) {
    fence_regs<64>(acc);
    mbar_arrive(bm_empty + 8 * (it % kStages));
    const int t = it / nrows, l = it % nrows, i = start + l;
    const int p0 = tile_pool(t), n_valid = min(kN, Wc - tile_col(t));
    // Pooled column m's centre: conv column 2 m (tile 0; the bulk path's one
    // tile) or 2 m + 1.
    const bool right = !BULK && t > 0;
    const int n_pool = min(right ? kRightPool : kLeftPool, Wp - p0);
    // Pooled row p of this tile starts at out[b, p, p0].
    auto row_at = [&](int p) {
      return static_cast<unsigned char*>(out) + (((size_t)b * Hp + p) * Wp + p0) * kF * kEsz;
    };
    // The pool on the exact sums: columns past the image are INT_MIN (every
    // window holds its centre), then the max over the centre column, its
    // pair and the neighbour in the next lane: on the left (tile 0: the high
    // half of lane c4 - 1, of q - 1 for c4 = 0) or on the right (the low half
    // of lane c4 + 1, of q + 1 for c4 = 3).
    int pm[32];
    auto pool_columns = [&](auto masked) {
      auto sum = [&](int q, int r) {
        if constexpr (decltype(masked)::value)
          return 8 * q + 2 * c4 + (r & 1) < n_valid ? acc[4 * q + r] : INT_MIN;
        else
          return acc[4 * q + r];
      };
#pragma unroll
      for (int q = 0; q < 16; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lo = sum(q, 2 * h), hi = sum(q, 2 * h + 1);
          const int send_l = c4 == 3 ? (q > 0 ? sum(q - 1, 2 * h + 1) : INT_MIN) : hi;
          const int send_r = c4 == 0 ? (q < 15 ? sum(q + 1, 2 * h) : INT_MIN) : lo;
          const int from = __shfl_sync(0xffffffffu, right ? send_r : send_l,
                                       (lane & ~3) | ((c4 + (right ? 1 : 3)) & 3));
          pm[2 * q + h] = max(max(lo, hi), from);
        }
      }
    };
    if (n_valid < kN)
      pool_columns(std::true_type());
    else
      pool_columns(std::false_type());
    // The max over conv rows 2 p - 1 .. 2 p + 1; a finished pooled row
    // through the affine and ReLU into the output.
    if (i & 1) {
      if (l > 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) run[e] = max(run[e], pm[e]);
        store_pooled<OUT_BF16>(smem + kOffT, run, sc, bi, f0, c4, row_at((i - 1) / 2), n_pool);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) run[e] = pm[e];  // starts pooled row (i + 1) / 2
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) run[e] = l == 0 ? pm[e] : max(run[e], pm[e]);
      if (i == Hc - 1)  // the image's last pooled row has no conv row 2 p + 1
        store_pooled<OUT_BF16>(smem + kOffT, run, sc, bi, f0, c4, row_at(i / 2), n_pool);
    }
  };

  if constexpr (BULK) {
    // One column tile: row it + 1's products run under row it's epilogue.
    // The code that issues them is straight-line (past the last row it
    // reruns a row still held), so that the products stay asynchronous.
    wait_full(0);
    products(acc0, 0);
    for (int it = 0; it < total; it += 2) {
      const bool has1 = it + 1 < total, has2 = it + 2 < total;
      if (has1) wait_full(it + 1);
      products(acc1, has1 ? it + 1 : it);
      wgmma_wait<1>();
      finish(acc0, it);
      if (has2) wait_full(it + 2);
      products(acc0, has2 ? it + 2 : it + (int)has1);
      wgmma_wait<1>();
      if (has1) finish(acc1, it + 1);
    }
    wgmma_wait<0>();
  } else {
    // Column tiles: each row's products, then its epilogue (the builders
    // overwrite the last tile's rows only once its last row is released).
    for (int it = 0; it < total; ++it) {
      wait_full(it);
      products(acc0, it);
      wgmma_wait<0>();
      finish(acc0, it);
    }
  }
}

template <bool BULK, bool OUT_BF16>
cudaError_t launch(const void* x, const void* wq, const void* inv_a, const void* scale,
                   const void* bias, void* out, int B, int H, int W, int band, int tiles,
                   cudaStream_t stream) {
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;
  auto kernel = stem_int8_kernel<BULK, OUT_BF16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Hc + band - 1) / band, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(inv_a), static_cast<const float*>(scale),
      static_cast<const float*>(bias), out, H, W, Hc, Wc, Hp, Wp, band, tiles);
  return cudaGetLastError();
}

}  // namespace

// band: conv rows a block (even); bulk: the bulk-copy path, which needs W <=
// 256, W % 4 == 0 and x 16-byte aligned. B <= 65,535.
extern "C" int mhent_stem_int8_forward(const void* x, const void* wq, const void* inv_a,
                                       const void* scale, const void* bias, void* out, int B,
                                       int H, int W, int out_bf16, int band, int bulk,
                                       void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || band < 2 || band % 2 ||
      (bulk && (W > kMaxBulkW || W % 4 || reinterpret_cast<uintptr_t>(x) % 16)))
    return (int)cudaErrorInvalidValue;
  const int Wp = ((W - 1) / 2) / 2 + 1;
  const int tiles = Wp <= kLeftPool ? 1 : 1 + (Wp - kLeftPool + kRightPool - 1) / kRightPool;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk)
    return (int)(out_bf16 ? launch<true, true>(x, wq, inv_a, scale, bias, out, B, H, W, band,
                                               tiles, s)
                          : launch<true, false>(x, wq, inv_a, scale, bias, out, B, H, W, band,
                                                tiles, s));
  return (int)(out_bf16
                   ? launch<false, true>(x, wq, inv_a, scale, bias, out, B, H, W, band, tiles, s)
                   : launch<false, false>(x, wq, inv_a, scale, bias, out, B, H, W, band, tiles,
                                          s));
}
