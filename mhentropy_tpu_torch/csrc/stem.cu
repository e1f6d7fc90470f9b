// Fused ResNet stem for Hopper (sm_90a): conv 7x7 stride 2 pad 3 (3 -> 64
// channels, no bias) + eval BatchNorm + ReLU + maxpool 3x3 stride 2 pad 1.
//
// Replaces mhentropy_tpu/models/stem_pallas.py::stem_forward (the Pallas
// `_kernel` at :49, launched at :172).
//
// What bounds it on the H100: the work of feeding the products, not the
// products or device memory. The fusion keeps the (B, H/2, W/2, 64) conv
// output out of device memory (the plain PyTorch path writes and re-reads
// 4x the pooled output's bytes); what is left at B = 32, 256 px is 29 MB
// (0.009 ms at 3.35 TB/s) and 7 G multiply-adds with this design's
// padding (0.014 ms at the dense bf16 peak), against about 0.08 ms on an
// H100 SXM at 700 W (PERF.md): 147 taps of only 3 input channels a conv
// output to gather, a per-block weight copy, and the pool. Run as f32 FMAs
// on the CUDA cores, the products would cost about one shared-memory load
// an FMA; here they are an implicit GEMM on the tensor cores.
//
// Design: one 256-thread block owns an 8 x 8 tile of pooled outputs for all
// 64 filters, i.e. the 17 x 17 = 289 conv outputs under their pool windows
// (19 m16 row tiles, the last 15 rows clamped reads whose results are
// dropped: 1.19x the 4 conv outputs a pooled one needs; a 4 x 4 tile
// computes 81 for 16, 1.27x). A larger square tile would
// not divide both the 56- and the 64-wide pooled maps of the 224 and 256 px
// images.
// - The GEMM is M = conv outputs, N = 64 filters, K = 7 ky rows x 24: for
//   one ky, a conv output's 21 taps are 21 contiguous bf16 values of an
//   input row (7 pixels x 3 channels, `fold`'s order (ky * 7 + kx) * 3 + c),
//   read as 24 (the 3 past the end meet zero weights). K = 168, padded to
//   11 k16 steps with a zero step: 176.
// - The (39, 39, 3) input tile sits in shared memory with 120-value rows,
//   so every tap pair a thread reads (column 6 cx + 8 part + 2 t) is 4-byte
//   aligned; A fragments are gathered straight from it, one 32-bit load a
//   register at a compile-time offset from the thread's row base: no
//   im2col, no rolled planes.
// - The folded weights are copied into shared memory in that K order (rows
//   of 64 filters, 16-byte chunks swizzled by row), once a block, and each
//   warp holds its 16 filters' B fragments for all of K in 44 registers.
//   Warp w runs filters 16 (w % 4) .. + 15 over every other m16 tile.
// - Epilogue: folded bias + ReLU on the accumulators, bf16 into a (289, 64)
//   conv tile in shared memory (conv outputs outside the conv map are 0);
//   the 3x3 / 2 max-pool on bf16 pairs there (__hmax2); 16-byte NHWC stores,
//   8 filters a thread, a quarter warp a pooled pixel.
//
// Shared memory: weights 22,528 + input 9,360 + conv tile 36,992 = 68,880
// bytes, so three blocks an SM.
//
// BN arrives folded into the weights (w' = w g, b' = beta - mean g with
// g = gamma / sqrt(var + eps)), as in stem_pallas.py:162-166. Conv positions
// outside the conv output act as -inf pool padding; since every pool window
// holds at least one real, ReLU'd (>= 0) output, the max starts at 0. The
// three values read past a segment's 21 taps belong to the next input
// pixel: with a zero weight they add 0 for any finite image. Any H and W
// are accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 8;                 // pooled outputs per block side
constexpr int kConv = 2 * kTile + 1;     // 17 conv outputs per block side
constexpr int kIn = 2 * (kConv - 1) + 7; // 39 input pixels per block side
constexpr int kConvPix = kConv * kConv;  // 289
constexpr int kMTiles = (kConvPix + 15) / 16;  // 19
constexpr int kF = 64;                   // filters
constexpr int kC = 3;                    // input channels
constexpr int kSeg = 7 * kC;             // 21 taps of one ky
constexpr int kHalfSteps = 7 * 3;        // 8-value K groups with taps: 3 a ky
constexpr int kKSteps = 11;              // k16 steps (the last half step is zero)
constexpr int kK = 16 * kKSteps;         // 176
constexpr int kInRow = 120;              // bf16 an input tile row (117 used)
constexpr int kThreads = 256;

constexpr int kOffW = 0;                          // (176, 64) [k][filter], swizzled
constexpr int kOffIn = kOffW + kK * kF * 2;       // (39, 120)
constexpr int kOffConv = kOffIn + kIn * kInRow * 2;  // (289, 64) bf16, swizzled
constexpr int kSmem = kOffConv + kConvPix * kF * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of row r in a tile with 128-byte rows.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));  // 0 bytes read: the 16 are zero-filled
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset, within the input tile, of K half step hs (8 values) from
// a conv output's first tap: ky row, 8 (hs % 3) values along it. The zero
// step past the taps reads the first ones again.
__host__ __device__ constexpr int half_step_offset(int hs) {
  return hs < kHalfSteps ? (hs / 3) * kInRow + 8 * (hs % 3) : 0;
}

// x: (B, H, W, 3) bf16; w: (147, 64) bf16, tap index (ky * 7 + kx) * 3 + c;
// bias: (64,) f32; out: (B, Hp, Wp, 64) bf16.
__global__ void __launch_bounds__(kThreads, 3)
    stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H,
                int W, int Hc, int Wc, int Hp, int Wp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_w = smem_addr(smem + kOffW);
  unsigned short* s_in = reinterpret_cast<unsigned short*>(smem + kOffIn);
  unsigned char* s_conv = smem + kOffConv;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kTile, px0 = blockIdx.x * kTile;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // first conv row / col
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // first input row / col
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // Weights in K order: row k = 8 hs + v holds fold's row ky * 21 + j,
  // j = 8 (hs % 3) + v, or zeros past the 21 taps and past the taps' steps.
  for (int e = tid; e < kK * 8; e += kThreads) {
    const int k = e >> 3, c = e & 7, hs = k >> 3, j = 8 * (hs % 3) + (k & 7);
    const bool ok = hs < kHalfSteps && j < kSeg;
    cp_async16(s_w + swz(k, c), ok ? w + ((hs / 3) * kSeg + j) * kF + c * 8 : w, ok);
  }
  asm volatile("cp.async.commit_group;\n");
  // The input tile; pixels outside the image (the conv's zero padding) and
  // each row's 3 values past its 117 read as zero.
  for (int e = tid; e < kIn * kInRow; e += kThreads) {
    const int r = e / kInRow, col = e % kInRow, ix = ix0 + col / kC, iy = iy0 + r;
    unsigned short v = 0;
    if (col < kIn * kC && iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = __ldg(xs + (((size_t)b * H + iy) * W + ix) * kC + col % kC);
    s_in[e] = v;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // This warp's 16 filters: B fragments for all 11 k steps, and the bias.
  const int n0 = 16 * (warp & 3);
  uint32_t bw[kKSteps][4];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const int k = 16 * s + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4_t(bw[s], s_w + swz(k, (n0 >> 3) + (lane >> 4)));
  }
  float bv[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    bv[j][0] = bias[n0 + 8 * j + 2 * t];
    bv[j][1] = bias[n0 + 8 * j + 2 * t + 1];
  }

#pragma unroll 1
  for (int mt = warp >> 2; mt < kMTiles; mt += 2) {
    // Row bases: conv outputs 16 mt + g and + 8 (clamped past the tile).
    const unsigned short* base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min(16 * mt + g + 8 * h, kConvPix - 1);
      const int cy = m / kConv, cx = m % kConv;
      base[h] = s_in + 2 * cy * kInRow + 6 * cx + 2 * t;
    }
    float acc[2][4] = {};
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(base[0] + half_step_offset(2 * s));
      a[1] = *reinterpret_cast<const uint32_t*>(base[1] + half_step_offset(2 * s));
      a[2] = *reinterpret_cast<const uint32_t*>(base[0] + half_step_offset(2 * s + 1));
      a[3] = *reinterpret_cast<const uint32_t*>(base[1] + half_step_offset(2 * s + 1));
      mma16816(acc[0], a, bw[s][0], bw[s][1]);
      mma16816(acc[1], a, bw[s][2], bw[s][3]);
    }
    // bias + ReLU, zero outside the conv map, bf16 into the conv tile.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * mt + g + 8 * h;
      if (m >= kConvPix) continue;
      const int cy = cy0 + m / kConv, cx = cx0 + m % kConv;
      const bool inside = cy >= 0 && cy < Hc && cx >= 0 && cx < Wc;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v0 = inside ? fmaxf(acc[j][2 * h] + bv[j][0], 0.0f) : 0.0f;
        const float v1 = inside ? fmaxf(acc[j][2 * h + 1] + bv[j][1], 0.0f) : 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(s_conv + swz(m, (n0 >> 3) + j) + 4 * t) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();

  // 3x3 / 2 max-pool: a quarter warp a pooled pixel, 8 filters a thread.
  for (int e = tid; e < kTile * kTile * 8; e += kThreads) {
    const int c = e & 7, pp = e >> 3, py = pp / kTile, px = pp % kTile;
    const int oy = py0 + py, ox = px0 + px;
    if (oy >= Hp || ox >= Wp) continue;
    __nv_bfloat162 m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = __float2bfloat162_rn(0.0f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            s_conv + swz((2 * py + dy) * kConv + 2 * px + dx, c));
        const __nv_bfloat162* vv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) m[q] = __hmax2(m[q], vv[q]);
      }
    uint4 o;
    o.x = *reinterpret_cast<const uint32_t*>(&m[0]);
    o.y = *reinterpret_cast<const uint32_t*>(&m[1]);
    o.z = *reinterpret_cast<const uint32_t*>(&m[2]);
    o.w = *reinterpret_cast<const uint32_t*>(&m[3]);
    *reinterpret_cast<uint4*>(out + (((size_t)b * Hp + oy) * Wp + ox) * kF + c * 8) = o;
  }
}

}  // namespace

extern "C" int mhent_stem_forward(const void* x, const void* w, const void* bias, void* out,
                                  int B, int H, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Wp + kTile - 1) / kTile, (Hp + kTile - 1) / kTile, B);
  stem_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W, Hc, Wc, Hp,
      Wp);
  return (int)cudaGetLastError();
}
