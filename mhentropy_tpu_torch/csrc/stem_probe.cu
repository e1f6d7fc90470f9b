// Cost probe of an im2col + tensor-core GEMM ResNet stem for Hopper (sm_90a),
// with four compile-time cuts of one kernel body (rolls, im2col, gemm, full).
//
// Replaces tools/stem_probe.py::probe_kernel_step (the Pallas kernel launched
// at :84) and tools/stem_cost_attrib.py::make_step (launched at :110). Those
// probes timed a stem written as 21 rolled/masked parity-plane taps, an
// im2col copy into a (152, 16384) K-major matrix and one (64, 152) x
// (152, 16384) bf16 GEMM, cut after each part, to find where a fused stem's
// time goes. The shipped card stem (`stem.cu`) uses f32 FMAs instead; this
// probe asks what the tensor-core formulation costs on the H100.
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
//
// Design: the TPU kernel held an image's whole Bm (5 MB) in VMEM. Here a
// block owns 16 conv rows of one image and walks them two at a time: it
// builds the 21 taps of the 10 plane rows those two conv rows read into
// shared memory, copies them into a (160, 256) Bm slice, and runs the
// (64, 160) x (160, 256) product on the tensor cores (WMMA bf16, f32
// accumulation; each warp owns 32 columns). gemm keeps its accumulators over
// the block's conv rows and adds its (64, 128) partial into the output with
// atomics; full runs the epilogue on each pair of conv rows, carrying the
// last row's BN/ReLU to the next pair (a block first computes the pair
// before its own, for the pooled row that straddles two blocks) and sums
// s @ max^T on the tensor cores. Every phase reserves the same shared memory
// (one block an SM), so a cut changes the work and not the occupancy. The
// rolls and im2col outputs read only part of what the body builds; the
// stores stay because the part read depends on blockIdx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kF = 64;                  // filters
constexpr int kLanes = 128;             // plane columns (conv output columns)
constexpr int kTaps = 21;               // (kx, c) groups
constexpr int kK = 152;                 // the TPU's K (147 taps + 5 zero rows)
constexpr int kKPad = 160;              // K padded to WMMA's 16
constexpr int kPair = 2;                // conv rows a chunk
constexpr int kRowsPerBlock = 16;       // conv rows a block
constexpr int kTapRows = 2 * kPair + 6; // plane rows a chunk builds (10)
constexpr int kN = kPair * kLanes;      // GEMM columns a chunk (256)
constexpr int kLdB = kN + 8;            // Bm / acc row stride (elements)
constexpr int kLdA = kKPad + 8;         // a row stride
constexpr int kLdS = kLanes + 8;        // s and the pooled max row stride
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

enum Phase { kRolls = 0, kIm2col = 1, kGemm = 2, kFull = 3 };

// kx -> lane shift (4 - kx) // 2 with Python's floor division.
__constant__ int kShift[7] = {2, 1, 1, 0, 0, -1, -1};

constexpr size_t kBytesR = sizeof(__nv_bfloat16) * kTaps * kTapRows * kLanes;  // 53,760
constexpr size_t kBytesB = sizeof(__nv_bfloat16) * kKPad * kLdB;               // 84,480
constexpr size_t kBytesA = sizeof(__nv_bfloat16) * kF * kLdA;                  // 21,504
constexpr size_t kBytesCarry = sizeof(float) * kF * kLanes;                    // 32,768
constexpr size_t kBytesS = sizeof(__nv_bfloat16) * kF * kLdS;                  // 17,408
constexpr size_t kSmem = kBytesR + kBytesB + kBytesA + kBytesCarry + kBytesS;  // 209,920
static_assert(sizeof(float) * kF * kLdB <= kBytesB, "acc staging must fit in Bm's room");
static_assert(sizeof(float) * kF * kLanes + sizeof(__nv_bfloat16) * kF * kLdS <= kBytesR,
              "the pooled max must fit in the taps' room");

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

// x: (B, 6, rows, 128) TIn; a: (64, 152) bf16; g, bn_b: (64, 128) f32;
// s: (64, 128) bf16; out: (B, 64, 128) f32, zeroed by the caller.
template <int PHASE, typename TIn>
__global__ void __launch_bounds__(kThreads)
    stem_probe_kernel(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                      const float* __restrict__ g, const float* __restrict__ bn_b,
                      const __nv_bfloat16* __restrict__ s, float* __restrict__ out, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sR = reinterpret_cast<__nv_bfloat16*>(smem);            // (21, 10, 128)
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + kBytesR);  // (160, kLdB)
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem + kBytesR + kBytesB);
  float* sCarry = reinterpret_cast<float*>(smem + kBytesR + kBytesB + kBytesA);  // (64, 128)
  __nv_bfloat16* sS =
      reinterpret_cast<__nv_bfloat16*>(smem + kBytesR + kBytesB + kBytesA + kBytesCarry);
  float* ys = reinterpret_cast<float*>(sB);   // (64, kLdB) f32 after the GEMM
  float* sM = reinterpret_cast<float*>(sR);   // (64, 128) row max, full phase
  __nv_bfloat16* sMM = reinterpret_cast<__nv_bfloat16*>(smem + sizeof(float) * kF * kLanes);

  const int b = blockIdx.y, tid = threadIdx.x, warp = tid / 32;
  const int i0 = blockIdx.x * kRowsPerBlock;
  const TIn* xb = x + (size_t)b * 6 * rows * kLanes;
  float* outb = out + (size_t)b * kF * kLanes;

  if (PHASE >= kGemm) {
    for (int e = tid; e < kF * kKPad; e += kThreads) {
      const int f = e / kKPad, k = e % kKPad;
      sA[f * kLdA + k] = k < kK ? a[f * kK + k] : __float2bfloat16(0.0f);
    }
  }
  if (PHASE == kFull) {
    for (int e = tid; e < kF * kLanes; e += kThreads)
      sS[(e / kLanes) * kLdS + e % kLanes] = s[e];
  }

  FragC acc[4][2];
  FragC tot[2];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[m][n], 0.0f);
  wmma::fill_fragment(tot[0], 0.0f);
  wmma::fill_fragment(tot[1], 0.0f);

  // full: the pair before the block's own supplies the straddling pool row.
  const int first = (PHASE == kFull && i0 > 0) ? i0 - kPair : i0;
  for (int c0 = first; c0 < i0 + kRowsPerBlock; c0 += kPair) {
    const bool halo = c0 < i0;
    __syncthreads();  // the previous chunk is done with sR / sB / sM
    // 1. taps: R rows 2 c0 .. 2 c0 + 9 of every (kx, c) group.
    for (int e = tid; e < kTaps * kTapRows * kLanes; e += kThreads) {
      const int t = e / (kTapRows * kLanes), rem = e % (kTapRows * kLanes);
      const int rr = rem / kLanes, j = rem % kLanes;
      const int kx = t / 3, c = t % 3;
      const int plane = ((kx + 1) % 2) * 3 + c, src = j - kShift[kx];
      __nv_bfloat16 v = __float2bfloat16(0.0f);
      if (src >= 0 && src < kLanes) v = to_bf16(xb[((size_t)plane * rows + 2 * c0 + rr) * kLanes + src]);
      sR[e] = v;
    }
    __syncthreads();
    if (PHASE == kRolls) {
      // This chunk owns R rows 2 c0 .. 2 c0 + 3; the output keeps rows < 64.
      for (int e = tid; e < 4 * kLanes; e += kThreads) {
        const int rr = e / kLanes, j = e % kLanes, r = 2 * c0 + rr;
        if (r >= kF) continue;
        float v = 0.0f;
        for (int t = 0; t < kTaps; ++t) v += __bfloat162float(sR[(t * kTapRows + rr) * kLanes + j]);
        outb[r * kLanes + j] = v;
      }
      continue;
    }
    // 2. im2col: Bm[7 t + k][128 i + j] = R[t][2 i + 1 + k][j], 16 bytes a copy.
    for (int e = tid; e < kKPad * (kN / 8); e += kThreads) {
      const int row = e / (kN / 8), col = (e % (kN / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < kTaps * 7) {
        const int t = row / 7, k = row % 7, i = col / kLanes, j = col % kLanes;
        v = *reinterpret_cast<const uint4*>(sR + (t * kTapRows + 2 * i + 1 + k) * kLanes + j);
      }
      *reinterpret_cast<uint4*>(sB + row * kLdB + col) = v;
    }
    __syncthreads();
    if (PHASE == kIm2col) {
      if (c0 == 0) {
        for (int e = tid; e < kF * kLanes; e += kThreads) {
          const int f = e / kLanes, j = e % kLanes;
          float v = 0.0f;
          v += __bfloat162float(sB[f * kLdB + j]);
          v += __bfloat162float(sB[(64 + f) * kLdB + j]);
          v += __bfloat162float(sB[(kK - 64 + f) * kLdB + j]);
          outb[f * kLanes + j] = v;
        }
      }
      continue;
    }
    // 3. GEMM: acc (64, 256) += a (64, 160) @ Bm (160, 256); warp owns 32 columns.
    if (PHASE == kFull) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[m][n], 0.0f);
    }
    const int n0 = warp * 32;
#pragma unroll 2
    for (int k = 0; k < kKPad; k += 16) {
      FragA fa[4];
      FragB fb[2];
#pragma unroll
      for (int m = 0; m < 4; ++m) wmma::load_matrix_sync(fa[m], sA + m * 16 * kLdA + k, kLdA);
#pragma unroll
      for (int n = 0; n < 2; ++n) wmma::load_matrix_sync(fb[n], sB + k * kLdB + n0 + n * 16, kLdB);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) wmma::mma_sync(acc[m][n], fa[m], fb[n], acc[m][n]);
    }
    if (PHASE == kGemm) continue;

    // 4. full epilogue on this pair of conv rows (2p, 2p + 1), p = c0 / 2.
    __syncthreads();  // every warp is done reading Bm
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wmma::store_matrix_sync(ys + m * 16 * kLdB + n0 + n * 16, acc[m][n], kLdB,
                                wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kF * kLanes; e += kThreads) {
      const int f = e / kLanes, j = e % kLanes;
      const float gg = g[e], bb = bn_b[e];
      const float y0 = fmaxf(__fadd_rn(__fmul_rn(ys[f * kLdB + j], gg), bb), 0.0f);
      const float y1 = fmaxf(__fadd_rn(__fmul_rn(ys[f * kLdB + kLanes + j], gg), bb), 0.0f);
      if (!halo) {
        float m = fmaxf(y0, y1);
        if (c0 > 0) m = fmaxf(m, sCarry[e]);
        sM[e] = m;
      }
      sCarry[e] = y1;
    }
    __syncthreads();
    if (halo) continue;
    for (int e = tid; e < kF * kLanes; e += kThreads) {
      const int f = e / kLanes, j = e % kLanes;
      const float m = sM[e];
      const float l = j > 0 ? sM[e - 1] : neg_inf();
      const float r = j < kLanes - 1 ? sM[e + 1] : neg_inf();
      sMM[f * kLdS + j] = __float2bfloat16(fmaxf(fmaxf(l, m), r));
    }
    __syncthreads();
    // tot (64, 64) += s (64, 128) @ mm^T: warp owns row tile warp / 2, two column tiles.
    {
      const int mt = warp / 2, nt0 = (warp % 2) * 2;
#pragma unroll
      for (int k = 0; k < kLanes; k += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, sS + mt * 16 * kLdS + k, kLdS);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          FragBt fb;
          wmma::load_matrix_sync(fb, sMM + (nt0 + n) * 16 * kLdS + k, kLdS);
          wmma::mma_sync(tot[n], fa, fb, tot[n]);
        }
      }
    }
  }

  if (PHASE == kGemm) {
    __syncthreads();
    const int n0 = warp * 32;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wmma::store_matrix_sync(ys + m * 16 * kLdB + n0 + n * 16, acc[m][n], kLdB,
                                wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kF * kLanes; e += kThreads) {
      const int f = e / kLanes, j = e % kLanes;
      atomicAdd(outb + e, ys[f * kLdB + j] + ys[f * kLdB + kLanes + j]);
    }
  } else if (PHASE == kFull) {
    __syncthreads();
    const int mt = warp / 2, nt0 = (warp % 2) * 2;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      wmma::store_matrix_sync(ys + mt * 16 * kLdB + (nt0 + n) * 16, tot[n], kLdB,
                              wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kF * kF; e += kThreads) {
      const int f = e / kF, c = e % kF;
      atomicAdd(outb + f * kLanes + c, ys[f * kLdB + c]);
    }
  }
}

template <int PHASE, typename TIn>
cudaError_t launch(const void* x, const void* a, const void* g, const void* bn_b,
                   const void* s, void* out, int B, int rows, int conv_rows,
                   cudaStream_t stream) {
  auto kernel = stem_probe_kernel<PHASE, TIn>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(conv_rows / kRowsPerBlock, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const __nv_bfloat16*>(a),
      static_cast<const float*>(g), static_cast<const float*>(bn_b),
      static_cast<const __nv_bfloat16*>(s), static_cast<float*>(out), rows);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t dispatch(int phase, const void* x, const void* a, const void* g,
                     const void* bn_b, const void* s, void* out, int B, int rows,
                     int conv_rows, cudaStream_t stream) {
  switch (phase) {
    case kRolls: return launch<kRolls, TIn>(x, a, g, bn_b, s, out, B, rows, conv_rows, stream);
    case kIm2col: return launch<kIm2col, TIn>(x, a, g, bn_b, s, out, B, rows, conv_rows, stream);
    case kGemm: return launch<kGemm, TIn>(x, a, g, bn_b, s, out, B, rows, conv_rows, stream);
    case kFull: return launch<kFull, TIn>(x, a, g, bn_b, s, out, B, rows, conv_rows, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// phase: 0 rolls, 1 im2col, 2 gemm, 3 full; in_bf16: the planes' type (else
// f32). out (B, 64, 128) f32 must be zero on entry.
extern "C" int mhent_stem_probe(const void* x, const void* a, const void* g, const void* bn_b,
                                const void* s, void* out, int B, int rows, int conv_rows,
                                int phase, int in_bf16, void* stream) {
  if (B < 1 || conv_rows < 2 * kRowsPerBlock || conv_rows % kRowsPerBlock ||
      2 * conv_rows + 6 > rows || phase < 0 || phase > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      in_bf16 ? dispatch<__nv_bfloat16>(phase, x, a, g, bn_b, s, out, B, rows, conv_rows, st)
              : dispatch<float>(phase, x, a, g, bn_b, s, out, B, rows, conv_rows, st);
  return (int)err;
}
