// Fused ResNet stem for Hopper (sm_90a): conv 7x7 stride 2 pad 3 (3 -> 64
// channels, no bias) + eval BatchNorm + ReLU + maxpool 3x3 stride 2 pad 1.
//
// Replaces mhentropy_tpu/models/stem_pallas.py::stem_forward (the Pallas
// `_kernel` at :49, launched at :172).
//
// What bounds it on the H100: 147 multiply-adds per conv output with only 3
// input channels, which is too shallow a contraction for the tensor cores to
// pay off, and the round trip of the (B, H/2, W/2, 64) conv output through
// device memory when conv, BN, ReLU and pool run as separate passes (the
// plain PyTorch path writes and re-reads 4x the pooled output's bytes).
//
// Design: one block owns a kTile x kTile tile of pooled outputs for all 64
// filters. It loads the input patch under those pools (kIn x kIn x 3) and the
// folded weights into shared memory, computes the (2 kTile + 1)^2 conv
// outputs under the pool windows with f32 FMAs (one thread per conv row and
// filter, nine accumulators each), applies the folded BN bias and ReLU into
// shared memory, and takes the 3x3/2 max there. Only the pooled bf16 NHWC
// tile goes back to device memory. The TPU kernel's parity planes, lane rolls
// and selection matmul were layout tricks for the 128-lane vector unit; none
// of them is needed here, and any H and W are accepted.
//
// BN arrives folded into the weights (w' = w g, b' = beta - mean g with
// g = gamma / sqrt(var + eps)), as in stem_pallas.py:162-166. Conv positions
// outside the conv output act as -inf pool padding; since every pool window
// holds at least one real, ReLU'd (>= 0) output, the max starts at 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 4;                 // pooled outputs per block side
constexpr int kConv = 2 * kTile + 1;     // conv outputs per block side
constexpr int kIn = 2 * (kConv - 1) + 7; // input pixels per block side
constexpr int kF = 64;                   // filters
constexpr int kC = 3;                    // input channels
constexpr int kTaps = 7 * 7 * kC;        // 147
constexpr int kThreads = kF * kConv;     // one thread per (conv row, filter)

size_t smem_bytes() {
  return sizeof(float) * (kTaps * kF + kIn * kIn * kC + kConv * kConv * kF);
}

// x: (B, H, W, 3) bf16; w: (147, 64) bf16, tap index (ky * 7 + kx) * 3 + c;
// bias: (64,) f32; out: (B, Hp, Wp, 64) bf16.
__global__ void __launch_bounds__(kThreads)
    stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H,
                int W, int Hc, int Wc, int Hp, int Wp) {
  extern __shared__ __align__(16) float sm[];
  float* s_w = sm;                        // (147, 64)
  float* s_in = s_w + kTaps * kF;         // (kIn, kIn, 3)
  float* s_conv = s_in + kIn * kIn * kC;  // (kConv, kConv, 64) after BN + ReLU

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kTile, px0 = blockIdx.x * kTile;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // first conv row / col
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // first input row / col
  const int tid = threadIdx.x;

  for (int e = tid; e < kTaps * kF; e += kThreads) s_w[e] = __bfloat162float(w[e]);
  for (int e = tid; e < kIn * kIn * kC; e += kThreads) {
    const int c = e % kC, xx = (e / kC) % kIn, yy = e / (kC * kIn);
    const int iy = iy0 + yy, ix = ix0 + xx;
    s_in[e] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                  ? __bfloat162float(x[(((size_t)b * H + iy) * W + ix) * kC + c])
                  : 0.0f;
  }
  __syncthreads();

  // A warp's 32 threads share one conv row, so the input reads broadcast.
  const int f = tid % kF, r = tid / kF;
  float acc[kConv];
#pragma unroll
  for (int j = 0; j < kConv; ++j) acc[j] = 0.0f;
  for (int ky = 0; ky < 7; ++ky) {
    const float* row = s_in + (2 * r + ky) * kIn * kC;
    for (int kx = 0; kx < 7; ++kx) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float wv = s_w[((ky * 7 + kx) * kC + c) * kF + f];
#pragma unroll
        for (int j = 0; j < kConv; ++j) acc[j] += row[(2 * j + kx) * kC + c] * wv;
      }
    }
  }
  const float bf = bias[f];
#pragma unroll
  for (int j = 0; j < kConv; ++j) s_conv[(r * kConv + j) * kF + f] = fmaxf(acc[j] + bf, 0.0f);
  __syncthreads();

  for (int e = tid; e < kTile * kTile * kF; e += kThreads) {
    const int ff = e % kF, px = (e / kF) % kTile, py = e / (kF * kTile);
    const int oy = py0 + py, ox = px0 + px;
    if (oy >= Hp || ox >= Wp) continue;
    float m = 0.0f;
    for (int dy = 0; dy < 3; ++dy) {
      const int cy = cy0 + 2 * py + dy;
      if (cy < 0 || cy >= Hc) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int cx = cx0 + 2 * px + dx;
        if (cx < 0 || cx >= Wc) continue;
        m = fmaxf(m, s_conv[((2 * py + dy) * kConv + 2 * px + dx) * kF + ff]);
      }
    }
    out[(((size_t)b * Hp + oy) * Wp + ox) * kF + ff] = __float2bfloat16(m);
  }
}

}  // namespace

extern "C" int mhent_stem_forward(const void* x, const void* w, const void* bias, void* out,
                                  int B, int H, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Wp + kTile - 1) / kTile, (Hp + kTile - 1) / kTile, B);
  stem_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W, Hc, Wc, Hp,
      Wp);
  return (int)cudaGetLastError();
}
