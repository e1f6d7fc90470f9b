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
// What bounds it on the H100: at B = 8, 256 x 256 it must read the f32
// image (6.3 MB) and write the bf16 output (4.2 MB), 3.1 us at 3.35 TB/s;
// its 2.5 GOP of s8 products take 1.2 us at the 1,979 TOP/s int8 peak. With
// 3 input channels the contraction is too shallow for the tensor cores, so
// the products are __dp4a (four s8 products and an s32 add an instruction).
//
// Design: csrc/stem.cu's tile. One block owns a 4 x 4 tile of pooled
// outputs for all 64 filters: it quantises the 23 x 23 x 3 input patch under
// them into shared memory, lays each input row out as nine 32-byte words
// of the 21 (kx, c) taps of one conv column (the last 11 bytes zero), so
// that a conv row of seven kernel rows is 7 x 6 dp4a on aligned words, and
// holds its filter's 42 weight words in registers (one thread per conv row
// and filter; a warp's 32 threads share the conv row, so the tap words
// broadcast). The 9 x 9 conv outputs under the pool windows go through the
// affine and ReLU into shared memory, and only the pooled tile leaves the
// SM. The TPU kernel's parity planes, lane rolls and selection matmul were
// layout tricks for its vector unit and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "int8_mma.cuh"

namespace {

constexpr int kTile = 4;                  // pooled outputs per block side
constexpr int kConv = 2 * kTile + 1;      // conv outputs per block side
constexpr int kIn = 2 * (kConv - 1) + 7;  // input pixels per block side (23)
constexpr int kF = 64;                    // filters
constexpr int kC = 3;                     // input channels
constexpr int kRowTaps = 24;              // 21 (kx, c) taps + 3 zero, 6 words
constexpr int kColBytes = 32;             // one conv column's row of taps in smem
constexpr int kThreads = kF * kConv;      // one thread per (conv row, filter)

// x: (B, H, W, 3) f32; wk: (7, 64, 24) s8 [ky][f][kx * 3 + c]; inv_a: (3,);
// scale, bias: (64,); out: (B, Hp, Wp, 64) bf16 or f32.
template <bool OUT_BF16>
__global__ void __launch_bounds__(kThreads)
    stem_int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ wk,
                     const float* __restrict__ inv_a, const float* __restrict__ scale,
                     const float* __restrict__ bias, void* __restrict__ out, int H, int W,
                     int Hc, int Wc, int Hp, int Wp) {
  __shared__ int8_t s_q[kIn * kIn * kC];                          // quantised patch
  __shared__ __align__(16) int8_t s_cols[kIn * kConv * kColBytes];  // [row][conv col][tap]
  __shared__ float s_conv[kConv * kConv * kF];                    // after affine + ReLU

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kTile, px0 = blockIdx.x * kTile;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // first conv row / col
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // first input row / col
  const int tid = threadIdx.x;

  for (int e = tid; e < kIn * kIn * kC; e += kThreads) {
    const int c = e % kC, xx = (e / kC) % kIn, yy = e / (kC * kIn);
    const int iy = iy0 + yy, ix = ix0 + xx;
    s_q[e] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                 ? quant(__fmul_rn(x[(((size_t)b * H + iy) * W + ix) * kC + c], inv_a[c]))
                 : (int8_t)0;
  }
  __syncthreads();
  // Word q of (row yy, conv column j): taps 4q..4q+3, tap t = kx * 3 + c
  // reads input column 2 j + kx of row yy.
  for (int e = tid; e < kIn * kConv * (kColBytes / 4); e += kThreads) {
    const int q = e % (kColBytes / 4), j = (e / (kColBytes / 4)) % kConv;
    const int yy = e / ((kColBytes / 4) * kConv);
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * q + i;
      if (t < 21) {
        const unsigned char v = (unsigned char)s_q[(yy * kIn + 2 * j) * kC + t];
        word |= (unsigned)v << (8 * i);
      }
    }
    reinterpret_cast<unsigned*>(s_cols)[e] = word;
  }

  const int f = tid % kF, r = tid / kF;
  int wr[7][kRowTaps / 4];
#pragma unroll
  for (int ky = 0; ky < 7; ++ky) {
    const int* src = reinterpret_cast<const int*>(wk + ((size_t)ky * kF + f) * kRowTaps);
#pragma unroll
    for (int q = 0; q < kRowTaps / 4; ++q) wr[ky][q] = __ldg(src + q);
  }
  __syncthreads();

  int acc[kConv];
#pragma unroll
  for (int j = 0; j < kConv; ++j) acc[j] = 0;
#pragma unroll
  for (int ky = 0; ky < 7; ++ky) {
    const int4* row = reinterpret_cast<const int4*>(s_cols + (2 * r + ky) * kConv * kColBytes);
#pragma unroll
    for (int j = 0; j < kConv; ++j) {
      const int4 lo = row[2 * j], hi = row[2 * j + 1];
      int a = acc[j];
      a = __dp4a(lo.x, wr[ky][0], a);
      a = __dp4a(lo.y, wr[ky][1], a);
      a = __dp4a(lo.z, wr[ky][2], a);
      a = __dp4a(lo.w, wr[ky][3], a);
      a = __dp4a(hi.x, wr[ky][4], a);
      a = __dp4a(hi.y, wr[ky][5], a);
      acc[j] = a;
    }
  }
  const float sf = scale[f], bf = bias[f];
#pragma unroll
  for (int j = 0; j < kConv; ++j)
    s_conv[(r * kConv + j) * kF + f] =
        fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[j]), sf), bf), 0.0f);
  __syncthreads();

  // Conv positions outside the conv output are the pool's -inf padding;
  // every window holds a real ReLU'd (>= 0) output, so the max starts at 0.
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
    const size_t off = (((size_t)b * Hp + oy) * Wp + ox) * kF + ff;
    if (OUT_BF16)
      static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16(m);
    else
      static_cast<float*>(out)[off] = m;
  }
}

}  // namespace

extern "C" int mhent_stem_int8_forward(const void* x, const void* wk, const void* inv_a,
                                       const void* scale, const void* bias, void* out, int B,
                                       int H, int W, int out_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;
  const dim3 grid((Wp + kTile - 1) / kTile, (Hp + kTile - 1) / kTile, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* w8 = static_cast<const int8_t*>(wk);
  const float* ia = static_cast<const float*>(inv_a);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (out_bf16)
    stem_int8_kernel<true><<<grid, kThreads, 0, s>>>(xf, w8, ia, sc, bi, out, H, W, Hc, Wc, Hp,
                                                     Wp);
  else
    stem_int8_kernel<false><<<grid, kThreads, 0, s>>>(xf, w8, ia, sc, bi, out, H, W, Hc, Wc,
                                                      Hp, Wp);
  return (int)cudaGetLastError();
}
