// Cost probe of ResNet-50 stage 1 in two layouts for Hopper (sm_90a): one
// bottleneck a launch, pixel-major (variant A) or channel-major (variant B).
//
// Replaces tools/stage1_probe.py::_probe_variant_a (the Pallas kernel
// launched at :121) and ::_probe_variant_b (launched at :237). The function
// of one bottleneck, with no BN and no bias (the probe's weights stand for
// folded ones):
//   h1  = bf16(relu(x @ w1))                    (Cin -> 64)
//   acc = sum over the nine taps (dy, dx) of tap(h1) @ w2[tap]   (3x3, zero pad)
//   h2  = bf16(relu(acc))
//   out = bf16(relu(h2 @ w3 + res))             (64 -> 256)
// where res = x @ wd (f32, block 0) or x itself (blocks 1-2). The TPU kernel
// ran the 3x3 as 4.5 tap-pair products of K = 128 (`wp[block, pair]` holds
// taps 2p and 2p + 1 stacked on K; the tenth slot is zero): the same nine
// K = 64 products, which is how the weights are read here. Variant B is A
// with every operand transposed: activations (C, HW), weights [out, in].
//
// What bounds it on the H100: the products, 55.8 GFLOP for the stage at
// B = 32 (56 us at the bf16 peak); its bytes (the 64-channel input, the
// 256-channel output and the two 256-channel maps between the blocks) are
// about 84 MB written once and read once (25 us at 3.35 TB/s).
//
// Design: a block owns 128 consecutive pixels of one image (two 64-pixel
// rows) in flat HW order, as the TPU kernel addressed a tap as a flat pixel
// offset W dy + dx. It computes h1 over those pixels and W + 16 more on each
// side (zero outside the image: the 3x3's padding), streaming the input
// through shared memory 64 channels at a time. Three copies of h1 are kept,
// each shifted by dx and masked at the image's left or right edge, so that
// every tap is an aligned offset of W dy into one of them (WMMA needs 32-byte
// aligned tiles; a one-pixel offset in the channel-major layout is not). The
// 3x3 and conv3 (+ the downsample, into the same accumulators) then run from
// shared memory; only the bf16 block output goes back to device memory. One
// source serves both layouts: A reads activations as row-major (pixel, C)
// tiles and weights [in, out]; B reads them as column-major tiles of the
// (C, pixel) arrays and weights [out, in], and writes its (256, HW) output a
// channel row of 16 pixels (one 32-byte sector) at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kM = 128;        // output pixels a block
constexpr int kMid = 64, kOut = 256;
constexpr int kChunk = 64;     // input channels staged at a time
constexpr int kLdP = kMid + 16;  // pixel-major tile row stride (160 bytes)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxConv1Tiles = 9;  // (kM + 2 * 64 + 32) / 16 * 4 / kWarps at W = 64

template <bool CM>
struct Layout {
  // Shared tiles of `pixels` x 64 channels: (pixel, C) rows of kLdP, or
  // (C, pixel) rows of pixels + 16.
  __host__ __device__ static int ld(int pixels) { return CM ? pixels + 16 : kLdP; }
  __host__ __device__ static int at(int q, int c, int ld) { return CM ? c * ld + q : q * ld + c; }
  __host__ __device__ static size_t bytes(int pixels) {
    return sizeof(__nv_bfloat16) * (CM ? (size_t)kMid * (pixels + 16) : (size_t)pixels * kLdP);
  }
};

template <bool CM>
using FragAct = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               typename std::conditional<CM, wmma::col_major,
                                                         wmma::row_major>::type>;
template <bool CM>
using FragW = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             typename std::conditional<CM, wmma::col_major,
                                                       wmma::row_major>::type>;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Params {
  const __nv_bfloat16* x;   // A (B, HW, cin); B (B, cin, HW)
  const __nv_bfloat16* w1;  // A (cin, 64) [in, out]; B (64, cin) [out, in]
  const __nv_bfloat16* wp;  // A (5, 128, 64); B (5, 64, 128): taps 2p, 2p + 1 on K
  const __nv_bfloat16* w3;  // A (64, 256); B (256, 64)
  const __nv_bfloat16* wd;  // A (64, 256); B (256, 64); null: identity residual
  __nv_bfloat16* out;       // A (B, HW, 256); B (B, 256, HW)
  int H, W, cin;
};

size_t span1_of(int W) { return kM + 2 * W + 32; }  // pixels of h1 a block computes
size_t spanc_of(int W) { return kM + 2 * W; }       // pixels of each shifted copy

template <bool CM>
size_t smem_bytes(int W) {
  return Layout<CM>::bytes(span1_of(W)) + 3 * Layout<CM>::bytes(spanc_of(W)) +
         Layout<CM>::bytes(kM) + sizeof(float) * kWarps * 256;
}

// The weight tile (k0.., n0..) of a (K, N) product whose weights are stored
// [in, out] (row-major K x N) for A or [out, in] (column-major) for B.
template <bool CM>
__device__ __forceinline__ const __nv_bfloat16* wtile(const __nv_bfloat16* w, int K, int N,
                                                      int k0, int n0) {
  return CM ? w + (size_t)n0 * K + k0 : w + (size_t)k0 * N + n0;
}

template <bool CM>
__global__ void __launch_bounds__(kThreads) bottleneck_probe_kernel(Params p) {
  using L = Layout<CM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = p.W, HW = p.H * p.W, cin = p.cin;
  const int span1 = kM + 2 * W + 32, spanc = kM + 2 * W;
  const int ld1 = L::ld(span1), ldc = L::ld(spanc), ldm = L::ld(kM);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem);  // span1 x 64: an input chunk
  __nv_bfloat16* s_c[3];                                         // spanc x 64: h1 shifted by dx
  s_c[0] = s_x + L::bytes(span1) / 2;
  s_c[1] = s_c[0] + L::bytes(spanc) / 2;
  s_c[2] = s_c[1] + L::bytes(spanc) / 2;
  __nv_bfloat16* s_h2 = s_c[2] + L::bytes(spanc) / 2;             // kM x 64
  float* stage = reinterpret_cast<float*>(s_h2 + L::bytes(kM) / 2);

  const int b = blockIdx.y, p0 = blockIdx.x * kM;
  const int q1 = p0 - W - 16, qc = p0 - W;  // first pixel of h1's span, of the copies
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* my_stage = stage + warp * 256;
  const __nv_bfloat16* xb = p.x + (size_t)b * HW * cin;

  // conv1 over span1 pixels: tile tau = warp + 8 i, (row tile tau / 4, column tile tau % 4).
  const int n_tiles1 = span1 / 16 * 4;
  FragC acc1[kMaxConv1Tiles];
#pragma unroll
  for (int i = 0; i < kMaxConv1Tiles; ++i) wmma::fill_fragment(acc1[i], 0.0f);
  for (int k0 = 0; k0 < cin; k0 += kChunk) {
    __syncthreads();
    // Stage input channels k0 .. k0 + 63 of the span, 8 values (16 bytes) a load;
    // pixels outside the image read as zero.
    for (int e = tid; e < span1 * kChunk / 8; e += kThreads) {
      int s, c;
      if (CM) { c = e / (span1 / 8); s = (e % (span1 / 8)) * 8; }
      else { s = e / (kChunk / 8); c = (e % (kChunk / 8)) * 8; }
      const int q = q1 + s;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (q >= 0 && q < HW)  // spans are 16-aligned and HW % 128 == 0: 8 pixels share a side
        v = *reinterpret_cast<const uint4*>(
            CM ? xb + (size_t)(k0 + c) * HW + q : xb + (size_t)q * cin + k0 + c);
      *reinterpret_cast<uint4*>(s_x + L::at(s, c, ld1)) = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxConv1Tiles; ++i) {
      const int tau = warp + kWarps * i;
      if (tau >= n_tiles1) continue;  // uniform a warp; keeps acc1's indices static
      const int rt = tau / 4, ct = tau % 4;
#pragma unroll
      for (int k = 0; k < kChunk; k += 16) {
        FragAct<CM> fa;
        FragW<CM> fw;
        wmma::load_matrix_sync(fa, s_x + L::at(rt * 16, k, ld1), ld1);
        wmma::load_matrix_sync(fw, wtile<CM>(p.w1, cin, kMid, k0 + k, ct * 16), CM ? cin : kMid);
        wmma::mma_sync(acc1[i], fa, fw, acc1[i]);
      }
    }
  }
  // h1 = bf16(relu) into the three copies: copy[dx + 1][r] = h1[qc + r + dx], zero
  // where the pixel's column + dx leaves the image (and outside the image).
#pragma unroll
  for (int i = 0; i < kMaxConv1Tiles; ++i) {
    const int tau = warp + kWarps * i;
    if (tau >= n_tiles1) continue;
    const int rt = tau / 4, ct = tau % 4;
    wmma::store_matrix_sync(my_stage, acc1[i], 16, CM ? wmma::mem_col_major : wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int m = CM ? e % 16 : e / 16, n = CM ? e / 16 : e % 16;
      const int q = q1 + rt * 16 + m, c = ct * 16 + n;
      const bool inside = q >= 0 && q < HW;
      const __nv_bfloat16 v = __float2bfloat16(inside ? fmaxf(my_stage[e], 0.0f) : 0.0f);
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
      const int col = ((q % W) + W) % W, r = q - qc;
      if (r >= 0 && r < spanc) s_c[1][L::at(r, c, ldc)] = v;
      if (r - 1 >= 0 && r - 1 < spanc) s_c[2][L::at(r - 1, c, ldc)] = col != 0 ? v : zero;
      if (r + 1 >= 0 && r + 1 < spanc) s_c[0][L::at(r + 1, c, ldc)] = col != W - 1 ? v : zero;
    }
    __syncwarp();
  }
  __syncthreads();

  // conv2: output row tile `warp` (16 pixels) x 4 column tiles.
  {
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const __nv_bfloat16* src = s_c[dx + 1];
      const int r0 = W + warp * 16 + W * dy;
      const __nv_bfloat16* wt =
          p.wp + (size_t)(tap / 2) * 2 * kMid * kMid + (CM ? (tap % 2) * kMid
                                                           : (size_t)(tap % 2) * kMid * kMid);
#pragma unroll
      for (int k = 0; k < kMid; k += 16) {
        FragAct<CM> fa;
        wmma::load_matrix_sync(fa, src + L::at(r0, k, ldc), ldc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragW<CM> fw;
          // A: rows k of the pair's (128, 64) [K, out]; B: the pair's (64, 128) [out, K].
          wmma::load_matrix_sync(fw, CM ? wt + (size_t)j * 16 * 2 * kMid + k
                                        : wt + (size_t)k * kMid + j * 16,
                                 CM ? 2 * kMid : kMid);
          wmma::mma_sync(acc[j], fa, fw, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(my_stage, acc[j], 16, CM ? wmma::mem_col_major : wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = CM ? e % 16 : e / 16, n = CM ? e / 16 : e % 16;
        s_h2[L::at(warp * 16 + m, j * 16 + n, ldm)] = __float2bfloat16(fmaxf(my_stage[e], 0.0f));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // conv3 (+ the downsample) + residual + ReLU: row tile `warp`, 16 column
  // tiles in two passes of 8.
  for (int half = 0; half < 2; ++half) {
    FragC acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int k = 0; k < kMid; k += 16) {
      FragAct<CM> fa;
      wmma::load_matrix_sync(fa, s_h2 + L::at(warp * 16, k, ldm), ldm);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragW<CM> fw;
        wmma::load_matrix_sync(fw, wtile<CM>(p.w3, kMid, kOut, k, (half * 8 + j) * 16),
                               CM ? kMid : kOut);
        wmma::mma_sync(acc[j], fa, fw, acc[j]);
      }
    }
    if (p.wd != nullptr) {  // block 0: cin == 64, still staged in s_x
#pragma unroll
      for (int k = 0; k < kMid; k += 16) {
        FragAct<CM> fa;
        wmma::load_matrix_sync(fa, s_x + L::at(W + 16 + warp * 16, k, ld1), ld1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          FragW<CM> fw;
          wmma::load_matrix_sync(fw, wtile<CM>(p.wd, kMid, kOut, k, (half * 8 + j) * 16),
                                 CM ? kMid : kOut);
          wmma::mma_sync(acc[j], fa, fw, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wmma::store_matrix_sync(my_stage, acc[j], 16, CM ? wmma::mem_col_major : wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = CM ? e % 16 : e / 16, n = CM ? e / 16 : e % 16;
        const int q = p0 + warp * 16 + m, c = (half * 8 + j) * 16 + n;
        const size_t at = CM ? ((size_t)b * kOut + c) * HW + q : ((size_t)b * HW + q) * kOut + c;
        float v = my_stage[e];
        if (p.wd == nullptr) v += __bfloat162float(p.x[at]);  // cin == 256: same layout
        p.out[at] = __float2bfloat16(fmaxf(v, 0.0f));
      }
      __syncwarp();
    }
  }
}

template <bool CM>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<CM>(p.W);
  cudaError_t err = cudaFuncSetAttribute(bottleneck_probe_kernel<CM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H * p.W / kM, B);
  bottleneck_probe_kernel<CM><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One bottleneck of the probe. channel_major: variant B's layouts (else A's).
// wd non-null: block 0 (cin 64, downsample residual); null: cin 256, identity.
extern "C" int mhent_stage1_probe_block(const void* x, const void* w1, const void* wp,
                                        const void* w3, const void* wd, void* out, int B,
                                        int H, int W, int cin, int channel_major,
                                        void* stream) {
  if (B < 1 || H < 1 || W < 16 || W > 64 || W % 16 || (H * W) % kM ||
      cin != (wd != nullptr ? kMid : kOut))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.wp = static_cast<const __nv_bfloat16*>(wp);
  p.w3 = static_cast<const __nv_bfloat16*>(w3);
  p.wd = static_cast<const __nv_bfloat16*>(wd);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.W = W;
  p.cin = cin;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(channel_major ? launch<true>(p, B, st) : launch<false>(p, B, st));
}
