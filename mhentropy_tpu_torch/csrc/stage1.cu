// ResNet-50 stage 1 for Hopper (sm_90a): one launch per bottleneck block,
// 1x1 (Cin -> 64) + bias + ReLU -> 3x3 (64 -> 64) + bias + ReLU -> 1x1
// (64 -> 256) + bias + residual + ReLU, with eval BatchNorm folded into every
// GEMM's weights and bias. Block 0's downsample 1x1 (64 -> 256) accumulates
// into the same accumulators as its conv3.
//
// Replaces mhentropy_tpu/models/stage1_pallas.py::stage1_forward (the Pallas
// `_kernel` at :64, launched at :225), which ran all three blocks in one
// VMEM-resident kernel.
//
// What bounds it on the H100: device-memory traffic of the 64- and
// 256-channel intermediates. Unfused, each bottleneck writes and re-reads two
// (B, H, W, 64) tensors plus a (B, H, W, 256) conv3 output before the residual
// add; the products themselves (about 0.9 GFLOP per 64x64 image for the
// stage) are small for the tensor cores.
//
// Design: one block owns a kTh x kTw tile of output pixels. It loads the
// (kTh + 2) x (kTw + 2) input halo into shared memory, computes the 1x1
// conv1 on the whole halo (h1 outside the image is forced to zero: that is
// the 3x3's zero padding), runs the 3x3 as nine shifted K = 64 products over
// the halo (a 16-pixel output row tile is 16 consecutive halo pixels, so each
// tap is a plain strided WMMA load), then conv3 (+ downsample) from shared
// memory, and writes only the bf16 NHWC block output. All products are WMMA
// bf16 x bf16 with f32 accumulation; h1 and h2 are rounded to bf16 in shared
// memory, as the TPU kernel held them in VMEM. Any H and W are accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kTh = 4, kTw = 16;            // output tile (rows x cols)
constexpr int kHw = kTw + 2;                // halo width
constexpr int kHalo = (kTh + 2) * kHw;      // 108 halo pixels
constexpr int kHaloPad = 112;               // 7 WMMA row tiles
constexpr int kMid = 64, kOut = 256;
constexpr int kPix = kTh * kTw;             // 64 output pixels
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 256;                 // floats of per-warp staging

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Params {
  const __nv_bfloat16* x;    // (B, H, W, cin)
  const __nv_bfloat16* w1;   // (cin, 64)      [in, out]
  const float* b1;           // (64,)
  const __nv_bfloat16* w2;   // (9, 64, 64)    [tap = (dy + 1) * 3 + dx + 1, in, out]
  const float* b2;           // (64,)
  const __nv_bfloat16* w3;   // (64, 256)
  const __nv_bfloat16* wd;   // (cin, 256) or null for the identity residual
  const float* b3;           // (256,), the downsample's bias already added
  __nv_bfloat16* out;        // (B, H, W, 256)
  int H, W, cin;
};

size_t smem_bytes(int cin) {
  return sizeof(__nv_bfloat16) * (kHaloPad * cin + kHaloPad * kMid + kPix * kMid) +
         sizeof(float) * kWarps * kStage;
}

__global__ void __launch_bounds__(kThreads) bottleneck_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cin = p.cin, H = p.H, W = p.W;
  // Region sizes are multiples of 32 bytes, so every WMMA pointer is aligned.
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem);  // (kHaloPad, cin)
  __nv_bfloat16* s_h1 = s_x + kHaloPad * cin;                    // (kHaloPad, 64)
  __nv_bfloat16* s_h2 = s_h1 + kHaloPad * kMid;                  // (kPix, 64)
  float* stage = reinterpret_cast<float*>(s_h2 + kPix * kMid);   // (kWarps, kStage)

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTh, tx0 = blockIdx.x * kTw;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* my_stage = stage + warp * kStage;

  // Halo load in 16-byte chunks; pixels outside the image (and the 4 pad
  // rows) read as zero.
  const int chunks = cin / 8;
  for (int e = tid; e < kHaloPad * chunks; e += kThreads) {
    const int pix = e / chunks, ch = e % chunks;
    const int y = ty0 - 1 + pix / kHw, xx = tx0 - 1 + pix % kHw;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (pix < kHalo && y >= 0 && y < H && xx >= 0 && xx < W)
      v = *reinterpret_cast<const uint4*>(p.x + (((size_t)b * H + y) * W + xx) * cin + ch * 8);
    *reinterpret_cast<uint4*>(s_x + pix * cin + ch * 8) = v;
  }
  __syncthreads();

  // conv1 over the halo: 7 row tiles x 4 column tiles, one row tile a warp.
  if (warp < kHaloPad / 16) {
    const int rt = warp;
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int k = 0; k < cin; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, s_x + rt * 16 * cin + k, cin);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bf;
        wmma::load_matrix_sync(bf, p.w1 + (size_t)k * kMid + j * 16, kMid);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(my_stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int pix = rt * 16 + e / 16, c = j * 16 + e % 16;
        const int y = ty0 - 1 + pix / kHw, xx = tx0 - 1 + pix % kHw;
        const bool inside = pix < kHalo && y >= 0 && y < H && xx >= 0 && xx < W;
        const float v = inside ? fmaxf(my_stage[e] + p.b1[c], 0.0f) : 0.0f;
        s_h1[pix * kMid + c] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // conv2 (3x3): output row tile rt = tile row, 2 column tiles a warp.
  {
    const int rt = warp / 2, j0 = (warp % 2) * 2;
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const __nv_bfloat16* base = s_h1 + ((rt + 1 + dy) * kHw + 1 + dx) * kMid;
      const __nv_bfloat16* wt = p.w2 + (size_t)tap * kMid * kMid;
#pragma unroll
      for (int k = 0; k < kMid; k += 16) {
        FragA a;
        wmma::load_matrix_sync(a, base + k, kMid);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB bf;
          wmma::load_matrix_sync(bf, wt + k * kMid + (j0 + j) * 16, kMid);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(my_stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int c = (j0 + j) * 16 + e % 16;
        s_h2[(rt * 16 + e / 16) * kMid + c] =
            __float2bfloat16(fmaxf(my_stage[e] + p.b2[c], 0.0f));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // conv3 (+ downsample) + bias + residual + ReLU: 8 column tiles a warp.
  {
    const int rt = warp / 2, j0 = (warp % 2) * 8;
    FragC acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int k = 0; k < kMid; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, s_h2 + rt * 16 * kMid + k, kMid);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB bf;
        wmma::load_matrix_sync(bf, p.w3 + k * kOut + (j0 + j) * 16, kOut);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
    const __nv_bfloat16* centre = s_x + ((rt + 1) * kHw + 1) * cin;  // tile row rt
    if (p.wd != nullptr) {
      for (int k = 0; k < cin; k += 16) {
        FragA a;
        wmma::load_matrix_sync(a, centre + k, cin);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          FragB bf;
          wmma::load_matrix_sync(bf, p.wd + (size_t)k * kOut + (j0 + j) * 16, kOut);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
    }
    const int y = ty0 + rt;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wmma::store_matrix_sync(my_stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = e / 16, c = (j0 + j) * 16 + e % 16, xx = tx0 + i;
        float v = my_stage[e] + p.b3[c];
        if (p.wd == nullptr) v += __bfloat162float(centre[i * cin + c]);
        if (y < H && xx < W)
          p.out[(((size_t)b * H + y) * W + xx) * kOut + c] = __float2bfloat16(fmaxf(v, 0.0f));
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int mhent_stage1_block(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* wd, const void* b3, void* out, int B, int H,
                                  int W, int cin, void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin % 16 || cin < 16 || (wd == nullptr && cin != kOut))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.w3 = static_cast<const __nv_bfloat16*>(w3);
  p.wd = static_cast<const __nv_bfloat16*>(wd);
  p.b3 = static_cast<const float*>(b3);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.W = W;
  p.cin = cin;
  const size_t smem = smem_bytes(cin);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTw - 1) / kTw, (H + kTh - 1) / kTh, B);
  bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
