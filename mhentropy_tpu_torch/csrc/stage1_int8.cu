// W8A8 ResNet-50 stage 1 for Hopper (sm_90a): one launch per bottleneck,
// s8 x s8 -> s32 tensor-core products (mma.sync m16n8k32) with the f32
// epilogues of the quantised eval path:
//
//   xq  = clip(rint(x * inv_in), +-127)                  (block input, once)
//   h1q = clip(rint(relu(acc1 * s1' + b1')), +-127)      (conv1, requant folded)
//   h2q = clip(rint(relu(acc2 * s2' + b2')), +-127)      (3x3 conv2)
//   y   = relu((acc3 * s3 + b3) + res)                   (conv3, f32 residual)
//   res = accd * sd + bd on block 0 (downsample on the same xq), else the
//         block input itself in f32.
//
// Replaces mhentropy_tpu/models/stage1_int8.py::stage1_forward_q (the Pallas
// `_kernel` at :46, launched at :274), which ran the three blocks in one
// kernel with the f32 block output resident in VMEM. The arithmetic and its
// order are the TPU kernel's (pinned by tests/test_stage1_int8.py's numpy
// replica): every multiply and add of an epilogue is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction), rint is round-half-even like
// jnp.round, and the integer products are exact.
//
// What bounds it on the H100: at B = 8, 64 x 64 the stage does 14.0 GOP of
// s8 products (7.1 us at the 1,979 TOP/s int8 peak) and must read the bf16
// input (4.2 MB) and write the bf16 output (16.8 MB, 6.3 us at 3.35 TB/s):
// the two bounds are close. Between the blocks this simple version keeps
// the f32 block output in device memory (33.6 MB written and read twice),
// because the residual is added in f32.
//
// Design: as csrc/stage1.cu, one block owns a 4 x 16 tile of output pixels.
// It quantises the (4 + 2) x (16 + 2) input halo into shared memory as s8
// (pixel rows padded by 16 bytes, so the fragment loads of 8 rows hit 8
// different banks), runs conv1 on the halo (h1 outside the image is the
// quantised zero: the 3x3's zero padding), the 3x3 as nine shifted K = 64
// products over the halo, and conv3 (+ downsample) on the tile, with every
// epilogue applied to the accumulator registers. Only the block output
// leaves the SM. Any H and W are accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "int8_mma.cuh"

namespace {

constexpr int kTh = 4, kTw = 16;            // output tile (rows x cols)
constexpr int kHw = kTw + 2;                // halo width
constexpr int kHalo = (kTh + 2) * kHw;      // 108 halo pixels
constexpr int kHaloPad = 112;               // 7 MMA row tiles
constexpr int kMid = 64, kOut = 256;
constexpr int kMidStride = kMid + 16;       // bytes per pixel row in smem
constexpr int kPix = kTh * kTw;             // 64 output pixels
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* x;            // (B, H, W, cin): bf16 on block 0, else f32
  const float* inv_in;      // (1,) quantise factor of the block input
  const int8_t* w1;         // (64, cin)   [out, in]
  const float* s1;          // (64,) conv1 scale * conv2 inv_sa
  const float* b1;          // (64,) conv1 bias * conv2 inv_sa
  const int8_t* w2;         // (64, 576)   [out, tap * 64 + in], tap = (dy+1)*3 + dx+1
  const float* s2;          // (64,) conv2 scale * conv3 inv_sa
  const float* b2;
  const int8_t* w3;         // (256, 64)   [out, in]
  const float* s3;          // (256,)
  const float* b3;
  const int8_t* wd;         // (256, 64) downsample [out, in], block 0 only
  const float* sd;
  const float* bd;
  void* out;                // (B, H, W, 256): f32, or bf16 on the last block
  int H, W;
};

__device__ __forceinline__ float epi(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

template <int CIN, bool FIRST, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads) bottleneck_q_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kInStride = CIN + 16;
  int8_t* s_x = reinterpret_cast<int8_t*>(smem);   // (kHaloPad, kInStride)
  int8_t* s_h1 = s_x + kHaloPad * kInStride;       // (kHaloPad, kMidStride)
  int8_t* s_h2 = s_h1 + kHaloPad * kMidStride;     // (kPix, kMidStride)

  const int H = p.H, W = p.W;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTh, tx0 = blockIdx.x * kTw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float inv_in = *p.inv_in;

  // Halo load, quantised: 4 channels a thread; outside the image (and the
  // 4 pad rows) is the quantised zero.
  constexpr int kQuads = CIN / 4;
  for (int e = tid; e < kHaloPad * kQuads; e += kThreads) {
    const int pix = e / kQuads, c = (e % kQuads) * 4;
    const int y = ty0 - 1 + pix / kHw, xx = tx0 - 1 + pix % kHw;
    char4 q = make_char4(0, 0, 0, 0);
    if (pix < kHalo && y >= 0 && y < H && xx >= 0 && xx < W) {
      const size_t off = (((size_t)b * H + y) * W + xx) * CIN + c;
      float v[4];
      if (FIRST) {
        const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(p.x) + off);
        const float2 lo = __bfloat1622float2(src[0]), hi = __bfloat1622float2(src[1]);
        v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
      } else {
        const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(p.x) + off);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      }
      q = make_char4(quant(__fmul_rn(v[0], inv_in)), quant(__fmul_rn(v[1], inv_in)),
                     quant(__fmul_rn(v[2], inv_in)), quant(__fmul_rn(v[3], inv_in)));
    }
    *reinterpret_cast<char4*>(s_x + pix * kInStride + c) = q;
  }
  __syncthreads();

  // conv1 over the halo: 7 row tiles, one a warp, all 8 column tiles.
  if (warp < kHaloPad / 16) {
    int acc[8][4] = {};
    for (int k = 0; k < CIN; k += 32) {
      unsigned a[4];
      load_a(a, s_x + warp * 16 * kInStride + k, kInStride);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        unsigned bf[2];
        load_b(bf, p.w1 + (size_t)n * 8 * CIN + k, CIN);
        mma_s8(acc[n], a, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pix = warp * 16 + g + (i >> 1) * 8, c = n * 8 + t * 2 + (i & 1);
        const int y = ty0 - 1 + pix / kHw, xx = tx0 - 1 + pix % kHw;
        const bool inside = pix < kHalo && y >= 0 && y < H && xx >= 0 && xx < W;
        s_h1[pix * kMidStride + c] =
            inside ? quant(fmaxf(epi(acc[n][i], p.s1[c], p.b1[c]), 0.0f)) : (int8_t)0;
      }
    }
  }
  __syncthreads();

  // conv2 (3x3): row tile rt = tile row, 4 column tiles a warp.
  {
    const int rt = warp >> 1, n0 = (warp & 1) * 4;
    int acc[4][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int8_t* base = s_h1 + ((rt + 1 + dy) * kHw + 1 + dx) * kMidStride;
#pragma unroll
      for (int k = 0; k < kMid; k += 32) {
        unsigned a[4];
        load_a(a, base + k, kMidStride);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          unsigned bf[2];
          load_b(bf, p.w2 + (size_t)(n0 + n) * 8 * 576 + tap * kMid + k, 576);
          mma_s8(acc[n], a, bf);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pix = rt * 16 + g + (i >> 1) * 8, c = (n0 + n) * 8 + t * 2 + (i & 1);
        s_h2[pix * kMidStride + c] = quant(fmaxf(epi(acc[n][i], p.s2[c], p.b2[c]), 0.0f));
      }
    }
  }
  __syncthreads();

  // conv3 (+ downsample) + residual + ReLU: 16 column tiles a warp, in two
  // halves of 8 to bound the accumulator registers.
  const int rt = warp >> 1;
  const int y = ty0 + rt;
  const int8_t* centre = s_x + ((rt + 1) * kHw + 1) * kInStride;  // tile row rt
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int n0 = (warp & 1) * 16 + half * 8;
    int acc[8][4] = {};
    int accd[8][4] = {};
#pragma unroll
    for (int k = 0; k < kMid; k += 32) {
      unsigned a[4];
      load_a(a, s_h2 + rt * 16 * kMidStride + k, kMidStride);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        unsigned bf[2];
        load_b(bf, p.w3 + (size_t)(n0 + n) * 8 * kMid + k, kMid);
        mma_s8(acc[n], a, bf);
      }
    }
    if (FIRST) {
#pragma unroll
      for (int k = 0; k < CIN; k += 32) {
        unsigned a[4];
        load_a(a, centre + k, kInStride);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          unsigned bf[2];
          load_b(bf, p.wd + (size_t)(n0 + n) * 8 * CIN + k, CIN);
          mma_s8(accd[n], a, bf);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = tx0 + g + (i >> 1) * 8, c = (n0 + n) * 8 + t * 2 + (i & 1);
        if (y >= H || col >= W) continue;
        const size_t off = (((size_t)b * H + y) * W + col) * kOut + c;
        const float y3 = epi(acc[n][i], p.s3[c], p.b3[c]);
        const float res = FIRST ? epi(accd[n][i], p.sd[c], p.bd[c])
                                : static_cast<const float*>(p.x)[off];
        const float o = fmaxf(__fadd_rn(y3, res), 0.0f);
        if (OUT_BF16)
          static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16(o);
        else
          static_cast<float*>(p.out)[off] = o;
      }
    }
  }
}

template <int CIN, bool FIRST, bool OUT_BF16>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = bottleneck_q_kernel<CIN, FIRST, OUT_BF16>;
  const size_t smem = (size_t)kHaloPad * (CIN + 16) + (size_t)kHaloPad * kMidStride +
                      (size_t)kPix * kMidStride;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + kTw - 1) / kTw, (p.H + kTh - 1) / kTh, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// block: 0 (bf16 64-channel input, downsample, f32 output), 1 (f32 256-channel
// input and output) or 2 (f32 input, bf16 output).
extern "C" int mhent_stage1_int8_block(const void* x, const void* inv_in, const void* w1,
                                       const void* s1, const void* b1, const void* w2,
                                       const void* s2, const void* b2, const void* w3,
                                       const void* s3, const void* b3, const void* wd,
                                       const void* sd, const void* bd, void* out, int B,
                                       int H, int W, int block, void* stream) {
  if (B < 1 || H < 1 || W < 1 || block < 0 || block > 2 || (block == 0 && wd == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.inv_in = static_cast<const float*>(inv_in);
  p.w1 = static_cast<const int8_t*>(w1);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.w3 = static_cast<const int8_t*>(w3);
  p.s3 = static_cast<const float*>(s3);
  p.b3 = static_cast<const float*>(b3);
  p.wd = static_cast<const int8_t*>(wd);
  p.sd = static_cast<const float*>(sd);
  p.bd = static_cast<const float*>(bd);
  p.out = out;
  p.H = H;
  p.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 0) return launch<kMid, true, false>(p, B, s);
  if (block == 1) return launch<kOut, false, false>(p, B, s);
  return launch<kOut, false, true>(p, B, s);
}
