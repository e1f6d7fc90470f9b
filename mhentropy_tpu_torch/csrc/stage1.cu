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
// What bounds it on the H100: the tensor-core products and the way they are
// fed, not device memory. At B = 32, 64 x 64 the stage does 30 G
// multiply-adds (0.23 M an output pixel, conv1's halo recompute included)
// and moves about 350 MB over its three launches: 0.06 ms at the dense bf16
// peak, 0.1 ms at 3.35 TB/s. It takes about 0.41 ms on an H100 SXM at
// 700 W (PERF.md): mma.sync from 8 warps an SM, with the phases of a tile
// separated by block barriers and each tile's loads only partly hidden
// behind the previous tile's products. The weights cross L2 once a block,
// not once a warp and tile.
//
// Design:
// - Persistent blocks: grid = min(tiles, SMs), one 256-thread block an SM.
//   Each block loads the bottleneck's w2 and w3 (and, at cin 64, w1 and the
//   downsample wd) into shared memory once and walks its tiles.
// - A tile is 8 x 16 output pixels: each output row is one m16 row tile,
//   so the 3x3's taps and conv3 read whole rows, and the 8 rows split
//   evenly over 8 warps. Its 10 x 18 input halo is 180 pixels, 12 m16
//   row tiles of which the last 12 rows are clamped reads whose results
//   are dropped. conv1's halo recompute is 180 / 128 = 1.41x (a 4 x 16
//   tile: 108 / 64 = 1.69x).
// - conv1 runs over the halo in 64-channel K chunks (one at cin 64, four at
//   cin 256): the halo chunk and, at cin 256, the w1 chunk arrive by
//   cp.async into one of two buffers while the other chunk's product runs.
//   At cin 256 the next tile's first chunk is prefetched during this tile's
//   conv2 and conv3, and the identity residual is read from device memory
//   (L2) in the epilogue, so the halo buffers need not outlive conv1. At
//   cin 64 the downsample reads the halo's centre pixels during conv3, so
//   the halo buffer and the h1 buffer swap roles from tile to tile and the
//   next tile's halo arrives in the old h1 buffer during conv3.
// - Products are mma.sync.m16n8k16 bf16 x bf16 -> f32, A and B fed by
//   ldmatrix (B with .trans from the [in, out] weights). Every shared tile
//   has 128- or 512-byte rows with 16-byte chunk c stored at c ^ (row & 7),
//   so each 8-row ldmatrix phase touches all 32 banks once. The 3x3 conv
//   reads each tap's shifted halo rows by handing ldmatrix the shifted row
//   addresses: no copy.
// - Epilogues run on the accumulator registers: bias (from shared memory)
//   + ReLU; h1 outside the image is forced to zero (the 3x3's zero
//   padding); h1 and h2 are rounded to bf16 in shared memory, as the TPU
//   kernel held them in VMEM. conv3's bf16(acc + bias) goes through a 2 KB
//   per-warp bf16 tile, from which the residual add, ReLU and the output
//   are done with 16-byte loads and stores (with the identity residual
//   the sum is rounded to bf16 twice, before and after the add).
//
// Shared memory (bytes): w2 73,728 + w3 32,768 + biases 1,536 + h2 16,384
// + epilogue tiles 16,384 + two 180-pixel x 64-channel buffers 46,080, then
// at cin 256 a third such buffer (h1) 23,040 + two w1 chunks 16,384
// (226,304 in all), or at cin 64 w1 8,192 + wd 32,768 (227,840): both
// under the 232,448 a block may use. A wider tile would not fit beside the
// resident weights; a narrower one recomputes more halo and reloads the
// halo's edge more often.
//
// Any H and W are accepted (ragged tiles mask their loads and stores);
// cin is 64 with a downsample (block 0) or 256 without (blocks 1-2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_sm80.cuh"

namespace {

constexpr int kTh = 8, kTw = 16;        // output tile (rows x cols)
constexpr int kHw = kTw + 2;            // halo width
constexpr int kHalo = (kTh + 2) * kHw;  // 180 halo pixels
constexpr int kPix = kTh * kTw;         // 128 output pixels
constexpr int kMid = 64, kOut = 256, kChunk = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Shared-memory regions (bytes); every offset is a multiple of 128.
constexpr int kTileBytes = kHalo * 128;  // 180 pixels x 64 channels
constexpr int kOffW2 = 0;
constexpr int kOffW3 = kOffW2 + 9 * kMid * 128;
constexpr int kOffBias = kOffW3 + kMid * kOut * 2;
constexpr int kOffH2 = kOffBias + (kMid + kMid + kOut) * 4;
constexpr int kOffStage = kOffH2 + kPix * 128;
constexpr int kOffBuf0 = kOffStage + kWarps * 16 * 128;
constexpr int kOffBuf1 = kOffBuf0 + kTileBytes;
constexpr int kOffRest = kOffBuf1 + kTileBytes;
// cin 256: h1, then two w1 chunks.
constexpr int kOffH1 = kOffRest;
constexpr int kOffW1c = kOffH1 + kTileBytes;
constexpr int kSmem256 = kOffW1c + 2 * kChunk * 128;
// cin 64: w1, then wd.
constexpr int kOffW1 = kOffRest;
constexpr int kOffWd = kOffW1 + kChunk * 128;
constexpr int kSmem64 = kOffWd + kChunk * kOut * 2;
static_assert(kSmem256 <= 232448 && kSmem64 <= 232448, "over the block's shared memory");

struct Params {
  const __nv_bfloat16* x;    // (B, H, W, cin)
  const __nv_bfloat16* w1;   // (cin, 64)      [in, out]
  const float* b1;           // (64,)
  const __nv_bfloat16* w2;   // (9, 64, 64)    [tap = (dy + 1) * 3 + dx + 1, in, out]
  const float* b2;           // (64,)
  const __nv_bfloat16* w3;   // (64, 256)
  const __nv_bfloat16* wd;   // (64, 256) or null for the identity residual (cin 256)
  const float* b3;           // (256,), the downsample's bias already added
  __nv_bfloat16* out;        // (B, H, W, 256)
  int H, W, cin, tiles_x, tiles_y, n_tiles;
};

// B fragments of two n8 tiles (n0 .. n0 + 15) at k rows k0 .. k0 + 15 of a
// swizzled [k][n] weight tile with `row`-byte rows: b[0..1] the first n8
// tile's, b[2..3] the second's.
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], uint32_t tile, int k0, int n0,
                                        int row) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4_t(b, tile + swz(k, (n0 >> 3) + (lane >> 4), row));
}

// `rows` x `row`-byte weight rows from device memory into a swizzled tile.
__device__ __forceinline__ void load_weights(uint32_t dst, const __nv_bfloat16* src, int rows,
                                             int row) {
  const int chunks = row / 16;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks, c = e % chunks;
    cp_async16(dst + swz(r, c, row), src + (size_t)r * (row / 2) + c * 8, true);
  }
}

__global__ void __launch_bounds__(kThreads, 1) bottleneck_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  const uint32_t s_w2 = s0 + kOffW2, s_w3 = s0 + kOffW3, s_h2 = s0 + kOffH2;
  const float* s_b1 = reinterpret_cast<const float*>(smem + kOffBias);
  const float* s_b2 = s_b1 + kMid;
  const float* s_b3 = s_b2 + kMid;
  unsigned char* stage = smem + kOffStage + (threadIdx.x >> 5) * 16 * 128;

  auto buf = [&](int i) { return s0 + kOffBuf0 + i * kTileBytes; };
  const bool ds = p.wd != nullptr;  // cin 64, block 0
  const int cin = p.cin, nch = cin / kChunk, H = p.H, W = p.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int frow = (lane & 7) + ((lane >> 3) & 1) * 8;  // this lane's ldmatrix A row

  // The resident weights and biases.
  load_weights(s_w2, p.w2, 9 * kMid, 128);
  load_weights(s_w3, p.w3, kMid, 512);
  if (ds) {
    load_weights(s0 + kOffW1, p.w1, kChunk, 128);
    load_weights(s0 + kOffWd, p.wd, kChunk, 512);
  }
  {
    float* b = reinterpret_cast<float*>(smem + kOffBias);
    for (int e = tid; e < kMid + kMid + kOut; e += kThreads)
      b[e] = e < kMid ? p.b1[e] : e < 2 * kMid ? p.b2[e - kMid] : p.b3[e - 2 * kMid];
  }

  // One 64-channel chunk of a tile's halo (and, at cin 256, of w1) by cp.async.
  auto issue_chunk = [&](int tile, int c, uint32_t xbuf, uint32_t wbuf) {
    const int per_img = p.tiles_x * p.tiles_y;
    const int b = tile / per_img, r = tile % per_img;
    const int y0 = (r / p.tiles_x) * kTh - 1, x0 = (r % p.tiles_x) * kTw - 1;
    for (int e = tid; e < kHalo * 8; e += kThreads) {
      const int pix = e >> 3, ch = e & 7;
      const int y = y0 + pix / kHw, xx = x0 + pix % kHw;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W;
      const __nv_bfloat16* src =
          ok ? p.x + (((size_t)b * H + y) * W + xx) * cin + c * kChunk + ch * 8 : p.x;
      cp_async16(xbuf + swz(pix, ch, 128), src, ok);
    }
    if (!ds) load_weights(wbuf, p.w1 + (size_t)c * kChunk * kMid, kChunk, 128);
  };

  int tile = blockIdx.x;
  issue_chunk(tile, 0, buf(0), s0 + kOffW1c);
  cp_async_commit();

  for (int it = 0; tile < p.n_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const int per_img = p.tiles_x * p.tiles_y;
    const int b = tile / per_img, r = tile % per_img;
    const int ty0 = (r / p.tiles_x) * kTh, tx0 = (r % p.tiles_x) * kTw;
    // cin 64: the halo in buffer it & 1, h1 in the other; cin 256: chunk c
    // in buffer c & 1, h1 in its own.
    const uint32_t s_x64 = buf(it & 1);
    const uint32_t s_h1 = ds ? buf((it + 1) & 1) : s0 + kOffH1;

    // conv1 over the halo: warp = 3 m16 row tiles x 32 channels.
    {
      const int mg = warp >> 1, n0 = (warp & 1) * 32;
      float acc[3][4][4] = {};
      for (int c = 0; c < nch; ++c) {
        cp_async_wait_all();
        __syncthreads();
        if (c + 1 < nch) {
          issue_chunk(tile, c + 1, buf((c + 1) & 1), s0 + kOffW1c + ((c + 1) & 1) * 8192);
          cp_async_commit();
        } else if (!ds && next < p.n_tiles) {
          issue_chunk(next, 0, buf(0), s0 + kOffW1c);
          cp_async_commit();
        }
        const uint32_t xb = ds ? s_x64 : buf(c & 1);
        const uint32_t wb = ds ? s0 + kOffW1 : s0 + kOffW1c + (c & 1) * 8192;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[3][4], bf[2][4];
#pragma unroll
          for (int i = 0; i < 3; ++i) frag_a(a[i], xb, min(16 * (3 * mg + i) + frow, kHalo - 1), kk);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) frag_b2(bf[nn], wb, 16 * kk, n0 + 16 * nn, 128);
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma16816(acc[i][j], a[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
      // bias + ReLU, zero outside the image, bf16 into h1.
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pix = 16 * (3 * mg + i) + g + 8 * h;
          if (pix >= kHalo) continue;
          const int y = ty0 - 1 + pix / kHw, xx = tx0 - 1 + pix % kHw;
          const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ch = n0 + 8 * j + 2 * t;
            const float v0 = inside ? fmaxf(acc[i][j][2 * h] + s_b1[ch], 0.0f) : 0.0f;
            const float v1 = inside ? fmaxf(acc[i][j][2 * h + 1] + s_b1[ch + 1], 0.0f) : 0.0f;
            *reinterpret_cast<uint32_t*>(smem + (s_h1 - s0) + swz(pix, ch >> 3, 128) + 4 * t) =
                pack_bf16(v0, v1);
          }
        }
    }
    __syncthreads();

    // conv2 (3x3) from h1: warp = 2 output rows x 32 channels.
    {
      const int oy0 = (warp >> 1) * 2, n0 = (warp & 1) * 32;
      float acc[2][4][4] = {};
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[2][4], bf[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) frag_a(a[i], s_h1, (oy0 + i + dy) * kHw + frow + dx, kk);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
            frag_b2(bf[nn], s_w2, tap * kMid + 16 * kk, n0 + 16 * nn, 128);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma16816(acc[i][j], a[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pix = 16 * (oy0 + i) + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ch = n0 + 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(smem + kOffH2 + swz(pix, ch >> 3, 128) + 4 * t) =
                pack_bf16(fmaxf(acc[i][j][2 * h] + s_b2[ch], 0.0f),
                          fmaxf(acc[i][j][2 * h + 1] + s_b2[ch + 1], 0.0f));
          }
        }
    }
    __syncthreads();
    if (ds && next < p.n_tiles) {  // h1 is dead: the next halo goes there
      issue_chunk(next, 0, s_h1, 0);
      cp_async_commit();
    }

    // conv3 (+ downsample) + bias + residual + ReLU: warp = 2 units of
    // 2 output rows x 64 channels.
#pragma unroll 1
    for (int u = warp; u < 16; u += kWarps) {
      const int oy0 = (u >> 2) * 2, n0 = (u & 3) * 64;
      float acc[2][8][4] = {};
#pragma unroll
      for (int src = 0; src < 2; ++src) {
        if (src == 1 && !ds) break;
        const uint32_t wt = src == 0 ? s_w3 : s0 + kOffWd;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[2][4], bf[4][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (src == 0)
              frag_a(a[i], s_h2, 16 * (oy0 + i) + frow, kk);
            else  // the halo's centre pixels
              frag_a(a[i], s_x64, (oy0 + i + 1) * kHw + frow + 1, kk);
          }
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) frag_b2(bf[nn], wt, 16 * kk, n0 + 16 * nn, 512);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              mma16816(acc[i][j], a[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // bf16(acc + bias) into the warp's 16 x 64 tile ...
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ch = n0 + 8 * j + 2 * t, row = g + 8 * h;
            *reinterpret_cast<uint32_t*>(stage + swz(row, j, 128) + 4 * t) =
                pack_bf16(acc[i][j][2 * h] + s_b3[ch], acc[i][j][2 * h + 1] + s_b3[ch + 1]);
          }
        __syncwarp();
        // ... then residual + ReLU and 16-byte stores: a quarter warp a pixel.
        const int y = ty0 + oy0 + i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (lane >> 3) + 4 * e, ch = lane & 7, xx = tx0 + row;
          if (y >= H || xx >= W) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(stage + swz(row, ch, 128));
          const size_t o = (((size_t)b * H + y) * W + xx) * kOut + n0 + ch * 8;
          const __nv_bfloat162* vv = reinterpret_cast<const __nv_bfloat162*>(&v);
          uint4 res = make_uint4(0, 0, 0, 0);
          if (!ds) res = __ldg(reinterpret_cast<const uint4*>(p.x + o));
          const __nv_bfloat162* rr = reinterpret_cast<const __nv_bfloat162*>(&res);
          uint4 outv;
          uint32_t* ov = reinterpret_cast<uint32_t*>(&outv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(vv[q]), rf = __bfloat1622float2(rr[q]);
            ov[q] = pack_bf16(fmaxf(f.x + rf.x, 0.0f), fmaxf(f.y + rf.y, 0.0f));
          }
          *reinterpret_cast<uint4*>(p.out + o) = outv;
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait_all();
}

}  // namespace

extern "C" int mhent_stage1_block(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* wd, const void* b3, void* out, int B, int H,
                                  int W, int cin, void* stream) {
  // Block 0 (cin 64, downsample) or blocks 1-2 (cin 256, identity residual).
  if (B < 1 || H < 1 || W < 1 || !((cin == kMid && wd != nullptr) ||
                                   (cin == kOut && wd == nullptr)))
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
  p.tiles_x = (W + kTw - 1) / kTw;
  p.tiles_y = (H + kTh - 1) / kTh;
  const long long n_tiles = (long long)B * p.tiles_x * p.tiles_y;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)n_tiles;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = wd != nullptr ? kSmem64 : kSmem256;
  err = cudaFuncSetAttribute(bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem64 > kSmem256 ? kSmem64 : kSmem256);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
