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
// input (4.2 MB) and write the bf16 output (16.8 MB, 6.3 us at 3.35 TB/s).
// Between the blocks the f32 block output stays in device memory (33.6 MB
// at B = 8), because the residual is added in f32: each of blocks 1 and 2
// reads it once (L2 holds much of it) and blocks 0 and 1 write it.
//
// The previous design (a 4 x 16 output tile a block, 1.69x conv1
// recompute, every weight fragment a 32-bit load from L2 for every tile and
// warp, scalar A loads and byte stores) measured 0.2710 ms eager / 0.2658 ms
// as a CUDA graph at (8, 64, 64, 64) for the three launches (PERF.md row 5,
// H100 80GB HBM3, 700 W).
//
// Design (stage1.cu's, in int8):
// - Persistent blocks: grid = min(tiles, SMs), one 256-thread block an SM,
//   each with all of its bottleneck's int8 weights resident in shared
//   memory, loaded once (w1 4,096 or 16,384 bytes, w2 36,864, w3 16,384,
//   block 0's downsample 16,384) and walking 8 x 16 output tiles (10 x 18
//   halo: 1.41x conv1 recompute).
// - Every s8 tile in shared memory is rows of 64 bytes (64 channels), the
//   16-byte chunk c of row r stored at c ^ ((r >> 1) & 3), so each 8-row
//   ldmatrix phase touches all 32 banks once; wider operands are K chunks of
//   such tiles. A and B fragments come by plain ldmatrix (a row of 16 s8 is
//   a row of 8 b16), B from the [out][in] weights. The 3x3 conv reads each
//   tap's shifted halo rows by handing ldmatrix the shifted row addresses.
// - Blocks 0 and 1 also write their output quantised for the next block
//   (q(y * the next block's inv_in), the same f32 multiply and rounding the
//   next block's input would do), so the halos of blocks 1 and 2 are s8 and
//   arrive by cp.async straight into the swizzled tile, the next tile's
//   while this one computes (two halo buffers). Block 0's bf16 halo arrives
//   by cp.async into a staging buffer during the previous tile and is
//   quantised in shared memory.
// - Epilogues run on the accumulators; conv3's f32 result goes through a
//   4 KB per-warp tile, from which the residual add (16-byte loads), ReLU
//   and the outputs are done with 16-byte f32 stores (4-byte s8, 8-byte
//   bf16).
//
// Shared memory (bytes): w2 36,864 + w3 16,384 + epilogue scales 3,072
// + h1 12,288 + h2 8,192 + epilogue tiles 32,768, then at cin 256 w1
// 16,384 + two s8 halos of 4 K chunks 98,304 (224,256 in all), or at cin 64
// w1 4,096 + wd 16,384 + its scales 2,048 + the bf16 halo 23,040 + the s8
// halo 12,288 (167,424): both under the 232,448 a block may use.
//
// Any H and W are accepted (ragged tiles mask their loads and stores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTh = 8, kTw = 16;        // output tile (rows x cols)
constexpr int kHw = kTw + 2;            // halo width
constexpr int kHalo = (kTh + 2) * kHw;  // 180 halo pixels
constexpr int kHaloRows = 192;          // 12 m16 row tiles (rows 180-191 clamped reads)
constexpr int kPix = kTh * kTw;         // 128 output pixels
constexpr int kMid = 64, kOut = 256;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Shared-memory regions (bytes); every offset is a multiple of 128.
constexpr int kT64 = 64 * 64;                // a [64][64] s8 tile
constexpr int kHaloChunk = kHaloRows * 64;   // a [192][64] s8 halo chunk
constexpr int kOffW2 = 0;                    // 9 taps x [64 out][64 in]
constexpr int kOffW3 = kOffW2 + 9 * kT64;    // [256 out][64 in]
constexpr int kOffScale = kOffW3 + 4 * kT64;  // s1 b1 s2 b2 (64), s3 b3 (256)
constexpr int kScales = 4 * kMid + 2 * kOut;
constexpr int kOffH1 = kOffScale + kScales * 4;  // [192][64]
constexpr int kOffH2 = kOffH1 + kHaloChunk;      // [128][64]
constexpr int kOffStage = kOffH2 + kPix * 64;    // 8 warps x [16 px][64 ch] f32
constexpr int kOffRest = kOffStage + kWarps * 16 * 256;
// cin 256: w1 as 4 K chunks of [64 out][64 in], then two halos of 4 chunks.
constexpr int kOffW1c = kOffRest;
constexpr int kOffHalo2 = kOffW1c + 4 * kT64;
constexpr int kSmem256 = kOffHalo2 + 2 * 4 * kHaloChunk;
// cin 64: w1, wd [256][64], sd bd, the bf16 halo [180][64], the s8 halo.
constexpr int kOffW1 = kOffRest;
constexpr int kOffWd = kOffW1 + kT64;
constexpr int kOffScaleD = kOffWd + 4 * kT64;
constexpr int kOffRaw = kOffScaleD + 2 * kOut * 4;
constexpr int kOffHalo1 = kOffRaw + kHalo * 128;
constexpr int kSmem64 = kOffHalo1 + kHaloChunk;
static_assert(kSmem256 <= 232448 && kSmem64 <= 232448, "over the block's shared memory");

struct Params {
  const void* x;            // block 0: (B, H, W, 64) bf16 input; else the f32 residual
  const int8_t* xq;         // blocks 1-2: (B, H, W, 256) the input quantised
  const float* inv_in;      // (1,) block 0's input quantise factor
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
  const float* inv_next;    // (1,) blocks 0-1: the next block's input quantise factor
  void* out;                // (B, H, W, 256): f32, or bf16 on the last block
  int8_t* out_q;            // blocks 0-1: (B, H, W, 256) out quantised by inv_next
  int H, W, tiles_x, tiles_y, n_tiles;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c (0-3) of row r in a [rows][64] s8 tile.
__device__ __forceinline__ uint32_t swz64(int r, int c) {
  return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));  // 0 bytes read: the 16 are zero-filled
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 32 s8, row-major) x b (32 x 8 s8, column-major); s32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows, k bytes 32 kk .. + 31) of a [rows][64] tile whose
// fragment row i lives in tile row `row` (this lane's: i = lane & 15).
// Lanes 0-15 give rows 0-15 at k chunk 2 kk, lanes 16-31 at 2 kk + 1: regs
// 0/1 rows g / g + 8 bytes 4t.., regs 2/3 bytes 16 + 4t.., the s8 layout.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t tile, int row, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + swz64(row, 2 * kk + (lane >> 4)));
}

// B fragments of two n8 tiles (n0 .. n0 + 15) at k bytes 32 kk .. + 31 of
// an [n][64] weight tile: b[0..1] the first n8 tile's, b[2..3] the second's.
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], uint32_t tile, int n0, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + swz64(n0 + (lane & 7) + 8 * (lane >> 4), 2 * kk + ((lane >> 3) & 1)));
}

__device__ __forceinline__ float epi(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// Round half to even and clip to +-127, as jnp.round / torch.round + clip.
__device__ __forceinline__ int quant(float v) {
  return (int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// `rows` x 64 bytes of [rows][in] weights with row stride `ld` bytes (from
// column `col`) into a swizzled [rows][64] tile.
__device__ __forceinline__ void load_tile(uint32_t dst, const int8_t* src, int rows, int ld) {
  for (int e = threadIdx.x; e < rows * 4; e += kThreads) {
    const int r = e >> 2, c = e & 3;
    cp_async16(dst + swz64(r, c), src + (size_t)r * ld + c * 16, true);
  }
}

template <bool FIRST, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_q_kernel(Params p) {
  constexpr int CIN = FIRST ? kMid : kOut;
  constexpr int NCH = CIN / 64;              // K chunks of conv1
  constexpr int NW = FIRST ? 32 : 64;        // conv3 channels a unit
  constexpr int NJ = NW / 8, NB = NW / 16;   // its n8 tiles, B loads a k-step
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  const float* s_s1 = reinterpret_cast<const float*>(smem + kOffScale);
  const float* s_b1 = s_s1 + kMid;
  const float* s_s2 = s_b1 + kMid;
  const float* s_b2 = s_s2 + kMid;
  const float* s_s3 = s_b2 + kMid;
  const float* s_b3 = s_s3 + kOut;
  const float* s_sd = reinterpret_cast<const float*>(smem + kOffScaleD);
  const float* s_bd = s_sd + kOut;
  const int H = p.H, W = p.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int frow = lane & 15;  // this lane's ldmatrix A row
  unsigned char* stage = smem + kOffStage + warp * 16 * 256;

  // The resident weights and epilogue scales.
  load_tile(s0 + kOffW3, p.w3, kOut, kMid);
  for (int tap = 0; tap < 9; ++tap) load_tile(s0 + kOffW2 + tap * kT64, p.w2 + tap * 64, 64, 576);
  if (FIRST) {
    load_tile(s0 + kOffW1, p.w1, 64, 64);
    load_tile(s0 + kOffWd, p.wd, kOut, kMid);
  } else {
    for (int c = 0; c < 4; ++c) load_tile(s0 + kOffW1c + c * kT64, p.w1 + c * 64, 64, kOut);
  }
  {
    float* sc = reinterpret_cast<float*>(smem + kOffScale);
    const float* src[6] = {p.s1, p.b1, p.s2, p.b2, p.s3, p.b3};
    for (int e = tid; e < kScales; e += kThreads) {
      const int k = e < 4 * kMid ? e / kMid : 4 + (e - 4 * kMid) / kOut;
      const int i = e < 4 * kMid ? e % kMid : (e - 4 * kMid) % kOut;
      sc[e] = src[k][i];
    }
    if (FIRST) {
      float* sd = reinterpret_cast<float*>(smem + kOffScaleD);
      for (int e = tid; e < 2 * kOut; e += kThreads) sd[e] = e < kOut ? p.sd[e] : p.bd[e - kOut];
    }
  }
  const float inv_in = FIRST ? *p.inv_in : 0.0f;
  const float inv_next = OUT_BF16 ? 0.0f : *p.inv_next;

  // The halo of `tile` by cp.async: block 0's bf16 pixels into the staging
  // buffer, blocks 1-2's s8 pixels into halo buffer `hb` (4 K chunks).
  // Outside the image is zero (the quantised zero).
  auto issue_halo = [&](int tile, int hb) {
    const int per_img = p.tiles_x * p.tiles_y;
    const int b = tile / per_img, r = tile % per_img;
    const int y0 = (r / p.tiles_x) * kTh - 1, x0 = (r % p.tiles_x) * kTw - 1;
    constexpr int kPieces = FIRST ? 8 : 16;  // 16-byte pieces a pixel
    for (int e = tid; e < kHalo * kPieces; e += kThreads) {
      const int pix = e / kPieces, c = e % kPieces;
      const int y = y0 + pix / kHw, xx = x0 + pix % kHw;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W;
      const size_t px = ((size_t)b * H + (ok ? y : 0)) * W + (ok ? xx : 0);
      if (FIRST) {
        cp_async16(s0 + kOffRaw + pix * 128 + c * 16,
                   static_cast<const __nv_bfloat16*>(p.x) + px * kMid + c * 8, ok);
      } else {
        cp_async16(s0 + kOffHalo2 + (hb * 4 + (c >> 2)) * kHaloChunk + swz64(pix, c & 3),
                   p.xq + px * kOut + c * 16, ok);
      }
    }
    cp_async_commit();
  };

  cp_async_commit();
  int tile = blockIdx.x;
  if (tile < p.n_tiles) issue_halo(tile, 0);

  for (int it = 0; tile < p.n_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const int per_img = p.tiles_x * p.tiles_y;
    const int b = tile / per_img, r = tile % per_img;
    const int ty0 = (r / p.tiles_x) * kTh, tx0 = (r % p.tiles_x) * kTw;
    cp_async_wait_all();  // this tile's halo (and, first, the weights)
    __syncthreads();      // ... everyone's; the last tile's conv3 is done
    uint32_t halo;        // the s8 halo, K chunk c at + c * kHaloChunk
    if (FIRST) {
      // Quantise the bf16 halo into the s8 one: 8 channels a thread.
      for (int e = tid; e < kHalo * 8; e += kThreads) {
        const int pix = e >> 3, c8 = e & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(smem + kOffRaw + pix * 128 + c8 * 16);
        const __nv_bfloat162* h2v = reinterpret_cast<const __nv_bfloat162*>(&v);
        int q[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h2v[i]);
          q[2 * i] = quant(__fmul_rn(f.x, inv_in));
          q[2 * i + 1] = quant(__fmul_rn(f.y, inv_in));
        }
        *reinterpret_cast<uint2*>(smem + kOffHalo1 + swz64(pix, c8 >> 1) + (c8 & 1) * 8) =
            make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
      }
      __syncthreads();  // the staging buffer is free, the s8 halo complete
      if (next < p.n_tiles) issue_halo(next, 0);
      halo = s0 + kOffHalo1;
    } else {
      if (next < p.n_tiles) issue_halo(next, (it + 1) & 1);
      halo = s0 + kOffHalo2 + (it & 1) * 4 * kHaloChunk;
      // The tile's f32 residual rows (16 pixels x 1 KB, contiguous) into
      // L2 now, so conv3's epilogue reads them from there.
      if (tid < kTh && ty0 + tid < H) {
        const float* row =
            static_cast<const float*>(p.x) + (((size_t)b * H + ty0 + tid) * W + tx0) * kOut;
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(row),
                     "r"(min(kTw, W - tx0) * kOut * 4)
                     : "memory");
      }
    }

    // conv1 over the halo: warp = 3 m16 row tiles x 32 channels.
    {
      const int mg = warp >> 1, n0 = (warp & 1) * 32;
      int acc[3][4][4] = {};
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint32_t xb = halo + c * kHaloChunk;
        const uint32_t wb = FIRST ? s0 + kOffW1 : s0 + kOffW1c + c * kT64;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[3][4], bf[2][4];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            frag_a(a[i], xb, min(16 * (3 * mg + i) + frow, kHalo - 1), kk);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) frag_b2(bf[nn], wb, n0 + 16 * nn, kk);
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_s8(acc[i][j], a[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
      // requantised ReLU, zero outside the image, s8 into h1.
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
            const int q0 = inside ? quant(fmaxf(epi(acc[i][j][2 * h], s_s1[ch], s_b1[ch]), 0.0f)) : 0;
            const int q1 =
                inside ? quant(fmaxf(epi(acc[i][j][2 * h + 1], s_s1[ch + 1], s_b1[ch + 1]), 0.0f))
                       : 0;
            *reinterpret_cast<char2*>(smem + kOffH1 + swz64(pix, ch >> 4) + (ch & 15)) =
                make_char2((char)q0, (char)q1);
          }
        }
    }
    __syncthreads();

    // conv2 (3x3) from h1: warp = 2 output rows x 32 channels.
    {
      const int oy0 = (warp >> 1) * 2, n0 = (warp & 1) * 32;
      int acc[2][4][4] = {};
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const uint32_t wt = s0 + kOffW2 + tap * kT64;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[2][4], bf[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            frag_a(a[i], s0 + kOffH1, (oy0 + i + dy) * kHw + frow + dx, kk);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) frag_b2(bf[nn], wt, n0 + 16 * nn, kk);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_s8(acc[i][j], a[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
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
            *reinterpret_cast<char2*>(smem + kOffH2 + swz64(pix, ch >> 4) + (ch & 15)) =
                make_char2((char)quant(fmaxf(epi(acc[i][j][2 * h], s_s2[ch], s_b2[ch]), 0.0f)),
                           (char)quant(fmaxf(epi(acc[i][j][2 * h + 1], s_s2[ch + 1],
                                                 s_b2[ch + 1]), 0.0f)));
          }
        }
    }
    __syncthreads();

    // conv3 (+ downsample) + residual + ReLU: units of 2 output rows x NW
    // channels, warps taking them in turn.
#pragma unroll 1
    for (int u = warp; u < 4 * (kOut / NW); u += kWarps) {
      const int oy0 = (u / (kOut / NW)) * 2, n0 = (u % (kOut / NW)) * NW;
      int acc[2][NJ][4] = {};
      int accd[FIRST ? 2 : 1][FIRST ? NJ : 1][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[2][4], bf[NB][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) frag_a(a[i], s0 + kOffH2, 16 * (oy0 + i) + frow, kk);
#pragma unroll
        for (int nn = 0; nn < NB; ++nn) frag_b2(bf[nn], s0 + kOffW3, n0 + 16 * nn, kk);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma_s8(acc[i][j], a[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        if (FIRST) {  // the downsample on the halo's centre pixels
#pragma unroll
          for (int i = 0; i < 2; ++i) frag_a(a[i], halo, (oy0 + i + 1) * kHw + frow + 1, kk);
#pragma unroll
          for (int nn = 0; nn < NB; ++nn) frag_b2(bf[nn], s0 + kOffWd, n0 + 16 * nn, kk);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              mma_s8(accd[FIRST ? i : 0][FIRST ? j : 0], a[i], bf[j >> 1][(j & 1) * 2],
                     bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // conv3's epilogue (block 0: + the downsample's, ReLU) into the
        // warp's [16 px][NW] f32 tile, 16-byte chunk q of row x at q ^ (x & 7) ...
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int col = 8 * j + 2 * t, ch = n0 + col, row = g + 8 * h;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = epi(acc[i][j][2 * h + e], s_s3[ch + e], s_b3[ch + e]);
              if (FIRST)
                v[e] = fmaxf(__fadd_rn(v[e], epi(accd[FIRST ? i : 0][FIRST ? j : 0][2 * h + e],
                                                 s_sd[ch + e], s_bd[ch + e])),
                             0.0f);
            }
            *reinterpret_cast<float2*>(stage + row * 256 + (((col >> 2) ^ (row & 7)) << 4) +
                                       (col & 3) * 4) = make_float2(v[0], v[1]);
          }
        __syncwarp();
        // ... then residual + ReLU and 16-byte stores: NW / 4 lanes a pixel.
        constexpr int kLanes = NW / 4, kPer = 32 / kLanes;
        const int y = ty0 + oy0 + i, q = lane % kLanes;
        float4 res[16 / kPer];
#pragma unroll
        for (int e = 0; e < 16 / kPer; ++e) {
          const int px = lane / kLanes + kPer * e, xx = tx0 + px;
          if (!FIRST && y < H && xx < W)
            res[e] = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p.x) +
                                                           (((size_t)b * H + y) * W + xx) * kOut +
                                                           n0 + 4 * q));
        }
#pragma unroll
        for (int e = 0; e < 16 / kPer; ++e) {
          const int px = lane / kLanes + kPer * e, xx = tx0 + px;
          if (y >= H || xx >= W) continue;
          float4 o = *reinterpret_cast<const float4*>(stage + px * 256 + ((q ^ (px & 7)) << 4));
          if (!FIRST) {
            o.x = fmaxf(__fadd_rn(o.x, res[e].x), 0.0f);
            o.y = fmaxf(__fadd_rn(o.y, res[e].y), 0.0f);
            o.z = fmaxf(__fadd_rn(o.z, res[e].z), 0.0f);
            o.w = fmaxf(__fadd_rn(o.w, res[e].w), 0.0f);
          }
          const size_t off = (((size_t)b * H + y) * W + xx) * kOut + n0 + 4 * q;
          if (OUT_BF16) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y), hi = __floats2bfloat162_rn(o.z, o.w);
            uint2 pk;
            pk.x = *reinterpret_cast<uint32_t*>(&lo);
            pk.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + off) = pk;
          } else {
            *reinterpret_cast<float4*>(static_cast<float*>(p.out) + off) = o;
            *reinterpret_cast<uint32_t*>(p.out_q + off) =
                pack4(quant(__fmul_rn(o.x, inv_next)), quant(__fmul_rn(o.y, inv_next)),
                      quant(__fmul_rn(o.z, inv_next)), quant(__fmul_rn(o.w, inv_next)));
          }
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait_all();
}

template <bool FIRST, bool OUT_BF16>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = bottleneck_q_kernel<FIRST, OUT_BF16>;
  const int smem = FIRST ? kSmem64 : kSmem256;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// block: 0 (bf16 64-channel input x, downsample, f32 output and its s8
// quantisation by inv_next), 1 (s8 256-channel input xq, f32 residual x, the
// same two outputs) or 2 (as 1, bf16 output only).
extern "C" int mhent_stage1_int8_block(const void* x, const void* xq, const void* inv_in,
                                       const void* w1, const void* s1, const void* b1,
                                       const void* w2, const void* s2, const void* b2,
                                       const void* w3, const void* s3, const void* b3,
                                       const void* wd, const void* sd, const void* bd,
                                       const void* inv_next, void* out, void* out_q, int B,
                                       int H, int W, int block, void* stream) {
  if (B < 1 || H < 1 || W < 1 || block < 0 || block > 2 ||
      (block == 0 && (wd == nullptr || inv_in == nullptr)) || (block > 0 && xq == nullptr) ||
      (block < 2 && (out_q == nullptr || inv_next == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.xq = static_cast<const int8_t*>(xq);
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
  p.inv_next = static_cast<const float*>(inv_next);
  p.out = out;
  p.out_q = static_cast<int8_t*>(out_q);
  p.H = H;
  p.W = W;
  p.tiles_x = (W + kTw - 1) / kTw;
  p.tiles_y = (H + kTh - 1) / kTh;
  const long long n_tiles = (long long)B * p.tiles_x * p.tiles_y;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)n_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 0) return launch<true, false>(p, s);
  if (block == 1) return launch<false, false>(p, s);
  return launch<false, true>(p, s);
}
