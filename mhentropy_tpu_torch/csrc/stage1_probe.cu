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
// with every operand transposed: activations (C, H, W), weights [out, in].
//
// What bounds it on the H100: the products, 55.8 GFLOP for the stage at
// B = 32 (56 us at the bf16 peak); its bytes (the 64-channel input, the
// 256-channel output and the two 256-channel maps between the blocks) are
// about 84 MB written once and read once (25 us at 3.35 TB/s). The products
// are only as fast as the tensor cores are fed from shared memory.
//
// Design: the shipped stage-1 kernel's (csrc/stage1.cu, its header), which
// both variants share; only their device-memory I/O differs.
// - Persistent blocks, one an SM (256 threads), each holding the
//   bottleneck's w2 and w3 (and at block 0 w1 and wd) in shared memory and
//   walking 8 x 16-pixel output tiles with a 10 x 18 halo (conv1's
//   recompute 180 / 128 = 1.41x). w1 at cin 256 streams in 64-channel
//   chunks, double-buffered.
// - mma.sync.m16n8k16 bf16 -> f32 fed by ldmatrix, every shared tile in
//   128- or 512-byte rows with 16-byte chunk c stored at c ^ (row & 7). The
//   3x3 reads each tap's shifted halo rows by handing ldmatrix the shifted
//   row addresses: no copies. Epilogues run on the registers: ReLU, zero
//   outside the image for h1 (the 3x3's padding), bf16 h1 and h2 in shared
//   memory. At blocks 1-2 the identity residual is added to bf16(acc), as
//   in stage1.cu (two roundings, within stage1_probe.tolerance).
// - Variant A reads the pixel-major halo by cp.async (zero-filled outside
//   the image), weights [in, out] through ldmatrix.trans, and writes its
//   (HW, 256) output a pixel row of 16-byte chunks at a time through a
//   per-warp shared tile (stage1.cu's epilogue).
// - Variant B loads each 64-channel chunk of the channel-major halo as rows
//   of 32 pixels (x0 - 8 .. x0 + 23: four 16-byte chunks, each inside the
//   image or zero-filled) by cp.async, then transposes it into the same
//   swizzled pixel-major tile (ldmatrix.trans and 4-byte stores), so
//   conv1-3 are A's. (A TMA box of the (B, C, H, W) tensor faulted on the
//   card when its innermost coordinate was negative or not a multiple of 8,
//   and the halo starts at x0 - 1.) Its weights [out, in] are the
//   B operands' natural layout (ldmatrix without .trans). It writes its
//   (256, HW) output a channel row at a time: at blocks 1-2 through a
//   per-warp (64 channel, 16 pixel) tile in h1's dead buffer
//   (stmatrix.trans), two lanes a row of 16 pixels, residual read and
//   output written 16 bytes a lane; at block 0, where no buffer is free,
//   movmatrix.trans turns each 16 x 8 accumulator block into channel rows in
//   the registers and each lane stores two pixels of a channel. B's raw
//   halo chunk (40,960 bytes) lies over A's epilogue tiles and halo buffer
//   0, its pixel-major copy in buffer 1; at cin 64 h1 goes to buffer 0, and
//   the next tile's raw halo is loaded once conv2 has read h1.
//
// Shared memory (bytes): w2 73,728 + w3 32,768 + h2 16,384 + two
// 180-pixel x 64-channel buffers 46,080 + epilogue tiles 16,384 + 1,536
// (B's raw halo), then at cin 256 h1 23,040 + two w1 chunks 16,384
// (226,304), or at cin 64 w1 8,192 + wd 32,768 (227,840); + 1,024 bytes of
// alignment.
//
// A takes any H and W; B takes W a multiple of 8 (its 16-byte halo chunks).
// cin is 64 with a downsample (block 0) or 256 without (blocks 1-2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_sm80.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTh = 8, kTw = 16;        // output tile (rows x cols)
constexpr int kHw = kTw + 2;            // halo width
constexpr int kHr = kTh + 2;            // halo rows
constexpr int kHalo = kHr * kHw;        // 180 halo pixels
constexpr int kPix = kTh * kTw;         // 128 output pixels
constexpr int kMid = 64, kOut = 256, kChunk = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRawW = 32;               // B: a raw halo row, 18 pixels in four 16-byte chunks
constexpr int kRawBytes = kHr * kChunk * kRawW * 2;  // 40,960

// Shared-memory regions (bytes) from a 1,024-byte aligned base.
constexpr int kTileBytes = kHalo * 128;  // 180 pixels x 64 channels
constexpr int kOffW2 = 0;
constexpr int kOffW3 = kOffW2 + 9 * kMid * 128;
constexpr int kOffH2 = kOffW3 + kMid * kOut * 2;
constexpr int kOffBuf1 = kOffH2 + kPix * 128;
constexpr int kOffStage = kOffBuf1 + kTileBytes;
constexpr int kOffBuf0 = kOffStage + kWarps * 16 * 128;
// B's raw halo chunk covers the epilogue tiles, buffer 0 and 1,536 bytes more.
constexpr int kOffRest = kOffStage + kRawBytes;
// cin 256: h1, then two w1 chunks.
constexpr int kOffH1 = kOffRest;
constexpr int kOffW1c = kOffH1 + kTileBytes;
constexpr int kSmem256 = kOffW1c + 2 * kChunk * 128;
// cin 64: w1, then wd.
constexpr int kOffW1 = kOffRest;
constexpr int kOffWd = kOffW1 + kChunk * 128;
constexpr int kSmem64 = kOffWd + kChunk * kOut * 2;
constexpr int kSmem = 1024 + (kSmem64 > kSmem256 ? kSmem64 : kSmem256);
static_assert(kSmem <= 232448, "over the block's shared memory");
static_assert(kOffBuf0 + kTileBytes <= kOffRest, "buffer 0 outside B's raw halo");

struct Params {
  const bf16* x;   // A (B, H, W, cin); B (B, cin, H, W)
  const bf16* w1;  // A (cin, 64) [in, out]; B (64, cin) [out, in]
  const bf16* wp;  // A (5, 128, 64); B (5, 64, 128): taps 2p, 2p + 1 stacked on K
  const bf16* w3;  // A (64, 256); B (256, 64)
  const bf16* wd;  // A (64, 256); B (256, 64); null: the identity residual (cin 256)
  bf16* out;       // A (B, H, W, 256); B (B, 256, H, W)
  int H, W, cin, tiles_x, tiles_y, n_tiles;
};

// The transposes of four 8 x 8 bf16 matrices whose fragments the warp holds
// (lane 4 g + t: row g, columns 2 t, 2 t + 1 of each) to shared memory:
// lane l gives the address of row l & 7 of matrix l >> 3's transpose.
__device__ __forceinline__ void stsm_x4_t(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// The transpose of the 8 x 8 bf16 matrix whose fragment the warp holds (lane
// 4 g + t: row g, columns 2 t, 2 t + 1): lane 4 g + t gets its row g,
// columns 2 t, 2 t + 1.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

// bf16(relu(a + b)) of two packed bf16 pairs, summed in f32.
__device__ __forceinline__ uint32_t add_relu_bf16(uint32_t a, uint32_t b) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return pack_bf16(fmaxf(fa.x + fb.x, 0.0f), fmaxf(fa.y + fb.y, 0.0f));
}

// B fragments of two n8 tiles (n0 .. n0 + 15) at k rows k0 .. k0 + 15 of a
// weight tile: b[0..1] the first n8 tile's, b[2..3] the second's. A keeps
// its weights [k][n] (`row`-byte rows, read with .trans), B [n][k] (128-byte
// rows of 64 k).
template <bool CM>
__device__ __forceinline__ void frag_w(uint32_t (&b)[4], uint32_t tile, int k0, int n0, int row) {
  const int lane = threadIdx.x & 31;
  if constexpr (CM) {
    ldsm_x4(b, tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3), (k0 >> 3) + ((lane >> 3) & 1),
                          128));
  } else {
    const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4_t(b, tile + swz(k, (n0 >> 3) + (lane >> 4), row));
  }
}

// `rows` x `row`-byte rows, row r from src + r * stride (elements), into a
// swizzled tile.
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, int rows, int row,
                                          int stride) {
  const int chunks = row / 16;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks, c = e % chunks;
    cp_async16(dst + swz(r, c, row), src + (size_t)r * stride + c * 8, true);
  }
}

// The resident weights: A [in, out] as given; B [out, in] as given, w2 from
// the pair tiles (tap t = pair t / 2, K half t % 2).
template <bool CM>
__device__ __forceinline__ void load_weights(uint32_t s0, const Params& p, bool ds) {
  if (CM) {
    for (int e = threadIdx.x; e < 9 * kMid * 8; e += kThreads) {
      const int r = e >> 3, c = e & 7, tap = r / kMid, n = r % kMid;
      cp_async16(s0 + kOffW2 + swz(r, c, 128),
                 p.wp + (size_t)(tap >> 1) * kMid * 2 * kMid + n * 2 * kMid + (tap & 1) * kMid +
                     c * 8,
                 true);
    }
    load_rows(s0 + kOffW3, p.w3, kOut, 128, kMid);
    if (ds) {
      load_rows(s0 + kOffW1, p.w1, kMid, 128, kChunk);
      load_rows(s0 + kOffWd, p.wd, kOut, 128, kMid);
    }
  } else {
    load_rows(s0 + kOffW2, p.wp, 9 * kMid, 128, kMid);
    load_rows(s0 + kOffW3, p.w3, kMid, 512, kOut);
    if (ds) {
      load_rows(s0 + kOffW1, p.w1, kChunk, 128, kMid);
      load_rows(s0 + kOffWd, p.wd, kMid, 512, kOut);
    }
  }
}

// w1's 64-channel chunk c at cin 256 (A rows c * 64.., B columns c * 64..).
template <bool CM>
__device__ __forceinline__ void load_w1_chunk(uint32_t dst, const bf16* w1, int c) {
  if (CM)
    load_rows(dst, w1 + c * kChunk, kMid, 128, kOut);
  else
    load_rows(dst, w1 + (size_t)c * kChunk * kMid, kChunk, 128, kMid);
}

// B's raw halo chunk: row (ry, c) of 64 bytes holds pixels x0 - 8 .. x0 + 23
// of halo row ry, channel c; its 16-byte chunk k is stored at k ^ ((c >> 1)
// & 3), so that ldmatrix's eight channel rows hit eight bank groups.
__device__ __forceinline__ uint32_t raw_at(int ry, int c, int k) {
  return (uint32_t)((ry * kChunk + c) * 64 + ((k ^ ((c >> 1) & 3)) << 4));
}

// B: the raw halo chunk -> the swizzled pixel-major tile, 8 x 8 blocks by
// ldmatrix.trans: a warp item is one halo row, one 8-pixel chunk and four
// 8-channel groups. Raw pixel s of a row is halo pixel s - 7.
__device__ __forceinline__ void transpose_halo(uint32_t raw, uint32_t tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = warp; item < kHr * 4 * 2; item += kWarps) {
    const int hy = item >> 3, k = (item >> 1) & 3, cg0 = (item & 1) * 4;
    const int ch = (cg0 + (lane >> 3)) * 8 + (lane & 7);
    uint32_t v[4];
    ldsm_x4_t(v, raw + raw_at(hy, ch, k));
    const int hx = 8 * k + (lane >> 2) - 7;
    if (hx >= 0 && hx < kHw) {
      const int pix = hy * kHw + hx;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(tile + swz(pix, cg0 + m, 128) +
                                                        4 * (lane & 3)),
                     "r"(v[m])
                     : "memory");
    }
  }
}

template <bool CM>
__global__ void __launch_bounds__(kThreads, 1)
    bottleneck_probe_kernel(Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t s0 = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s0 - raw0);
  const uint32_t s_w2 = s0 + kOffW2, s_w3 = s0 + kOffW3, s_h2 = s0 + kOffH2;
  unsigned char* stage = smem + kOffStage + (threadIdx.x >> 5) * 16 * 128;

  auto buf = [&](int i) { return s0 + (i ? kOffBuf1 : kOffBuf0); };
  const bool ds = p.wd != nullptr;  // cin 64, block 0
  const int cin = p.cin, nch = cin / kChunk, H = p.H, W = p.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int frow = (lane & 7) + ((lane >> 3) & 1) * 8;  // this lane's ldmatrix A row
  const int per_img = p.tiles_x * p.tiles_y;
  // B: the raw halo chunk's buffer, and its pixel-major copy's.
  const uint32_t s_raw = s0 + kOffStage, s_pix = buf(1);

  load_weights<CM>(s0, p, ds);

  // A: one 64-channel chunk of a tile's halo (and, at cin 256, of w1) by cp.async.
  auto issue_chunk = [&](int tile, int c, uint32_t xbuf, uint32_t wbuf) {
    const int b = tile / per_img, r = tile % per_img;
    const int y0 = (r / p.tiles_x) * kTh - 1, x0 = (r % p.tiles_x) * kTw - 1;
    for (int e = tid; e < kHalo * 8; e += kThreads) {
      const int pix = e >> 3, ch = e & 7;
      const int y = y0 + pix / kHw, xx = x0 + pix % kHw;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W;
      const bf16* src = ok ? p.x + (((size_t)b * H + y) * W + xx) * cin + c * kChunk + ch * 8 : p.x;
      cp_async16(xbuf + swz(pix, ch, 128), src, ok);
    }
    if (!ds) load_w1_chunk<false>(wbuf, p.w1, c);
  };
  // B: one 64-channel chunk of a tile's raw halo by cp.async: four 16-byte
  // chunks a channel and halo row, each wholly inside the image or outside
  // it (W % 8 == 0) and then zero-filled.
  auto issue_raw = [&](int tile, int c) {
    const int b = tile / per_img, r = tile % per_img;
    const int y0 = (r / p.tiles_x) * kTh - 1, x0 = (r % p.tiles_x) * kTw - 8;
    for (int e = tid; e < kHr * kChunk * 4; e += kThreads) {
      const int k = e & 3, hy = (e >> 2) % kHr, ch = e / (4 * kHr);
      const int y = y0 + hy, xx = x0 + 8 * k;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W;
      const bf16* src = ok ? p.x + (((size_t)b * cin + c * kChunk + ch) * H + y) * W + xx : p.x;
      cp_async16(s_raw + raw_at(hy, ch, k), src, ok);
    }
  };

  int tile = blockIdx.x;
  if (CM) {
    issue_raw(tile, 0);
    if (!ds) load_w1_chunk<true>(s0 + kOffW1c, p.w1, 0);
  } else {
    issue_chunk(tile, 0, buf(0), s0 + kOffW1c);
  }
  cp_async_commit();

  for (int it = 0; tile < p.n_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const int b = tile / per_img, r = tile % per_img;
    const int ty0 = (r / p.tiles_x) * kTh, tx0 = (r % p.tiles_x) * kTw;
    // The halo (pixel-major) and h1. A at cin 64: the halo in buffer it & 1,
    // h1 in the other; A at cin 256: chunk c in buffer c & 1, h1 in its own;
    // B: the halo (each chunk at cin 256) in buffer 1, h1 in buffer 0 (cin
    // 64, inside the raw halo's buffer) or its own.
    const uint32_t s_x64 = CM ? s_pix : buf(it & 1);
    const uint32_t s_h1 = ds ? buf(CM ? 0 : (it + 1) & 1) : s0 + kOffH1;

    // conv1 over the halo: warp = 3 m16 row tiles x 32 channels.
    {
      const int mg = warp >> 1, n0 = (warp & 1) * 32;
      float acc[3][4][4] = {};
      for (int c = 0; c < nch; ++c) {
        uint32_t xb, wb;
        if (CM) {
          cp_async_wait_all();
          __syncthreads();  // every warp is done with the last chunk's s_pix and w1 buffer
          transpose_halo(s_raw, s_pix);
          __syncthreads();
          const bool more = c + 1 < nch;
          if (more || (!ds && next < p.n_tiles)) {
            issue_raw(more ? tile : next, more ? c + 1 : 0);
            if (!ds)
              load_w1_chunk<true>(s0 + kOffW1c + ((c + 1) & 1) * 8192, p.w1, more ? c + 1 : 0);
            cp_async_commit();
          }
          xb = s_pix;
          wb = ds ? s0 + kOffW1 : s0 + kOffW1c + (c & 1) * 8192;
        } else {
          cp_async_wait_all();
          __syncthreads();
          if (c + 1 < nch) {
            issue_chunk(tile, c + 1, buf((c + 1) & 1), s0 + kOffW1c + ((c + 1) & 1) * 8192);
            cp_async_commit();
          } else if (!ds && next < p.n_tiles) {
            issue_chunk(next, 0, buf(0), s0 + kOffW1c);
            cp_async_commit();
          }
          xb = ds ? s_x64 : buf(c & 1);
          wb = ds ? s0 + kOffW1 : s0 + kOffW1c + (c & 1) * 8192;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[3][4], bf[2][4];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            frag_a(a[i], xb, min(16 * (3 * mg + i) + frow, kHalo - 1), kk);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) frag_w<CM>(bf[nn], wb, 16 * kk, n0 + 16 * nn, 128);
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma16816(acc[i][j], a[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
      // ReLU, zero outside the image, bf16 into h1.
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
            const float v0 = inside ? fmaxf(acc[i][j][2 * h], 0.0f) : 0.0f;
            const float v1 = inside ? fmaxf(acc[i][j][2 * h + 1], 0.0f) : 0.0f;
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
            frag_w<CM>(bf[nn], s_w2 + tap * kMid * 128, 16 * kk, n0 + 16 * nn, 128);
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
                pack_bf16(fmaxf(acc[i][j][2 * h], 0.0f), fmaxf(acc[i][j][2 * h + 1], 0.0f));
          }
        }
    }
    __syncthreads();
    if (ds && next < p.n_tiles) {  // h1 is dead: the next halo goes there (B: over it)
      if (CM)
        issue_raw(next, 0);
      else
        issue_chunk(next, 0, s_h1, 0);
      cp_async_commit();
    }

    // conv3 (+ downsample) + residual + ReLU: warp = 2 units of 2 output
    // rows x 64 channels.
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
          for (int nn = 0; nn < 4; ++nn) frag_w<CM>(bf[nn], wt, 16 * kk, n0 + 16 * nn, 512);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              mma16816(acc[i][j], a[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int y = ty0 + oy0 + i;
        if (CM && !ds) {
          // bf16(acc) into the warp's (64 channel, 16 pixel) tile in h1's
          // dead buffer by stmatrix.trans (32-byte channel rows, their
          // halves swapped on every other group of four rows) ...
          const uint32_t tile = s0 + kOffH1 + warp * 2048;
          const int m = lane >> 3, row = lane & 7;
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            const int ch = 8 * (j + (m >> 1)) + row, h = m & 1;
            stsm_x4_t(tile + ch * 32 + ((h ^ ((ch >> 2) & 1)) << 4),
                      pack_bf16(acc[i][j][0], acc[i][j][1]), pack_bf16(acc[i][j][2], acc[i][j][3]),
                      pack_bf16(acc[i][j + 1][0], acc[i][j + 1][1]),
                      pack_bf16(acc[i][j + 1][2], acc[i][j + 1][3]));
          }
          __syncwarp();
          // ... then residual + ReLU and 16-byte stores: two lanes a channel row.
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int item = lane + 32 * e, ch = item >> 1, h = item & 1, xx = tx0 + 8 * h;
            if (y >= H || xx >= W) continue;
            const uint4 v = *reinterpret_cast<const uint4*>(
                smem + (tile - s0) + ch * 32 + ((h ^ ((ch >> 2) & 1)) << 4));
            const size_t o = (((size_t)b * kOut + n0 + ch) * H + y) * W + xx;
            const uint4 res = __ldg(reinterpret_cast<const uint4*>(p.x + o));
            uint4 outv;
            outv.x = add_relu_bf16(v.x, res.x);
            outv.y = add_relu_bf16(v.y, res.y);
            outv.z = add_relu_bf16(v.z, res.z);
            outv.w = add_relu_bf16(v.w, res.w);
            *reinterpret_cast<uint4*>(p.out + o) = outv;
          }
          __syncwarp();
        } else if (CM) {
          // Block 0 (no residual; every buffer is taken: the next tile's raw
          // halo is arriving over the epilogue tiles): movmatrix.trans in
          // the registers, lane 4 g + t holding channel n0 + 8 j + g, pixels
          // tx0 + 8 h + 2 t, +1.
          const size_t row0 = ((size_t)b * kOut + n0 + g) * H + y;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t v =
                  movmatrix_t(pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]));
              const int xx = tx0 + 8 * h + 2 * t;
              if (y < H && xx < W)
                *reinterpret_cast<uint32_t*>(p.out + (row0 + (size_t)8 * j * H) * W + xx) =
                    add_relu_bf16(v, 0);
            }
        } else {
          // bf16(acc) into the warp's 16 x 64 tile ...
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<uint32_t*>(stage + swz(g + 8 * h, j, 128) + 4 * t) =
                  pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          __syncwarp();
          // ... then residual + ReLU and 16-byte stores: a quarter warp a pixel.
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (lane >> 3) + 4 * e, ch = lane & 7, xx = tx0 + row;
            if (y >= H || xx >= W) continue;
            const uint4 v = *reinterpret_cast<const uint4*>(stage + swz(row, ch, 128));
            const size_t o = (((size_t)b * H + y) * W + xx) * kOut + n0 + ch * 8;
            uint4 res = make_uint4(0, 0, 0, 0);
            if (!ds) res = __ldg(reinterpret_cast<const uint4*>(p.x + o));
            uint4 outv;
            outv.x = add_relu_bf16(v.x, res.x);
            outv.y = add_relu_bf16(v.y, res.y);
            outv.z = add_relu_bf16(v.z, res.z);
            outv.w = add_relu_bf16(v.w, res.w);
            *reinterpret_cast<uint4*>(p.out + o) = outv;
          }
          __syncwarp();
        }
      }
    }
  }
  cp_async_wait_all();
}

template <bool CM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bottleneck_probe_kernel<CM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  bottleneck_probe_kernel<CM><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One bottleneck of the probe. channel_major: variant B's layouts (else A's).
// wd non-null: block 0 (cin 64, downsample residual); null: cin 256, identity.
extern "C" int mhent_stage1_probe_block(const void* x, const void* w1, const void* wp,
                                        const void* w3, const void* wd, void* out, int B,
                                        int H, int W, int cin, int channel_major,
                                        void* stream) {
  if (B < 1 || H < 1 || W < 1 || (channel_major && W % 8) ||
      cin != (wd != nullptr ? kMid : kOut))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.wp = static_cast<const bf16*>(wp);
  p.w3 = static_cast<const bf16*>(w3);
  p.wd = static_cast<const bf16*>(wd);
  p.out = static_cast<bf16*>(out);
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.tiles_x = (W + kTw - 1) / kTw;
  p.tiles_y = (H + kTh - 1) / kTh;
  const long long n_tiles = (long long)B * p.tiles_x * p.tiles_y;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)n_tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(channel_major ? launch<true>(p, st) : launch<false>(p, st));
}
