// Conditional RealNVP transform with f32 weights for Hopper (sm_90a): the
// forward of the differentiable hypothesis draw.
//
// Replaces mhentropy_tpu/flows/pallas_sampler.py::_kernel_transform (:304),
// the f32-weight launch of the Pallas `_kernel` (:64) that
// `sample_fused_diff` (:338) / `transform_diff` (:288) run under their
// custom VJP. The backward recomputes the plain f32 flow (as `_transform_bwd`
// :327 reruns the XLA scan), so this forward must agree with that flow to
// f32 rounding: it computes in f32 FMAs throughout (one-pass TF32 would keep
// 10 mantissa bits, and the loss and its gradient would describe different
// functions).
//
// What it computes: every row of B images x N hypotheses through all L
// coupling layers. Per layer: x_m = x * mask; for the s and t nets,
// h1 = lrelu(x_m W0 + b0 + c0), h2 = lrelu(h1 W1 + b1 + c1), o = h2 W2 + b2
// (tanh on s), with c0 / c1 the row's image's conditioning projections; then
// x = x_m + (1 - mask) * (x * exp(s) + t) and logdet += sum(s).
//
// What bounds it on the H100: operations. 2 nets x (Dp H + H H + H Dp) MACs a
// row a layer, about 0.62 M at H = 512; at 640 rows (N = 10, B = 64) and 12
// layers that is 9.6 GFLOP, 0.14 ms at the 67 TFLOP/s f32 peak. The f32
// weights of 12 layers (30 MB) fit the 50 MB L2, so the blocks after the
// first read them from L2.
//
// Design: one block owns kRows consecutive rows of the flattened (B * N) row
// space, whatever images they belong to (at N = 10 a tile of one image would
// leave most rows empty), and loops over all L layers itself. x, the masked
// x, both hidden activations and the log-det stay in shared memory in f32.
// The weights stream through shared memory in tiles of kTileK rows with
// cp.async, two tiles in flight, so every block reads them with coalesced
// 16-byte copies instead of one dependent load per FMA group. In a hidden
// product each thread owns a 4 x 4 tile of outputs: per four k it reads four
// float4 of staged weights and four float4 of activations (broadcasts
// within a warp) and issues 64 FMAs. The conditioning projection of each row's image is added
// in the epilogue. D is padded to a multiple of 16 with mask = 1 on padded
// dims: they pass through unchanged and add nothing to the log-det.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 8;  // rows per block
constexpr int kThreads = 256;
constexpr int kTileK = 32;  // weight rows per staged tile
constexpr int kCols = 2 * kThreads;  // columns of one hidden-product pass

struct Params {
  const float* z0;     // (B, N, D) image-major base samples
  const float* cproj;  // (L, 4, B, H): s0, s1, t0, t1 projections
  const float* masks;  // (L, Dp)
  const float* w0;     // (L, 2, Dp, H)   [in, out], net 0 = s, 1 = t
  const float* w1;     // (L, 2, H, H)
  const float* w2;     // (L, 2, H, Dp)
  const float* b0;     // (L, 2, H)
  const float* b1;     // (L, 2, H)
  const float* b2;     // (L, 2, Dp)
  float* x_out;        // (B, N, D)
  float* logdet;       // (B, N)
  int B, N, D, Dp, H, L;
};

__device__ __forceinline__ float lrelu(float v) { return v > 0.0f ? v : 0.01f * v; }

// Starts copying rows [k0, k0 + kk) x columns [c0, c0 + cw) of w (row
// stride ld, all multiples of 4) into dst (kk x cw), 16 bytes a copy.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ w, int ld,
                                      int k0, int kk, int c0, int cw) {
  const int per_row = cw / 4;
  for (int i = threadIdx.x; i < kk * per_row; i += kThreads) {
    const int r = i / per_row, q = i % per_row;
    __pipeline_memcpy_async(dst + r * cw + 4 * q, w + (size_t)(k0 + r) * ld + c0 + 4 * q, 16);
  }
  __pipeline_commit();
}

// Runs body(tile, k0, kk) over the kTileK-row tiles of w's rows [0, K) and
// columns [c0, c0 + cw), each staged in one of the two buffers of wbuf while
// the previous tile is computed on. Every thread of the block calls it.
template <typename Body>
__device__ __forceinline__ void over_tiles(const float* __restrict__ w, int ld, int K, int c0,
                                           int cw, float* wbuf, Body body) {
  const int tiles = (K + kTileK - 1) / kTileK;
  stage(wbuf, w, ld, 0, min(kTileK, K), c0, cw);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTileK, kk = min(kTileK, K - k0);
    if (t + 1 < tiles) {
      stage(wbuf + ((t + 1) % 2) * kTileK * cw, w, ld, k0 + kTileK,
            min(kTileK, K - k0 - kTileK), c0, cw);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    body(wbuf + (t % 2) * kTileK * cw, k0, kk);
    __syncthreads();  // the buffer is staged into again two tiles on
  }
}

// out[r, c] = lrelu(sum_k a[r, k] w[k, c] + bias[c] + cp[img[r], c]) for the
// block's kRows rows and all H columns. a: (kRows, K) in shared memory (K a
// multiple of 4); w: (K, H) in device memory; cp: (B, H). Thread (g, q) owns
// the 4 x 4 outputs of rows 4q .. 4q + 3 and columns 4g .. 4g + 3 of a pass.
__device__ void hidden_product(const float* a, int K, const float* __restrict__ w, int H,
                               const float* __restrict__ bias, const float* __restrict__ cp,
                               const int* img, float* wbuf, float* out) {
  static_assert(kRows == 4 * (kThreads / (kCols / 4)), "4 x 4 outputs a thread");
  const int j = 4 * (threadIdx.x % (kCols / 4));  // first column within a pass
  const int r0 = 4 * (threadIdx.x / (kCols / 4));
  for (int c_base = 0; c_base < H; c_base += kCols) {
    const int cw = min(kCols, H - c_base);
    const bool active = j < cw;
    float acc[4][4] = {};
    over_tiles(w, H, K, c_base, cw, wbuf, [&](const float* tile, int k0, int kk) {
      if (!active) return;
      for (int k = 0; k < kk; k += 4) {
        float4 wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = *reinterpret_cast<const float4*>(tile + (k + i) * cw + j);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(a + (r0 + r) * K + k0 + k);
          const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[r][0] = fmaf(ak[i], wv[i].x, acc[r][0]);
            acc[r][1] = fmaf(ak[i], wv[i].y, acc[r][1]);
            acc[r][2] = fmaf(ak[i], wv[i].z, acc[r][2]);
            acc[r][3] = fmaf(ak[i], wv[i].w, acc[r][3]);
          }
        }
      }
    });
    if (active) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* cpr = cp + (size_t)img[r0 + r] * H;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c_base + j + q;
          out[(r0 + r) * H + c] = lrelu(acc[r][q] + bias[c] + cpr[c]);
        }
      }
    }
  }
}

// out[r, c] = sum_k h[r, k] w[k, c] for kRows rows and Dp columns. h: (kRows,
// H) in shared memory; w: (H, Dp). Thread (c, g) owns column c of the four
// rows 4g .. 4g + 3.
__device__ void out_product(const float* h, int H, const float* __restrict__ w, int Dp,
                            float* wbuf, float* out) {
  static_assert(kRows % 4 == 0, "row groups of four");
  const int c = threadIdx.x % Dp, g = threadIdx.x / Dp;
  const bool active = g < kRows / 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  over_tiles(w, Dp, H, 0, Dp, wbuf, [&](const float* tile, int k0, int kk) {
    if (!active) return;
    for (int k = 0; k < kk; k += 4) {
      const float w0 = tile[k * Dp + c], w1 = tile[(k + 1) * Dp + c];
      const float w2 = tile[(k + 2) * Dp + c], w3 = tile[(k + 3) * Dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(h + (4 * g + i) * H + k0 + k);
        acc[i] = fmaf(hv.x, w0, acc[i]);
        acc[i] = fmaf(hv.y, w1, acc[i]);
        acc[i] = fmaf(hv.z, w2, acc[i]);
        acc[i] = fmaf(hv.w, w3, acc[i]);
      }
    }
  });
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[(4 * g + i) * Dp + c] = acc[i];
  }
}

// Columns of a staged weight tile: a hidden-product pass or the Dp outputs.
__host__ __device__ inline int staged_cols(int Dp, int H) {
  const int pass = H < kCols ? H : kCols;
  return pass > Dp ? pass : Dp;
}

size_t smem_bytes(int Dp, int H) {
  const int wcols = staged_cols(Dp, H);
  return sizeof(float) * (2 * kTileK * wcols + 4 * kRows * Dp + 2 * kRows * H + kRows) +
         sizeof(int) * kRows;
}

__global__ void __launch_bounds__(kThreads) realnvp_sample_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = p.Dp, H = p.H;
  const int rows = p.B * p.N;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;

  // Every region starts at a multiple of 16 bytes: Dp is a multiple of 16
  // and H of 4.
  const int wcols = staged_cols(Dp, H);
  float* wbuf = reinterpret_cast<float*>(smem);  // (2, kTileK, wcols) staged weights
  float* x = wbuf + 2 * kTileK * wcols;          // (kRows, Dp) state
  float* xm = x + kRows * Dp;                    // (kRows, Dp) masked state
  float* so = xm + kRows * Dp;                   // (2, kRows, Dp) s and t
  float* h1 = so + 2 * kRows * Dp;               // (kRows, H)
  float* h2 = h1 + kRows * H;                    // (kRows, H)
  float* ld = h2 + kRows * H;                    // (kRows,) log-det
  int* img = reinterpret_cast<int*>(ld + kRows);  // (kRows,) image of each row

  for (int e = tid; e < kRows * Dp; e += kThreads) {
    const int r = e / Dp, d = e % Dp, g = row0 + r;
    x[e] = (g < rows && d < p.D) ? p.z0[(size_t)g * p.D + d] : 0.0f;
  }
  if (tid < kRows) {
    const int g = row0 + tid;
    ld[tid] = 0.0f;
    img[tid] = (g < rows ? g : rows - 1) / p.N;
  }
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const float* mask = p.masks + (size_t)l * Dp;
    for (int e = tid; e < kRows * Dp; e += kThreads) xm[e] = x[e] * mask[e % Dp];
    __syncthreads();
    for (int net = 0; net < 2; ++net) {
      const size_t ln = (size_t)l * 2 + net;
      const float* cp0 = p.cproj + ((size_t)l * 4 + 2 * net) * p.B * H;
      const float* cp1 = cp0 + (size_t)p.B * H;
      hidden_product(xm, Dp, p.w0 + ln * Dp * H, H, p.b0 + ln * H, cp0, img, wbuf, h1);
      __syncthreads();
      hidden_product(h1, H, p.w1 + ln * H * H, H, p.b1 + ln * H, cp1, img, wbuf, h2);
      __syncthreads();
      out_product(h2, H, p.w2 + ln * H * Dp, Dp, wbuf, so + net * kRows * Dp);
      __syncthreads();
    }
    const float* b2s = p.b2 + (size_t)l * 2 * Dp;
    const float* b2t = b2s + Dp;
    for (int e = tid; e < kRows * Dp; e += kThreads) {
      const int d = e % Dp;
      const float m = mask[d], inv = 1.0f - m;
      const float s = tanhf(so[e] + b2s[d]) * inv;
      const float t = (so[kRows * Dp + e] + b2t[d]) * inv;
      x[e] = xm[e] + inv * (x[e] * expf(s) + t);
      so[e] = s;
    }
    __syncthreads();
    if (tid < kRows) {
      float acc = 0.0f;
      for (int d = 0; d < Dp; ++d) acc += so[tid * Dp + d];
      ld[tid] += acc;
    }
    // The next write to `so` is three barriers away, so the row sums above
    // need no barrier of their own.
  }
  __syncthreads();

  for (int e = tid; e < kRows * p.D; e += kThreads) {
    const int r = e / p.D, d = e % p.D, g = row0 + r;
    if (g < rows) p.x_out[(size_t)g * p.D + d] = x[r * Dp + d];
  }
  if (tid < kRows && row0 + tid < rows) p.logdet[row0 + tid] = ld[tid];
}

}  // namespace

extern "C" int mhent_realnvp_sample_f32(const void* z0, const void* cproj, const void* masks,
                                        const void* w0, const void* w1, const void* w2,
                                        const void* b0, const void* b1, const void* b2,
                                        void* x_out, void* logdet, int B, int N, int D,
                                        int Dp, int H, int L, void* stream) {
  if (B < 1 || N < 1 || D < 1 || Dp % 16 || Dp < D || Dp > kThreads / (kRows / 4) || H < 4 ||
      H % 4 || L < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.z0 = static_cast<const float*>(z0);
  p.cproj = static_cast<const float*>(cproj);
  p.masks = static_cast<const float*>(masks);
  p.w0 = static_cast<const float*>(w0);
  p.w1 = static_cast<const float*>(w1);
  p.w2 = static_cast<const float*>(w2);
  p.b0 = static_cast<const float*>(b0);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.x_out = static_cast<float*>(x_out);
  p.logdet = static_cast<float*>(logdet);
  p.B = B;
  p.N = N;
  p.D = D;
  p.Dp = Dp;
  p.H = H;
  p.L = L;
  const size_t smem = smem_bytes(Dp, H);
  cudaError_t err = cudaFuncSetAttribute(
      realnvp_sample_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B * N + kRows - 1) / kRows;
  realnvp_sample_f32_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
