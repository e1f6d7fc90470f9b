// Fused conditional RealNVP sampler for Hopper (sm_90a).
//
// Replaces mhentropy_tpu/flows/pallas_sampler.py::sample_fused (the Pallas
// `_kernel` at :64, launched by `_fused_transform` at :115).
//
// What it computes: every hypothesis row of every image through all L
// coupling layers. Per layer: x_m = x * mask; for the s and t nets,
// h1 = lrelu(x_m W0 + b0 + c0), h2 = lrelu(h1 W1 + b1 + c1), o = h2 W2 + b2
// (tanh on s), with c0/c1 the image's conditioning projections; then
// x = x_m + (1 - mask) * (x * exp(s) + t) and logdet += sum(s).
//
// What bounds it on the H100: the (rows, 512) x (512, 512) products, about
// 1.2 MFLOP per row per layer, and re-reading each layer's weights (1.1 MB in
// bf16) once per block. The XLA scan and a plain PyTorch loop write x and the
// (rows, 512) hidden activations to device memory between every product.
//
// Design: one block owns kRows hypothesis rows of ONE image and loops over
// all L layers itself (the TPU ran the layer axis as a sequential grid axis
// with x in VMEM; here the loop lives inside the block). x and the log-det
// stay in shared memory in f32 across layers; the hidden activations live in
// shared memory as bf16 and feed the tensor cores through WMMA bf16
// fragments with f32 accumulation. Weights stream from device memory / L2
// (14 MB for 12 layers fits the 50 MB L2, so blocks after the first hit L2).
// The image's conditioning projections are added as a per-column bias in the
// GEMM epilogue, so no (rows, L, 4, H) tensor is ever built. D is padded to a
// multiple of 16 with mask = 1 on padded dims: they pass through unchanged
// and add nothing to the log-det.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

using namespace nvcuda;

namespace {

constexpr int kRows = 32;         // hypothesis rows per block (2 WMMA row tiles)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerWarp = 4;   // 16-wide column tiles a warp owns at once
constexpr int kStage = 256;       // floats of per-warp epilogue staging

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Params {
  const float* z0;             // (B, N, D) image-major base samples
  const float* cproj;          // (L, 4, B, H): s0, s1, t0, t1 projections
  const float* masks;          // (L, Dp)
  const __nv_bfloat16* w0;     // (L, 2, Dp, H)   [in, out], net 0 = s, 1 = t
  const __nv_bfloat16* w1;     // (L, 2, H, H)
  const __nv_bfloat16* w2;     // (L, 2, H, Dp)
  const float* b0;             // (L, 2, H)
  const float* b1;             // (L, 2, H)
  const float* b2;             // (L, 2, Dp)
  float* x_out;                // (B, N, D)
  float* logdet;               // (B, N)
  int B, N, D, Dp, H, L;
};

// out[r, c] = lrelu(sum_k a[r, k] w[k, c] + bias[c] + cp[c]) stored as bf16,
// for the block's kRows rows and all H columns. a: (kRows, k_dim) row-major
// in shared memory; w: (k_dim, H) row-major in device memory.
__device__ void hidden_gemm(const __nv_bfloat16* a, int lda, int k_dim,
                            const __nv_bfloat16* w, int H, const float* bias,
                            const float* cp, __nv_bfloat16* out, float* stage) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = H / (16 * kColsPerWarp);
  for (int g = warp; g < groups; g += kWarps) {
    FragC acc[2][kColsPerWarp];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerWarp; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k = 0; k < k_dim; k += 16) {
      FragA a0, a1;
      wmma::load_matrix_sync(a0, a + k, lda);
      wmma::load_matrix_sync(a1, a + 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < kColsPerWarp; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, w + (size_t)k * H + (g * kColsPerWarp + j) * 16, H);
        wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kColsPerWarp; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int col0 = (g * kColsPerWarp + j) * 16;
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = col0 + e % 16;
          float v = stage[e] + bias[c] + cp[c];
          v = v > 0.0f ? v : 0.01f * v;
          out[(i * 16 + r) * H + c] = __float2bfloat16(v);
        }
        __syncwarp();
      }
    }
  }
}

// out[r, c] = sum_k h[r, k] w[k, c] in f32 for kRows rows and Dp columns.
__device__ void out_gemm(const __nv_bfloat16* h, int H, const __nv_bfloat16* w,
                         int Dp, float* out) {
  const int warp = threadIdx.x / 32;
  const int col_tiles = Dp / 16;
  for (int t = warp; t < 2 * col_tiles; t += kWarps) {
    const int i = t / col_tiles, j = t % col_tiles;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < H; k += 16) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, h + i * 16 * H + k, H);
      wmma::load_matrix_sync(b, w + (size_t)k * Dp + j * 16, Dp);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out + i * 16 * Dp + j * 16, acc, Dp, wmma::mem_row_major);
  }
}

size_t smem_bytes(int Dp, int H) {
  return sizeof(float) * (3 * kRows * Dp + kWarps * kStage + kRows) +
         sizeof(__nv_bfloat16) * (kRows * Dp + 2 * kRows * H);
}

__global__ void __launch_bounds__(kThreads) realnvp_sample_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = p.Dp, H = p.H;
  const int tiles = (p.N + kRows - 1) / kRows;
  const int img = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * kRows;
  const int tid = threadIdx.x;

  // Every region starts at a multiple of 32 bytes (WMMA's alignment rule):
  // Dp and H are multiples of 16, kRows is 32.
  float* x = reinterpret_cast<float*>(smem);      // (kRows, Dp) state
  float* so = x + kRows * Dp;                     // (2, kRows, Dp) s and t
  float* stage = so + 2 * kRows * Dp;             // (kWarps, kStage)
  float* ld = stage + kWarps * kStage;            // (kRows,) log-det
  __nv_bfloat16* xm = reinterpret_cast<__nv_bfloat16*>(ld + kRows);  // (kRows, Dp)
  __nv_bfloat16* h1 = xm + kRows * Dp;            // (kRows, H)
  __nv_bfloat16* h2 = h1 + kRows * H;             // (kRows, H)
  float* my_stage = stage + (tid / 32) * kStage;

  for (int e = tid; e < kRows * Dp; e += kThreads) {
    const int r = e / Dp, d = e % Dp, n = row0 + r;
    x[e] = (n < p.N && d < p.D) ? p.z0[((size_t)img * p.N + n) * p.D + d] : 0.0f;
  }
  if (tid < kRows) ld[tid] = 0.0f;
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const float* mask = p.masks + (size_t)l * Dp;
    for (int e = tid; e < kRows * Dp; e += kThreads)
      xm[e] = __float2bfloat16(x[e] * mask[e % Dp]);
    __syncthreads();
    for (int net = 0; net < 2; ++net) {
      const size_t ln = (size_t)l * 2 + net;
      const float* cp0 = p.cproj + (((size_t)l * 4 + 2 * net) * p.B + img) * H;
      const float* cp1 = cp0 + (size_t)p.B * H;
      hidden_gemm(xm, Dp, Dp, p.w0 + ln * Dp * H, H, p.b0 + ln * H, cp0, h1, my_stage);
      __syncthreads();
      hidden_gemm(h1, H, H, p.w1 + ln * H * H, H, p.b1 + ln * H, cp1, h2, my_stage);
      __syncthreads();
      out_gemm(h2, H, p.w2 + ln * H * Dp, Dp, so + net * kRows * Dp);
      __syncthreads();
    }
    const float* b2s = p.b2 + (size_t)l * 2 * Dp;
    const float* b2t = b2s + Dp;
    for (int e = tid; e < kRows * Dp; e += kThreads) {
      const int d = e % Dp;
      const float m = mask[d], inv = 1.0f - m;
      const float s = tanhf(so[e] + b2s[d]) * inv;
      const float t = (so[kRows * Dp + e] + b2t[d]) * inv;
      const float xv = x[e];
      x[e] = xv * m + inv * (xv * expf(s) + t);
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
    const int r = e / p.D, d = e % p.D, n = row0 + r;
    if (n < p.N) p.x_out[((size_t)img * p.N + n) * p.D + d] = x[r * Dp + d];
  }
  if (tid < kRows && row0 + tid < p.N) p.logdet[(size_t)img * p.N + row0 + tid] = ld[tid];
}

}  // namespace

extern "C" int mhent_realnvp_sample(const void* z0, const void* cproj, const void* masks,
                                    const void* w0, const void* w1, const void* w2,
                                    const void* b0, const void* b1, const void* b2,
                                    void* x_out, void* logdet, int B, int N, int D,
                                    int Dp, int H, int L, void* stream) {
  if (B < 1 || N < 1 || D < 1 || Dp % 16 || Dp < D || H % (16 * kColsPerWarp) || L < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.z0 = static_cast<const float*>(z0);
  p.cproj = static_cast<const float*>(cproj);
  p.masks = static_cast<const float*>(masks);
  p.w0 = static_cast<const __nv_bfloat16*>(w0);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
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
      realnvp_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kRows - 1) / kRows;
  realnvp_sample_kernel<<<B * tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
