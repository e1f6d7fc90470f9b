// W8A8 fused conditional RealNVP sampler for Hopper (sm_90a).
//
// Replaces mhentropy_tpu/flows/pallas_sampler_int8.py::sample_fused_q (the
// Pallas `_kernel` at :278, launched by `_fused_transform_q` at :333).
//
// What it computes: every hypothesis row of every image through all L
// coupling layers with the quantised arithmetic of `_quant_layer` (:211):
//   xq = clip(rint(x * qm), +-127)                    (x * mask, quantised)
//   h1 = q(lrelu(acc(xq W0) * e0 + c0))               c0, c1: the image's
//   h2 = q(lrelu(acc(h1 W1) * e1 + c1))               pre-scaled cond cache
//   o  = acc(h2 W2) * e2 + b2  (tanh on the s net)
//   x  = x * mask + (1 - mask) * (x * exp(s) + t),  logdet += sum(s)
// with s8 x s8 -> s32 products (mma.sync m16n8k32) and every epilogue
// multiply and add rounded on its own (no FMA contraction), as the XLA
// emulation `xla_forward_q` computes them. x, exp(s) and the log-det are f32.
//
// What bounds it on the H100: the products. Per row and layer the six
// GEMMs are 2 x (D x H + H x H + H x D) MACs, 0.62 M at D = 45 and H = 512;
// at B = 8, N = 200, L = 12 that is 23.7 GOP, 12 us at the 1,979 TOP/s int8
// peak, against 8 MB of int8 weights (2.4 us at 3.35 TB/s). Every block
// streams each layer's weights (0.33 MB a net) from L2, which bounds this
// simple version long before the tensor cores do.
//
// Design: the bf16 sampler's (csrc/realnvp_sampler.cu) with s8 operands.
// One block owns kRows hypothesis rows of ONE image and loops over all L
// layers itself (the TPU ran the layer axis as a sequential grid axis with
// x in VMEM). x, the s/t outputs and the log-det stay in shared memory in
// f32; the quantised activations live in shared memory as s8 (rows padded
// by 16 bytes so the fragment loads of 8 rows hit 8 banks). Each epilogue runs on the
// accumulator registers and writes the next layer's s8 operand directly.
// Weights are stored [out][in], so a B fragment is one 32-bit load. D is
// padded to Dp (a multiple of 32) with mask = 1 and zero weights on the
// padding: padded dims pass through and add nothing to the log-det.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "int8_mma.cuh"

namespace {

constexpr int kRows = 32;  // hypothesis rows per block (2 MMA row tiles)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Params {
  const float* z0;      // (B, N, D) image-major base samples
  const float* cq;      // (L, B, 4, H) pre-scaled cond: s0, s1, t0, t1
  const float* masks;   // (L, Dp)
  const float* qm;      // (L, Dp) mask * inv_a0
  const int8_t* w0;     // (L, 2, H, Dp)  [out, in], net 0 = s, 1 = t
  const int8_t* w1;     // (L, 2, H, H)
  const int8_t* w2;     // (L, 2, Dp, H)
  const float* e0;      // (L, 2, H)
  const float* e1;      // (L, 2, H)
  const float* e2;      // (L, 2, Dp)
  const float* b2;      // (L, 2, Dp)
  float* x_out;         // (B, N, D)
  float* logdet;        // (B, N)
  int B, N, D, Dp, H, L;
};

// out[r, c] = q(lrelu(acc[r, c] * e[c] + cp[c])) for the block's kRows rows
// and all H columns; a (kRows, k_dim) s8 with row stride lda, w (H, k_dim).
__device__ void hidden_gemm(const int8_t* a, int lda, int k_dim, const int8_t* w, int H,
                            const float* e, const float* cp, int8_t* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // Column tiles of 8: warp w owns tiles w, w + 8, w + 16, ..., up to 8 at
  // a time in registers.
  const int ntiles = H / 8;
  for (int base = warp; base < ntiles; base += 8 * kWarps) {
    int acc[2][8][4] = {};
    for (int k = 0; k < k_dim; k += 32) {
      unsigned a0[4], a1[4];
      load_a(a0, a + k, lda);
      load_a(a1, a + 16 * lda + k, lda);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int nt = base + n * kWarps;
        if (nt >= ntiles) break;
        unsigned bf[2];
        load_b(bf, w + (size_t)nt * 8 * k_dim + k, k_dim);
        mma_s8(acc[0][n], a0, bf);
        mma_s8(acc[1][n], a1, bf);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int nt = base + n * kWarps;
        if (nt >= ntiles) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m * 16 + g + (i >> 1) * 8, c = nt * 8 + t * 2 + (i & 1);
          float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[m][n][i]), e[c]), cp[c]);
          v = v > 0.0f ? v : __fmul_rn(0.01f, v);
          out[r * ldo + c] = quant(v);
        }
      }
  }
}

// out[r, c] = acc[r, c] * e[c] + bias[c] (tanh when squash) in f32 for
// kRows rows and Dp columns; h (kRows, H) s8, w (Dp, H).
__device__ void out_gemm(const int8_t* h, int ldh, int H, const int8_t* w, int Dp,
                         const float* e, const float* bias, bool squash, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col_tiles = Dp / 8;
  for (int tile = warp; tile < 2 * col_tiles; tile += kWarps) {
    const int m = tile / col_tiles, n0 = (tile % col_tiles) * 8;
    int acc[4] = {};
    for (int k = 0; k < H; k += 32) {
      unsigned a[4], bf[2];
      load_a(a, h + m * 16 * ldh + k, ldh);
      load_b(bf, w + (size_t)n0 * H + k, H);
      mma_s8(acc, a, bf);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m * 16 + g + (i >> 1) * 8, c = n0 + t * 2 + (i & 1);
      float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), e[c]), bias[c]);
      out[r * Dp + c] = squash ? tanhf(v) : v;
    }
  }
}

size_t smem_bytes(int Dp, int H) {
  return sizeof(float) * (3 * kRows * Dp + kRows) +
         (size_t)kRows * (Dp + 16) + 2 * (size_t)kRows * (H + 16);
}

__global__ void __launch_bounds__(kThreads) realnvp_sample_q_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = p.Dp, H = p.H;
  const int tiles = (p.N + kRows - 1) / kRows;
  const int img = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * kRows;
  const int tid = threadIdx.x;
  const int ldx = Dp + 16, ldh = H + 16;

  float* x = reinterpret_cast<float*>(smem);            // (kRows, Dp) state
  float* so = x + kRows * Dp;                           // (2, kRows, Dp) s and t
  float* ld = so + 2 * kRows * Dp;                      // (kRows,) log-det
  int8_t* xq = reinterpret_cast<int8_t*>(ld + kRows);   // (kRows, ldx)
  int8_t* h1 = xq + kRows * ldx;                        // (kRows, ldh)
  int8_t* h2 = h1 + kRows * ldh;                        // (kRows, ldh)

  for (int e = tid; e < kRows * Dp; e += kThreads) {
    const int r = e / Dp, d = e % Dp, n = row0 + r;
    x[e] = (n < p.N && d < p.D) ? p.z0[((size_t)img * p.N + n) * p.D + d] : 0.0f;
  }
  if (tid < kRows) ld[tid] = 0.0f;
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const float* mask = p.masks + (size_t)l * Dp;
    const float* qm = p.qm + (size_t)l * Dp;
    for (int e = tid; e < kRows * Dp; e += kThreads) {
      const int r = e / Dp, d = e % Dp;
      xq[r * ldx + d] = quant(__fmul_rn(x[e], qm[d]));
    }
    __syncthreads();
    for (int net = 0; net < 2; ++net) {
      const size_t ln = (size_t)l * 2 + net;
      const float* cp0 = p.cq + (((size_t)l * p.B + img) * 4 + 2 * net) * H;
      const float* cp1 = cp0 + H;
      hidden_gemm(xq, ldx, Dp, p.w0 + ln * H * Dp, H, p.e0 + ln * H, cp0, h1, ldh);
      __syncthreads();
      hidden_gemm(h1, ldh, H, p.w1 + ln * H * H, H, p.e1 + ln * H, cp1, h2, ldh);
      __syncthreads();
      out_gemm(h2, ldh, H, p.w2 + ln * Dp * H, Dp, p.e2 + ln * Dp, p.b2 + ln * Dp,
               net == 0, so + net * kRows * Dp);
      __syncthreads();
    }
    for (int e = tid; e < kRows * Dp; e += kThreads) {
      const int d = e % Dp;
      const float m = mask[d], inv = 1.0f - m;
      const float s = __fmul_rn(so[e], inv);
      const float t = __fmul_rn(so[kRows * Dp + e], inv);
      const float xv = x[e];
      x[e] = __fadd_rn(__fmul_rn(xv, m), __fmul_rn(inv, __fadd_rn(__fmul_rn(xv, expf(s)), t)));
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

extern "C" int mhent_realnvp_sample_q(const void* z0, const void* cq, const void* masks,
                                      const void* qm, const void* w0, const void* w1,
                                      const void* w2, const void* e0, const void* e1,
                                      const void* e2, const void* b2, void* x_out,
                                      void* logdet, int B, int N, int D, int Dp, int H, int L,
                                      void* stream) {
  if (B < 1 || N < 1 || D < 1 || Dp % 32 || Dp < D || H % 32 || H < 32 || L < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.z0 = static_cast<const float*>(z0);
  p.cq = static_cast<const float*>(cq);
  p.masks = static_cast<const float*>(masks);
  p.qm = static_cast<const float*>(qm);
  p.w0 = static_cast<const int8_t*>(w0);
  p.w1 = static_cast<const int8_t*>(w1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.e0 = static_cast<const float*>(e0);
  p.e1 = static_cast<const float*>(e1);
  p.e2 = static_cast<const float*>(e2);
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
      realnvp_sample_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kRows - 1) / kRows;
  realnvp_sample_q_kernel<<<B * tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
