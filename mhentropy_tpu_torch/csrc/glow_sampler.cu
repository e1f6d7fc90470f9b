// Fused ConditionalGlow sampler (base -> data, with the log-det) for Hopper
// (sm_90a): the ProHMR / Humans flow.
//
// Replaces mhentropy_tpu/flows/pallas_glow_sampler.py::sample_and_log_prob_fused
// (the Pallas `_kernel` at :169, launched by `_fused_transform` at :283).
//
// What it computes, per (reversed) glow layer, for every hypothesis row, with
// x and the log-det in f32, bf16 weights (folded by cuda_glow_sampler.pack),
// every product's operands in bf16 and its sums in f32, as the TPU kernel
// casts every dot operand to the weights' dtype:
//
//   temps = x W_in + b_in + c_init            (c_*: the row's image's context
//   t     = relu(temps) W_00 + b_00            projections, per image)
//   temps += (relu(t) W_01 + b_01) * sigmoid(c_blk0)
//   t     = relu(temps) W_10 + b_10
//   temps += (relu(t) W_11 + b_11) * sigmoid(c_blk1)
//   shift = temps W_s + b_s;  scale = mask ? sigmoid(temps W_c + b_c + 2) + 1e-3 : 1
//   x = (x - shift * mask) / scale;  ld += sum log scale
//   x = (x - lu_bias) LU^-T;  x = (x - an_shift) * exp(-an_log_scale)
//
// What bounds it on the H100: the four (rows, H) x (H, H) products of every
// layer. At the ProHMR shape (3,200 rows = B 32 x N 100, D = 144 padded to
// Dp = 144, H = 1,024, 4 layers) that is about 18.6 M MAC a row, 119 GFLOP
// in all: 0.12 ms at the 989 TFLOP/s bf16 peak. The 37 MB of bf16 weights
// take 0.011 ms at 3.35 TB/s. So the shape is bound by operations.
//
// Design (b): one launch per stage over all rows, the (rows, H) state in
// device memory. At H = 1,024 one row's f32 temps and bf16 t take 6 KB, so
// a block that carried its rows through all layers (the RealNVP kernels'
// design) could hold at most 16 rows in 227 KB of shared memory, and each of
// its 200 blocks would then stream all 37 MB of weights from L2 (7.4 GB of
// L2 reads). Here each stage is a tiled GEMM over all 3,200 rows, so each
// weight tile is read by 50 row tiles from L2 and the (rows, H) state
// (13 MB f32 temps, two 6.5 MB bf16 operand copies) lives in device memory
// and mostly in L2, written and read once per stage. A layer is six
// launches from one C call:
//
//   glow_gemm<kInit>    x16 W_in   -> temps, a16 = bf16(relu(temps))
//   glow_gemm<kHidden>  a16 W_00   -> t16 = bf16(relu(t))
//   glow_gemm<kGate>    t16 W_01   -> temps +=, a16 = bf16(relu(temps))
//   glow_gemm<kHidden>  a16 W_10   -> t16
//   glow_gemm<kGate>    t16 W_11   -> a16 = bf16(temps)   (the last block)
//   glow_coupling       a16 [W_s | W_c], the affine step, x LU^-T, actnorm
//                       -> x (f32), x16 = bf16(x) for the next layer
//
// glow_gemm: 128 x 128 output tiles (25 x 8 = 200 blocks at the ProHMR
// shape), 8 warps of 64 x 32, BK = 32, operands in three shared-memory
// stages filled by cp.async (zero-filled past the ragged row edge and past
// K, so K need only be a multiple of 8), WMMA bf16 16x16x16 with f32
// accumulation, the epilogue through shared memory (the same bytes) with
// 16-byte stores. glow_coupling: 16 rows a block (16 warps) hold their bf16
// temps, the shift/scale products, the affine step and the (Dp x Dp) LU
// product in shared memory; the weights' fragments come from L2, two in
// flight a warp.
//
// The rows are image-major (b * N + n), so a row's image is row / N. D is
// padded to Dp (a multiple of 16, at most 256) with zero weights, mask 0
// and actnorm scale 1: the padding stays exactly zero and adds nothing to
// the log-det. H must be a multiple of 64. TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int BM = 128, BN = 128, BK = 32, kStages = 3;
constexpr int kGemmThreads = 256;   // 8 warps, 2 (M) x 4 (N), each a 64 x 32 tile
constexpr int LDA_S = BK + 8;       // bf16; rows 80 B apart (16-byte aligned)
constexpr int LDB_S = BN + 8;       // bf16; rows 272 B apart
constexpr int LDC_S = BN + 4;       // f32 epilogue staging; rows 528 B apart
constexpr int kStageElems = BM * LDA_S + BK * LDB_S;  // bf16 per pipeline stage
constexpr size_t kGemmSmem =
    sizeof(float) * BM * LDC_S > sizeof(__nv_bfloat16) * kStages * kStageElems
        ? sizeof(float) * BM * LDC_S
        : sizeof(__nv_bfloat16) * kStages * kStageElems;
constexpr int CR = 16;              // rows per coupling block
constexpr int kCoupThreads = 512;   // 16 warps
constexpr int kMaxDp = 256;

enum Epilogue { kInit = 0, kHidden = 1, kGate = 2 };

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (then
// nothing is read from src).
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  __pipeline_memcpy_async(dst, src, 16, ok ? 0 : 16);
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

struct GemmArgs {
  const bf16* a;      // (M, K) row-major, lda = K
  const bf16* w;      // (K, N) row-major
  const float* bias;  // (N,)
  const float* ctx;   // (images, N): this stage's context projections, or null
  float* temps;       // (M, N) f32 residual stream
  bf16* out16;        // (M, N) the next product's operand
  int M, N, K;
  int rows_per_image;
  int relu_out;       // kGate: out16 = relu(temps) (1) or temps (0)
};

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads) glow_gemm(GemmArgs g) {
  // kStages operand stages while the product runs; the f32 epilogue
  // staging reuses the same bytes afterwards.
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* s_c = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;

  auto load_tile = [&](int stage, int k0) {
    bf16* s_a = stages + stage * kStageElems;
    bf16* s_b = s_a + BM * LDA_S;
    for (int c = tid; c < BM * BK / 8; c += kGemmThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < g.M && gk < g.K;
      copy16(s_a + r * LDA_S + kc, ok ? g.a + (size_t)gr * g.K + gk : g.a, ok);
    }
    for (int c = tid; c < BK * BN / 8; c += kGemmThreads) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < g.K && gn < g.N;
      copy16(s_b + r * LDB_S + nc, ok ? g.w + (size_t)gk * g.N + gn : g.w, ok);
    }
  };

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // Tile kt sits in stage kt % kStages; one commit group per tile (empty
  // groups past the last tile keep the count uniform).
  const int ktiles = (g.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile(s, s * BK);
    __pipeline_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    __pipeline_wait_prior(kStages - 2);  // tile kt has landed
    __syncthreads();                     // and every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_tile(next % kStages, next * BK);
    __pipeline_commit();
    const bf16* a = stages + (kt % kStages) * kStageElems;
    const bf16* b = a + BM * LDA_S;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[4];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 64 + i * 16) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * LDB_S + wn * 32 + j * 16, LDB_S);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the operand stages are free for the epilogue staging

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s_c + (wm * 64 + i * 16) * LDC_S + wn * 32 + j * 16, acc[i][j],
                              LDC_S, wmma::mem_row_major);
  __syncthreads();

  // Four consecutive columns a thread (N is a multiple of 64, so a group is
  // wholly inside or outside the matrix): 16-byte f32 and 8-byte bf16 I/O.
  for (int e = tid; e < BM * BN / 4; e += kGemmThreads) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= g.M || gc >= g.N) continue;
    const size_t idx = (size_t)gr * g.N + gc;
    float4 v = *reinterpret_cast<const float4*>(s_c + r * LDC_S + c);
    const float4 bias = *reinterpret_cast<const float4*>(g.bias + gc);
    v.x += bias.x;
    v.y += bias.y;
    v.z += bias.z;
    v.w += bias.w;
    float4 o;
    if (EPI == kInit) {
      const float4 cx =
          *reinterpret_cast<const float4*>(g.ctx + (size_t)(gr / g.rows_per_image) * g.N + gc);
      o = make_float4(v.x + cx.x, v.y + cx.y, v.z + cx.z, v.w + cx.w);
      *reinterpret_cast<float4*>(g.temps + idx) = o;
      o = make_float4(fmaxf(o.x, 0.0f), fmaxf(o.y, 0.0f), fmaxf(o.z, 0.0f), fmaxf(o.w, 0.0f));
    } else if (EPI == kHidden) {
      o = make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f), fmaxf(v.w, 0.0f));
    } else {
      const float4 cx =
          *reinterpret_cast<const float4*>(g.ctx + (size_t)(gr / g.rows_per_image) * g.N + gc);
      const float4 t = *reinterpret_cast<const float4*>(g.temps + idx);
      o = make_float4(t.x + v.x * sigmoidf(cx.x), t.y + v.y * sigmoidf(cx.y),
                      t.z + v.z * sigmoidf(cx.z), t.w + v.w * sigmoidf(cx.w));
      if (g.relu_out) {
        *reinterpret_cast<float4*>(g.temps + idx) = o;
        o = make_float4(fmaxf(o.x, 0.0f), fmaxf(o.y, 0.0f), fmaxf(o.z, 0.0f),
                        fmaxf(o.w, 0.0f));
      }
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y), hi = __floats2bfloat162_rn(o.z, o.w);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(g.out16 + idx) = packed;
  }
}

struct CoupArgs {
  const bf16* a16;       // (M, H) bf16 temps after the last block
  const bf16* w_shift;   // (H, Dp)
  const float* b_shift;  // (Dp,)
  const bf16* w_scale;   // (H, Dp)
  const float* b_scale;  // (Dp,)
  const bf16* lu_inv_t;  // (Dp, Dp)
  const float* lu_bias;  // (Dp,)
  const float* an_shift; // (Dp,)
  const float* an_scale; // (Dp,) exp(-log_scale), 1 on the padding
  const float* mask;     // (Dp,) 1 on the transformed dims
  float* xs;             // (M, Dp) f32 state
  bf16* x16;             // (M, Dp) bf16 copy for the next layer's product
  float* ld;             // (M,) log-det, accumulated
  float* x_out;          // (M, D) on the last layer, else null
  int M, D, Dp, H;
};

size_t coupling_smem(int Dp, int H) {
  return sizeof(bf16) * ((size_t)CR * H + (size_t)CR * Dp) +
         sizeof(float) * (3 * (size_t)CR * Dp);
}

__global__ void __launch_bounds__(kCoupThreads) glow_coupling(CoupArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = p.Dp, H = p.H;
  const int r0 = blockIdx.x * CR;
  const int tid = threadIdx.x, warp = tid / 32;
  // Regions, each a multiple of 32 bytes long (Dp % 16 == 0, H % 64 == 0).
  bf16* s_a = reinterpret_cast<bf16*>(smem);          // (CR, H)
  float* s_o = reinterpret_cast<float*>(s_a + CR * H); // (2, CR, Dp) shift | scale products
  float* s_x = s_o + 2 * CR * Dp;                     // (CR, Dp) state
  bf16* s_y = reinterpret_cast<bf16*>(s_x + CR * Dp); // (CR, Dp) LU operand

  const int vec_h = H / 8;  // 16-byte chunks of a bf16 row
  for (int c = tid; c < CR * vec_h; c += kCoupThreads) {
    const int r = c / vec_h, k = (c % vec_h) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < p.M) v = *reinterpret_cast<const uint4*>(p.a16 + (size_t)(r0 + r) * H + k);
    *reinterpret_cast<uint4*>(s_a + r * H + k) = v;
  }
  for (int e = tid; e < CR * Dp; e += kCoupThreads) {
    const int r = e / Dp, d = e % Dp;
    s_x[e] = r0 + r < p.M ? p.xs[(size_t)(r0 + r) * Dp + d] : 0.0f;
  }
  __syncthreads();

  // shift and unconstrained-scale products: 2 x Dp/16 column tiles.
  const int ct = Dp / 16;
  for (int t = warp; t < 2 * ct; t += kCoupThreads / 32) {
    const bf16* w = (t < ct ? p.w_shift : p.w_scale) + (t % ct) * 16;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
    for (int k = 0; k < H; k += 32) {  // H % 64 == 0: two fragments in flight
      FragA fa0, fa1;
      FragB fb0, fb1;
      wmma::load_matrix_sync(fb0, w + (size_t)k * Dp, Dp);
      wmma::load_matrix_sync(fb1, w + (size_t)(k + 16) * Dp, Dp);
      wmma::load_matrix_sync(fa0, s_a + k, H);
      wmma::load_matrix_sync(fa1, s_a + k + 16, H);
      wmma::mma_sync(acc, fa0, fb0, acc);
      wmma::mma_sync(acc, fa1, fb1, acc);
    }
    wmma::store_matrix_sync(s_o + (t / ct) * CR * Dp + (t % ct) * 16, acc, Dp,
                            wmma::mem_row_major);
  }
  __syncthreads();

  for (int e = tid; e < CR * Dp; e += kCoupThreads) {
    const int d = e % Dp;
    const float m = p.mask[d];
    const float shift = s_o[e] + p.b_shift[d];
    const float scale = m > 0.0f ? sigmoidf(s_o[CR * Dp + e] + p.b_scale[d] + 2.0f) + 1e-3f : 1.0f;
    const float xv = (s_x[e] - shift * m) / scale;
    s_o[CR * Dp + e] = logf(scale);
    s_y[e] = __float2bfloat16(xv - p.lu_bias[d]);
  }
  __syncthreads();
  if (tid < CR && r0 + tid < p.M) {
    float acc = 0.0f;
    for (int d = 0; d < Dp; ++d) acc += s_o[CR * Dp + tid * Dp + d];
    p.ld[r0 + tid] += acc;
  }

  // x LU^-T: Dp/16 column tiles over the Dp-deep product, into s_o's first half.
  for (int t = warp; t < ct; t += kCoupThreads / 32) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < Dp; k += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, s_y + k, Dp);
      wmma::load_matrix_sync(fb, p.lu_inv_t + (size_t)k * Dp + t * 16, Dp);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(s_o + t * 16, acc, Dp, wmma::mem_row_major);
  }
  __syncthreads();

  for (int e = tid; e < CR * Dp; e += kCoupThreads) {
    const int r = e / Dp, d = e % Dp, row = r0 + r;
    if (row >= p.M) continue;
    const float xv = (s_o[e] - p.an_shift[d]) * p.an_scale[d];
    if (p.x_out != nullptr) {
      if (d < p.D) p.x_out[(size_t)row * p.D + d] = xv;
    } else {
      p.xs[(size_t)row * Dp + d] = xv;
      p.x16[(size_t)row * Dp + d] = __float2bfloat16(xv);
    }
  }
}

__global__ void glow_init(const float* z0, float* xs, bf16* x16, float* ld, int M, int D,
                          int Dp) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)M * Dp) return;
  const size_t row = e / Dp;
  const int d = (int)(e % Dp);
  const float v = d < D ? z0[row * D + d] : 0.0f;
  xs[e] = v;
  x16[e] = __float2bfloat16(v);
  if (d == 0) ld[row] = 0.0f;
}

template <int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      glow_gemm<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  glow_gemm<EPI><<<grid, kGemmThreads, kGemmSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mhent_glow_sample(
    const void* z0, const void* ctx, const void* big, const void* b_big, const void* w_in,
    const void* b_in, const void* w_shift, const void* b_shift, const void* w_scale,
    const void* b_scale, const void* lu_inv_t, const void* lu_bias, const void* an_shift,
    const void* an_scale, const void* mask, void* x_out, void* logdet, void* xs, void* x16,
    void* temps, void* a16, void* t16, int B, int N, int D, int Dp, int H, int L,
    void* stream) {
  if (B < 1 || N < 1 || D < 1 || Dp < D || Dp % 16 || Dp > kMaxDp || H < 64 || H % 64 ||
      L < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const size_t csmem = coupling_smem(Dp, H);
  cudaError_t err = cudaFuncSetAttribute(
      glow_coupling, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
  if (err != cudaSuccess) return (int)err;

  const size_t n_state = (size_t)M * Dp;
  glow_init<<<(unsigned)((n_state + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(z0), static_cast<float*>(xs), static_cast<bf16*>(x16),
      static_cast<float*>(logdet), M, D, Dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const bf16* bigw = static_cast<const bf16*>(big);
  const float* bigb = static_cast<const float*>(b_big);
  const float* c = static_cast<const float*>(ctx);
  const size_t hh = (size_t)H * H, ctx_stage = (size_t)B * H;
  for (int l = 0; l < L; ++l) {
    GemmArgs g;
    g.temps = static_cast<float*>(temps);
    g.M = M;
    g.N = H;
    g.rows_per_image = N;
    g.relu_out = 1;
    // initial layer: x16 W_in (+ b_in + the image's context slice)
    g.a = static_cast<const bf16*>(x16);
    g.w = static_cast<const bf16*>(w_in) + (size_t)l * Dp * H;
    g.bias = static_cast<const float*>(b_in) + (size_t)l * H;
    g.ctx = c + (size_t)(l * 3 + 0) * ctx_stage;
    g.out16 = static_cast<bf16*>(a16);
    g.K = Dp;
    if ((err = launch_gemm<kInit>(g, st)) != cudaSuccess) return (int)err;
    g.K = H;
    for (int blk = 0; blk < 2; ++blk) {
      g.a = static_cast<const bf16*>(a16);
      g.w = bigw + (size_t)(l * 4 + 2 * blk) * hh;
      g.bias = bigb + (size_t)(l * 4 + 2 * blk) * H;
      g.ctx = nullptr;
      g.out16 = static_cast<bf16*>(t16);
      if ((err = launch_gemm<kHidden>(g, st)) != cudaSuccess) return (int)err;
      g.a = static_cast<const bf16*>(t16);
      g.w = bigw + (size_t)(l * 4 + 2 * blk + 1) * hh;
      g.bias = bigb + (size_t)(l * 4 + 2 * blk + 1) * H;
      g.ctx = c + (size_t)(l * 3 + 1 + blk) * ctx_stage;
      g.out16 = static_cast<bf16*>(a16);
      g.relu_out = blk == 0;
      if ((err = launch_gemm<kGate>(g, st)) != cudaSuccess) return (int)err;
    }
    CoupArgs p;
    p.a16 = static_cast<const bf16*>(a16);
    p.w_shift = static_cast<const bf16*>(w_shift) + (size_t)l * H * Dp;
    p.b_shift = static_cast<const float*>(b_shift) + (size_t)l * Dp;
    p.w_scale = static_cast<const bf16*>(w_scale) + (size_t)l * H * Dp;
    p.b_scale = static_cast<const float*>(b_scale) + (size_t)l * Dp;
    p.lu_inv_t = static_cast<const bf16*>(lu_inv_t) + (size_t)l * Dp * Dp;
    p.lu_bias = static_cast<const float*>(lu_bias) + (size_t)l * Dp;
    p.an_shift = static_cast<const float*>(an_shift) + (size_t)l * Dp;
    p.an_scale = static_cast<const float*>(an_scale) + (size_t)l * Dp;
    p.mask = static_cast<const float*>(mask) + (size_t)l * Dp;
    p.xs = static_cast<float*>(xs);
    p.x16 = static_cast<bf16*>(x16);
    p.ld = static_cast<float*>(logdet);
    p.x_out = l == L - 1 ? static_cast<float*>(x_out) : nullptr;
    p.M = M;
    p.D = D;
    p.Dp = Dp;
    p.H = H;
    glow_coupling<<<(M + CR - 1) / CR, kCoupThreads, csmem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
