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
// take 0.011 ms at 3.35 TB/s. So the shape is bound by operations, and the
// products must run on wgmma, the only way to that peak.
//
// Design: one launch per stage over all rows, the (rows, H) state in device
// memory (13 MB f32 temps and two 6.5 MB bf16 operand copies at the ProHMR
// shape, mostly in L2), written and read once per stage; a layer is six
// launches from one C call, after glow_init (x, the log-det) and glow_gates
// (sigmoid of every image's two gate projections, once an image):
//
//   glow_gemm<kInit>    x16 W_in   -> temps, a16 = bf16(relu(temps))
//   glow_gemm<kHidden>  a16 W_00   -> t16 = bf16(relu(t))
//   glow_gemm<kGate>    t16 W_01   -> temps +=, a16 = bf16(relu(temps))
//   glow_gemm<kHidden>  a16 W_10   -> t16
//   glow_gemm<kGate>    t16 W_11   -> a16 = bf16(temps)   (the last block)
//   glow_coupling<NCH>  a16 [W_s | W_c], the affine step, x LU^-T, actnorm
//                       -> x (f32), x16 = bf16(x) for the next layer
//
// glow_gemm: a warp-specialised TMA + wgmma GEMM on 64 x 128 output tiles.
// A CTA is two consumer warpgroups (64 x 64 each, side by side) and one
// producer warp: 288 threads, 97 KB of shared memory, two CTAs an SM. The
// producer's lane 0 keeps a ring of four stages in flight, each the tile's
// 64 x 64 slice of the activations and 128 x 64 slice of the weights in
// their K-major copy (cuda_glow_sampler.pack's big_t / w_in_t: (out, in)),
// both loaded by TMA with the 128-byte swizzle and completing on the
// stage's full mbarrier; the consumers release a stage on its empty
// mbarrier once the wgmma that read it has retired (one wgmma group stays
// in flight). Each warpgroup issues wgmma.mma_async m64n64k16 bf16 -> f32
// straight from the swizzled shared memory, four a stage. The CTAs are
// persistent (grid = min(tiles, 2 x SMs)) and walk the tiles, so the
// producer loads the next tile while the consumers run the epilogue, and
// the SM's other CTA keeps the tensor cores busy meanwhile. The epilogue
// runs from the registers: one shuffle gives each thread four consecutive
// f32 columns (16-byte bias, context or gate, and temps I/O, sixteen
// columns' loads in flight at once), a second one eight consecutive bf16
// columns (16-byte operand stores). At the ProHMR shape that is 400 tiles
// on 264 CTAs, at the MHEnt Glow shape (1,600 rows, H = 512) 100 tiles on
// 100. Ragged rows and the init product's K = Dp < 64 come from TMA's zero
// fill past the tensor's edge; columns past N (H not a multiple of 128) are
// computed from the next matrix's rows and never stored.
//
// glow_coupling: 64 rows a CTA on the same skeleton: each stage holds the
// rows' 64-deep slice of a16 and of [W_s | W_c]^T (w_ss_t: (2 Dp, H)), so
// the shift | scale weights stream through shared memory once a CTA (50
// CTAs at the ProHMR shape). The 2 Dp columns go to the two warpgroups in
// NCH = ceil(Dp / 32) m64n32 chunks each, issued unconditionally (the last
// may read 32 rows past the stage and is dropped). The accumulators then
// go to shared memory (reusing the ring) beside the layer's six parameter
// vectors, where the affine step and the log-det (four threads a row, x's
// loads all in flight), the (Dp x Dp) LU product (WMMA, four row tiles as
// independent chains, LU^-T's column slices copied to shared memory) and
// the actnorm run.
//
// The rows are image-major (b * N + n), so a row's image is row / N. D is
// padded to Dp (a multiple of 16, at most 256) with zero weights, mask 0
// and actnorm scale 1: the padding stays exactly zero and adds nothing to
// the log-det. H must be a multiple of 64 (the 64-deep stages and the
// 64-column epilogue groups). Any row count.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

#include "hopper_tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;                       // K a stage: one 128-byte swizzle row of bf16
constexpr int kRowBytes = BK * 2;            // 128
constexpr int kStages = 4;                   // GEMM ring depth
constexpr int kConsumerThreads = 256;        // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int CR = 64;                       // rows a coupling CTA (one wgmma M)
constexpr int kMaxDp = 256;
constexpr size_t kMaxSmem = 227 * 1024;

enum Epilogue { kInit = 0, kHidden = 1, kGate = 2 };

// D (64 x N f32, the warpgroup's accumulator fragment) += A B, A and B
// K-major bf16 in shared memory (descriptors), one 16-deep step.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f), fmaxf(v.w, 0.0f));
}

__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 out;
  out.x = *reinterpret_cast<unsigned*>(&lo);
  out.y = *reinterpret_cast<unsigned*>(&hi);
  return out;
}

struct GemmArgs {
  const float* bias;  // (N,)
  const float* ctx;   // (images, N): kInit's context projections, kGate's gates, or null
  float* temps;       // (M, N) f32 residual stream
  bf16* out16;        // (M, N) the next product's operand
  int M, N, K;
  int w_row0;         // the weight matrix's first row in the K-major weight map
  int rows_per_image;
  int relu_out;       // kGate: out16 = relu(temps) (1) or temps (0)
};

// The GEMM's tile: 64 rows x 128 columns, the two consumer warpgroups side
// by side (64 x 64 each). 97 KB of shared memory and 64 accumulators a
// thread, so two CTAs share an SM and one's epilogue overlaps the other's
// products. (128 x 128 and 64 x 256 tiles, one CTA an SM, ran 2-3 % slower
// at the ProHMR shape and 19-20 % at the MHEnt Glow shape on an H100.)
constexpr int BM = 64, BN = 128, WN = 64;
constexpr int kCtasPerSm = 2;
constexpr int A_BYTES = BM * kRowBytes, B_BYTES = BN * kRowBytes;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr size_t kGemmSmem = (size_t)kStages * STAGE_BYTES + 2 * kStages * 8 + 1024;

// The epilogue's operands of one float4 (four columns of a row): the bias,
// the row's image's context slice (kInit) or gate (kGate: the sigmoid of
// its context slice, computed once an image by glow_gates) and the
// residual stream (kGate). Loaded for a group of chunks before any of the
// group's stores, so that a thread has a dozen 16-byte loads in flight.
struct EpiIn {
  float4 bias, cx, t;
};

template <int EPI>
__device__ __forceinline__ EpiIn epilogue_load(const GemmArgs& g, int gr, int gc, bool ok) {
  EpiIn in;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  in.bias = ok ? __ldg(reinterpret_cast<const float4*>(g.bias + gc)) : zero;
  in.cx = EPI != kHidden && ok ? __ldg(reinterpret_cast<const float4*>(
                                     g.ctx + (size_t)(gr / g.rows_per_image) * g.N + gc))
                               : zero;
  in.t = EPI == kGate && ok ? *reinterpret_cast<const float4*>(g.temps + (size_t)gr * g.N + gc)
                            : zero;
  return in;
}

template <int EPI>
__device__ __forceinline__ float4 epilogue_apply(const GemmArgs& g, float4 v, const EpiIn& in,
                                                 size_t idx, bool ok) {
  v = make_float4(v.x + in.bias.x, v.y + in.bias.y, v.z + in.bias.z, v.w + in.bias.w);
  if (EPI == kHidden) return relu4(v);
  float4 o;
  if (EPI == kInit) {
    o = make_float4(v.x + in.cx.x, v.y + in.cx.y, v.z + in.cx.z, v.w + in.cx.w);
    if (ok) *reinterpret_cast<float4*>(g.temps + idx) = o;
    return relu4(o);
  }
  o = make_float4(fmaf(v.x, in.cx.x, in.t.x), fmaf(v.y, in.cx.y, in.t.y),
                  fmaf(v.z, in.cx.z, in.t.z), fmaf(v.w, in.cx.w, in.t.w));
  if (!g.relu_out) return o;
  if (ok) *reinterpret_cast<float4*>(g.temps + idx) = o;
  return relu4(o);
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    glow_gemm(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
              const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1,024 bytes: align the ring to that.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * STAGE_BYTES, empty = full + kStages * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = (g.M + BM - 1) / BM, tiles_n = (g.N + BN - 1) / BN;
  const int n_tiles = tiles_m * tiles_n, ktiles = (g.K + BK - 1) / BK;

  if (warp == kConsumerThreads / 32) {  // producer
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t a = ring + stage * STAGE_BYTES, bar = full + 8 * stage;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(a, &tm_a, kt * BK, m0, bar);
          tma_load(a + A_BYTES, &tm_w, kt * BK, g.w_row0 + n0, bar);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wn owns the tile's columns [wn * WN, +WN).
  const int wn = warp / 4;
  const uint32_t b_off = A_BYTES + wn * WN * kRowBytes;
  // After the first shuffle a thread holds row `row_e` of its warp's 16,
  // columns [c8 + col_q, +4) of each 8-column chunk c8.
  const bool odd = lane & 1;
  const int row_e = (warp % 4) * 16 + lane / 4 + (odd ? 8 : 0);
  const int hq = (lane & 3) >> 1, col_q = 4 * hq;
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
    fence_regs<WN / 2>(acc);
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t base = ring + stage * STAGE_BYTES;
      const uint64_t da = sw128_desc(base), db = sw128_desc(base + b_off);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_bf16<WN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group has retired
      if (prev >= 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs<WN / 2>(acc);
    if (prev >= 0) mbar_arrive(empty + 8 * prev);

    const int gr = m0 + row_e;
    const int col0 = n0 + wn * WN;
    const bool row_ok = gr < g.M;
    constexpr int kG = 4;  // chunks a group: their loads are in flight together
#pragma unroll
    for (int c0 = 0; c0 < WN / 8; c0 += kG) {  // kG 8-column chunks a group
      float4 v[kG];
      int gc[kG];
#pragma unroll
      for (int h = 0; h < kG; ++h) {
        const float* d = acc + 4 * (c0 + h);
        // Even lanes keep row r's pair and take the odd partner's (columns
        // +2, +3); odd lanes keep row r + 8's and take the even partner's.
        const float s0 = odd ? d[0] : d[2], s1 = odd ? d[1] : d[3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        v[h] = odd ? make_float4(r0, r1, d[2], d[3]) : make_float4(d[0], d[1], r0, r1);
        gc[h] = col0 + 8 * (c0 + h) + col_q;
      }
      EpiIn in[kG];
#pragma unroll
      for (int h = 0; h < kG; ++h) in[h] = epilogue_load<EPI>(g, gr, gc[h], row_ok && gc[h] < g.N);
      uint2 pk[kG];
#pragma unroll
      for (int h = 0; h < kG; ++h)
        pk[h] = pack_bf16x4(epilogue_apply<EPI>(g, v[h], in[h], (size_t)gr * g.N + gc[h],
                                                row_ok && gc[h] < g.N));
      // Lanes l and l ^ 2 hold the two halves of chunks c and c + 1 of one
      // row: swap so that each holds a whole chunk (8 bf16, 16 bytes).
#pragma unroll
      for (int h = 0; h < kG; h += 2) {
        const uint2 send = hq ? pk[h] : pk[h + 1];
        uint2 recv;
        recv.x = __shfl_xor_sync(0xffffffffu, send.x, 2);
        recv.y = __shfl_xor_sync(0xffffffffu, send.y, 2);
        const uint4 o = hq ? make_uint4(recv.x, recv.y, pk[h + 1].x, pk[h + 1].y)
                           : make_uint4(pk[h].x, pk[h].y, recv.x, recv.y);
        const int col = col0 + 8 * (c0 + h + hq);
        if (row_ok && col < g.N) *reinterpret_cast<uint4*>(g.out16 + (size_t)gr * g.N + col) = o;
      }
    }
  }
}

struct CoupArgs {
  const float* b_shift;  // (Dp,)
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
  int w_row0;            // this layer's first row in the [W_s | W_c]^T map
  int stages;            // ring depth
};

// The coupling CTA's shared memory: the ring (stage = 64 a16 rows and 2 Dp
// weight rows, 128 bytes each) and 32 rows past it (the last chunk of
// warpgroup 1 may read up to 32 rows past the stage; their columns are never
// stored), reused after the product by the f32 shift and scale products
// (64 x (Dp + 8) each), the LU operand (64 x (Dp + 8) bf16) and the six
// parameter vectors.
constexpr int kOverrun = 32 * kRowBytes;
__host__ __device__ size_t coupling_stage_bytes(int Dp) {
  return (size_t)(CR + 2 * Dp) * kRowBytes;
}
__host__ __device__ size_t coupling_epilogue_bytes(int Dp) {
  return (2 * sizeof(float) + sizeof(bf16)) * CR * ((size_t)Dp + 8) + sizeof(float) * 6 * Dp;
}
__host__ __device__ size_t coupling_body_bytes(int Dp, int stages) {
  const size_t ring = (size_t)stages * coupling_stage_bytes(Dp) + kOverrun;
  return ring > coupling_epilogue_bytes(Dp) ? ring : coupling_epilogue_bytes(Dp);
}
size_t coupling_smem(int Dp, int stages) {
  return coupling_body_bytes(Dp, stages) + 2 * kStages * 8 + 1024;
}
int coupling_stages(int Dp) {
  for (int s = kStages; s >= 2; --s)
    if (coupling_smem(Dp, s) <= kMaxSmem) return s;
  return 0;
}

// NCH: m64n32 chunks a warpgroup, ceil(Dp / 32): both warpgroups issue
// NCH unconditionally (a predicated wgmma would serialise the pipeline).
template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
    glow_coupling(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_w, const CoupArgs p) {
  using namespace nvcuda;
  extern __shared__ unsigned char smem_raw[];
  const int Dp = p.Dp, H = p.H, stages = p.stages;
  const uint32_t stage_bytes = (uint32_t)coupling_stage_bytes(Dp);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* body = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const uint32_t full = ring + (uint32_t)coupling_body_bytes(Dp, stages);
  const uint32_t empty = full + kStages * 8;
  const int r0 = blockIdx.x * CR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ktiles = H / BK;

  if (warp == kConsumerThreads / 32) {  // producer
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t a = ring + stage * stage_bytes, bar = full + 8 * stage;
        mbar_expect_tx(bar, stage_bytes);
        tma_load(a, &tm_a, kt * BK, r0, bar);
        tma_load(a + CR * kRowBytes, &tm_w, kt * BK, p.w_row0, bar);
        tma_load(a + (CR + Dp) * kRowBytes, &tm_w, kt * BK, p.w_row0 + Dp, bar);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The 2 Dp product columns in m64n32 chunks: warpgroup w takes chunks
  // [w NCH, (w + 1) NCH); those past 2 Dp are computed and dropped.
  const int wg = warp / 4, n_chunks = Dp / 16, chunk0 = wg * NCH;
  float acc[NCH][16];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[c][i] = 0.0f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) fence_regs<16>(acc[c]);
  {
    int stage = 0, phase = 0, prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t base = ring + stage * stage_bytes;
      const uint64_t da = sw128_desc(base);
      const uint64_t db = sw128_desc(base + (CR + 32 * chunk0) * kRowBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NCH; ++c)  // a chunk is 32 rows of 128 bytes: +256 in the address
          wgmma_bf16<32>(acc[c], da + 2 * kk, db + 256 * c + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs<16>(acc[c]);
  }
  named_sync(1, kConsumerThreads);  // every wgmma has read its stages: the ring is free

  // After the product the ring holds: the shift and scale planes (f32,
  // CR x SP each), the LU operand (bf16, CR x SP) and the layer's six
  // (Dp,) parameter vectors, copied once so that the element loops read
  // shared memory, not a chain of L2 round trips.
  const int SP = Dp + 8;  // row pitch of every plane (floats or bf16)
  float* s_sh = reinterpret_cast<float*>(body);             // (CR, SP) shift products
  float* s_sc = s_sh + (size_t)CR * SP;                     // (CR, SP) scale products
  bf16* s_y = reinterpret_cast<bf16*>(s_sc + (size_t)CR * SP);  // (CR, SP) LU operand
  float* s_par = reinterpret_cast<float*>(s_y + (size_t)CR * SP);  // (6, Dp)
  {
    const int row = (warp % 4) * 16 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (chunk0 + c >= n_chunks) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cc = 32 * (chunk0 + c) + 8 * i + col;  // < 2 Dp: shift, then scale
        float* plane = cc < Dp ? s_sh + cc : s_sc + (cc - Dp);
        *reinterpret_cast<float2*>(plane + row * SP) =
            make_float2(acc[c][4 * i], acc[c][4 * i + 1]);
        *reinterpret_cast<float2*>(plane + (row + 8) * SP) =
            make_float2(acc[c][4 * i + 2], acc[c][4 * i + 3]);
      }
    }
    const float* par[6] = {p.mask, p.b_shift, p.b_scale, p.lu_bias, p.an_shift, p.an_scale};
    for (int e = tid; e < 6 * Dp; e += kConsumerThreads) s_par[e] = __ldg(par[e / Dp] + e % Dp);
  }
  const float *s_mask = s_par, *s_bsh = s_par + Dp, *s_bsc = s_par + 2 * Dp,
              *s_lub = s_par + 3 * Dp, *s_ans = s_par + 4 * Dp, *s_anc = s_par + 5 * Dp;

  // x LU^-T (below) goes into the shift plane: warp w owns column tiles w,
  // w + 8, ... of the Dp / 16. It copies LU^-T's (Dp x 16) column slice
  // (16-byte loads: the first tile's in flight during the affine step, the
  // next one's during this one's products) into its Dp x 16 piece of the
  // scale plane once the affine step is done with it, and runs the four row
  // tiles as four independent WMMA chains from there and the LU operand.
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  const int ct = Dp / 16;
  bf16* slice = reinterpret_cast<bf16*>(s_sc) + (size_t)warp * Dp * 16;
  uint4 v[2 * NCH];  // LU^-T rows 16 j + lane / 2, half lane % 2 (Dp <= 32 NCH)
  auto load_slice = [&](int tc) {
#pragma unroll
    for (int j = 0; j < 2 * NCH; ++j)
      if (j < ct)
        v[j] = *reinterpret_cast<const uint4*>(p.lu_inv_t + (size_t)(16 * j + lane / 2) * Dp +
                                               tc * 16 + 8 * (lane % 2));
  };
  if (warp < ct) load_slice(warp);

  // The affine step and the log-det: thread t owns row t / 4 and the
  // 4-column groups d4 = t % 4, + 4, ... (Dp / 16 of them), its x loads all
  // in flight at once; the row's four threads sum their log scales.
  const int row = tid / 4, part = tid % 4, grow = r0 + row, n4 = Dp / 16;
  const bool row_ok = grow < p.M;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  {
    float4 x4[2 * NCH];
#pragma unroll
    for (int i = 0; i < 2 * NCH; ++i)
      if (i < n4)
        x4[i] = row_ok ? *reinterpret_cast<const float4*>(p.xs + (size_t)grow * Dp +
                                                          4 * (part + 4 * i))
                       : zero4;
    named_sync(1, kConsumerThreads);  // the planes and parameters are in place
    float ld_part = 0.0f;
#pragma unroll
    for (int i = 0; i < 2 * NCH; ++i) {
      if (i >= n4) break;
      const int d = 4 * (part + 4 * i);
      const float4 m = *reinterpret_cast<const float4*>(s_mask + d);
      const float4 bs = *reinterpret_cast<const float4*>(s_bsh + d);
      const float4 bc = *reinterpret_cast<const float4*>(s_bsc + d);
      const float4 lb = *reinterpret_cast<const float4*>(s_lub + d);
      const float4 sh = *reinterpret_cast<const float4*>(s_sh + row * SP + d);
      const float4 sc = *reinterpret_cast<const float4*>(s_sc + row * SP + d);
      const float mv[4] = {m.x, m.y, m.z, m.w}, bsv[4] = {bs.x, bs.y, bs.z, bs.w};
      const float bcv[4] = {bc.x, bc.y, bc.z, bc.w}, lbv[4] = {lb.x, lb.y, lb.z, lb.w};
      const float shv[4] = {sh.x, sh.y, sh.z, sh.w}, scv[4] = {sc.x, sc.y, sc.z, sc.w};
      const float xv[4] = {x4[i].x, x4[i].y, x4[i].z, x4[i].w};
      float y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float shift = shv[c] + bsv[c];
        const float scale = mv[c] > 0.0f ? sigmoidf(scv[c] + bcv[c] + 2.0f) + 1e-3f : 1.0f;
        ld_part += logf(scale);
        y[c] = (xv[c] - shift * mv[c]) / scale - lbv[c];
      }
      *reinterpret_cast<uint2*>(s_y + row * SP + d) =
          pack_bf16x4(make_float4(y[0], y[1], y[2], y[3]));
    }
    ld_part += __shfl_xor_sync(0xffffffffu, ld_part, 1);
    ld_part += __shfl_xor_sync(0xffffffffu, ld_part, 2);
    if (part == 0 && row_ok) p.ld[grow] += ld_part;
  }
  named_sync(1, kConsumerThreads);

  for (int tc = warp; tc < ct; tc += kConsumerThreads / 32) {
#pragma unroll
    for (int j = 0; j < 2 * NCH; ++j)
      if (j < ct)
        *reinterpret_cast<uint4*>(slice + (16 * j + lane / 2) * 16 + 8 * (lane % 2)) = v[j];
    __syncwarp();
    if (tc + kConsumerThreads / 32 < ct) load_slice(tc + kConsumerThreads / 32);
    FragC f[CR / 16];
#pragma unroll
    for (int tr = 0; tr < CR / 16; ++tr) wmma::fill_fragment(f[tr], 0.0f);
    for (int k = 0; k < ct; ++k) {
      FragB fb;
      wmma::load_matrix_sync(fb, slice + k * 16 * 16, 16);
#pragma unroll
      for (int tr = 0; tr < CR / 16; ++tr) {
        FragA fa;
        wmma::load_matrix_sync(fa, s_y + tr * 16 * SP + k * 16, SP);
        wmma::mma_sync(f[tr], fa, fb, f[tr]);
      }
    }
#pragma unroll
    for (int tr = 0; tr < CR / 16; ++tr)
      wmma::store_matrix_sync(s_sh + tr * 16 * SP + tc * 16, f[tr], SP, wmma::mem_row_major);
    __syncwarp();  // the slice is read before the next column tile's copy
  }
  named_sync(1, kConsumerThreads);

  // The actnorm, and the state (or x) out: the same (row, 4-column) groups.
#pragma unroll
  for (int i = 0; i < 2 * NCH; ++i) {
    if (i >= n4 || !row_ok) break;
    const int d = 4 * (part + 4 * i);
    const float4 o = *reinterpret_cast<const float4*>(s_sh + row * SP + d);
    const float4 as = *reinterpret_cast<const float4*>(s_ans + d);
    const float4 ac = *reinterpret_cast<const float4*>(s_anc + d);
    const float4 v = make_float4((o.x - as.x) * ac.x, (o.y - as.y) * ac.y, (o.z - as.z) * ac.z,
                                 (o.w - as.w) * ac.w);
    if (p.x_out != nullptr) {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d + c < p.D) p.x_out[(size_t)grow * p.D + d + c] = vv[c];
    } else {
      *reinterpret_cast<float4*>(p.xs + (size_t)grow * Dp + d) = v;
      *reinterpret_cast<uint2*>(p.x16 + (size_t)grow * Dp + d) = pack_bf16x4(v);
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

// gates[l][k] = sigmoid(ctx[l][1 + k]) for the two blocks of every layer:
// each image's gate once, not once a row.
__global__ void glow_gates(const float* ctx, float* gates, int BH, int L) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)L * 2 * BH) return;
  const size_t l = e / (2 * (size_t)BH), rest = e % (2 * (size_t)BH);
  gates[e] = sigmoidf(ctx[(l * 3 + 1) * BH + rest]);
}

// A 2D map of a row-major (rows, cols) bf16 tensor, boxes of 64 columns by
// `box_rows` rows, 128-byte swizzle, zeros past the edges.
bool make_map(CUtensorMap* map, const void* base, int cols, int rows, int box_rows) {
  return make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), base, cols, rows, BK,
                     box_rows);
}

// The maps of the three activation buffers and the two weight stacks.
struct GemmMaps {
  CUtensorMap x16, a16, t16, w_in, big;
};

template <int EPI>
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& w, const GemmArgs& g, int grid,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      glow_gemm<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  glow_gemm<EPI><<<grid, kThreads, kGemmSmem, stream>>>(a, w, g);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t launch_coupling(const CUtensorMap& a, const CUtensorMap& w, const CoupArgs& p,
                            int grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      glow_coupling<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  glow_coupling<NCH><<<grid, kThreads, smem, stream>>>(a, w, p);
  return cudaGetLastError();
}

struct Call {
  const float* ctx;
  const float* gates;
  const float* b_in;
  const float* b_big;
  float* temps;
  bf16 *a16, *t16;
  int M, N, Dp, H, B, grid;
  cudaStream_t stream;
};

// One layer's five products, on persistent CTAs: two an SM, or one a tile.
cudaError_t layer_gemms(const Call& c, const GemmMaps& m, int l) {
  const int tiles = ((c.M + BM - 1) / BM) * ((c.H + BN - 1) / BN);
  const int grid = c.grid < tiles ? c.grid : tiles;
  const size_t ctx_stage = (size_t)c.B * c.H;
  GemmArgs g;
  g.temps = c.temps;
  g.M = c.M;
  g.N = c.H;
  g.rows_per_image = c.N;
  g.relu_out = 1;
  // initial layer: x16 W_in (+ b_in + the image's context slice)
  g.bias = c.b_in + (size_t)l * c.H;
  g.ctx = c.ctx + (size_t)(l * 3 + 0) * ctx_stage;
  g.out16 = c.a16;
  g.K = c.Dp;
  g.w_row0 = l * c.H;
  cudaError_t err = launch_gemm<kInit>(m.x16, m.w_in, g, grid, c.stream);
  if (err != cudaSuccess) return err;
  g.K = c.H;
  for (int blk = 0; blk < 2; ++blk) {
    const int i0 = l * 4 + 2 * blk;
    g.bias = c.b_big + (size_t)i0 * c.H;
    g.ctx = nullptr;
    g.out16 = c.t16;
    g.w_row0 = i0 * c.H;
    if ((err = launch_gemm<kHidden>(m.a16, m.big, g, grid, c.stream)) != cudaSuccess)
      return err;
    g.bias = c.b_big + (size_t)(i0 + 1) * c.H;
    g.ctx = c.gates + (size_t)(l * 2 + blk) * ctx_stage;
    g.out16 = c.a16;
    g.w_row0 = (i0 + 1) * c.H;
    g.relu_out = blk == 0;
    if ((err = launch_gemm<kGate>(m.t16, m.big, g, grid, c.stream)) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int mhent_glow_sample(
    const void* z0, const void* ctx, const void* big_t, const void* b_big, const void* w_in_t,
    const void* b_in, const void* w_ss_t, const void* b_shift, const void* b_scale,
    const void* lu_inv_t, const void* lu_bias, const void* an_shift, const void* an_scale,
    const void* mask, void* x_out, void* logdet, void* xs, void* x16, void* temps, void* a16,
    void* t16, void* gates, int B, int N, int D, int Dp, int H, int L, void* stream) {
  if (B < 1 || N < 1 || D < 1 || Dp < D || Dp % 16 || Dp > kMaxDp || H < 64 || H % 64 ||
      L < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const int stages = coupling_stages(Dp);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t csmem = coupling_smem(Dp, stages);
  cudaError_t err;

  GemmMaps m;
  CUtensorMap ca, cw;
  if (!make_map(&m.x16, x16, Dp, M, BM) || !make_map(&m.a16, a16, H, M, BM) ||
      !make_map(&m.t16, t16, H, M, BM) || !make_map(&m.w_in, w_in_t, Dp, L * H, BN) ||
      !make_map(&m.big, big_t, H, L * 4 * H, BN) || !make_map(&ca, a16, H, M, CR) ||
      !make_map(&cw, w_ss_t, H, L * 2 * Dp, Dp))
    return (int)cudaErrorInvalidValue;

  const size_t n_state = (size_t)M * Dp;
  glow_init<<<(unsigned)((n_state + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(z0), static_cast<float*>(xs), static_cast<bf16*>(x16),
      static_cast<float*>(logdet), M, D, Dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n_gates = (size_t)L * 2 * B * H;
  glow_gates<<<(unsigned)((n_gates + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ctx), static_cast<float*>(gates), B * H, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  Call c;
  c.ctx = static_cast<const float*>(ctx);
  c.gates = static_cast<const float*>(gates);
  c.b_in = static_cast<const float*>(b_in);
  c.b_big = static_cast<const float*>(b_big);
  c.temps = static_cast<float*>(temps);
  c.a16 = static_cast<bf16*>(a16);
  c.t16 = static_cast<bf16*>(t16);
  c.M = M;
  c.N = N;
  c.Dp = Dp;
  c.H = H;
  c.B = B;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  c.grid = kCtasPerSm * sms;
  c.stream = st;
  for (int l = 0; l < L; ++l) {
    if ((err = layer_gemms(c, m, l)) != cudaSuccess) return (int)err;

    CoupArgs p;
    p.b_shift = static_cast<const float*>(b_shift) + (size_t)l * Dp;
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
    p.w_row0 = l * 2 * Dp;
    p.stages = stages;
    const int grid_c = (M + CR - 1) / CR;
    switch ((Dp + 31) / 32) {
      case 1: err = launch_coupling<1>(ca, cw, p, grid_c, csmem, st); break;
      case 2: err = launch_coupling<2>(ca, cw, p, grid_c, csmem, st); break;
      case 3: err = launch_coupling<3>(ca, cw, p, grid_c, csmem, st); break;
      case 4: err = launch_coupling<4>(ca, cw, p, grid_c, csmem, st); break;
      case 5: err = launch_coupling<5>(ca, cw, p, grid_c, csmem, st); break;
      case 6: err = launch_coupling<6>(ca, cw, p, grid_c, csmem, st); break;
      case 7: err = launch_coupling<7>(ca, cw, p, grid_c, csmem, st); break;
      default: err = launch_coupling<8>(ca, cw, p, grid_c, csmem, st); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
