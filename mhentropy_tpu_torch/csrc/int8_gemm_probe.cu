// int8 vs bf16 GEMM probe for Hopper (sm_90a): the same hand-written
// tensor-core GEMM, (M, K) x (N, K)^T, as s8 x s8 -> s32 and as bf16 x bf16
// -> f32 sums rounded to bf16.
//
// Replaces tools/mosaic_int8_probe.py::make_kernels (:23; the Pallas
// kernels launched at :54), which asked the TPU whether its int8 matrix
// path beats bf16 at (32768, 640) x (640, 512). It asks the H100 the same
// question, with hand-written kernels on both sides.
//
// What bounds it on the H100: at that shape both sides do 21.5 G
// multiply-adds (10.9 us at the 1,979 TOP/s int8 peak, 21.7 us at 989
// TFLOP/s bf16), and both must move their operands and output: s8 reads
// 21 MB and writes a 67 MB s32 output (26.4 us at 3.35 TB/s), bf16 reads
// 42 MB and writes 34 MB (22.7 us). s8 is bound by the memory rate; bf16 by
// both at once, so its products must run near the tensor cores' peak while
// its bytes stream near the memory rate. What holds a tile back is the
// latency of x's slices, which come from device memory: the pipeline has to
// keep many of them in flight.
//
// Design (both types, one template):
// - Persistent, warp-specialised CTAs, one an SM, each walking 128 x 256
//   output tiles: two consumer warpgroups (64 rows each) and two producer
//   warps, 320 threads.
// - Each producer warp's lane 0 keeps its own ring of stages in flight,
//   128 bytes of K each (64 bf16 or 128 s8), loaded by TMA with the
//   128-byte swizzle from the operands as they lie in device memory
//   (K-major): one ring of the tile's 128-row slices of x (A_STAGES deep,
//   16 KB a stage), one of its 256-row slices of w (B_STAGES, 32 KB). w is
//   655 KB at most and stays in L2, so its ring can be shallow; x streams
//   from device memory, so its ring is deep. A stage completes on its full
//   mbarrier; each consumer warp releases it on the stage's empty mbarrier
//   once the wgmma that read it has retired (one wgmma group stays in
//   flight).
// - Each consumer warpgroup issues wgmma.mma_async m64n256k16 (bf16 -> f32)
//   or m64n256k32 (s8 -> s32) straight from the swizzled stages: 128
//   accumulators a thread.
// - Epilogue: the accumulators go, converted to the output type, into
//   64-row x 128-byte slabs in shared memory (64 bf16 or 32 s32 columns,
//   the 128-byte swizzle, a ring of RING slabs a warpgroup), and one thread
//   of the warpgroup writes each slab to device memory with a TMA bulk
//   store (`cp.async.bulk.wait_group.read` before a slab is reused). The
//   stores of one tile drain while the producers have already filled the
//   rings for the next tile and the consumers run its products.
// - Tile order: the column tile runs fastest, so the CTAs resident at once
//   cover about 66 row tiles and both column tiles: each x block is read
//   from device memory once and from L2 once more.
// - Ragged edges: TMA zero-fills loads past the tensors' edges and clips
//   stores, so a column tile past N (N a multiple of 128) costs work but no
//   masking.
// - Rejected on the card (an H100 80GB HBM3 at 700 W): one ring holding
//   both operands' slices (x's latency from device memory then bounded
//   every stage); w's ring two stages deep (kernel_variants.py's x6_w2_r2
//   and x8_w2_r2: the consumers wait on w); clusters of two on adjacent row
//   tiles, each CTA loading half of w's slice and multicasting it (each
//   consumer warp's cluster-scope release of a stage cost more than the
//   halved w traffic saved). A ping-pong of the two warpgroups on separate
//   64-row tiles would hide the epilogue but load w's slices twice as
//   often.
// B is stored [n][k] (N, K).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_tma.cuh"

namespace {

constexpr int BM = 128;                       // rows a CTA tile: two warpgroups of 64
constexpr int BN = 256;                       // columns a tile: one m64n256 wgmma a warpgroup
constexpr int KB = 128;                       // K bytes a stage: one 128-byte swizzle row
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 64;  // + the two producer warps
constexpr int A_BYTES = BM * KB;
constexpr int B_BYTES = BN * KB;
constexpr int SLAB = 64 * 128;                // an output slab: 64 rows x 128 bytes

// Ring depths: x's slices, w's, and output slabs a warpgroup.
template <bool S8>
struct Depths {
  static constexpr int A_STAGES = 6;
  static constexpr int B_STAGES = 3;
  static constexpr int RING = 2;
  static constexpr size_t SMEM = 1024 + (size_t)A_STAGES * A_BYTES + (size_t)B_STAGES * B_BYTES +
                                 2 * RING * SLAB + 16 * (A_STAGES + B_STAGES);
  static_assert(SMEM <= 232448, "over the block's shared memory");
};

#define MHENT_ACC8(C, b)                                                                       \
  "+" C(d[b]), "+" C(d[b + 1]), "+" C(d[b + 2]), "+" C(d[b + 3]), "+" C(d[b + 4]),             \
      "+" C(d[b + 5]), "+" C(d[b + 6]), "+" C(d[b + 7])
#define MHENT_ACC128(C)                                                                        \
  MHENT_ACC8(C, 0), MHENT_ACC8(C, 8), MHENT_ACC8(C, 16), MHENT_ACC8(C, 24), MHENT_ACC8(C, 32), \
      MHENT_ACC8(C, 40), MHENT_ACC8(C, 48), MHENT_ACC8(C, 56), MHENT_ACC8(C, 64),              \
      MHENT_ACC8(C, 72), MHENT_ACC8(C, 80), MHENT_ACC8(C, 88), MHENT_ACC8(C, 96),              \
      MHENT_ACC8(C, 104), MHENT_ACC8(C, 112), MHENT_ACC8(C, 120)
#define MHENT_REGS128                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "           \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "           \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "           \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "     \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127"

// D (64 x 256, the warpgroup's fragment: 128 registers a thread) += A B^T
// over one 32-byte K step, A and B K-major in shared memory (descriptors).
// Register 4 j + r of a thread (warp w of the warpgroup, lane 4 g + t) holds
// row 16 w + g + 8 (r / 2), column 8 j + 2 t + r % 2.
__device__ __forceinline__ void wgmma_256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" MHENT_REGS128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MHENT_ACC128("f")
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" MHENT_REGS128
      "}, %128, %129, p;\n}\n"
      : MHENT_ACC128("r")
      : "l"(da), "l"(db), "r"(1));
}

#undef MHENT_ACC8
#undef MHENT_ACC128
#undef MHENT_REGS128

__device__ __forceinline__ void advance(int& stage, int& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// S8: x (M, K) s8, w (N, K) s8, out (M, N) s32. Else bf16 x, w and out.
template <bool S8>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_out, int M, int N, int kbytes) {
  using Acc = typename std::conditional<S8, int, float>::type;
  using D = Depths<S8>;
  constexpr int kElems = S8 ? KB : KB / 2;    // K values a stage
  constexpr int kSlabCols = S8 ? 32 : 64;     // output columns a slab
  constexpr int kSlabs = BN / kSlabCols;      // slabs a warpgroup a tile
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1,024 bytes: align the rings to that.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_ring = (raw + 1023u) & ~1023u;
  const uint32_t b_ring = a_ring + D::A_STAGES * A_BYTES;
  const uint32_t out_smem = b_ring + D::B_STAGES * B_BYTES;
  const uint32_t a_full = out_smem + 2 * D::RING * SLAB, a_empty = a_full + 8 * D::A_STAGES;
  const uint32_t b_full = a_empty + 8 * D::A_STAGES, b_empty = b_full + 8 * D::B_STAGES;
  unsigned char* out_ptr = smem_raw + (out_smem - raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D::A_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < D::B_STAGES; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int ktiles = (kbytes + KB - 1) / KB;

  if (warp >= kConsumerWarps) {  // producers: warp 8 loads x's slices, warp 9 w's
    if (lane == 0) {
      const bool is_a = warp == kConsumerWarps;
      const int stages = is_a ? D::A_STAGES : D::B_STAGES;
      const uint32_t ring = is_a ? a_ring : b_ring, full = is_a ? a_full : b_full;
      const uint32_t empty = is_a ? a_empty : b_empty, bytes = is_a ? A_BYTES : B_BYTES;
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t dst = ring + stage * bytes, bar = full + 8 * stage;
          mbar_expect_tx(bar, bytes);
          if (is_a)
            tma_load(dst, &tm_x, kt * kElems, m0, bar);
          else
            tma_load(dst, &tm_w, kt * kElems, n0, bar);
          advance(stage, phase, stages);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, +64) of the tile.
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int row_lo = 16 * (warp % 4) + g;  // the fragment's rows: row_lo, row_lo + 8
  const bool leader = threadIdx.x % 128 == 0;
  int sa = 0, pa = 0, sb = 0, pb = 0, slabs = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    Acc acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    fence_regs<128>(acc);
    int prev_a = -1, prev_b = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(a_full + 8 * sa, pa);
      mbar_wait(b_full + 8 * sb, pb);
      const uint64_t da = sw128_desc(a_ring + sa * A_BYTES + wg * 64 * KB);
      const uint64_t db = sw128_desc(b_ring + sb * B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk) wgmma_256(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stages' group has retired
      if (prev_a >= 0) {
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(a_empty + 8 * prev_a);
          mbar_arrive(b_empty + 8 * prev_b);
        }
      }
      prev_a = sa;
      prev_b = sb;
      advance(sa, pa, D::A_STAGES);
      advance(sb, pb, D::B_STAGES);
    }
    wgmma_wait<0>();
    fence_regs<128>(acc);
    if (prev_a >= 0) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(a_empty + 8 * prev_a);
        mbar_arrive(b_empty + 8 * prev_b);
      }
    }

    // Epilogue: slab by slab through the warpgroup's ring.
#pragma unroll
    for (int q = 0; q < kSlabs; ++q) {
      const int slot = slabs % D::RING;
      if (slabs >= D::RING && leader) bulk_wait_read<D::RING - 1>();  // the slot's store read it
      named_sync(1 + wg, 128);
      unsigned char* slab = out_ptr + (wg * D::RING + slot) * SLAB;
#pragma unroll
      for (int jj = 0; jj < kSlabCols / 8; ++jj) {
        const int j = q * (kSlabCols / 8) + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_lo + 8 * h;  // row & 7 == g
          if constexpr (S8) {
            const int chunk = 2 * jj + (t >> 1);
            *reinterpret_cast<int2*>(slab + row * 128 + ((chunk ^ g) << 4) + 8 * (t & 1)) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          } else {
            __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(slab + row * 128 + ((jj ^ g) << 4) + 4 * t) = v;
          }
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (leader) {
        tma_store(&tm_out, out_smem + (wg * D::RING + slot) * SLAB, n0 + q * kSlabCols,
                  m0 + 64 * wg);
        bulk_commit();
      }
      ++slabs;
    }
  }
  if (leader) bulk_wait<0>();
}

template <bool S8>
int launch(const void* x, const void* w, void* out, int M, int N, int K, cudaStream_t stream) {
  const int esz = S8 ? 1 : 2, osz = S8 ? 4 : 2, kbytes = K * esz;
  if (M < 1 || M % 128 != 0 || N < 1 || N % 128 != 0 || K < 1 || kbytes % 64 != 0)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType in_t =
      S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType out_t =
      S8 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_x, tm_w, tm_out;
  if (!make_map_2d(&tm_x, in_t, esz, x, K, M, KB / esz, BM) ||
      !make_map_2d(&tm_w, in_t, esz, w, K, N, KB / esz, BN) ||
      !make_map_2d(&tm_out, out_t, osz, out, N, M, 128 / osz, 64))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Depths<S8>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<S8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles = (M / BM) * ((N + BN - 1) / BN);
  gemm_kernel<S8><<<tiles < sms ? tiles : sms, kThreads, smem, stream>>>(tm_x, tm_w, tm_out, M,
                                                                          N, kbytes);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K), w: (N, K), out: (M, N); s8 -> s32 or bf16 -> bf16.
extern "C" int mhent_gemm_probe_s8(const void* x, const void* w, void* out, int M, int N, int K,
                                   void* stream) {
  return launch<true>(x, w, out, M, N, K, static_cast<cudaStream_t>(stream));
}

extern "C" int mhent_gemm_probe_bf16(const void* x, const void* w, void* out, int M, int N,
                                     int K, void* stream) {
  return launch<false>(x, w, out, M, N, K, static_cast<cudaStream_t>(stream));
}
