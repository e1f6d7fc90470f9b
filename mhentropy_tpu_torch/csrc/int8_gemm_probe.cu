// int8 vs bf16 GEMM probe for Hopper (sm_90a): the same hand-written
// tensor-core GEMM, (M, K) x (K, N), as s8 x s8 -> s32 (mma.sync m16n8k32)
// and as bf16 x bf16 -> f32 (mma.sync m16n8k16) rounded to bf16.
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
// 42 MB and writes 34 MB (22.7 us). Both sides are bound by the memory
// rate, so the int8 peak's 2x should not show.
//
// Design: one kernel for both types. A block owns a 128 x 128 output tile
// (8 warps, 4 (M) x 2 (N), 32 x 64 each); K is walked in 64-byte steps (64
// s8 or 32 bf16 values) through a three-stage cp.async ring in shared
// memory, rows padded to 80 bytes so the 32-bit fragment reads are
// conflict-free. The s8 m16n8k32 and bf16 m16n8k16 fragments cover the
// same bytes of a 16 x 32-byte A tile and a 32-byte x 8 B tile, so only the
// mma instruction and the epilogue differ. B is stored [n][k] (N, K).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "int8_mma.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;  // K step in bytes
constexpr int kStages = 3;
constexpr int kLd = kBK + 16;
constexpr int kThreads = 256;
constexpr int kTileA = kBM * kLd, kTileB = kBN * kLd;
constexpr int kSmem = kStages * (kTileA + kTileB);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// S8: a (M, K) s8, b (N, K) s8, out (M, N) s32. Else a, b bf16, out bf16.
// M % 128 == 0, N % 128 == 0, K * size % 64 == 0 (the wrapper checks).
template <bool S8>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, void* out, int M,
                int N, int kbytes) {
  extern __shared__ __align__(16) int8_t smem[];
  using Acc = typename std::conditional<S8, int, float>::type;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;

  auto load_stage = [&](int stage, int kt) {
    int8_t* sa = smem + stage * (kTileA + kTileB);
    int8_t* sb = sa + kTileA;
    const size_t k0 = (size_t)kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + kThreads * i, row = e >> 2, chunk = e & 3;
      cp_async16(sa + row * kLd + chunk * 16, a + (size_t)(m0 + row) * kbytes + k0 + chunk * 16);
      cp_async16(sb + row * kLd + chunk * 16, b + (size_t)(n0 + row) * kbytes + k0 + chunk * 16);
    }
  };

  Acc acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  const int ktiles = kbytes / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n");
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    const int pre = kt + kStages - 1;
    if (pre < ktiles) load_stage(pre % kStages, pre);
    asm volatile("cp.async.commit_group;\n");
    const int8_t* sa = smem + (kt % kStages) * (kTileA + kTileB);
    const int8_t* sb = sa + kTileA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p0 = sa + (wm * 32 + mi * 16 + g) * kLd + kk + t * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p0);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p0 + 8 * kLd);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p0 + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p0 + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* p = sb + (wn * 64 + ni * 8 + g) * kLd + kk + t * 4;
        unsigned bf[2];
        bf[0] = *reinterpret_cast<const unsigned*>(p);
        bf[1] = *reinterpret_cast<const unsigned*>(p + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if constexpr (S8)
            mma_s8(acc[mi][ni], af[mi], bf);
          else
            mma_bf16(acc[mi][ni], af[mi], bf);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mi * 16 + g + half * 8;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const size_t off = (size_t)m * N + n0 + wn * 64 + ni * 8 + t * 2;
        if constexpr (S8)
          *reinterpret_cast<int2*>(static_cast<int*>(out) + off) =
              make_int2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off) =
              __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

template <bool S8>
int launch(const void* a, const void* b, void* out, int M, int N, int K, cudaStream_t s) {
  const int kbytes = K * (S8 ? 1 : 2);
  if (M < 1 || M % kBM != 0 || N % kBN != 0 || K < 1 || kbytes % kBK != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(gemm_kernel<S8>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / kBN, M / kBM);
  gemm_kernel<S8><<<grid, kThreads, kSmem, s>>>(static_cast<const int8_t*>(a),
                                                static_cast<const int8_t*>(b), out, M, N,
                                                kbytes);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (M, K), b: (N, K), out: (M, N); s8 -> s32 or bf16 -> bf16.
extern "C" int mhent_gemm_probe_s8(const void* a, const void* b, void* out, int M, int N, int K,
                                   void* stream) {
  return launch<true>(a, b, out, M, N, K, static_cast<cudaStream_t>(stream));
}

extern "C" int mhent_gemm_probe_bf16(const void* a, const void* b, void* out, int M, int N,
                                     int K, void* stream) {
  return launch<false>(a, b, out, M, N, K, static_cast<cudaStream_t>(stream));
}
