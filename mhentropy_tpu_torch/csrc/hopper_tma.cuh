// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels
// (glow_sampler.cu, int8_gemm_probe.cu, stem_probe.cu, stem_int8.cu):
// mbarriers, bulk copies, TMA loads and stores through tensor maps, wgmma
// descriptors and fences, and the host's cuTensorMapEncodeTiled, looked up
// through the runtime so that the library needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the phase of parity `parity` has completed. A wait that never
// ends (a lost arrival) traps after about 4 M polls, so a fault fails the
// launch instead of hanging the card.
static __device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls > (1 << 22)) __trap();
  }
}

// `bytes` (a multiple of 16) of contiguous device memory at src into shared
// memory at dst, both 16-byte aligned, completing on mbarrier `bar`.
static __device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                                 uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A box of a 2D tensor map at (col, row) into shared memory, completing on
// mbarrier `bar`.
static __device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col,
                                                int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// A box of a 3D tensor map at (c0, c1, c2) into shared memory, completing on
// mbarrier `bar`.
static __device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A shared-memory box to a 2D tensor map at (col, row); the map clips what
// lies past the tensor's edge. Completion is tracked by bulk groups of the
// issuing thread.
static __device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col,
                                                 int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}

static __device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N>
static __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
static __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (a TMA store reading what the thread wrote, a TMA load
// overwriting what it read).
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows in the
// 128-byte swizzle (as TMA writes it): 8-row groups 1,024 bytes apart. A
// 32-byte K step (16 bf16 or 32 s8) is +2 in the address field.
static __device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins n accumulator registers at this point of the instruction stream: the
// compiler sees the wgmma as synchronous, so without this it may read an
// accumulator before wgmma.wait_group or move its zeroing past the first
// wgmma.
template <int N, typename T>
static __device__ __forceinline__ void fence_regs(T* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_floating_point<T>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

static __device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint[ByVersion]
// so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2D map of a row-major (rows, cols) tensor of `elem_bytes`-byte values,
// boxes of (box_cols, box_rows) with 128-byte rows in the 128-byte swizzle
// (wgmma's operand layout), zeros past the edges.
static inline bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                               const void* base, int cols, int rows, int box_cols,
                               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3D map of a (d2, d1, d0) tensor of `elem_bytes`-byte values with row
// stride `s1` and plane stride `s2` elements, boxes of (box0, box1, box2)
// stored densely (no swizzle), zeros past the edges: a box wider than d0
// gives each row its zero margin.
static inline bool make_map_3d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                               const void* base, int d0, int d1, int d2, long long s1,
                               long long s2, int box0, int box1, int box2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(s1 * elem_bytes), (cuuint64_t)(s2 * elem_bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)box2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
