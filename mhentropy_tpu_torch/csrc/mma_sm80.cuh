// mma.sync building blocks shared by the bf16 stage-1 kernels (stage1.cu,
// stage1_probe.cu; the swizzle and bf16 packing also stem_probe.cu, the
// swizzle stem_int8.cu):
// shared-memory addresses, the XOR swizzle of their
// 128- and 512-byte-row tiles, zero-filling cp.async, ldmatrix and the
// m16n8k16 bf16 product.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile with `row`-byte rows.
static __device__ __forceinline__ uint32_t swz(int r, int c, int row) {
  return (uint32_t)(r * row + ((c ^ (r & 7)) << 4));
}

static __device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));  // 0 bytes read: the 16 are zero-filled
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

static __device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

static __device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row-major) x b (16 x 8); f32 accumulators.
static __device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (rows 0-15, k 16 kk .. +15) of a swizzled 64-channel tile whose
// fragment row i lives in tile row rows(i): lane l gives row (l & 7) +
// 8 ((l >> 3) & 1) and k chunk 2 kk + (l >> 4).
static __device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t tile, int row,
                                              int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + swz(row, 2 * kk + (lane >> 4), 128));
}
