// s8 x s8 -> s32 tensor-core helpers of the int8 stage kernel
// (stage2_int8.cu): mma.sync m16n8k32
// with its fragments loaded by hand. WMMA's int8 tiles step K by 16 bytes, below its
// documented 32-byte pointer alignment; these loads need 4-byte alignment
// only.
//
// Fragment layout (PTX ISA, mma.m16n8k32 .s8): lane = 4 g + t;
//   A (16 x 32, row-major): regs 0/1 rows g/g+8, bytes 4t..4t+3; regs 2/3
//     the same rows, bytes 16+4t..;
//   B (32 x 8, stored [n][k]): column g, bytes 4t.. and 16+4t..;
//   C/D (16 x 8 s32): regs 0,1 row g, columns 2t, 2t+1; regs 2,3 row g+8.

#pragma once

#include <cstdint>

static __device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a 16 x 32 s8 tile, row-major with `lda` bytes per row.
static __device__ __forceinline__ void load_a(unsigned (&a)[4], const int8_t* tile, int lda) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* p0 = tile + g * lda + t * 4;
  const int8_t* p1 = p0 + 8 * lda;
  a[0] = *reinterpret_cast<const unsigned*>(p0);
  a[1] = *reinterpret_cast<const unsigned*>(p1);
  a[2] = *reinterpret_cast<const unsigned*>(p0 + 16);
  a[3] = *reinterpret_cast<const unsigned*>(p1 + 16);
}

// B fragment of a 32 x 8 s8 tile stored [n][k] with `ldb` bytes per n, read
// through the read-only cache (weights).
static __device__ __forceinline__ void load_b(unsigned (&b)[2], const int8_t* tile, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* p = tile + g * ldb + t * 4;
  b[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  b[1] = __ldg(reinterpret_cast<const unsigned*>(p + 16));
}

// Round half to even and clip to +-127, as jnp.round / torch.round + clip.
static __device__ __forceinline__ int8_t quant(float v) {
  return (int8_t)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}
