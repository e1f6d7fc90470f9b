// Linear-blend-skinning blend for Hopper (sm_90a), batch-last planes:
//
//   verts[r, v, b] = sum_c A[r, c](v, b) * v_posed[c, v, b] + T[r](v, b)
//   A[r, c](v, b) = sum_j W[v, j] R[r, c, j, b],  T[r](v, b) = sum_j W[v, j] t[r, j, b]
//
// Replaces mhentropy_tpu/core/lbs_pallas.py::lbs_blend (the Pallas `_kernel`
// at :33, launched at :97).
//
// What bounds it on the H100: device memory. At the eval shape (V = 778,
// J = 16, 12,800 rows) it must read v_posed (119.5 MB) plus R and t
// (9.8 MB) and write 119.5 MB: about 249 MB, 74 us at 3.35 TB/s. Its 4.0
// GFLOP of f32 take 60 us at the 67 TFLOP/s FMA peak, so the two are close
// and the kernel must not waste either. The einsum path materialises nine
// (V, rows) per-vertex-rotation planes and three translation planes in
// device memory first, about five times the bytes.
//
// Design: one block owns kTr = 32 rows (b) and all vertices. It stages W
// (V x J, 50 KB for MANO) and its rows' R and t (12 x J x 32 floats) in
// shared memory once. Each thread owns one row (threadIdx.x, so the 32
// lanes of a warp read and write 32 consecutive rows: every v_posed load
// and verts store is one 128-byte line) and kVpt vertices at a time; it
// forms the 12 per-vertex coefficients for its vertices in registers from
// the J joints (each R/t value read from shared memory once and applied to
// kVpt vertices, each W value a warp-wide broadcast) and never writes them
// out. Plain f32 FMAs throughout, no TF32: the JAX kernel runs
// Precision.HIGHEST. Any V, J and row count (the ragged last row tile is
// masked).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTr = 32;      // rows per block (one warp's lanes)
constexpr int kTy = 8;       // warps per block, along vertices
constexpr int kVpt = 4;      // vertices per thread per pass

struct Params {
  const float* w;        // (V, J)
  const float* rot;      // (3, 3, J, R)
  const float* trans;    // (3, J, R)
  const float* vposed;   // (3, V, R)
  float* out;            // (3, V, R)
  int V, J, R;
};

size_t smem_bytes(int V, int J) {
  return sizeof(float) * ((size_t)V * J + (size_t)12 * J * kTr);
}

__global__ void __launch_bounds__(kTr * kTy) lbs_blend_kernel(Params p) {
  extern __shared__ float smem[];
  const int V = p.V, J = p.J, R = p.R;
  float* s_w = smem;                       // (V, J)
  float* s_rt = s_w + (size_t)V * J;       // (12, J, kTr): 9 rotation + 3 translation planes
  const int r0 = blockIdx.x * kTr;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTr + tx;
  const int nthreads = kTr * kTy;

  for (int e = tid; e < V * J; e += nthreads) s_w[e] = p.w[e];
  for (int e = tid; e < 12 * J * kTr; e += nthreads) {
    const int col = e % kTr, pj = e / kTr;  // pj = plane * J + j
    const int plane = pj / J, j = pj % J;
    const int r = r0 + col;
    float v = 0.0f;
    if (r < R)
      v = plane < 9 ? p.rot[((size_t)plane * J + j) * R + r]
                    : p.trans[((size_t)(plane - 9) * J + j) * R + r];
    s_rt[e] = v;
  }
  __syncthreads();

  const int r = r0 + tx;
  if (r >= R) return;
  const size_t plane_stride = (size_t)V * R;
  for (int v0 = ty * kVpt; v0 < V; v0 += kTy * kVpt) {
    float acc[kVpt][12];
#pragma unroll
    for (int k = 0; k < kVpt; ++k)
#pragma unroll
      for (int q = 0; q < 12; ++q) acc[k][q] = 0.0f;
    for (int j = 0; j < J; ++j) {
      float rt[12];
#pragma unroll
      for (int q = 0; q < 12; ++q) rt[q] = s_rt[(q * J + j) * kTr + tx];
#pragma unroll
      for (int k = 0; k < kVpt; ++k) {
        const int v = v0 + k;
        const float wv = v < V ? s_w[v * J + j] : 0.0f;
#pragma unroll
        for (int q = 0; q < 12; ++q) acc[k][q] = fmaf(wv, rt[q], acc[k][q]);
      }
    }
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      const int v = v0 + k;
      if (v >= V) break;
      const size_t idx = (size_t)v * R + r;
      const float p0 = p.vposed[idx], p1 = p.vposed[plane_stride + idx],
                  p2 = p.vposed[2 * plane_stride + idx];
#pragma unroll
      for (int row = 0; row < 3; ++row) {
        float o = acc[k][9 + row];
        o = fmaf(acc[k][row * 3 + 0], p0, o);
        o = fmaf(acc[k][row * 3 + 1], p1, o);
        o = fmaf(acc[k][row * 3 + 2], p2, o);
        p.out[row * plane_stride + idx] = o;
      }
    }
  }
}

}  // namespace

extern "C" int mhent_lbs_blend(const void* w, const void* rot, const void* trans,
                               const void* vposed, void* out, int V, int J, int R,
                               void* stream) {
  if (V < 1 || J < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(V, J);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  Params p;
  p.w = static_cast<const float*>(w);
  p.rot = static_cast<const float*>(rot);
  p.trans = static_cast<const float*>(trans);
  p.vposed = static_cast<const float*>(vposed);
  p.out = static_cast<float*>(out);
  p.V = V;
  p.J = J;
  p.R = R;
  cudaError_t err = cudaFuncSetAttribute(
      lbs_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kTr, kTy);
  const int grid = (R + kTr - 1) / kTr;
  lbs_blend_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
