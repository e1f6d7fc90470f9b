// Linear-blend-skinning blend for Hopper (sm_90a), batch-last planes:
//
//   verts[r, v, b] = sum_c A[r, c](v, b) * v_posed[c, v, b] + T[r](v, b)
//   A[r, c](v, b) = sum_j W[v, j] R[r, c, j, b],  T[r](v, b) = sum_j W[v, j] t[r, j, b]
//
// Replaces mhentropy_tpu/core/lbs_pallas.py::lbs_blend (the Pallas `_kernel`
// at :33, launched at :97).
//
// What bounds it on the H100: at MANO's eval shape (V = 778, J = 16,
// 12,800 rows) device memory. It must read v_posed (119.5 MB) plus R and t
// (9.8 MB) and write 119.5 MB: about 249 MB, 74 us at 3.35 TB/s. Its 4.0
// GFLOP of f32 take 60 us at the 67 TFLOP/s FMA peak, so the two are close
// and the kernel must not waste either. At SMPL's (V = 6,890, J = 24,
// 3,200 rows of the ProHMR path) the operations: about 533 MB (0.16 ms)
// against 13.1 GFLOP of f32 FMA (0.20 ms). The einsum path materialises
// nine (V, rows) per-vertex-rotation planes and three translation planes
// in device memory first, about five times the bytes.
//
// Design: block (x, y) owns kTr = 32 rows (b) and one tile of kVt = 1024
// vertices, as the JAX kernel tiles vertices (lbs_pallas.py:85-92,
// v_tile = min(V, 1024)). It stages its tile's W rows (Vt x J floats; 50 KB
// for MANO's 778 x 16, 98 KB for a SMPL tile of 1024 x 24) and its rows'
// R and t (12 x J x 32 floats) in shared memory once. MANO stays one tile
// per row block, so its grid and shared memory are what they were before
// the tiling; SMPL (V = 6,890) takes 7 tiles, each re-staging its rows'
// R and t (37 KB) from L2. Each thread owns one row (threadIdx.x, so the
// 32 lanes of a warp read and write 32 consecutive rows: every v_posed load
// and verts store is one 128-byte line) and kVpt vertices at a time; it
// forms the 12 per-vertex coefficients for its vertices in registers from
// the J joints (each R/t value read from shared memory once and applied to
// kVpt vertices, each W value a warp-wide broadcast) and never writes them
// out. Plain f32 FMAs throughout, no TF32: the JAX kernel runs
// Precision.HIGHEST. Any V and row count (the ragged last row tile and
// vertex tile are masked). J up to 150: the entry point shrinks the vertex
// tile until W's rows and the rows' R and t fit the 227 KB a block may use
// (from J = 42 on, below 1024 vertices), and returns cudaErrorInvalidValue
// when not one vertex fits (J > 150); the wrapper asks
// mhent_lbs_vertex_tile first and raises with the shapes.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTr = 32;      // rows per block (one warp's lanes)
constexpr int kTy = 8;       // warps per block, along vertices
constexpr int kVpt = 4;      // vertices per thread per pass
constexpr int kVt = 1024;    // vertices per tile (blockIdx.y)
constexpr size_t kMaxSmem = 227 * 1024;

struct Params {
  const float* w;        // (V, J)
  const float* rot;      // (3, 3, J, R)
  const float* trans;    // (3, J, R)
  const float* vposed;   // (3, V, R)
  float* out;            // (3, V, R)
  int V, J, R, Vt;  // Vt: vertices per tile
};

size_t smem_bytes(int Vt, int J) {
  return sizeof(float) * ((size_t)Vt * J + (size_t)12 * J * kTr);
}

__global__ void __launch_bounds__(kTr * kTy) lbs_blend_kernel(Params p) {
  extern __shared__ float smem[];
  const int J = p.J, R = p.R;
  const int vbase = blockIdx.y * p.Vt;     // first vertex of this tile
  const int V = min(p.Vt, p.V - vbase);    // vertices in this tile
  float* s_w = smem;                       // (V, J): W[vbase:vbase + V]
  float* s_rt = s_w + (size_t)p.Vt * J;    // (12, J, kTr): 9 rotation + 3 translation planes
  const int r0 = blockIdx.x * kTr;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTr + tx;
  const int nthreads = kTr * kTy;

  for (int e = tid; e < V * J; e += nthreads) s_w[e] = p.w[(size_t)vbase * J + e];
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
  const size_t plane_stride = (size_t)p.V * R;
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
      const size_t idx = (size_t)(vbase + v) * R + r;
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

// The vertex tile: min(V, kVt, the most whose staging fits); below 1 when
// not even one vertex fits beside the rows' R and t. The wrapper asks it
// before a launch, so the shared-memory limit lives here only.
extern "C" int mhent_lbs_vertex_tile(int V, int J) {
  if (V < 1 || J < 1) return 0;
  const long fit = ((long)(kMaxSmem / sizeof(float)) - 12L * J * kTr) / J;
  long vt = V < kVt ? V : kVt;
  return (int)(vt < fit ? vt : fit);
}

extern "C" int mhent_lbs_blend(const void* w, const void* rot, const void* trans,
                               const void* vposed, void* out, int V, int J, int R,
                               void* stream) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  const int vt = mhent_lbs_vertex_tile(V, J);
  if (vt < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(vt, J);
  Params p;
  p.w = static_cast<const float*>(w);
  p.rot = static_cast<const float*>(rot);
  p.trans = static_cast<const float*>(trans);
  p.vposed = static_cast<const float*>(vposed);
  p.out = static_cast<float*>(out);
  p.V = V;
  p.J = J;
  p.R = R;
  p.Vt = vt;
  cudaError_t err = cudaFuncSetAttribute(
      lbs_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kTr, kTy);
  const dim3 grid((R + kTr - 1) / kTr, (V + vt - 1) / vt);
  lbs_blend_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
