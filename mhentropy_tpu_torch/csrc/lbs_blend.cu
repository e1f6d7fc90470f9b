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
// Design: the same sum, factored per joint so that a thread's registers
// hold 3 accumulators a vertex, not A's and T's 12:
//
//   verts[r](v, b) = sum_j W[v, j] (t[r, j, b] + sum_c R[r, c, j, b] v_posed[c, v, b])
//
// 12 FMAs a (vertex, row, joint), as the two-step form. Block (x, y) owns
// 32 rows and a tile of up to 512 vertices (the JAX kernel tiles vertices
// too). It stages its rows' R and t in shared memory as [j][row][12] (a
// row's 12 values of a joint are three 16-byte loads) and the tile's W rows
// as [v][j], the pitch J rounded up to even and to 2 mod 4 (one 8-byte load
// gives a vertex two joints' weights), eight loads a thread in flight. A
// warp is 16 rows x 2 vertex halves: lanes i and i + 16 share row i, so each
// R/t load has 16 distinct addresses (2 wavefronts, not 4), and the halves'
// W rows, kVg vertices apart, fall in different banks. A thread carries
// kVg = 8 vertices through each pass over the joints: per joint 3 16-byte
// loads (R/t) and 4 8-byte loads (W) for 96 FMAs, 10 shared-memory
// wavefronts a warp against 24 FMA cycles, so the FMAs, not the shared
// loads, set the pace. Each pass's v_posed loads are issued before its
// joint loop; the SM's other warps' FMAs cover them (a one-pass-ahead
// prefetch, 24 registers more, measured 2 % slower at SMPL, and four lanes
// a row 3 % slower). 88 KB of shared memory at SMPL's tile (52 KB W, 36 KB
// R and t): two blocks (16 warps) an SM. Plain f32 FMAs throughout, no
// TF32: the JAX kernel runs Precision.HIGHEST (a 3xTF32 mma.sync version of
// the W R product ran slower: it splits every R/t value once a vertex
// tile). Any V and row count (the ragged last row block and vertex tile are
// masked). J up to 150: the entry point shrinks the vertex tile until W's
// rows and the rows' R and t fit the 227 KB a block may use (at SMPL's V
// from J = 67 on), and returns cudaErrorInvalidValue when not one vertex
// fits (J > 150); the wrapper asks mhent_lbs_vertex_tile first and raises
// with the shapes.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTr = 32;      // rows per block
constexpr int kWarps = 8;    // warps per block: two row halves of 16 x four along vertices
constexpr int kVg = 8;       // vertices a thread carries through a pass
constexpr int kVt = 512;     // vertices per tile at most (blockIdx.y)
constexpr int kStage = 8;    // staging loads a thread keeps in flight
constexpr size_t kMaxSmem = 227 * 1024;

struct Params {
  const float* __restrict__ w;      // (V, J)
  const float* __restrict__ rot;    // (3, 3, J, R)
  const float* __restrict__ trans;  // (3, J, R)
  const float* vposed;   // (3, V, R)
  float* out;            // (3, V, R)
  int V, J, R, Vt;  // Vt: vertices per tile
};

// W's row pitch in shared memory: J rounded up to even (8-byte loads of two
// joints), then to 2 mod 4, so that the two half-warps' rows, kVg apart,
// fall in different banks.
__host__ __device__ int w_pitch(int J) {
  const int j2 = (J + 1) & ~1;
  return j2 % 4 == 2 ? j2 : j2 + 2;
}

// Floats before the R/t region: the W tile, rounded up to 16 bytes.
__host__ __device__ size_t w_floats(int Vt, int J) {
  return ((size_t)Vt * w_pitch(J) + 3) & ~(size_t)3;
}

size_t smem_bytes(int Vt, int J) {
  return sizeof(float) * (w_floats(Vt, J) + (size_t)12 * J * kTr);
}

__global__ void __launch_bounds__(32 * kWarps, 2) lbs_blend_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int J = p.J, P = w_pitch(J), R = p.R;
  const int vbase = blockIdx.y * p.Vt;     // first vertex of this tile
  const int nv = min(p.Vt, p.V - vbase);   // vertices in this tile
  float* s_w = smem;                       // (nv, P): W[vbase + v], 0 past J
  float* s_rt = smem + w_floats(p.Vt, J);  // (J, kTr, 12): R row-major, then t
  const int r0 = blockIdx.x * kTr;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nthreads = 32 * kWarps;

  // Staging: kStage loads a thread in flight before their stores.
  const int n_w = nv * P, n_rt = 12 * J * kTr;
  for (int e0 = tid; e0 < n_w; e0 += nthreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * nthreads, v_ = e / P, j = e % P;
      v[u] = e < n_w && j < J ? __ldg(p.w + (size_t)(vbase + v_) * J + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (e0 + u * nthreads < n_w) s_w[e0 + u * nthreads] = v[u];
  }
  for (int e0 = tid; e0 < n_rt; e0 += nthreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * nthreads;
      const int row = e % kTr, qj = e / kTr;  // qj = q * J + j
      const int q = qj / J, j = qj % J;
      const int r = r0 + row;
      v[u] = 0.0f;
      if (e < n_rt && r < R)
        v[u] = q < 9 ? __ldg(p.rot + ((size_t)q * J + j) * R + r)
                     : __ldg(p.trans + ((size_t)(q - 9) * J + j) * R + r);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * nthreads;
      if (e < n_rt) {
        const int row = e % kTr, qj = e / kTr;
        s_rt[((size_t)(qj % J) * kTr + row) * 12 + qj / J] = v[u];
      }
    }
  }
  __syncthreads();

  // Lane (h, i) of warp w: row half w / 4, row i of it, vertex half h of
  // each pass of 2 kVg vertices; the warp's passes are w % 4, + 4, ...
  const int half = lane / 16, row = (warp / 4) * 16 + lane % 16, r = r0 + row;
  const bool row_ok = r < R;
  const size_t plane = (size_t)p.V * R;
  const float4* rt_row = reinterpret_cast<const float4*>(s_rt) + row * 3;
  constexpr int kPassV = 2 * kVg, kSlots = kWarps / 2;
  const int n_pass = (nv + kPassV - 1) / kPassV;

  for (int pass = warp % kSlots; pass < n_pass; pass += kSlots) {
    const int v0 = pass * kPassV + half * kVg;  // this lane's first vertex
    float vp[kVg][3], acc[kVg][3];  // v_posed of this lane's vertices, in flight now
#pragma unroll
    for (int k = 0; k < kVg; ++k) {
      const int v = v0 + k;
      const bool ok = row_ok && v < nv;
      const size_t idx = (size_t)(vbase + v) * R + r;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        vp[k][c] = ok ? p.vposed[c * plane + idx] : 0.0f;
        acc[k][c] = 0.0f;
      }
    }

    for (int jb = 0; jb < J; jb += 2) {
      float2 w2[kVg];
#pragma unroll
      for (int k = 0; k < kVg; ++k)
        w2[k] = v0 + k < nv ? *reinterpret_cast<const float2*>(s_w + (v0 + k) * P + jb)
                            : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = jb + jj;
        if (j >= J) break;
        // a = R00 R01 R02 R10, b = R11 R12 R20 R21, c = R22 t0 t1 t2
        const float4 a = rt_row[j * kTr * 3], b = rt_row[j * kTr * 3 + 1],
                     c = rt_row[j * kTr * 3 + 2];
#pragma unroll
        for (int k = 0; k < kVg; ++k) {
          const float wv = jj == 0 ? w2[k].x : w2[k].y;
          const float x = vp[k][0], y = vp[k][1], z = vp[k][2];
          const float u0 = fmaf(a.x, x, fmaf(a.y, y, fmaf(a.z, z, c.y)));
          const float u1 = fmaf(a.w, x, fmaf(b.x, y, fmaf(b.y, z, c.z)));
          const float u2 = fmaf(b.z, x, fmaf(b.w, y, fmaf(c.x, z, c.w)));
          acc[k][0] = fmaf(wv, u0, acc[k][0]);
          acc[k][1] = fmaf(wv, u1, acc[k][1]);
          acc[k][2] = fmaf(wv, u2, acc[k][2]);
        }
      }
    }
    if (!row_ok) continue;
#pragma unroll
    for (int k = 0; k < kVg; ++k) {
      const int v = v0 + k;
      if (v >= nv) break;
      const size_t idx = (size_t)(vbase + v) * R + r;
#pragma unroll
      for (int c = 0; c < 3; ++c) p.out[c * plane + idx] = acc[k][c];
    }
  }
}

}  // namespace

// The vertex tile: the tile count of at most kVt vertices each, evened out
// and rounded up to a pass (2 kVg), capped by the most whose staging fits; below 1
// when not even one vertex fits beside the rows' R and t. The wrapper asks
// it before a launch, so the shared-memory limit lives here only.
extern "C" int mhent_lbs_vertex_tile(int V, int J) {
  if (V < 1 || J < 1) return 0;
  const int tiles = (V + kVt - 1) / kVt;
  long vt = ((V + tiles - 1) / tiles + 2 * kVg - 1) / (2 * kVg) * (2 * kVg);
  if (vt > V) vt = V;
  while (vt > 0 && smem_bytes((int)vt, J) > kMaxSmem) --vt;
  return (int)vt;
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
  const dim3 grid((R + kTr - 1) / kTr, (V + vt - 1) / vt);
  lbs_blend_kernel<<<grid, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
