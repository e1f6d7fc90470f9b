// Train-mode BatchNorm channel sums for Hopper (sm_90a).
//
// Replaces mhentropy_tpu/models/bn_pallas.py::stats_sums (:182) and
// grad_sums (:187): the Pallas `_stats_kernel` (:106) and `_reduce2_kernel`
// (:124) launched by `_row_call` (:143).
//
// What it computes: a channels-last activation viewed as (M, C) rows, bf16 or
// f32, reduced over its rows per channel with f32 accumulation:
//   stats: (sum_m x[m, c], sum_m x[m, c]^2)
//   grad:  (sum_m dy[m, c], sum_m dy[m, c] * x[m, c])
//
// What bounds it on the H100: bytes. Each input element is read once for one
// or two FMAs, far below the card's 20 FLOP per byte of f32 FMA peak.
//
// Design: pass 1 runs a 2-D grid, channel blocks x row splits. A thread owns
// VEC consecutive channels, one 16-byte load per row (8 bf16 or 4 f32); the
// gx channel groups of a block sit side by side along the row, so a warp
// reads whole rows of narrow activations and 512 contiguous bytes of wide
// ones. The ry row lanes of a block stride over the rows, four rows in flight
// per thread, and accumulate in f32 registers. The block reduces its ry lanes
// through shared memory in lane order and writes one row of partial sums to a
// (2, G, C) scratch that the caller allocates. Pass 2 sums the G partials of
// each channel in a fixed order. No float atomics: a run repeats itself bit
// for bit. Any M and C: where C is not a multiple of VEC or a base pointer is
// not 16-byte aligned, a thread loads one channel at a time (VEC = 1).
// The TPU version folded rows into 128 lanes and needed power-of-two row
// blocks; nothing here depends on either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 32;  // channel groups across one block
constexpr int kUnroll = 4;      // rows in flight per thread
constexpr int kFinishX = 32;    // channels per pass-2 block
constexpr int kFinishY = 8;     // partial-row splits per pass-2 block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive elements at p (16-byte aligned when VEC > 1) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte load");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(v[i]);
  }
}

template <int VEC, bool kGrad>
__device__ __forceinline__ void accumulate(const float (&a)[VEC], const float (&b)[VEC],
                                           float (&s1)[VEC], float (&s2)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s1[i] += a[i];
    s2[i] = fmaf(a[i], kGrad ? b[i] : a[i], s2[i]);
  }
}

// Pass 1. a: x (stats) or dy (grad); b: x (grad only). partial: (2, G, C).
template <typename T, int VEC, bool kGrad>
__global__ void __launch_bounds__(kThreads) partial_sums_kernel(
    const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ partial, int M,
    int C, int gx, int ry) {
  extern __shared__ float red[];  // (2, ry, gx * VEC)
  const int tx = threadIdx.x % gx, ty = threadIdx.x / gx;
  const int width = gx * VEC;
  const int c0 = blockIdx.x * width + tx * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.0f;
  if (c0 < C) {
    const long long stride = (long long)gridDim.y * ry;
    long long m = (long long)blockIdx.y * ry + ty;
    for (; m + (kUnroll - 1) * stride < M; m += kUnroll * stride) {
      float va[kUnroll][VEC], vb[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = (size_t)(m + u * stride) * C + c0;
        load_vec<T, VEC>(a + off, va[u]);
        if constexpr (kGrad) load_vec<T, VEC>(b + off, vb[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<VEC, kGrad>(va[u], vb[u], s1, s2);
    }
    for (; m < M; m += stride) {
      float va[VEC], vb[VEC];
      const size_t off = (size_t)m * C + c0;
      load_vec<T, VEC>(a + off, va);
      if constexpr (kGrad) load_vec<T, VEC>(b + off, vb);
      accumulate<VEC, kGrad>(va, vb, s1, s2);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[ty * width + tx * VEC + i] = s1[i];
    red[(ry + ty) * width + tx * VEC + i] = s2[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * width; e += blockDim.x) {
    const int which = e / width, col = e % width;
    const int c = blockIdx.x * width + col;
    if (c >= C) continue;
    float acc = 0.0f;
    for (int r = 0; r < ry; ++r) acc += red[(which * ry + r) * width + col];
    partial[((size_t)which * gridDim.y + blockIdx.y) * C + c] = acc;
  }
}

// Pass 2: out1[c] = sum_g partial[0, g, c], out2[c] = sum_g partial[1, g, c],
// each in a fixed order (kFinishY strided runs, then the runs in order).
__global__ void __launch_bounds__(kFinishX * kFinishY) finish_kernel(
    const float* __restrict__ partial, float* __restrict__ out1, float* __restrict__ out2,
    int G, int C) {
  __shared__ float red[2][kFinishY][kFinishX];
  const int tx = threadIdx.x % kFinishX, ty = threadIdx.x / kFinishX;
  const int c = blockIdx.x * kFinishX + tx;
  float a = 0.0f, b = 0.0f;
  if (c < C) {
#pragma unroll 4
    for (int g = ty; g < G; g += kFinishY) {
      a += partial[(size_t)g * C + c];
      b += partial[((size_t)G + g) * C + c];
    }
  }
  red[0][ty][tx] = a;
  red[1][ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < C) {
    float s = 0.0f, t = 0.0f;
    for (int r = 0; r < kFinishY; ++r) {
      s += red[0][r][tx];
      t += red[1][r][tx];
    }
    out1[c] = s;
    out2[c] = t;
  }
}

template <typename T, bool kGrad>
int launch(const void* a, const void* b, void* partial, void* out1, void* out2, int M, int C,
           int G, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       (!kGrad || reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const int vec = (C % kVec == 0 && aligned) ? kVec : 1;
  const int groups = (C + vec - 1) / vec;
  const int gx = groups < kMaxGroups ? groups : kMaxGroups;
  const int ry = kThreads / gx;
  const dim3 grid((groups + gx - 1) / gx, G);
  const size_t smem = sizeof(float) * 2 * ry * gx * vec;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  float* p = static_cast<float*>(partial);
  if (vec == kVec)
    partial_sums_kernel<T, kVec, kGrad><<<grid, gx * ry, smem, stream>>>(ta, tb, p, M, C, gx, ry);
  else
    partial_sums_kernel<T, 1, kGrad><<<grid, gx * ry, smem, stream>>>(ta, tb, p, M, C, gx, ry);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<(C + kFinishX - 1) / kFinishX, kFinishX * kFinishY, 0, stream>>>(
      p, static_cast<float*>(out1), static_cast<float*>(out2), G, C);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.
template <bool kGrad>
int dispatch(const void* a, const void* b, void* partial, void* out1, void* out2, int M, int C,
             int G, int dtype, void* stream) {
  if (M < 1 || C < 1 || G < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kGrad>(a, b, partial, out1, out2, M, C, G, s);
  if (dtype == 1) return launch<__nv_bfloat16, kGrad>(a, b, partial, out1, out2, M, C, G, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// (sum x, sum x^2) per channel of x (M, C) row-major. partial: (2, G, C) f32.
extern "C" int mhent_bn_stats_sums(const void* x, void* partial, void* sum, void* sumsq, int M,
                                   int C, int G, int dtype, void* stream) {
  return dispatch<false>(x, nullptr, partial, sum, sumsq, M, C, G, dtype, stream);
}

// (sum dy, sum dy * x) per channel of dy and x (M, C) row-major, one dtype.
extern "C" int mhent_bn_grad_sums(const void* dy, const void* x, void* partial, void* sum_dy,
                                  void* sum_dyx, int M, int C, int G, int dtype, void* stream) {
  return dispatch<true>(dy, x, partial, sum_dy, sum_dyx, M, C, G, dtype, stream);
}
