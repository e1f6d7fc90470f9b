// W8A8 ResNet-50 stages 2 and 3 for Hopper (sm_90a): one C call per
// bottleneck, each convolution an implicit-GEMM kernel of s8 x s8 -> s32
// tensor-core products (mma.sync m16n8k32) with the quantised eval path's
// f32 epilogue fused:
//
//   block 0: xq = clip(rint(x * inv[0]), +-127)          (bf16 / f32 stage input)
//   h1q = clip(rint(relu(acc1 * s1' + b1')), +-127)      (1x1, conv2's inv_sa folded)
//   h2q = clip(rint(relu(acc2 * s2' + b2')), +-127)      (3x3, stride 2 on block 0)
//   res = accd * sd + bd on block 0 (1x1 stride 2 on xq), else the f32 carry
//   y   = relu((acc3 * s3 + b3) + res)                   (f32 carry, or the stage's
//                                                        bf16 / f32 output)
//   next block's xq = clip(rint(y * inv[j + 1]), +-127)  (emitted beside y)
//
// Replaces mhentropy_tpu/models/stage2_int8.py::stage_forward_q (the Pallas
// `_kernel` at :81, launched at :277). The arithmetic and its order are the
// TPU kernel's: every epilogue multiply and add is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction), rint rounds half to even
// like jnp.round, the integer sums are exact, and the carry between blocks
// is f32. conv2 of the stride-2 block is computed at stride 2 directly: the
// TPU kernel's full-resolution conv2 and selection matmuls give the same
// integer sums at the kept pixels.
//
// What bounds it on the H100: stage 2 at B = 8 (4 bottlenecks, 64 x 64 x 256
// in, 32 x 32 x 512 out) does 21.5 GOP of s8 products, 10.9 us at the 1,979
// TOP/s int8 peak, and must move its bf16 input and output (25 MB, 7.5 us
// at 3.35 TB/s); stage 3 (6 bottlenecks, 32 x 32 x 512 in, 16 x 16 x 1024
// out) 30.6 GOP, 15.5 us. Beyond that bound, the f32 carry between blocks
// (16.8 MB for a stage-2 block output at B = 8, 67 MB at B = 32) is written
// by one block and read twice by the next (its quantised copy and its
// residual), L2-resident at B = 8 and not at B = 32.
//
// Design: the TPU kernel kept a whole image's stage in VMEM (several MB a
// grid step), which 227 KB of shared memory cannot hold. Here each
// convolution of a bottleneck is one launch of one kernel: a 64-pixel x
// 128-channel output tile a block (4 warps, 32 x 64 each; 64 channels
// where 128 would leave SMs idle), K walked in
// 64-byte steps through a three-stage cp.async ring in shared memory (so
// conv2's 147 KB / 590 KB of weights stream and never need to fit), the A
// operand gathered straight from the s8 NHWC map at each tap's shifted (and
// strided) pixel with the zero padding as zero-filled copies: an implicit
// GEMM, no im2col in memory. The requantise epilogues write s8, so between
// the convolutions of a bottleneck only s8 maps travel (h1q 4.2 MB and h2q
// 1 MB for a stage-2 block 0 at B = 8), all in L2; fusing them on chip
// would save that little beside the f32 carry. The last conv's epilogue
// adds the residual, applies the ReLU and also emits the next block's s8
// input, so the next conv1 reads bytes, not the f32 carry. Splitting the
// output channels over the grid gives stage 3 at B = 8 (2,048 output
// pixels) 128-512 blocks a launch. Fragments are loaded with ldmatrix
// (rows padded to 80 bytes, conflict-free); wgmma, split K for the long
// 3x3 and a fused bottleneck are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "int8_mma.cuh"

namespace {

constexpr int kBM = 64, kBK = 64;  // output pixels, K bytes a step
constexpr int kStages = 3;
constexpr int kLd = kBK + 16;      // smem row stride in bytes
constexpr int kThreads = 128;      // 4 warps: 2 (M) x 2 (N), 32 x BN / 2 each
constexpr int kTileA = kBM * kLd;

// The three-stage ring of a block with BN output channels.
template <int BN>
constexpr int smem_bytes() {
  return kStages * (kTileA + BN * kLd);
}

enum Epi { kRequant = 0, kAffine = 1, kResidual = 2 };

struct Conv {
  const int8_t* a;        // (B, Hin, Win, Ca) s8 NHWC
  const int8_t* w;        // (N, K) s8, k = (dy * ks + dx) * Ca + c
  const float* scale;     // (N,)
  const float* bias;      // (N,)
  const float* res;       // kResidual: (M, N) f32 residual (may alias out)
  void* out;              // (M, N): s8 (kRequant), f32 (kAffine), f32 / bf16 (kResidual)
  int8_t* q_next;         // kResidual: (M, N) s8 quantised copy for the next block, or null
  const float* inv_next;  // (1,) its quantise factor
  int Hin, Win, Ca, Ho, Wo, N, K, ks, stride, pad, M, out_bf16;
};

__device__ __forceinline__ float epi(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 16-byte matrices from smem, one a register: lane l gives the row
// address of matrix l / 8, and receives of each matrix row l / 4, bytes
// 4 (l % 4) .. +3, which is the mma.sync s8 fragment layout.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const int8_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The A fragment of a 16 x 32-byte tile (rows 0-7 / 8-15, bytes 0-15 /
// 16-31 in a[0..3]).
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const int8_t* tile) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 16);
}

// The B fragments of two neighbouring n8 tiles (16 rows [n][k], 32 bytes):
// b[0..1] the first tile's, b[2..3] the second's.
__device__ __forceinline__ void frag_b2(unsigned (&b)[4], const int8_t* tile) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 16);
}

template <int EPI, int BN>
__global__ void __launch_bounds__(kThreads) conv_q_kernel(Conv p) {
  constexpr int kTileB = BN * kLd, kNI = BN / 16;  // n8 tiles a warp
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;

  // The two A rows (output pixels) this thread copies, 16 bytes each step.
  const int chunk = tid & 3;
  const int8_t* a_img[2];
  int a_iy[2], a_ix[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 32 * i;
    a_ok[i] = m < p.M;
    const int mm = a_ok[i] ? m : 0;
    const int hw = p.Ho * p.Wo;
    const int bimg = mm / hw, rem = mm - bimg * hw;
    const int oy = rem / p.Wo, ox = rem - oy * p.Wo;
    a_img[i] = p.a + (size_t)bimg * p.Hin * p.Win * p.Ca;
    a_iy[i] = oy * p.stride - p.pad;
    a_ix[i] = ox * p.stride - p.pad;
  }

  auto load_stage = [&](int stage, int kt) {
    int8_t* sa = smem + stage * (kTileA + kTileB);
    int8_t* sb = sa + kTileA;
    const int k0 = kt * kBK;
    const int tap = k0 / p.Ca, c0 = k0 - tap * p.Ca;
    const int dy = tap / p.ks, dx = tap - dy * p.ks;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
      const bool ok = a_ok[i] && iy >= 0 && iy < p.Hin && ix >= 0 && ix < p.Win;
      const int8_t* src =
          ok ? a_img[i] + ((size_t)iy * p.Win + ix) * p.Ca + c0 + chunk * 16 : p.a;
      cp_async16(sa + ((tid >> 2) + 32 * i) * kLd + chunk * 16, src, ok);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int row = (tid >> 2) + 32 * i;
      cp_async16(sb + row * kLd + chunk * 16, p.w + (size_t)(n0 + row) * p.K + k0 + chunk * 16,
                 true);
    }
  };

  int acc[2][kNI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  const int ktiles = p.K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = kt + kStages - 1;
    if (pre < ktiles) load_stage(pre % kStages, pre);
    cp_async_commit();
    const int8_t* sa = smem + (kt % kStages) * (kTileA + kTileB);
    const int8_t* sb = sa + kTileA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) frag_a(af[mi], sa + (wm * 32 + mi * 16) * kLd + kk);
#pragma unroll
      for (int ni = 0; ni < kNI; ni += 2) {
        unsigned bf[4];
        frag_b2(bf, sb + (wn * (BN / 2) + ni * 8) * kLd + kk);
        const unsigned b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(acc[mi][ni], af[mi], b0);
          mma_s8(acc[mi][ni + 1], af[mi], b1);
        }
      }
    }
  }
  cp_async_wait<0>();

  const float inv_next = (EPI == kResidual && p.q_next != nullptr) ? *p.inv_next : 0.0f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int c = n0 + wn * (BN / 2) + ni * 8 + t * 2;
        const size_t off = (size_t)m * p.N + c;
        const int a0 = acc[mi][ni][2 * half], a1 = acc[mi][ni][2 * half + 1];
        const float y0 = epi(a0, p.scale[c], p.bias[c]);
        const float y1 = epi(a1, p.scale[c + 1], p.bias[c + 1]);
        if (EPI == kRequant) {
          char2 q = make_char2(quant(fmaxf(y0, 0.0f)), quant(fmaxf(y1, 0.0f)));
          *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + off) = q;
        } else if (EPI == kAffine) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(y0, y1);
        } else {
          const float2 r = *reinterpret_cast<const float2*>(p.res + off);
          const float o0 = fmaxf(__fadd_rn(y0, r.x), 0.0f);
          const float o1 = fmaxf(__fadd_rn(y1, r.y), 0.0f);
          if (p.out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + off) =
                __floats2bfloat162_rn(o0, o1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(o0, o1);
          if (p.q_next != nullptr)
            *reinterpret_cast<char2*>(p.q_next + off) =
                make_char2(quant(__fmul_rn(o0, inv_next)), quant(__fmul_rn(o1, inv_next)));
        }
      }
    }
  }
}

// The stage input quantised with conv1's factor: 8 values a thread.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                                int8_t* __restrict__ xq, size_t n8) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float s = *inv;
  float v[8];
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float4 lo = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 hi = reinterpret_cast<const float4*>(x)[2 * i + 1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
  char4 q0 = make_char4(quant(__fmul_rn(v[0], s)), quant(__fmul_rn(v[1], s)),
                        quant(__fmul_rn(v[2], s)), quant(__fmul_rn(v[3], s)));
  char4 q1 = make_char4(quant(__fmul_rn(v[4], s)), quant(__fmul_rn(v[5], s)),
                        quant(__fmul_rn(v[6], s)), quant(__fmul_rn(v[7], s)));
  reinterpret_cast<char4*>(xq)[2 * i] = q0;
  reinterpret_cast<char4*>(xq)[2 * i + 1] = q1;
}

template <int EPI, int BN>
int launch_conv(const Conv& p, cudaStream_t stream) {
  auto kernel = conv_q_kernel<EPI, BN>;
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.N / BN, (p.M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// 128 output channels a block, or 64 where 128 would leave SMs without a
// block (stage 3 at B = 8, stage 2's narrow convs at B = 8).
template <int EPI>
int conv(const Conv& p, int sms, cudaStream_t stream) {
  if (p.K % kBK != 0 || p.N % 128 != 0 || p.Ca % kBK != 0 || p.M < 1)
    return (int)cudaErrorInvalidValue;
  const long blocks128 = (long)(p.N / 128) * ((p.M + kBM - 1) / kBM);
  return blocks128 < sms ? launch_conv<EPI, 64>(p, stream) : launch_conv<EPI, 128>(p, stream);
}

Conv make_conv(const void* a, const void* w, const void* scale, const void* bias, int B,
               int Hin, int Win, int Ca, int N, int ks, int stride, int pad) {
  Conv p{};
  p.a = static_cast<const int8_t*>(a);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.Hin = Hin;
  p.Win = Win;
  p.Ca = Ca;
  p.Ho = (Hin + 2 * pad - ks) / stride + 1;
  p.Wo = (Win + 2 * pad - ks) / stride + 1;
  p.N = N;
  p.K = ks * ks * Ca;
  p.ks = ks;
  p.stride = stride;
  p.pad = pad;
  p.M = B * p.Ho * p.Wo;
  return p;
}

}  // namespace

// One bottleneck of stage 2 or 3. H x W is the block's input size (the
// stage input's on block 0, which strides by 2; the output's after).
//   x:      block 0 only, the (B, H, W, cin) stage input, bf16 (x_bf16) or f32
//   xq:     (B, H, W, cin_j) s8 block input: block 0 writes it from x with
//           inv_in; later blocks read what the block before emitted
//   w1, s1, b1: conv1 (width, cin_j) s8, its scale and bias (conv2's inv_sa folded)
//   w2, s2, b2: conv2 (width, 9 width) s8 [out][tap * width + in] (conv3's folded)
//   w3, s3, b3: conv3 (cout, width) s8
//   wd, sd, bd: block 0's downsample (cout, cin) s8
//   h1, h2: s8 scratch, (B, H, W, width) and (B, Ho, Wo, width)
//   carry:  (B, Ho, Wo, cout) f32, the residual of blocks >= 1 (block 0's
//           downsample writes it) and this block's output unless it is last
//   out:    the block's output: carry, or the stage's (bf16 if out_bf16)
//   xq_next, inv_next: the next block's s8 input and factor, or null (last)
extern "C" int mhent_stage2_int8_block(
    const void* x, void* xq, const void* inv_in, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, const void* w3,
    const void* s3, const void* b3, const void* wd, const void* sd, const void* bd, void* h1,
    void* h2, void* carry, void* out, void* xq_next, const void* inv_next, int x_bf16,
    int out_bf16, int B, int H, int W, int cin, int width, int cout, int first,
    void* stream) {
  if (B < 1 || H < 2 || W < 2 || cin % kBK != 0 || width % 128 != 0 || cout % 128 != 0 ||
      (first && (x == nullptr || wd == nullptr)) || (xq_next != nullptr && inv_next == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err, dev, sms;
  if ((err = (int)cudaGetDevice(&dev)) != 0 ||
      (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return err;
  if (first) {
    const size_t n8 = (size_t)B * H * W * cin / 8;
    const unsigned blocks = (unsigned)((n8 + 255) / 256);
    if (x_bf16)
      quantize_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(inv_in),
          static_cast<int8_t*>(xq), n8);
    else
      quantize_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(inv_in),
                                                    static_cast<int8_t*>(xq), n8);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  const int stride = first ? 2 : 1;
  Conv c1 = make_conv(xq, w1, s1, b1, B, H, W, cin, width, 1, 1, 0);
  c1.out = h1;
  if ((err = conv<kRequant>(c1, sms, s)) != 0) return err;
  Conv c2 = make_conv(h1, w2, s2, b2, B, H, W, width, width, 3, stride, 1);
  c2.out = h2;
  if ((err = conv<kRequant>(c2, sms, s)) != 0) return err;
  if (first) {
    Conv cd = make_conv(xq, wd, sd, bd, B, H, W, cin, cout, 1, 2, 0);
    cd.out = carry;
    if ((err = conv<kAffine>(cd, sms, s)) != 0) return err;
  }
  Conv c3 = make_conv(h2, w3, s3, b3, B, c2.Ho, c2.Wo, width, cout, 1, 1, 0);
  c3.res = static_cast<const float*>(carry);
  c3.out = out;
  c3.out_bf16 = out_bf16;
  c3.q_next = static_cast<int8_t*>(xq_next);
  c3.inv_next = static_cast<const float*>(inv_next);
  return conv<kResidual>(c3, sms, s);
}
