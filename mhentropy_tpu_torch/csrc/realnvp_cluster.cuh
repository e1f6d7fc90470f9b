// The thread-block-cluster skeleton shared by the conditional RealNVP
// sampler kernels: realnvp_sampler.cu (bf16 weights, mma.sync bf16) and
// realnvp_sampler_f32.cu (f32 weights, 3xTF32 mma.sync). Each source's
// header says which Pallas kernel it replaces and what bounds it.
//
// What a launch computes: rows = B * N image-major base samples x (D f32,
// padded to Dp with mask = 1) through L coupling layers. Per layer:
// x_m = x * mask; for the s and t nets, h1 = lrelu(x_m W0 + b0 + c0),
// h2 = lrelu(h1 W1 + b1 + c1), o = h2 W2 + b2 (tanh on s), c0 / c1 the
// row's image's conditioning projections; x = x_m + (1 - mask) (x exp(s) + t)
// and logdet += sum(s).
//
// Design:
// - Rows are flattened: a tile is R consecutive rows of the (B * N) row
//   space across image boundaries; each row looks its image up (img[]) for
//   the conditioning projections. R is a multiple of 16, at most 128 (one
//   m16 row tile a warp), chosen by the host plan
//   (flows/cuda_sampler.py::plan) so that one wave of clusters fills the
//   card.
// - A cluster of C CTAs (C = 8 where H allows it) owns one tile. CTA c
//   computes hidden columns [c H/C, (c + 1) H/C) of h1 and h2 and reads only
//   that slice of W0 and W1, and rows [c H/C, ...) of W2: each CTA streams
//   1/C of the weights, the cluster all of them once a tile.
// - h1 is held slice-major: one contiguous block of (R, H / C) a CTA,
//   rows XOR-swizzled by 16-byte chunk. A CTA writes its block from the
//   accumulators, then the TMA unit copies it to each peer as one bulk
//   shared-to-shared copy that completes on the peer's mbarrier. The W1
//   product waits on its mbarrier before the first chunk that needs a peer
//   block; where a weight chunk spans no more than one block (f32), it
//   starts on the CTA's own. h2's slice never leaves the CTA: the
//   output product is split along K, each CTA writes its partial (R, Dp)
//   sums to its own shared memory, and the owner of a row (CTA c owns rows
//   [c R/C, (c + 1) R/C)) sums the C partials in rank order (the same order
//   every run), applies the coupling update and the log-det in f32, and
//   pushes the row's next x_m to every peer. x and the log-det live only at
//   the row's owner. Three cluster barriers a layer: the s net's partials
//   (h1 free again), the t net's partials, the next x_m.
// - Weights stream through a ring of kStages chunks of kChunkK K-rows in
//   shared memory by cp.async, in the fixed order in which the products
//   consume them (per layer and net: W0, W1, W2 slices), one chunk ahead,
//   across products and cluster barriers. Issuing the copies, not waiting
//   for them, is what the ring costs: so the chunks are few and large (128
//   K-rows of bf16, 64 of f32; 4 of half the size measured slower) and the
//   copy addresses cheap (no division in the issue path). One TMA bulk
//   copy a weight row measured slower on the H100.
// - The other tiles are row-padded (pitch = width + 16 bytes, or + 32 bytes
//   for f32 B tiles), so every 8-row ldmatrix phase and every tf32 B
//   fragment read touches each bank once. Each thread loads its epilogue's
//   bias and conditioning values before the K loop; the epilogue adds them
//   to the accumulators in registers and stores pairs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;         // weight chunks in the shared-memory ring
constexpr int kMaxTileRows = 128;  // one m16 row tile a warp
constexpr int kMaxSlice = 64;      // hidden columns a CTA: four n16 tiles a warp
constexpr int kMaxDp = 64;         // padded flow width: four n16 output tiles
constexpr int kSmemLimit = 232448;

struct Params {
  const float* z0;     // (B, N, D) image-major base samples
  const float* cproj;  // (L, 4, B, H): s0, s1, t0, t1 projections
  const float* masks;  // (L, Dp)
  const void* w0;      // (L, 2, Dp, H)   [in, out], net 0 = s, 1 = t
  const void* w1;      // (L, 2, H, H)
  const void* w2;      // (L, 2, H, Dp)
  const float* b0;     // (L, 2, H)
  const float* b1;     // (L, 2, H)
  const float* b2;     // (L, 2, Dp)
  float* x_out;        // (B, N, D)
  float* logdet;       // (B, N)
  int B, N, D, Dp, H, L, R;  // R: rows a cluster tile
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The shared::cluster address of shared address `addr` in cluster CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// `bytes` (a multiple of 16) of this CTA's shared memory into a peer's
// (`dst` and the peer's mbarrier `bar` as shared::cluster addresses) by the
// TMA unit, completing on that mbarrier.
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// An activation tile in shared memory, the A operand of a product. Row-
// padded (`slice` = 0): row r at base + r * pitch. Or h1's slice-major
// layout: C blocks of `block` bytes, one a CTA's columns [c slice,
// (c + 1) slice), rows of `pitch` = slice * size bytes, 16-byte chunk q of
// row r stored at q ^ (r & mask): each block is contiguous, so it crosses
// to a peer as one bulk copy, and 8-row ldmatrix phases stay conflict-free.
struct ATile {
  uint32_t base;
  int pitch, slice, block, mask, shift;  // shift: log2(slice), or -1

  // The byte address of element `col` (16-byte aligned) of row r.
  __device__ __forceinline__ uint32_t addr(int r, int col, int size) const {
    if (slice == 0) return base + r * pitch + col * size;
    const int b = shift >= 0 ? col >> shift : col / slice, k = (col - b * slice) * size;
    return base + b * block + r * pitch + ((((k >> 4) ^ (r & mask)) << 4) | (k & 15));
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float lrelu(float v) { return v > 0.0f ? v : 0.01f * v; }

// bf16 weights and activations, f32 accumulators: mma.sync.m16n8k16 with A
// and B (.trans, from [k][n] tiles) loaded by ldmatrix.
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kChunkK = 128;  // K rows of a staged weight chunk
  static constexpr bool kPreloadB = true;  // a k-step's B fragments before its products
  __host__ __device__ static constexpr int a_pitch(int w) { return w * 2 + 16; }
  __host__ __device__ static constexpr int b_pitch(int w) { return w * 2 + 16; }

  struct A {
    uint32_t r[4];
  };

  // A fragment of rows row0 .. row0 + 15 of tile t, k ka .. ka + 15.
  static __device__ __forceinline__ void load_a(A& a, const ATile& t, int row0, int ka) {
    const int lane = threadIdx.x & 31;
    ldsm_x4(a.r, t.addr(row0 + (lane & 15), ka + 8 * (lane >> 4), 2));
  }

  struct B {
    uint32_t r[4];
  };

  // B fragments of B[kb .. kb + 15][n0 .. n0 + 15] of a [k][n] chunk.
  static __device__ __forceinline__ void load_b(B& f, uint32_t b, int pitch, int kb, int n0) {
    const int lane = threadIdx.x & 31;
    ldsm_x4_t(f.r, b + (kb + (lane & 15)) * pitch + (n0 + 8 * (lane >> 4)) * 2);
  }

  // d[h] += A x B's n8 tile h, h = 0, 1.
  static __device__ __forceinline__ void mma(float (&d)[2][4], const A& a, const B& f) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[h][0]), "+f"(d[h][1]), "+f"(d[h][2]), "+f"(d[h][3])
          : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(f.r[2 * h]),
            "r"(f.r[2 * h + 1]));
  }

  static __device__ __forceinline__ void store2(T* dst, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  }
};

// f32 weights and activations on the tensor cores as 3xTF32: each operand
// is split into a TF32 part and the TF32 rounding of its remainder, and
// a b = a_big b_small + a_small b_big + a_big b_big (the small x small
// term, about 2^-22 relative, is dropped), f32 accumulators.
// mma.sync.m16n8k8; A by ldmatrix (a row of 4 floats is a row of 8 b16),
// B by 32-bit shared loads.
struct Tf32x3 {
  using T = float;
  static constexpr int kChunkK = 64;
  static constexpr bool kPreloadB = false;  // 16 registers a fragment: one at a time
  __host__ __device__ static constexpr int a_pitch(int w) { return w * 4 + 16; }
  __host__ __device__ static constexpr int b_pitch(int w) { return (w + 8) * 4; }

  struct A {
    uint32_t big[2][4], small[2][4];  // the two k8 halves
  };

  static __device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
    const float rest = x - __uint_as_float(big);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
  }

  static __device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  static __device__ __forceinline__ void load_a(A& a, const ATile& t, int row0, int ka) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4];
      ldsm_x4(r, t.addr(row0 + (lane & 15), ka + 8 * h + 4 * (lane >> 4), 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), a.big[h][i], a.small[h][i]);
    }
  }

  struct B {
    uint32_t big[2][2][2], small[2][2][2];  // [n8 tile][k8 half][reg]
  };

  static __device__ __forceinline__ void load_b(B& f, uint32_t b, int pitch, int kb, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          split(lds_f32(b + (kb + 8 * h + 4 * i + t) * pitch + (n0 + 8 * j + g) * 4),
                f.big[j][h][i], f.small[j][h][i]);
  }

  static __device__ __forceinline__ void mma(float (&d)[2][4], const A& a, const B& f) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma8(d[j], a.small[h], f.big[j][h][0], f.big[j][h][1]);
        mma8(d[j], a.big[h], f.small[j][h][0], f.small[j][h][1]);
        mma8(d[j], a.big[h], f.big[j][h][0], f.big[j][h][1]);
      }
    }
  }

  static __device__ __forceinline__ void store2(T* dst, float v0, float v1) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  }
};

// Byte offsets of the shared-memory regions: multiples of 16, the mbarrier
// of 8. The host's launch plan reads `bytes` through the `_smem` C entries
// (tests/test_torch_sampler.py::kernel_smem models it for the CPU tests).
template <class Tr>
struct Layout {
  int slot, h1, h2, xm, os, ot, xo, img, ld, bar, bytes;
  int block, p_h2, p_xm;  // h1's block of one CTA's columns; A-tile pitches (bytes)
  __host__ __device__ Layout(int R, int Dp, int H, int C) {
    const int ns = H / C;
    block = R * ns * (int)sizeof(typename Tr::T);
    p_h2 = Tr::a_pitch(ns);
    p_xm = Tr::a_pitch(Dp);
    const int pb = Tr::b_pitch(ns) > Tr::b_pitch(Dp) ? Tr::b_pitch(ns) : Tr::b_pitch(Dp);
    slot = Tr::kChunkK * pb;
    // ring at 0: (kStages, kChunkK, pb) weight chunks
    h1 = kStages * slot;          // (C, R, H / C) the full h1, slice-major
    h2 = h1 + C * block;          // (R, H / C) this CTA's h2 slice
    xm = h2 + R * p_h2;           // (R, Dp) x_m
    os = xm + R * p_xm;           // (R, Dp) f32 partial s-net output
    ot = os + R * Dp * 4;         // (R, Dp) f32 partial t-net output
    xo = ot + R * Dp * 4;         // (R / C, Dp) f32 x of the owned rows
    img = xo + (R / C) * Dp * 4;  // (R,) image of each row
    ld = img + R * 4;             // (R / C,) log-det of the owned rows
    bar = ld + (R / C) * 4;       // the mbarrier of h1's arrival (R / C is even)
    bytes = bar + 8;
  }
};

__host__ __device__ inline bool valid_shape(int B, int N, int D, int Dp, int H, int L, int R,
                                            int C) {
  return B >= 1 && N >= 1 && D >= 1 && L >= 1 && (long long)B * N < (1LL << 31) &&
         Dp % 16 == 0 && D <= Dp && Dp <= kMaxDp && (C == 1 || C == 2 || C == 4 || C == 8) &&
         H % (16 * C) == 0 && H / C <= kMaxSlice && R % 16 == 0 && R >= 16 &&
         R <= kMaxTileRows;
}

// Which 16-byte pieces of a staged chunk with `pieces` pieces a row this
// thread copies: piece `pc` of rows r0, r0 + step, ... Each warp covers
// 32 / pieces whole rows an instruction, so no thread divides in the loop.
struct CopyLanes {
  int r0, pc, step;
  __device__ CopyLanes(int pieces) {
    const int lane = threadIdx.x & 31, per = 32 / pieces;
    pc = lane % pieces;
    r0 = lane / pieces < per ? (threadIdx.x >> 5) * per + lane / pieces : 1 << 30;
    step = kWarps * per;
  }
};

// The weight chunks in the order the products consume them: per layer and
// net, W0's ceil(Dp / kChunkK), W1's ceil(H / kChunkK) (in K order rotated
// by `rot` chunks: this CTA's own block of h1 first), W2's
// ceil(H / C / kChunkK). issue() starts the cp.async copies of the next
// chunk into its ring slot and commits a group (an empty one past the last
// chunk); every thread calls it in turn.
template <class Tr>
struct ChunkStream {
  using T = typename Tr::T;
  static constexpr int KC = Tr::kChunkK;
  const T *w0, *w1, *w2;
  int H, Dp, cs, ns, n0c, n1c, per_net, rot, left;
  int ln = 0, j = 0;  // the next chunk: layer * 2 + net, index within the net
  CopyLanes hid, out;  // copy lanes of a W0 / W1 chunk (ns wide), a W2 chunk (Dp)

  __device__ ChunkStream(const Params& p, int ns_, int cs_, int rot_)
      : w0(static_cast<const T*>(p.w0)),
        w1(static_cast<const T*>(p.w1)),
        w2(static_cast<const T*>(p.w2)),
        H(p.H),
        Dp(p.Dp),
        cs(cs_),
        ns(ns_),
        n0c((p.Dp + KC - 1) / KC),
        n1c((p.H + KC - 1) / KC),
        per_net(n0c + n1c + (ns_ + KC - 1) / KC),
        rot(rot_),
        left(2 * per_net * p.L),
        hid(ns_ * (int)sizeof(T) / 16),
        out(p.Dp * (int)sizeof(T) / 16) {}

  __device__ __forceinline__ void issue(uint32_t dst) {
    if (left > 0) {
      const T* src;
      int ld, kk;
      bool wide;  // a W2 chunk: Dp columns
      if (j < n0c) {
        const int k0 = j * KC;
        kk = min(KC, Dp - k0);
        src = w0 + ((size_t)ln * Dp + k0) * H + cs;
        ld = H;
        wide = false;
      } else if (j < n0c + n1c) {
        int kc = j - n0c + rot;
        if (kc >= n1c) kc -= n1c;
        const int k0 = kc * KC;
        kk = min(KC, H - k0);
        src = w1 + ((size_t)ln * H + k0) * H + cs;
        ld = H;
        wide = false;
      } else {
        const int k0 = (j - n0c - n1c) * KC;
        kk = min(KC, ns - k0);
        src = w2 + ((size_t)ln * H + cs + k0) * Dp;
        ld = Dp;
        wide = true;
      }
      const int pitch = Tr::b_pitch(wide ? Dp : ns);
      const int r0 = wide ? out.r0 : hid.r0, pc = wide ? out.pc : hid.pc;
      const int step = wide ? out.step : hid.step;
      for (int r = r0; r < kk; r += step)
        cp_async16(dst + r * pitch + pc * 16, src + (size_t)r * ld + pc * (16 / (int)sizeof(T)));
      --left;
      if (++j == per_net) {
        j = 0;
        ++ln;
      }
    }
    cp_async_commit();
  }
};

// (R, ns) = lrelu(A (R, K) x the next ceil(K / kChunkK) ring chunks + the
// addends add(row, col)), handed to st(row, col, v, v_next_col) in column
// pairs. The chunks arrive in K order rotated by `rot` (the stream's
// order); gate() runs once before chunk `gate_at` is used (-1: never).
// Each thread loads its addends before the K loop, so their latency hides
// behind the products. Warps split the m16 row tiles first, then the n16
// column tiles. Every thread calls it.
template <class Tr, class Next, class Gate, class Add, class Store>
__device__ __forceinline__ void hidden_product(const ATile& at, int K, int rot, int gate_at,
                                               Gate& gate, int R, int ns, Next& next, Add add,
                                               Store st) {
  constexpr int KC = Tr::kChunkK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = R / 16, ws = kWarps / mt;
  const int mi = warp / ws, part = warp % ws;
  const int nt = ns / 16, per = (nt + ws - 1) / ws, j0 = part * per;
  const int jn = mi < mt ? min(per, nt - j0) : 0;
  const int b_pitch = Tr::b_pitch(ns);
  float2 addend[4][2][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < jn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (j0 + j) * 16 + 8 * h + 2 * t;
        addend[j][h][0] = add(mi * 16 + g, col);
        addend[j][h][1] = add(mi * 16 + g + 8, col);
      }
    }
  }
  float acc[4][2][4] = {};
  const int chunks = (K + KC - 1) / KC;
  for (int it = 0; it < chunks; ++it) {
    const uint32_t b = next();
    if (it == gate_at) gate();
    const int k0 = ((it + rot) % chunks) * KC, kk = min(KC, K - k0);
    if (jn > 0) {
#pragma unroll
      for (int kb = 0; kb < KC; kb += 16) {
        if (kb < kk) {
          typename Tr::A a;
          typename Tr::B f[4];
          Tr::load_a(a, at, mi * 16, k0 + kb);
          if (Tr::kPreloadB) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < jn) Tr::load_b(f[j], b, b_pitch, kb, (j0 + j) * 16);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < jn) Tr::mma(acc[j], a, f[j]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j < jn) {
                Tr::load_b(f[0], b, b_pitch, kb, (j0 + j) * 16);
                Tr::mma(acc[j], a, f[0]);
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < jn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (j0 + j) * 16 + 8 * h + 2 * t;
        const float2 u = addend[j][h][0], v = addend[j][h][1];
        st(mi * 16 + g, col, lrelu(acc[j][h][0] + u.x), lrelu(acc[j][h][1] + u.y));
        st(mi * 16 + g + 8, col, lrelu(acc[j][h][2] + v.x), lrelu(acc[j][h][3] + v.y));
      }
    }
  }
}

// o (R, Dp) f32 = h2 slice (R, ns) x W2 rows of the slice (the next
// ceil(ns / kChunkK) ring chunks). Warps take the 16 x 16 output tiles in
// turn. Every thread calls it.
template <class Tr, class Next>
__device__ __forceinline__ void output_product(const ATile& at, int ns, int R, int Dp,
                                               Next& next, float* o) {
  constexpr int KC = Tr::kChunkK;
  const int warp = threadIdx.x >> 5;
  const int nd = Dp / 16, units = (R / 16) * nd;
  const int b_pitch = Tr::b_pitch(Dp);
  float acc[4][2][4] = {};
  for (int k0 = 0; k0 < ns; k0 += KC) {
    const uint32_t b = next();
    const int kk = min(KC, ns - k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = warp + kWarps * i;
      if (u < units) {
#pragma unroll
        for (int kb = 0; kb < KC; kb += 16) {
          if (kb < kk) {
            typename Tr::A a;
            typename Tr::B f;
            Tr::load_a(a, at, (u / nd) * 16, k0 + kb);
            Tr::load_b(f, b, b_pitch, kb, (u % nd) * 16);
            Tr::mma(acc[i], a, f);
          }
        }
      }
    }
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = warp + kWarps * i;
    if (u < units) {
      const int r = (u / nd) * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (u % nd) * 16 + 8 * h + 2 * t;
        *reinterpret_cast<float2*>(o + r * Dp + col) = make_float2(acc[i][h][0], acc[i][h][1]);
        *reinterpret_cast<float2*>(o + (r + 8) * Dp + col) =
            make_float2(acc[i][h][2], acc[i][h][3]);
      }
    }
  }
}

template <class Tr>
__global__ void __launch_bounds__(kThreads, 1) realnvp_sample_kernel(const Params p) {
  using T = typename Tr::T;
  constexpr int KC = Tr::kChunkK;
  constexpr int kSize = (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int R = p.R, H = p.H, Dp = p.Dp, ns = H / C, cs = rank * ns;
  const int ro = R / C, own0 = rank * ro;  // rows this CTA owns
  const int rows = p.B * p.N;
  const int row0 = (int)(blockIdx.x / C) * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout<Tr> lay(R, Dp, H, C);
  const uint32_t s0 = smem_u32(smem);
  int* img = reinterpret_cast<int*>(smem + lay.img);
  float* xo = reinterpret_cast<float*>(smem + lay.xo);
  float* ld = reinterpret_cast<float*>(smem + lay.ld);
  const float* o_s = reinterpret_cast<const float*>(smem + lay.os);
  const float* o_t = reinterpret_cast<const float*>(smem + lay.ot);
  T* h2 = reinterpret_cast<T*>(smem + lay.h2);
  const int e_h2 = lay.p_h2 / kSize;
  const int chunks16 = ns * kSize / 16;  // 16-byte chunks of an h1 row
  const ATile t_xm{s0 + (uint32_t)lay.xm, lay.p_xm, 0, 0, 0, 0};
  const ATile t_h2{s0 + (uint32_t)lay.h2, lay.p_h2, 0, 0, 0, 0};
  const ATile t_h1{s0 + (uint32_t)lay.h1, ns * kSize, ns, lay.block,
                   (chunks16 & (chunks16 - 1)) == 0 ? min(chunks16, 8) - 1 : 0,
                   (ns & (ns - 1)) == 0 ? __ffs(ns) - 1 : -1};
  const uint32_t own_block = s0 + lay.h1 + rank * lay.block, h1_bar = s0 + lay.bar;

  // The weight ring: chunk q lands in slot q % kStages, kStages - 1 ahead.
  // W1's chunks start at this CTA's own columns of h1 where a chunk holds
  // whole slices, so the product starts before the peers' slices arrive.
  const int n1c = (H + KC - 1) / KC;
  const int own = ns % KC == 0 ? ns / KC : 0;  // W1 chunks of this CTA's own slice
  const int rot = ns % KC == 0 ? rank * own : 0;
  ChunkStream<Tr> stream(p, ns, cs, rot);
  int slot = 0;  // the ring slot of the chunk consumed next
  auto next = [&]() -> uint32_t {
    cp_async_wait<kStages - 2>();  // its copies have landed (this thread's)
    __syncthreads();               // ... everyone's; and the previous slot is free
    stream.issue(s0 + (slot == 0 ? kStages - 1 : slot - 1) * lay.slot);
    const uint32_t b = s0 + slot * lay.slot;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    return b;
  };
  for (int c = 0; c < kStages - 1; ++c) stream.issue(s0 + c * lay.slot);
  int exchange = 0;  // h1 exchanges so far: the arrival mbarrier's phase
  auto h1_arrived = [&]() {
    if (C > 1) mbar_wait(h1_bar, exchange & 1);
  };
  auto no_gate = []() {};

  // x_m of owned row r (columns d, d + 1) into every CTA of the cluster.
  auto push_xm = [&](int r, int d, float v0, float v1) {
    T* local = reinterpret_cast<T*>(smem + lay.xm + r * lay.p_xm) + d;
    for (int c = 0; c < C; ++c) Tr::store2(cluster.map_shared_rank(local, c), v0, v1);
  };

  if (tid == 0) {
    mbar_init(h1_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = tid; r < R; r += kThreads) img[r] = min(row0 + r, rows - 1) / p.N;
  for (int e = tid; e < ro * Dp; e += kThreads) {
    const int j = e / Dp, d = e % Dp, g = row0 + own0 + j;
    xo[e] = (g < rows && d < p.D) ? p.z0[(size_t)g * p.D + d] : 0.0f;
  }
  for (int j = tid; j < ro; j += kThreads) ld[j] = 0.0f;
  cluster.sync();  // every CTA of the cluster runs, its mbarrier ready
  for (int j = warp; j < ro; j += kWarps)
    for (int d = 2 * lane; d < Dp; d += 64)
      push_xm(own0 + j, d, xo[j * Dp + d] * p.masks[d], xo[j * Dp + d + 1] * p.masks[d + 1]);
  cluster.sync();

  for (int l = 0; l < p.L; ++l) {
    for (int net = 0; net < 2; ++net) {
      const size_t ln = (size_t)l * 2 + net;
      const float* c0 = p.cproj + ((size_t)l * 4 + 2 * net) * p.B * H + cs;
      const float* c1 = c0 + (size_t)p.B * H;
      const float* bias0 = p.b0 + ln * H + cs;
      const float* bias1 = p.b1 + ln * H + cs;
      if (tid == 0 && C > 1) mbar_expect_tx(h1_bar, (C - 1) * lay.block);
      // This CTA's columns of h1, then its block to every peer.
      hidden_product<Tr>(
          t_xm, Dp, 0, -1, no_gate, R, ns, next,
          [&](int r, int c) {
            const float2 b = *reinterpret_cast<const float2*>(bias0 + c);
            const float2 k = *reinterpret_cast<const float2*>(c0 + (size_t)img[r] * H + c);
            return make_float2(b.x + k.x, b.y + k.y);
          },
          [&](int r, int c, float v0, float v1) {
            Tr::store2(reinterpret_cast<T*>(smem + (t_h1.addr(r, cs + c, kSize) - s0)), v0, v1);
          });
      // Every thread's h1 stores made visible to the async proxy (the bulk
      // copies read them) before the barrier after which they are issued.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (warp == 0 && lane + 1 < C) {
        const int peer = (rank + 1 + lane) % C;
        bulk_to_peer(mapa(own_block, peer), own_block, lay.block, mapa(h1_bar, peer));
      }
      // This CTA's h2 slice (own block of h1 first, then the peers'), then
      // its partial output sums.
      hidden_product<Tr>(
          t_h1, H, rot, own, h1_arrived, R, ns, next,
          [&](int r, int c) {
            const float2 b = *reinterpret_cast<const float2*>(bias1 + c);
            const float2 k = *reinterpret_cast<const float2*>(c1 + (size_t)img[r] * H + c);
            return make_float2(b.x + k.x, b.y + k.y);
          },
          [&](int r, int c, float v0, float v1) { Tr::store2(h2 + r * e_h2 + c, v0, v1); });
      ++exchange;
      output_product<Tr>(t_h2, ns, R, Dp, next,
                         reinterpret_cast<float*>(smem + (net ? lay.ot : lay.os)));
      cluster.sync();  // partials complete; every peer is done with h1
    }
    // Owned rows: sum the C partials in rank order, couple, log-det, and the
    // next layer's x_m to every CTA. One warp a row, two columns a lane.
    const float* mask = p.masks + (size_t)l * Dp;
    const float* b2s = p.b2 + (size_t)l * 2 * Dp;
    const float* b2t = b2s + Dp;
    for (int j = warp; j < ro; j += kWarps) {
      const int r = own0 + j;
      float sum = 0.0f;
      for (int d = 2 * lane; d < Dp; d += 64) {
        float2 pa[8], pb[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c < C) {
            pa[c] = *cluster.map_shared_rank(
                reinterpret_cast<const float2*>(o_s + r * Dp + d), c);
            pb[c] = *cluster.map_shared_rank(
                reinterpret_cast<const float2*>(o_t + r * Dp + d), c);
          }
        }
        float so[2] = {0.0f, 0.0f}, to[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c < C) {
            so[0] += pa[c].x;
            so[1] += pa[c].y;
            to[0] += pb[c].x;
            to[1] += pb[c].y;
          }
        }
        float xn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = mask[d + e], inv = 1.0f - m;
          const float s = tanhf(so[e] + b2s[d + e]) * inv;
          const float t = (to[e] + b2t[d + e]) * inv;
          const float xv = xo[j * Dp + d + e];
          xn[e] = xv * m + inv * (xv * expf(s) + t);
          xo[j * Dp + d + e] = xn[e];
          sum += s;
        }
        if (l + 1 < p.L) push_xm(r, d, xn[0] * mask[Dp + d], xn[1] * mask[Dp + d + 1]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) ld[j] += sum;
    }
    cluster.sync();  // x_m complete; no peer reads this CTA's partials any more
  }

  for (int e = tid; e < ro * p.D; e += kThreads) {
    const int j = e / p.D, d = e % p.D, g = row0 + own0 + j;
    if (g < rows) p.x_out[(size_t)g * p.D + d] = xo[j * Dp + d];
  }
  for (int j = tid; j < ro; j += kThreads) {
    const int g = row0 + own0 + j;
    if (g < rows) p.logdet[g] = ld[j];
  }
}

template <class Tr>
int smem_bytes(int R, int Dp, int H, int C) {
  if (!valid_shape(1, 1, 1, Dp, H, 1, R, C)) return -1;
  const int bytes = Layout<Tr>(R, Dp, H, C).bytes;
  return bytes <= kSmemLimit ? bytes : -1;
}

template <class Tr>
cudaLaunchConfig_t launch_config(int R, int Dp, int H, int C, int tiles, void* stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<Tr>(R, Dp, H, C).bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C CTAs that fit on the card at once at this shape (>= 0), or
// -(the CUDA error).
template <class Tr>
int max_clusters(int R, int Dp, int H, int C) {
  const int bytes = smem_bytes<Tr>(R, Dp, H, C);
  if (bytes < 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(realnvp_sample_kernel<Tr>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<Tr>(R, Dp, H, C, 1, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, realnvp_sample_kernel<Tr>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <class Tr>
int launch(const void* z0, const void* cproj, const void* masks, const void* w0,
           const void* w1, const void* w2, const void* b0, const void* b1, const void* b2,
           void* x_out, void* logdet, int B, int N, int D, int Dp, int H, int L, int R, int C,
           void* stream) {
  if (!valid_shape(B, N, D, Dp, H, L, R, C)) return (int)cudaErrorInvalidValue;
  const int bytes = Layout<Tr>(R, Dp, H, C).bytes;
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  Params p;
  p.z0 = static_cast<const float*>(z0);
  p.cproj = static_cast<const float*>(cproj);
  p.masks = static_cast<const float*>(masks);
  p.w0 = w0;
  p.w1 = w1;
  p.w2 = w2;
  p.b0 = static_cast<const float*>(b0);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.x_out = static_cast<float*>(x_out);
  p.logdet = static_cast<float*>(logdet);
  p.B = B;
  p.N = N;
  p.D = D;
  p.Dp = Dp;
  p.H = H;
  p.L = L;
  p.R = R;
  cudaError_t err = cudaFuncSetAttribute(realnvp_sample_kernel<Tr>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B * N + R - 1) / R;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<Tr>(R, Dp, H, C, tiles, stream, attr);
  err = cudaLaunchKernelEx(&cfg, realnvp_sample_kernel<Tr>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
