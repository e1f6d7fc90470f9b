// W8A8 fused conditional RealNVP sampler for Hopper (sm_90a).
//
// Replaces mhentropy_tpu/flows/pallas_sampler_int8.py::sample_fused_q (the
// Pallas `_kernel` at :278, launched by `_fused_transform_q` at :333).
//
// What it computes: every hypothesis row of every image through all L
// coupling layers with the quantised arithmetic of `_quant_layer` (:211):
//   xq = clip(rint(x * qm), +-127)                    (x * mask, quantised)
//   h1 = q(lrelu(acc(xq W0) * e0 + c0))               c0, c1: the image's
//   h2 = q(lrelu(acc(h1 W1) * e1 + c1))               pre-scaled cond cache
//   o  = acc(h2 W2) * e2 + b2  (tanh on the s net)
//   x  = x * mask + (1 - mask) * (x * exp(s) + t),  logdet += sum(s)
// with s8 x s8 -> s32 products and every epilogue multiply and add rounded
// on its own (no FMA contraction), as the XLA emulation `xla_forward_q`
// computes them. x, exp(s) and the log-det are f32.
//
// What bounds it on the H100: operations. Per row and layer the six GEMMs
// are 2 x (Dp x H + H x H + H x Dp) MACs, 0.66 M at Dp = 64 and H = 512; at
// B = 8, N = 200, L = 12 that is 25 GOP, 13 us at the 1,979 TOP/s int8
// peak, against 8 MB of int8 weights (2.4 us at 3.35 TB/s).
//
// The previous design (one 256-thread block per 32 rows of one image, every
// B fragment a 32-bit load from L2, scalar A loads, byte stores, a serial
// log-det) measured 1.0023 ms eager / 1.0022 ms as a CUDA graph at 1,600
// rows (PERF.md row 6, H100 80GB HBM3, 700 W): 56 blocks on 132 SMs, each
// streaming all 7.9 MB of weights from L2 for its 32 rows.
//
// This design: the cluster skeleton of realnvp_cluster.cuh with its `S8`
// traits. Rows flattened across images; a cluster of 8 CTAs a tile, each
// CTA one eighth of every hidden product's columns, so each cluster
// streams the weights once a tile, [n][k] chunks through the cp.async
// ring; h1 exchanged between the CTAs by TMA bulk copies;
// mma.sync.m16n8k32.s8 fed by plain ldmatrix from shared memory; the
// owner of a row sums the s32 partial outputs in rank order, couples in
// f32 and pushes the next xq to its peers. One CTA of 16 warps an SM,
// tiles of up to 128 rows (191 KB of shared memory a CTA at H = 512,
// Dp = 64); `cuda_sampler.plan` (through flows/cuda_sampler_int8.py::
// launch_plan) sizes them to fill each wave of 15 clusters. Like the bf16
// kernel's, its time goes to a chain of latencies a layer (weight-chunk
// hand-offs, the h1 exchange, three cluster barriers, the warps' fragment
// loads and mma chains), not to the tensor cores' rate: PERF.md row 6 has
// the times and the variants measured and rejected.

#include "realnvp_cluster.cuh"

extern "C" int mhent_realnvp_sample_q(const void* z0, const void* cq, const void* masks,
                                      const void* qm, const void* w0, const void* w1,
                                      const void* w2, const void* e0, const void* e1,
                                      const void* e2, const void* b2, void* x_out,
                                      void* logdet, int B, int N, int D, int Dp, int H, int L,
                                      int tile_rows, int cluster, void* stream) {
  Params p = {};
  p.z0 = static_cast<const float*>(z0);
  p.cproj = static_cast<const float*>(cq);
  p.masks = static_cast<const float*>(masks);
  p.qm = static_cast<const float*>(qm);
  p.w0 = w0;
  p.w1 = w1;
  p.w2 = w2;
  p.e0 = static_cast<const float*>(e0);
  p.e1 = static_cast<const float*>(e1);
  p.e2 = static_cast<const float*>(e2);
  p.b2 = static_cast<const float*>(b2);
  p.x_out = static_cast<float*>(x_out);
  p.logdet = static_cast<float*>(logdet);
  p.B = B;
  p.N = N;
  p.D = D;
  p.Dp = Dp;
  p.H = H;
  p.L = L;
  return launch_params<S8>(p, tile_rows, cluster, stream);
}

// Shared memory a CTA of this shape takes (bytes), or -1 if it is not one
// or does not fit in a CTA's shared memory.
extern "C" int mhent_realnvp_sample_q_smem(int tile_rows, int Dp, int H, int cluster) {
  return smem_bytes<S8>(tile_rows, Dp, H, cluster);
}

// Clusters of this shape resident on the card at once, or -(CUDA error).
extern "C" int mhent_realnvp_sample_q_clusters(int tile_rows, int Dp, int H, int cluster) {
  return max_clusters<S8>(tile_rows, Dp, H, cluster);
}
