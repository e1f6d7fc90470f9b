// Fused conditional RealNVP sampler for Hopper (sm_90a), bf16 weights.
//
// Replaces mhentropy_tpu/flows/pallas_sampler.py::sample_fused (:191; the
// Pallas `_kernel` at :64, launched by `_fused_transform` at :115).
//
// What it computes: every hypothesis row of every image through all L
// coupling layers (realnvp_cluster.cuh states the function). Activations
// are rounded to bf16 between products, as the TPU kernel held them in
// VMEM; products accumulate in f32; x, the coupling update and the log-det
// stay in f32.
//
// What bounds it on the H100: operations. 2 nets x (Dp H + H H + H Dp)
// multiply-adds a row a layer, 0.62 M at Dp = 48, H = 512: at 1,600 rows
// (B = 8, N = 200) and 12 layers 23.9 GFLOP, 0.024 ms at the dense bf16
// peak. Its 15 MB of bf16 weights fit the 50 MB L2.
//
// The previous design (one 256-thread block per 32 rows of one image, WMMA with
// every B fragment loaded straight from L2, a scalar staged epilogue)
// measured 1.2519 ms eager / 1.2499 ms as a CUDA graph at 1,600 rows (PERF.md
// row 3a, run G) and 1.61 ms of the bench step at 3,200 rows (run V), on an
// H100 80GB HBM3 at 700 W: 56 blocks on 132 SMs (7 at B = 1), each block
// re-reading all the weights for its 32 rows, one SM at about 0.38 TFLOP/s.
//
// This design (realnvp_cluster.cuh): tiles of up to 112 rows flattened
// across images, a cluster of 8 CTAs a tile, each CTA one eighth of every
// hidden product's columns (weights streamed once a cluster through a
// 2-chunk cp.async ring), h1 exchanged between the CTAs' shared memories by
// TMA bulk copies, mma.sync.m16n8k16 fed by ldmatrix from padded or
// swizzled tiles, epilogues on the accumulators. The host plan fills one
// wave of clusters at every main-path row count (200, 1,600, 3,200,
// 12,800). Ablations of the source on the card while it was written put
// its time in chains of dependent latencies (each weight chunk's issue and
// barrier, each h1 exchange, the epilogues' loads, the cluster barriers),
// not in the tensor cores; PERF.md rows 3a and 3b have the times.

#include "realnvp_cluster.cuh"

extern "C" int mhent_realnvp_sample(const void* z0, const void* cproj, const void* masks,
                                    const void* w0, const void* w1, const void* w2,
                                    const void* b0, const void* b1, const void* b2,
                                    void* x_out, void* logdet, int B, int N, int D, int Dp,
                                    int H, int L, int tile_rows, int cluster, void* stream) {
  return launch<Bf16>(z0, cproj, masks, w0, w1, w2, b0, b1, b2, x_out, logdet, B, N, D, Dp, H,
                      L, tile_rows, cluster, stream);
}

// Shared memory a CTA of this shape takes (bytes), or -1 if it is not one
// or does not fit in a CTA's shared memory.
extern "C" int mhent_realnvp_sample_smem(int tile_rows, int Dp, int H, int cluster) {
  return smem_bytes<Bf16>(tile_rows, Dp, H, cluster);
}

// Clusters of this shape resident on the card at once, or -(CUDA error).
extern "C" int mhent_realnvp_sample_clusters(int tile_rows, int Dp, int H, int cluster) {
  return max_clusters<Bf16>(tile_rows, Dp, H, cluster);
}
