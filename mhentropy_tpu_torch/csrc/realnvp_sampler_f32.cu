// Conditional RealNVP transform with f32 weights for Hopper (sm_90a): the
// forward of the differentiable hypothesis draw.
//
// Replaces mhentropy_tpu/flows/pallas_sampler.py::_kernel_transform (:304),
// the f32-weight launch of the Pallas `_kernel` (:64) that
// `sample_fused_diff` (:338) / `transform_diff` (:288) run under their
// custom VJP. The backward recomputes the plain f32 flow (as `_transform_bwd`
// :327 reruns the XLA scan), so this forward must agree with that flow to
// f32 rounding: one-pass TF32 (10 mantissa bits) would make the loss and
// its gradient describe different functions. It uses 3xTF32 on the tensor
// cores (realnvp_cluster.cuh, `Tf32x3`): about f32's accuracy, the
// dropped small x small term about 2^-22 of each product.
//
// What it computes: the function of realnvp_cluster.cuh with h1, h2 and
// x_m held in f32.
//
// What bounds it on the H100: operations. 0.62 M multiply-adds a row a
// layer at Dp = 48, H = 512; at 640 rows (B = 64, N = 10) and 12 layers
// 9.6 GFLOP, run as 3 TF32 products each: 28.7 GFLOP at 495 TFLOP/s,
// 0.058 ms (0.143 ms for the same work at the 67 TFLOP/s f32 FFMA peak).
// Its 30 MB of f32 weights fit the 50 MB L2.
//
// The previous design (one block per 8 flattened rows, f32 FFMA, weights
// staged by cp.async two tiles deep) measured 1.2550 ms eager / 1.2543 ms
// as a CUDA graph at 640 rows (PERF.md row 3b, run G, H100 80GB HBM3,
// 700 W): 80 blocks each streaming all 30 MB of weights for 8 rows, about
// 2.4 GB of L2 reads a launch at 4 FLOP a byte, bound by L2 bandwidth.
//
// This design: the cluster skeleton of realnvp_cluster.cuh with tiles of
// up to 64 rows (48 at 640 rows: 14 clusters of 8 CTAs), so every cluster
// reads the weights once for its whole tile, an eighth a CTA; the products
// on the tensor cores as 3xTF32.

#include "realnvp_cluster.cuh"

extern "C" int mhent_realnvp_sample_f32(const void* z0, const void* cproj, const void* masks,
                                        const void* w0, const void* w1, const void* w2,
                                        const void* b0, const void* b1, const void* b2,
                                        void* x_out, void* logdet, int B, int N, int D, int Dp,
                                        int H, int L, int tile_rows, int cluster,
                                        void* stream) {
  return launch<Tf32x3>(z0, cproj, masks, w0, w1, w2, b0, b1, b2, x_out, logdet, B, N, D, Dp,
                        H, L, tile_rows, cluster, stream);
}

extern "C" int mhent_realnvp_sample_f32_smem(int tile_rows, int Dp, int H, int cluster) {
  return smem_bytes<Tf32x3>(tile_rows, Dp, H, cluster);
}

extern "C" int mhent_realnvp_sample_f32_clusters(int tile_rows, int Dp, int H, int cluster) {
  return max_clusters<Tf32x3>(tile_rows, Dp, H, cluster);
}
