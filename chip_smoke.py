#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mhentropy_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit).
2. Builds the CUDA kernels from mhentropy_tpu_torch/csrc/ (one nvcc per
   source, in parallel, sm_90a) and prints the sources whose build log has
   ptxas serializing a wgmma (C7515 / C7517 / C7518): a report, which fails
   the run only for stage2_int8.cu; then `cuobjdump -sass` of the library:
   every conv kernel of stage2_int8.cu issues s8 wgmma (IGMMA), none
   mma.sync (IMMA).
3. Runs each kernel against its plain PyTorch version on the card at the
   main path's shapes with random weights of realistic magnitude: stem
   (8, 256, 256, 3) and the bench's (32, 256, 256, 3); stage 1
   (8, 64, 64, 64) and (32, 64, 64, 64); each of the two and int8
   stage 1 also at the ProHMR path's 224 px (56 x 56 after the stem) at
   B=8 and B=32, the stem's and stage 1's plain (cuDNN) graph time as
   their `library_graph_ms`; bf16 sampler at L=12, H=512 and B=8, N=200 (the
   line), B=1, N=200, B=32, N=100 and B=64, N=200, each with its launch
   plan; LBS blend at
   12,800 rows (N=200, B=64) on MANO (V=778, J=16) and at 3,200 rows
   (N=100, B=32) on SMPL (V=6,890, J=24); int8
   stage 1 (8, 64, 64, 64), (32, 64, 64, 64) and (64, 64, 64, 64) on sites
   calibrated from a He-initialised resnet50 with random BN; int8 sampler
   B=8, N=200 (and B=32, N=100; B=64, N=200), L=12, H=512 on an O(1) flow,
   each with its launch plan; after the kernels of 8, the Glow sampler at B=32, N=100, D=144,
   H=1024, 4 layers (ProHMR) and at B=8, N=200, D=45, H=512 (the MHEnt
   Glow) on O(1) flows, x and the log-det each against its tolerance (max-
   and mean-abs), with a torch.profiler breakdown of its launches and
   torch.matmul on one (rows, H) x (H, H) bf16 product beside each shape
   as its per-stage yardstick (`library_stage_graph_ms`); the
   opt-in int8 kernels on a He-initialised resnet50 with random BN,
   calibrated (int8_stem, pallas_mid, q_from 1) on 8 and on 32 random
   256 px images: the int8 stem (the bf16 stem kernel's graph time beside
   it), stages 2 and 3 on the float stem and stage 1's output (the
   `torch._int_mm` walk of the same stage beside them); the int8-vs-bf16
   GEMM probe at (32768, 640) x (640, 512), its `lower` run first (one
   launch each), each side against its plain version and its library call
   (torch._int_mm, bf16 torch.matmul); the stem and stage-1 probes (each
   probe's `check` run first, its launches counted): the im2col + GEMM stem
   envelope on f32 planes (32, 6, 264, 128), its four cuts (rolls, im2col,
   gemm, full) on bf16 planes at 128 and 64 conv rows, beside cuDNN's stem
   and the stem kernel at (32, 256, 256, 3); stage-1 probes A (pixel-major)
   and B (channel-major) at (32, 64, 64, 64) beside cuDNN's stage 1 and the
   stage-1 kernel. Each error is held to its stated
   tolerance, and each pair is timed with CUDA events: RUNS windows of at
   least KERNEL_WINDOW_S seconds (NEW_WINDOW_S for the opt-in int8
   kernels), kernel and plain alternating, called eagerly (ms, plain_ms)
   and as CUDA-graph replays (graph_ms, plain_graph_ms). `bound_ms` is
   computed from the shapes (bytes over 3.35 TB/s, operations over the
   peak of their type).
4. Float serving: configs/ho3d.yaml (resnet50 at 256 px, 12x512 RealNVP,
   N=200, fresh seeded weights, synthetic MANO) through InferenceServer and
   its HTTP front end (GET /healthz, POST /predict at B=1 u8, B=3 f32, B=8
   u8), then B=8 and B=1 request latency, then kernel path vs plain path on
   one batch under an O(1) flow.
5. int8 serving: InferenceServer(quantize=True, max_batch=8): a B=8 request
   (int8 bucket) and a B=1 request (float bucket), each with its launches;
   B=8 int8 latency; int8 vs float on one batch under an O(1) flow.
5b. The opt-in int8 path: mhent.sample_hypotheses(quant=) at B=8, N=200 on
   configs/ho3d.yaml with QuantSpec(int8_stem=True, pallas_mid=True) at
   q_from 0 and 1, calibrated on that batch: launches int8 stem 1, bf16
   stem 0, the stage kernel 10 (one a bottleneck, stages 2 and 3), int8
   stage 1 3 (q_from 0) or stage 1 3 (q_from 1), int8 sampler 1 and no
   others; xyz and uv against the default int8 spec on the same images,
   base noise and sampler tree within INT8_TOL. bench_quant's steps at
   B=32, N=100 (q_from 1): bf16, int8, int8 + mid, int8 + int8 stem and
   both in alternating windows of BENCH_QUANT_STEPS steps, hypotheses/s,
   with a torch.profiler trace of the int8, int8 + mid and int8 + int8
   stem steps.
5c. Export (mhentropy_tpu_torch/export.py): configs/ho3d.yaml at full width,
   B=8, N=200, mods xyz, uv and verts, as four artifacts: float, int8
   (encoder and int8 sampler, calibrated as serve.py does), the two opt-ins
   (int8_stem, pallas_mid, q_from 0) and the glow MHEnt; each exported,
   saved to bytes, loaded and called: its launches equal the live
   sampler's (and the counted numbers, none 0), its outputs equal the live
   sampler's within SLICE_TOL, and both are timed in alternating windows
   with a trace of each (busy share); a CUDA artifact called with CPU
   inputs raises; the phase within EXPORT_PHASE_S.
6. Eval: the port's run.py path (Experiment.train_baseline with epochs 0)
   on configs/ho3d.yaml: the synthetic eval split of 128 at 256 px, B=64,
   N=200, float and with tpu.quantize_encoder; every metric finite; the
   launches of each run; ms per eval batch and hypotheses/s.
   The reverse-KL draw runs the f32 sampler kernel; the float eval step is
   also timed with that draw on the plain f32 flow (the routing before the
   f32 kernel existed), in alternating windows.
7. Verts: mhent.sample_hypotheses with its default mods at B=64, N=200
   launches the LBS blend; its vertices against the plain blend's.
   ProHMR: eval_prohmr at B=8, N=100 (resnet50 at 224 px, the
   ConditionalGlow(144, 1024, 4, 2, context 2048), the 6,890-vertex SMPL
   fixture, fresh seeded weights): every metric finite, launches stem 1,
   stage 1 3, Glow 1, LBS 1; the kernel path against the plain path and
   int8 against float on that batch (joints3d, uv, log q); bench_prohmr's
   steps at B=32, N=100 for the kernel, plain and int8 variants in
   alternating windows (ms per step, hypotheses/s), and the peak memory.
8. BN sums: the stats and grad kernels against their plain versions at
   (64, 128, 128, 64) and (64, 8, 8, 2048) bf16 channels-last, timed as in
   3, with torch.batch_norm_stats / torch.batch_norm_backward_reduce as the
   library yardsticks. f32 sampler: the kernel against transform_plain at
   B=64, N=10, L=12, H=512 and at a ragged B=7, N=93 on an O(1) flow (its
   bound counts the three TF32 products of each f32 one at 495 TFLOP/s),
   and the autograd Function's gradients against plain autograd.
9. Train: the run.py path (Experiment.train_baseline) on configs/rhd.yaml
   with training.epochs 1 (initial eval at N=100, 4 train steps at B=64,
   N=10, checkpoints) with tpu.fused_train_bn false and "full": finite
   losses, the checkpoint reloads, each kernel launched the counted number
   of times; one train step with kernels against the plain path (loss,
   gradient cosines, running statistics; in bf16 beside the plain path run
   twice, and in f32); ms per train step for kernels +
   "stats", kernels + "full" and the plain path in alternating windows;
   a torch.profiler trace of a few steps (device busy share, top ops).
9b. RLE: the run.py path (Experiment.train_baseline) on configs/rhd_rle.yaml
   with training.epochs 1 (the initial eval's 2 batches at B=64, 4 train
   steps, checkpoints; resnet50 at 256 px, the per-joint RealNVP of dim 3,
   H=256, 12 layers, K1=10, nf_res rle): finite losses and metrics, the
   checkpoint reloads, launches stem 2, stage 1 6, BN stats sums 4 x 53 and
   no other; then from one copy of its weights, kernels against the plain
   path on the same batch and draws: one step (loss, log p, running
   statistics; in f32 every parameter's gradient against float64, a
   check that the planted BN-sum faults of RLE_F32_FAULTS must fail),
   RLE_STEPS make_rle_train_step steps' losses and launches, and one eval
   batch (metrics, log p, draws) on the kernel-trained weights; ms per
   train step and per eval batch, kernels and plain in alternating
   windows; a trace of TRACED train steps of each (device busy share,
   time by layer, top ops).
9c. det: MHEnt with the det regressor at configs/ho3d.yaml's widths:
   sample_hypotheses at B=8, N=200 with the mesh (launches stem 1, stage 1
   3, LBS 1) and one train step at B=64 (BN stats sums 53), each against
   the plain path; ms per call, in alternating windows; a trace of each
   train step.
9d. The port's bench (mhentropy_tpu_torch/bench.py) at N=100, B=32 with
   BENCH_STEPS steps a round: the headline hypotheses/s, mfu, every
   section of bench.py (none may fail), the device time by layer.
9e. Loaders: which of Pillow, cv2 and imageio import (decided once, up
   front); an RHD tree (LOADER_RHD train / eval items at 320 x 320), a
   FreiHAND tree and, where cv2 imports, an HO3D tree, written by
   mhentropy_tpu_torch/data/fixtures.py (without Pillow, every image also
   into the decode cache, tpu.decode_cache); then run.py's path
   (Experiment.train_baseline, tpu.data_dir at the tree, training.epochs 1)
   on configs/rhd.yaml (its eval alone without Pillow: the train mode's
   hue jitter needs it), configs/freihand.yaml and, with cv2,
   configs/ho3d.yaml and configs/rhd.yaml as mixed_ho3d_rhd: finite losses
   and metrics, every kernel's launches equal to the counted numbers, the
   checkpoint reloads; the first train run's first loader batch through one
   step with kernels and the plain path (held as in 9); host items/s of the
   train loader plain and through the prefix cache and of the eval loader
   plain and through the sample cache (LOADER_THREADS threads), and ms per
   train step fed by the loader through prefetch against pre-staged
   synthetic batches, alternating windows, with the busy share of each.
9f. Glow: the glow MHEnt that Experiment builds from configs/rhd.yaml with
   network.regressor glow (resnet50 at 256 px, feature 512,
   ConditionalGlow(45, 512, 4, 2), dropout 0.2): 3 train steps at B=64,
   N=10 (losses kernels against plain; launches a step: BN stats sums 53,
   no sampler kernel of any kind) and one eval batch at B=64, N=200
   (launches stem 1, stage 1 3, Glow 1, no RealNVP sampler; every metric
   against plain), ms of each in alternating windows; the Glow kernel
   alone at the eval batch's 12,800 rows (as in 3, a side line of the
   glow_sampler entry); ProHMR's nll_loss forward and backward at B=32
   (every gradient finite, kernels on and off); run.py's path twice in one
   model_dir (configs/smoke.yaml as a glow MHEnt, 1 epoch, then 2 with
   tpu.autoresume: resumed at epoch 1, twice the steps, both runs' log and
   scalars); the learning demo at its defaults (BH-MPJPE must fall); the
   phase within 90 s.
9g. Render and mask likelihood: configs/ho3d.yaml's sample_hypotheses at
   B=64, N=200, then decode with the "m" and "depth" mods of its 12,800
   rows (launches stem 1, stage 1 3, bf16 sampler 1, LBS 1): the masks in
   [0, 1] and covering their projected vertices, the render against a
   float64 evaluation on the CPU (RENDER_TOL), what it allocates at 12,800
   rows and, forward and backward, at a train step's 640 (RENDER_MEM_GB),
   its ms eager and as a CUDA graph beside its bound; then run.py's path
   with network.use_mask_loss on 9e's RHD tree (configs/rhd.yaml, one epoch)
   and, where cv2 imports, its HO3D tree (configs/ho3d.yaml, hand_mask at
   256 px): every objective's log p(m | z) present, finite and not 0, the
   launches of 9e and no LBS, the checkpoint reloads; one mask train step
   kernels against plain (bf16 loss, f32 gradient cosines; BN stats sums
   53, f32 sampler 1, LBS 0 a step) and with the term off (the flow's
   gradients move); one mask eval batch (stem 1, stage 1 3, bf16 sampler 1,
   f32 sampler 1); ms a train step with and without the term in
   alternating windows, a trace of each (busy share, the term's share of
   device time); the phase within 90 s.
9h. Parallel (`phase_parallel`): 2 processes on cuda:0 joined under gloo
   (the card's machine has one H100, and NCCL refuses two ranks on one
   device; gloo's all-gather, send and recv of a CUDA tensor go through
   pinned host memory, which the phase prints). On every rank: the
   configs/rhd.yaml train step (resnet50 at 256 px, B = 64 over 2 data
   ranks, N = 10) against the 1-process step on the same batch, weights
   and base noise (bf16: loss; launches a rank BN stats sums 53, f32
   sampler 1); in f32 the DP step and the TP step (tp = 2) held to a
   float64 evaluation, beside a planted fault (BN statistics per rank)
   that the same gate must refuse; the configs/ho3d.yaml eval batch
   (B = 64, N = 200 over 2 hypo ranks) against the unsharded batch (every
   metric; launches a rank stem 1, stage 1 3, bf16 sampler 1, f32 sampler
   1); one pipelined draw (pp = 2, the 12-coupling flow at 640 rows, 2
   microbatches) against the sequential one, values and gradients; one
   FSDP step against the DP step (every weight and Adam moment); one TP
   eval (tp = 2) against the replicated eval (the same launches a rank);
   each pair's ms in alternating windows; the phase within
   PARALLEL_PHASE_S.
9i. The released-checkpoint eval (`phase_released`): the CLI of
   mhentropy_tpu_torch/eval_released_checkpoint.py on a full-schema .pth
   (the port's MHEnt at configs/ho3d.yaml's width with the reference's
   `mano_dec.th_*` buffers and an empty `decoderPose`) and an HO3D tree of
   RELEASED_FRAMES evaluation frames, at B = 64, N = 200: the four
   README-table numbers finite, the eval kernels launched.
10. Prints the kernels' JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Every path is driven with every kernel's launch count set to 0 just before
it and read just after. Any failed check raises, so the script exits
non-zero. It refuses to run without a CUDA device; it never falls back to
the CPU or to a plain path.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

N_HYPO = 200
BATCH = 8
# Kernel vs plain on the same bf16 inputs and bf16 weights, the plain one in
# f32: the kernel rounds its activations to bf16 (2^-9 relative) between
# products, so the max-abs error is held to a share of the output's range.
TOL = {"stem": 2e-2, "stage1": 3e-2, "sampler": 1e-2,
       "lbs_blend": 2e-5, "stage1_int8": 1e-2, "realnvp_sampler_int8": 1e-2,
       "glow_sampler": 1e-2}
# LBS blend: f32 on both sides, 16-term sums in another order: a share of
# the output's range. int8 stage 1: exact integer products and identically
# rounded epilogues, so the kernel's bf16 output is the plain f32 result
# rounded to bf16 (2^-9 relative), bar a rare requantise tie. int8 sampler:
# exp and tanh may differ in the last ulp, which can move a requantised
# activation by one step.
# Whole slice, kernel path vs plain path on one batch with the same base
# noise and the flow at O(1) weights: xyz is bone-normalised (largest value
# about 3), uv in pixels. On an H100 the two paths differed by 0.0138 (xyz)
# and 1.72 px (uv); the bounds are about three times that.
SLICE_TOL = {"xyz": 4e-2, "uv": 5.0}
# BN sums: f32 accumulation in another order than the plain sums; each
# channel within this share of its sum of absolute values.
BN_TOL = 1e-5
# f32 sampler vs the plain f32 flow: f32 FMAs against cuBLAS f32 products,
# 12 layers; max-abs error within this share of the output's range, and the
# Function's gradients within this relative tolerance of plain autograd.
SAMPLER_F32_TOL = 1e-4
# One train step, kernels against the plain path, same weights, batch and
# noise. With the bf16 backbone the two differ by the f32 rounding of the BN
# sums, which moves bf16 roundings and maximum-pool ties near the stem and
# hypotheses across the likelihood's dead-zone kinks: the loss is held to
# TRAIN_LOSS_TOL relative and the running statistics to TRAIN_STATS_TOL,
# and the gradients' cosines are printed beside those of the plain path
# against itself with the image nudged by TRAIN_NUDGE (below bf16's
# resolution at most pixels). Computing in f32 the same step holds each
# parameter's gradient to a cosine of at least TRAIN_GRAD_COS with the plain
# path's and the loss to TRAIN_F32_LOSS_TOL. On an H100 the f32 step agreed
# to a lowest cosine of 0.99943 (the stem's weight) and a loss of 2.1e-6.
TRAIN_LOSS_TOL = 1e-2
TRAIN_STATS_TOL = 1e-2
TRAIN_GRAD_COS = 0.999
TRAIN_F32_LOSS_TOL = 1e-4
TRAIN_NUDGE = 1e-3
TRAIN_BATCH = 64
N_TRAIN_HYPO = 10
# int8 serving vs float serving on one B=8 batch, same base noise, O(1)
# flow (calibrated on that batch): xyz bone-normalised, uv in pixels. On an
# H100 the two differed by 0.0624 (xyz) and 7.71 px (uv); the bounds are
# about three times that.
INT8_TOL = {"xyz": 0.2, "uv": 25.0}
# Sampled vertices (normalised by the bone length), kernel blend vs plain.
VERTS_TOL = 1e-4
# Glow sampler: kernel and transform_plain round the same operands to bf16
# and differ by the order of f32 sums, which can move an activation's bf16
# rounding; the 1e-3 floor of the coupling scale divides, so an error may
# grow up to 1000x a layer near saturation. x is held to
# TOL["glow_sampler"] of its range; the log-det (tens of nats, where a
# share of the range would pass a wrong mask on a few lanes) to GLOW_LD_TOL
# nats, and the mean-abs errors of x and the log-det to GLOW_MEAN_TOL. On an
# H100 (700 W) the ProHMR shape differed by 0.0033 nats (log-det max-abs),
# 3.6e-4 and 1.5e-4 (x and log-det mean-abs).
GLOW_LD_TOL = 0.02
GLOW_MEAN_TOL = 1e-3
# ProHMR path (B=8, N=100, fresh seeded weights, 6,890-vertex SMPL): the
# kernel path (bf16 Glow operands, stem and stage-1 kernels) against the
# plain path (cuDNN, the f32 flow), and int8 against float, on the same
# base noise; joints3d in metres, uv in the crop's normalised units, log q
# in nats. On an H100 the kernel and plain paths differed by 0.041
# (joints3d), 0.038 (uv) and 0.0046 (log q), int8 and float by 0.107,
# 0.102 and 0.0134; the bounds are about three times that.
PROHMR_TOL = {"joints3d": 0.12, "uv": 0.12, "log_q": 0.015}
PROHMR_INT8_TOL = {"joints3d": 0.3, "uv": 0.3, "log_q": 0.04}
PROHMR_EVAL = (8, 100)  # tools/eval_prohmr.py's B, N
PROHMR_BENCH = (32, 100)  # tools/bench_prohmr.py's B, N
# The stem's, stage 1's and int8 stage 1's inputs on the ProHMR path
# (resnet50 at 224 px, 56 x 56 after the stem) at both batches: (B, px).
PROHMR_SHAPES = ((PROHMR_EVAL[0], 224), (PROHMR_BENCH[0], 224))
# Timing: RUNS windows per version, each at least this many seconds long.
RUNS = 3
KERNEL_WINDOW_S = 0.3
SLICE_WINDOW_S = 1.0
EVAL_BATCH = 64
# The H100 SXM's published peaks (NVIDIA's data sheet, dense rates, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
# Eval and train steps' windows.
STEP_WINDOW_S = 1.0
# The int8 stem and stage 2/3 kernels against their plain versions: exact
# integer sums and identically rounded f32 epilogues, so the kernel's bf16
# output is the plain f32 result rounded to bf16; the max-abs error is held
# to about one bf16 ulp of the largest output (2^-7 of it).
INT8_KERNEL_TOL = 2.0 ** -7
MID_BATCHES = (BATCH, 32)  # the int8 stem's and stage 2/3 kernels' checks
NEW_WINDOW_S = 0.25  # the timing windows of the phases of the opt-in int8 kernels
BENCH_QUANT = (32, 100)  # bench_quant's default B, N
BENCH_QUANT_STEPS = 30  # steps a window
BENCH_STEPS = 100  # the port's bench: steps a round (its default is bench.py's 250)
BENCH_BATCH = 32  # the port's bench batch: the stem and stage 1 are also timed there
# The RLE mode (configs/rhd_rle.yaml) and the det MHEnt, kernels against the
# plain path from the same weights, inputs and draws, in bf16. RLE: one
# step's and each of RLE_STEPS steps' loss (relative), one step's log p
# (max-abs over the largest |log p|) and running statistics
# (TRAIN_STATS_TOL), one eval batch's log p, draws and mu (max-abs, in the
# pose's bone-normalised units) and every eval metric (relative). On an
# H100 (700 W) they differed by 2.8e-3 (loss, the worst of 3 steps), 4.2e-3
# (log p, train mode), 3.7e-3 (draws) and 1.2e-4 (metrics); the bounds are
# about three times that. The gradients in bf16 are printed beside those of
# the plain path against itself with the image nudged by TRAIN_NUDGE. In
# f32, where both paths share flax's E[x^2] - E[x]^2 statistics and differ
# only in the sums' order, every parameter's gradient is held to a float64
# evaluation of the plain path: the kernel path's relative L2 error at most
# RLE_F32_GRAD_FACTOR x the plain f32 path's largest plus 1e-4, and its
# cosine at least RLE_F32_GRAD_COS; the loss to TRAIN_F32_LOSS_TOL. On an
# H100 (700 W) the f32 kernel path lay 0.053 (relative L2, a BN weight;
# lowest cosine 0.99861) from float64 and the plain f32 path 0.038
# (0.99930): flax's statistics in f32 carry that much on their own. Every
# fault of RLE_F32_FAULTS must fail the same check: there the BN sums off
# by 1e-5 of themselves gave 0.148 / 0.98987 (sum of squares) and 0.213 /
# 0.97815 (sum), by 1e-6 0.065 / 0.99798 (which passes); the bounds lie
# between. det: the kernel and plain paths
# differed by 3.3e-3 (xyz), 0.63 px (uv), 3.1e-3 (verts) and 4.2e-4 (train
# loss, relative): xyz and verts bone-normalised, uv in pixels, bounds about
# three times that; the train step's loss to TRAIN_LOSS_TOL.
# The export phase (mhentropy_tpu_torch/export.py): each artifact, loaded,
# against the live sampler on the same inputs. Both launch the same kernels
# on the same operands, so the outputs are expected equal; they are held to
# the kernel-vs-plain bounds of the slice (SLICE_TOL) and the det phase's
# verts bound. The phase must finish within EXPORT_PHASE_S.
EXPORT_MODS = ("xyz", "uv", "verts")
EXPORT_WINDOW_S = 0.2
EXPORT_PHASE_S = 60.0
RLE_STEPS = 3
RLE_TOL = {"loss": 1e-2, "log_p": 1.5e-2, "xyz": 1.2e-2, "metrics": 4e-4}
RLE_F32_GRAD_FACTOR = 2.0
RLE_F32_GRAD_COS = 0.995
DET_TOL = {"xyz": 1e-2, "uv": 2.0, "verts": 1e-2}
RLE_WINDOW_S = 0.5  # the RLE and det phases' timing windows
TRACED = 2  # steps a trace of the RLE and det train steps


# The parallel phase (9h): its ranks, the steps (or eval batches) a timing
# window, and its bounds. Two ranks' halves of a batch compute what one
# process computes on the whole, in another order of sums: the train loss
# (bf16, relative) as TRAIN_LOSS_TOL, in f32 the loss to 1e-4 and the
# gradients against float64 as parallel_f32_grads states; the eval
# metrics, each relative, to PARALLEL_METRIC_TOL (a rank's encoder and
# sampler rows are the whole batch's rows); the pipelined draw to
# SAMPLER_F32_TOL of its largest value. FSDP against DP after one step:
# every weight within PARALLEL_FSDP_WEIGHT_TOL (the update moves a weight
# by up to lr = 2e-4, so a wrong shard or gather shows) and every Adam
# moment within PARALLEL_FSDP_MOMENT_TOL of its tensor's largest (the
# moments carry the clip, which Adam's first update divides out).
PARALLEL_RANKS = 2
PARALLEL_STEPS = 2
PARALLEL_PHASE_S = 120.0
PARALLEL_METRIC_TOL = 1e-3
PARALLEL_TP_TOL = 2e-2  # the TP eval: bf16 partial products summed in f32
PARALLEL_F32_ALL_FACTOR = 3.0
PARALLEL_FSDP_WEIGHT_TOL = 1e-6
PARALLEL_FSDP_MOMENT_TOL = 1e-4
RELEASED_FRAMES = 8
# Launches a rank: a train step of configs/rhd.yaml, an eval batch of
# configs/ho3d.yaml (stage 1 launches once a bottleneck).
PARALLEL_TRAIN_LAUNCHES = {"bn_stats_sums": 53, "realnvp_sampler_f32": 1}
PARALLEL_EVAL_LAUNCHES = {"stem": 1, "stage1": 3, "realnvp_sampler": 1, "realnvp_sampler_f32": 1}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    from mhentropy_tpu_torch import profile_step

    return profile_step.card_line()


def spread(xs: list[float]) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "runs": len(xs)}


def cuda_ms(torch, fn, seconds: float = KERNEL_WINDOW_S) -> float:
    """Mean ms per call, by CUDA events, over a window of about `seconds`
    (profile_step.cuda_ms)."""
    from mhentropy_tpu_torch import profile_step

    return profile_step.cuda_ms(fn, seconds)


# The timings ab_ms takes of each kernel and its plain version.
TIMES = ("ms", "plain_ms", "graph_ms", "plain_graph_ms")


def graphed(torch, fn):
    """One call of fn captured as a CUDA graph (profile_step.graphed)."""
    from mhentropy_tpu_torch import profile_step

    return profile_step.graphed(fn)


def ab_ms(torch, kernel_fn, plain_fn, seconds: float = KERNEL_WINDOW_S) -> dict:
    """Spreads of RUNS windows each of kernel and plain, called eagerly (ms,
    plain_ms) and as CUDA-graph replays (graph_ms, plain_graph_ms), in
    alternating order (plain first on even runs, kernel first on odd ones)."""
    fns = dict(zip(TIMES, (kernel_fn, plain_fn, graphed(torch, kernel_fn),
                           graphed(torch, plain_fn))))
    times = {k: [] for k in TIMES}
    for r in range(RUNS):
        for pair in (("plain_ms", "ms"), ("plain_graph_ms", "graph_ms")):
            for k in (pair if r % 2 == 0 else pair[::-1]):
                times[k].append(cuda_ms(torch, fns[k], seconds))
    return {k: spread(v) for k, v in times.items()}


def rand_bn(torch, bn, g) -> None:
    n = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
        bn.bias.copy_(0.1 * torch.randn(n, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(n, generator=g))
        bn.running_var.copy_(1.0 + 0.5 * torch.rand(n, generator=g))


def he_(torch, w, g) -> None:
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=g) * math.sqrt(2.0 / w[0].numel()))


def sass_mma_counts(lib_path, source_stem: str) -> dict:
    """{function: {"IGMMA": n, "IMMA": n}} of the built library's kernels
    from `source_stem`.cu, by `cuobjdump -sass` (s8 wgmma shows as IGMMA,
    s8 mma.sync as IMMA)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if f"{source_stem}_cu" in name else None
            if fn:
                counts[fn] = {"IGMMA": 0, "IMMA": 0}
        elif fn:
            toks = line.split("*/")[1].split() if "*/" in line else []
            op = toks[1] if len(toks) > 1 and toks[0].startswith("@") else toks[0] if toks else ""
            for kind in counts[fn]:
                counts[fn][kind] += op.startswith(kind + ".")
    return counts


def kernel_counters() -> dict:
    """Every kernel of the port, by name: (wrapper module, its launch count)."""
    from mhentropy_tpu_torch import int8_gemm_probe, stage1_probe, stem_cost_attrib, stem_probe
    from mhentropy_tpu_torch.core import lbs_cuda
    from mhentropy_tpu_torch.flows import cuda_glow_sampler, cuda_sampler, cuda_sampler_int8
    from mhentropy_tpu_torch.models import (bn_cuda, stage1_cuda, stage1_int8_cuda,
                                            stage2_int8_cuda, stem_cuda, stem_int8_cuda)

    return {"stem": (stem_cuda, "launches"), "stage1": (stage1_cuda, "launches"),
            "realnvp_sampler": (cuda_sampler, "launches"), "lbs_blend": (lbs_cuda, "launches"),
            "stage1_int8": (stage1_int8_cuda, "launches"),
            "realnvp_sampler_int8": (cuda_sampler_int8, "launches"),
            "bn_stats_sums": (bn_cuda, "stats_launches"),
            "bn_grad_sums": (bn_cuda, "grad_launches"),
            "realnvp_sampler_f32": (cuda_sampler, "launches_f32"),
            "glow_sampler": (cuda_glow_sampler, "launches"),
            "stem_int8": (stem_int8_cuda, "launches"),
            "stage2_int8": (stage2_int8_cuda, "launches"),
            "int8_gemm_probe_s8": (int8_gemm_probe, "launches_s8"),
            "int8_gemm_probe_bf16": (int8_gemm_probe, "launches_bf16"),
            "stem_probe": (stem_probe, "launches"),
            "stem_cost_attrib": (stem_cost_attrib, "launches"),
            "stage1_probe_a": (stage1_probe, "launches_a"),
            "stage1_probe_b": (stage1_probe, "launches_b")}


def reset_launches() -> None:
    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernel_counters().items()}


def roofline(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops, "bound_ops_type": kind}


def stage1_macs(b: int, h: int, w: int) -> int:
    """Bottleneck products of resnet50 stage 1: block 0 (64 -> 64 -> 64 ->
    256 plus the 64 -> 256 downsample), blocks 1-2 (256 -> 64 -> 64 -> 256)."""
    per_pixel = (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256) + 2 * (256 * 64 + 9 * 64 * 64
                                                                      + 64 * 256)
    return b * h * w * per_pixel


def sampler_macs(rows: int, d: int, h: int, n_layers: int) -> int:
    """Six products a coupling layer: two nets of d x h, h x h, h x d."""
    return rows * n_layers * 2 * (d * h + h * h + h * d)


def side_line(entry: dict) -> dict:
    """A further shape's numbers beside a kernel's main line: each timing's
    median and its [min, max]."""
    return {**{k: (v["median"] if k in TIMES else v) for k, v in entry.items()},
            **{f"{k}_min_max": [entry[k]["min"], entry[k]["max"]] for k in TIMES}}


def stem_case(torch, image, w, b) -> dict:
    """The stem kernel against its plain version on one image batch: the
    error within TOL["stem"] of the output's range, the timings and bound."""
    from mhentropy_tpu_torch.models import stem_cuda

    bb, px = image.shape[:2]
    out = stem_cuda.stem_forward(image, w, b)
    torch.cuda.synchronize()
    ref = stem_cuda.stem_plain(image.float(), w.float(), b)
    check(out.shape == (bb, px // 4, px // 4, 64), f"stem {px} px: shape {tuple(out.shape)}")
    err = (out.float() - ref).abs().max().item()
    tol = TOL["stem"] * max(1.0, ref.abs().max().item())
    check(err <= tol, f"stem {tuple(image.shape)}: max-abs error {err} > {tol}")
    times = ab_ms(torch, lambda: stem_cuda.stem_forward(image, w, b),
                  lambda: stem_cuda.stem_plain(image, w, b))
    # Conv products only (no halo recompute); bf16 image in, bf16 out.
    macs = bb * (px // 2) ** 2 * 64 * stem_cuda.TAPS
    n_bytes = image.numel() * 2 + out.numel() * 2 + w.numel() * 2 + b.numel() * 4
    return {"shape": list(image.shape), "max_abs_err": err, "tol": tol, **times,
            **roofline(n_bytes, 2 * macs, "bf16")}


def phase_stem(torch, dev):
    """The serving shape (8, 256, 256, 3) makes the line; the bench's
    (32, 256, 256, 3) and the ProHMR path's 224 px at eval_prohmr's and
    bench_prohmr's batch stand beside it. The plain version is cuDNN's conv
    with PyTorch's ReLU and max-pool: its graph time is `library_graph_ms`,
    the kernel's yardstick graph against graph."""
    from mhentropy_tpu_torch.models import stem_cuda

    g = torch.Generator().manual_seed(1)
    conv_w = torch.empty(64, 3, 7, 7)
    he_(torch, conv_w, g)
    bn = torch.nn.BatchNorm2d(64)
    rand_bn(torch, bn, g)
    w, b = stem_cuda.fold(conv_w, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    w, b = w.to(dev), b.to(dev)
    cases = [stem_case(torch, torch.randn((bb, px, px, 3), generator=g).to(dev, torch.bfloat16),
                       w, b) for bb, px in ((BATCH, 256), (BENCH_BATCH, 256), *PROHMR_SHAPES)]
    return {"name": "stem", "source": "mhentropy_tpu_torch/csrc/stem.cu",
            "replaces": "mhentropy_tpu/models/stem_pallas.py:120", **cases[0],
            # The plain version is cuDNN's conv + PyTorch's ReLU and max-pool.
            "library": "plain", "library_graph_ms": cases[0]["plain_graph_ms"]["median"],
            "other_shapes": [side_line(cases[1])],
            "prohmr_shapes": [side_line(c) for c in cases[2:]]}


def stage1_case(torch, x, folded) -> dict:
    from mhentropy_tpu_torch.models import stage1_cuda

    bb, hh, ww, _ = x.shape
    out = stage1_cuda.stage1_forward(x, folded)
    torch.cuda.synchronize()
    ref = stage1_cuda.stage1_plain(x.float(), folded)
    check(out.shape == (bb, hh, ww, 256), f"stage 1: shape {tuple(out.shape)}")
    err = (out.float() - ref).abs().max().item()
    tol = TOL["stage1"] * max(1.0, ref.abs().max().item())
    check(err <= tol, f"stage 1 {tuple(x.shape)}: max-abs error {err} > {tol}")
    times = ab_ms(torch, lambda: stage1_cuda.stage1_forward(x, folded),
                  lambda: stage1_cuda.stage1_plain(x, folded))
    n_weights = sum(t.numel() * t.element_size() for blk in folded for t in blk
                    if t is not None)
    n_bytes = x.numel() * 2 + out.numel() * 2 + n_weights
    return {"shape": list(x.shape), "max_abs_err": err, "tol": tol, **times,
            **roofline(n_bytes, 2 * stage1_macs(bb, hh, ww), "bf16")}


def phase_stage1(torch, dev):
    """(8, 64, 64, 64) of the 256 px serving path makes the line; the bench's
    (32, 64, 64, 64) and the ProHMR path's 56 x 56 (a ragged last 16-wide
    column tile) stand beside it; `library_graph_ms` as in phase_stem."""
    from mhentropy_tpu_torch.models import resnet, stage1_cuda

    g = torch.Generator().manual_seed(2)
    layer1 = torch.nn.Sequential(resnet.Bottleneck(64, 64), resnet.Bottleneck(256, 64),
                                 resnet.Bottleneck(256, 64))
    for m in layer1.modules():
        if isinstance(m, torch.nn.Conv2d):
            he_(torch, m.weight, g)
        elif isinstance(m, torch.nn.BatchNorm2d):
            rand_bn(torch, m, g)
    folded = [stage1_cuda.FoldedBlock(*(None if t is None else t.to(dev) for t in blk))
              for blk in stage1_cuda.fold(layer1)]
    cases = [stage1_case(torch, torch.relu(torch.randn((bb, px // 4, px // 4, 64), generator=g))
                         .to(dev, torch.bfloat16), folded)
             for bb, px in ((BATCH, 256), (BENCH_BATCH, 256), *PROHMR_SHAPES)]
    return {"name": "stage1", "source": "mhentropy_tpu_torch/csrc/stage1.cu",
            "replaces": "mhentropy_tpu/models/stage1_pallas.py:160", **cases[0],
            # The plain version is the stage's cuDNN convolutions.
            "library": "plain", "library_graph_ms": cases[0]["plain_graph_ms"]["median"],
            "other_shapes": [side_line(cases[1])],
            "prohmr_shapes": [side_line(c) for c in cases[2:]]}


# The bf16 draw's row counts on the main path, (B, N): a served request at
# B = 1, the B = 8 request (the line's shape), the bench step and the eval
# batch.
SAMPLER_SHAPES = ((BATCH, N_HYPO), (1, N_HYPO), (BENCH_BATCH, 100), (EVAL_BATCH, N_HYPO))


def sampler_case(torch, packed, packed_plain, z0, cproj, tol: float, kind: str) -> dict:
    """One sampler kernel at one shape: x and the log-det against
    transform_plain (max-abs, held to tol times the output's range, at
    least 1), kernel and plain timed as ab_ms does, the bound from these
    inputs (each read once, x and the log-det written once) and the launch
    plan."""
    from mhentropy_tpu_torch.flows import cuda_sampler

    b, n, d = z0.shape
    x, ld = cuda_sampler.transform(packed, z0, cproj)
    torch.cuda.synchronize()
    x_ref, ld_ref = cuda_sampler.transform_plain(packed, z0, cproj)
    check(x.shape == (b, n, d) and ld.shape == (b, n),
          f"sampler {kind}: shapes {tuple(x.shape)} {tuple(ld.shape)}")
    err_x = (x - x_ref).abs().max().item()
    err_ld = (ld - ld_ref).abs().max().item()
    bound_x = tol * max(1.0, x_ref.abs().max().item())
    bound_ld = tol * max(1.0, ld_ref.abs().max().item())
    check(err_x <= bound_x, f"sampler {kind} at {(b, n)}: x max-abs error {err_x} > {bound_x}")
    check(err_ld <= bound_ld,
          f"sampler {kind} at {(b, n)}: logdet max-abs error {err_ld} > {bound_ld}")
    times = ab_ms(torch, lambda: cuda_sampler.transform(packed, z0, cproj),
                  lambda: cuda_sampler.transform_plain(packed_plain, z0, cproj))
    n_weights = sum(getattr(packed, k).numel() * getattr(packed, k).element_size()
                    for k in ("w0", "w1", "w2", "b0", "b1", "b2"))
    n_bytes = 2 * z0.numel() * 4 + b * n * 4 + cproj.numel() * 4 + n_weights
    h = packed.w1.shape[-1]
    macs = sampler_macs(b * n, d, h, packed.masks.shape[0])
    f32 = kind == "f32"
    plan = cuda_sampler.launch_plan(z0.device.index, b * n, h, packed.masks.shape[1], f32)
    # 3xTF32: three TF32 tensor-core products for each f32 one.
    ops = (3 * 2 * macs, "tf32") if f32 else (2 * macs, "bf16")
    return {"shape": [b, n], "rows": b * n, "max_abs_err": max(err_x, err_ld),
            "max_abs_err_x": err_x, "max_abs_err_logdet": err_ld, "tol": bound_x,
            "plan": plan._asdict(), **times, **roofline(n_bytes, *ops)}


def phase_sampler(torch, dev):
    """The bf16 sampler at every main-path row count; B = 8, N = 200 makes
    the line."""
    from mhentropy_tpu_torch.flows import cuda_sampler, realnvp

    torch.manual_seed(3)  # torch-default Linear init: the reference's own
    cfg = realnvp.RealNVPConfig(dim=45, cond_dim=512, h_dim=512, num_steps=6)
    flow = realnvp.RealNVP(cfg).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    with torch.inference_mode():
        packed = cuda_sampler.pack(flow)  # bf16 weights, as the kernel runs
        packed_f32 = cuda_sampler.pack(flow, dtype=torch.float32)
        for b, n in SAMPLER_SHAPES:
            feat = torch.randn((b, 512), generator=g, device=dev)
            z0 = torch.randn((b, n, 45), generator=g, device=dev) * 0.8
            cproj = realnvp.cond_cache(flow, feat).contiguous()
            cases.append(sampler_case(torch, packed, packed_f32, z0, cproj, TOL["sampler"],
                                      "bf16"))
    return {"name": "realnvp_sampler", "source": "mhentropy_tpu_torch/csrc/realnvp_sampler.cu",
            "replaces": "mhentropy_tpu/flows/pallas_sampler.py:191", **cases[0],
            "library": None, "other_shapes": [side_line(c) for c in cases[1:]]}


def lbs_bound(args, out) -> dict:
    """Each input read once, the vertices written once; per vertex and row
    12 coefficients of J joints and the 3 x 3 + t blend, f32 FMAs."""
    w = args[0]
    v, j = w.shape
    rows = out.shape[-1]
    n_bytes = sum(t.numel() * 4 for t in args) + out.numel() * 4
    return roofline(n_bytes, 2 * v * rows * (12 * j + 9), "f32")


def phase_lbs_smpl(torch, dev) -> dict:
    """The blend at the ProHMR shape (B=32, N=100 -> 3,200 rows) on the SMPL
    fixture at SMPL's size (V=6,890, J=24) and a chain from random 6D poses:
    seven vertex tiles a row block."""
    from mhentropy_tpu_torch.core import lbs_cuda, rotations, smpl

    rows = PROHMR_BENCH[0] * PROHMR_BENCH[1]
    model = smpl.synthetic_smpl_model(0, n_verts=smpl.N_VERTS, device=dev)
    g = torch.Generator(device=dev).manual_seed(15)
    rotmats = rotations.rotmat_from_6d(torch.randn((rows, 24, 6), generator=g, device=dev))
    betas = torch.randn((rows, 10), generator=g, device=dev)
    with torch.inference_mode():
        chain_r, chain_t, joints = smpl._chain_nl(model, rotmats, betas)
        skin_t = chain_t - smpl.mv3(chain_r, joints)
        args = [t.contiguous() for t in (model.lbs_weights, chain_r, skin_t,
                                         smpl._v_posed_nl(model, rotmats, betas))]
        out = lbs_cuda.lbs_blend(*args)
        torch.cuda.synchronize()
        ref = lbs_cuda.lbs_blend_plain(*args)
        check(out.shape == (3, smpl.N_VERTS, rows), f"lbs smpl: shape {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        tol = TOL["lbs_blend"] * ref.abs().max().item()
        check(err <= tol, f"lbs smpl: max-abs error {err} > {tol}")
        times = ab_ms(torch, lambda: lbs_cuda.lbs_blend(*args),
                      lambda: lbs_cuda.lbs_blend_plain(*args))
    return side_line({"shape": {"V": smpl.N_VERTS, "J": 24, "rows": rows}, "max_abs_err": err,
                      "tol": tol, **times, **lbs_bound(args, out)})


def phase_lbs(torch, dev):
    """The blend at MANO's eval shape (N=200, B=64 -> 12,800 rows) on the
    MANO stand-in's skinning weights and a real chain from random poses;
    then at SMPL's (phase_lbs_smpl), its line beside MANO's."""
    from mhentropy_tpu_torch.core import lbs_cuda, mano

    rows = N_HYPO * EVAL_BATCH
    model = mano.synthetic_mano_model(0, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    theta = torch.randn((rows, 48), generator=g, device=dev) * 0.5
    beta = torch.randn((rows, 10), generator=g, device=dev) * 0.01
    with torch.inference_mode():
        fold = mano.fold_keypoints(model)
        chain_r, _, skin_t, pose_map = mano._chain_nl(model, fold, theta, beta, mano.ManoConfig())
        v_posed = (model.v_template.T[:, :, None]
                   + torch.einsum("vdc,bc->dvb", model.shapedirs, beta)
                   + torch.einsum("vdp,bp->dvb", model.posedirs, pose_map))
        args = [t.contiguous() for t in (model.lbs_weights, chain_r, skin_t, v_posed)]
        out = lbs_cuda.lbs_blend(*args)
        torch.cuda.synchronize()
        ref = lbs_cuda.lbs_blend_plain(*args)
        check(out.shape == (3, 778, rows), f"lbs: shape {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        tol = TOL["lbs_blend"] * ref.abs().max().item()
        check(err <= tol, f"lbs: max-abs error {err} > {tol}")
        times = ab_ms(torch, lambda: lbs_cuda.lbs_blend(*args),
                      lambda: lbs_cuda.lbs_blend_plain(*args))
        bound = lbs_bound(args, out)
        del args, out, ref, v_posed
    return {"name": "lbs_blend", "source": "mhentropy_tpu_torch/csrc/lbs_blend.cu",
            "replaces": "mhentropy_tpu/core/lbs_pallas.py:56",
            "max_abs_err": err, "tol": tol, **times, "library": None, **bound,
            "smpl_shape": phase_lbs_smpl(torch, dev)}


# The Glow sampler's two shapes: ProHMR's (bench_prohmr's B=32, N=100) and
# the MHEnt Glow regressor's (models/mhent.py's glow branch: D=45, H=512,
# context 512, B=8, N=200), which will launch the same kernel.
GLOW_SHAPES = {"prohmr": {"d": 144, "h": 1024, "c": 2048, "b": 32, "n": 100},
               "mhent_glow": {"d": 45, "h": 512, "c": 512, "b": 8, "n": 200}}


def o1_glow(torch, cfg, seed: int, dev):
    """A ConditionalGlow with O(1) outputs: torch-default Linears throughout
    (the blocks' last Linears too, not the near-zero init), actnorm and the
    LU factors drawn around the identity."""
    from mhentropy_tpu_torch.flows import glow

    torch.manual_seed(seed)
    flow = glow.ConditionalGlow(cfg)
    g = torch.Generator().manual_seed(seed)
    d = cfg.features
    with torch.no_grad():
        for i in range(cfg.num_layers):
            an, lin, _ = flow.step(i)
            an.log_scale.copy_(0.1 * torch.randn(d, generator=g))
            an.shift.copy_(0.1 * torch.randn(d, generator=g))
            for p in (lin.lower_entries, lin.upper_entries):
                p.copy_(0.3 / math.sqrt(d) * torch.randn(p.shape, generator=g))
    return flow.to(dev).eval()


def glow_macs(rows: int, d: int, h: int, n_layers: int) -> int:
    """A layer's products per row: the four H x H of the residual blocks,
    the initial Linear on the identity lanes (d_id x H), the shift and
    scale of the transformed lanes (H x d_tr each), the LU (D x D). The
    identity lanes alternate between ceil(D / 2) and floor(D / 2), as
    glow.coupling_masks gives them."""
    total = 0
    for i in range(n_layers):
        d_id = (d + 1) // 2 if i % 2 == 0 else d // 2
        total += 4 * h * h + (d_id + 2 * (d - d_id)) * h + d * d
    return rows * total


def glow_case(torch, dev, label: str, s: dict) -> dict:
    """The Glow kernel against transform_plain at shape `s` on an O(1)
    flow: x and the log-det each against its tolerance (max- and
    mean-abs), kernel and plain timed eager and as graph replays, a trace
    of 10 calls, torch.matmul on one (rows, H) x (H, H) bf16 hidden product
    as the per-stage yardstick, the bound from glow_macs."""
    from mhentropy_tpu_torch.flows import cuda_glow_sampler as cgs
    from mhentropy_tpu_torch.flows import glow

    cfg = glow.GlowConfig(features=s["d"], hidden=s["h"], num_layers=4, num_blocks=2,
                          context_features=s["c"])
    flow = o1_glow(torch, cfg, 14, dev)
    b, n, d = s["b"], s["n"], s["d"]
    g = torch.Generator(device=dev).manual_seed(14)
    feat = torch.randn((b, s["c"]), generator=g, device=dev)
    z0 = torch.randn((b, n, d), generator=g, device=dev)
    with torch.inference_mode():
        packed = cgs.pack(flow)
        ctx = cgs.pack_context(flow, feat)
        x, ld = cgs.transform(packed, z0, ctx)
        torch.cuda.synchronize()
        x_ref, ld_ref = cgs.transform_plain(packed, z0, ctx)
        check(x.shape == (b, n, d) and ld.shape == (b, n),
              f"glow {label}: shapes {tuple(x.shape)} {tuple(ld.shape)}")
        check(bool(torch.isfinite(x).all() and torch.isfinite(ld).all()),
              f"glow {label}: non-finite outputs")
        err_x = (x - x_ref).abs().max().item()
        err_ld = (ld - ld_ref).abs().max().item()
        mean_x = (x - x_ref).abs().mean().item()
        mean_ld = (ld - ld_ref).abs().mean().item()
        tol_x = TOL["glow_sampler"] * max(1.0, x_ref.abs().max().item())
        tol_ld = GLOW_LD_TOL
        print(f"glow {label}: x max-abs {err_x:.4g} mean {mean_x:.4g} (tol {tol_x:.4g}, "
              f"largest {x_ref.abs().max().item():.4g}); log-det max-abs {err_ld:.4g} "
              f"mean {mean_ld:.4g} (tol {tol_ld:.4g}, largest "
              f"{ld_ref.abs().max().item():.4g})", flush=True)
        check(err_x <= tol_x, f"glow {label}: x max-abs error {err_x} > {tol_x}")
        check(err_ld <= tol_ld, f"glow {label}: log-det max-abs error {err_ld} > {tol_ld}")
        check(mean_x <= GLOW_MEAN_TOL and mean_ld <= GLOW_MEAN_TOL,
              f"glow {label}: mean-abs errors x {mean_x}, log-det {mean_ld} > "
              f"{GLOW_MEAN_TOL}")
        times = ab_ms(torch, lambda: cgs.transform(packed, z0, ctx),
                      lambda: cgs.transform_plain(packed, z0, ctx))
        # Device time by kernel (the GEMMs, the coupling steps) of 10 calls.
        trace = trace_steps(torch, lambda: cgs.transform(packed, z0, ctx),
                            times["ms"]["median"], n=10, top=6)
        # The per-stage yardstick: torch.matmul on one of the call's 16
        # (rows, H) x (H, H) bf16 products, timed here only.
        a16 = torch.randn((b * n, s["h"]), generator=g, device=dev).to(torch.bfloat16)
        w16 = packed.big[0, 0]
        stage_ms = spread([cuda_ms(torch, graphed(torch, lambda: torch.matmul(a16, w16)))
                           for _ in range(RUNS)])["median"]
        print(f"glow {label}: torch.matmul ({b * n}, {s['h']}) x ({s['h']}, {s['h']}) "
              f"bf16 {stage_ms:.4f} ms graph", flush=True)
    n_weights = sum(t.numel() * t.element_size() for t in packed[:13])
    n_bytes = 2 * z0.numel() * 4 + b * n * 4 + ctx.numel() * 4 + n_weights
    return {"shape": {**s, "layers": 4}, "max_abs_err": max(err_x, err_ld),
            "max_abs_err_x": err_x, "max_abs_err_logdet": err_ld,
            "mean_abs_err_x": mean_x, "mean_abs_err_logdet": mean_ld, "tol": tol_x,
            "tol_logdet": tol_ld, "tol_mean": GLOW_MEAN_TOL, **times, "trace": trace,
            "library_stage_graph_ms": stage_ms,
            **roofline(n_bytes, 2 * glow_macs(b * n, d, s["h"], 4), "bf16")}


def phase_glow_sampler(torch, dev):
    """The Glow kernel against transform_plain at both GLOW_SHAPES on an
    O(1) flow; the ProHMR shape's numbers make the line, the MHEnt shape's
    stand beside them (phase_glow adds the glow MHEnt's eval batch)."""
    out = {}
    for label, s in GLOW_SHAPES.items():
        entry = glow_case(torch, dev, label, s)
        if label == "prohmr":
            out = {"name": "glow_sampler", "source": "mhentropy_tpu_torch/csrc/glow_sampler.cu",
                   "replaces": "mhentropy_tpu/flows/pallas_glow_sampler.py:324",
                   "library": None, **entry}
        else:
            out["other_shape"] = side_line(entry)
    return out


def he_resnet50(torch, dev, seed: int):
    """A resnet50 backbone with He-initialised convs and random BN, prepared
    as the served one is (bf16, channels_last, kernel weights folded)."""
    from mhentropy_tpu_torch.models import resnet

    g = torch.Generator().manual_seed(seed)
    res = resnet.resnet50()
    for m in res.modules():
        if isinstance(m, torch.nn.Conv2d):
            he_(torch, m.weight, g)
        elif isinstance(m, torch.nn.BatchNorm2d):
            rand_bn(torch, m, g)
    res = res.eval().to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    res.fold_kernel_weights()
    return res


def stage1_int8_case(torch, res, images) -> dict:
    """Sites calibrated (q_from = 0) on the images through res; the input
    is those images' stem output."""
    from mhentropy_tpu_torch.models import quant, stage1_int8_cuda, stem_cuda

    bb, px = images.shape[:2]
    spec = quant.QuantSpec(backbone="resnet50", q_from=0)
    qtree = quant.prepare(spec, res, quant.calibrate(spec, res, images))
    packed = qtree["stage1"]
    x = stem_cuda.stem_forward(images.to(torch.bfloat16).contiguous(), *res.folded[0])
    out = stage1_int8_cuda.stage1_forward_q(x, packed)
    torch.cuda.synchronize()
    ref = stage1_int8_cuda.stage1_plain(x, packed)
    check(out.shape == (bb, px // 4, px // 4, 256) and out.dtype == torch.bfloat16,
          f"stage 1 int8: {tuple(out.shape)} {out.dtype}")
    err = (out.float() - ref).abs().max().item()
    exact = (out == ref.to(torch.bfloat16)).float().mean().item()
    tol = TOL["stage1_int8"] * max(1.0, ref.abs().max().item())
    check(err <= tol, f"stage 1 int8 {tuple(x.shape)}: max-abs error {err} > {tol}")
    times = ab_ms(torch, lambda: stage1_int8_cuda.stage1_forward_q(x, packed),
                  lambda: stage1_int8_cuda.stage1_plain(x, packed))
    # The library yardstick: the same stage's `torch._int_mm` walk, conv by conv.
    walk = lambda: quant.walk_stage(spec, res, qtree["sites"], x, 0)  # noqa: E731
    library = {"library_ms": cuda_ms(torch, walk, NEW_WINDOW_S),
               "library_graph_ms": cuda_ms(torch, graphed(torch, walk), NEW_WINDOW_S),
               "library_max_abs_diff": (walk().float() - ref).abs().max().item()}
    n_weights = sum(t.numel() * t.element_size() for blk in packed for t in blk
                    if t is not None)
    n_bytes = x.numel() * 2 + out.numel() * 2 + n_weights
    return {"shape": list(x.shape), "max_abs_err": err, "tol": tol, "bf16_exact_share": exact,
            **times, **library,
            **roofline(n_bytes, 2 * stage1_macs(bb, px // 4, px // 4), "int8")}


def phase_stage1_int8(torch, dev):
    """A He-initialised resnet50 with random BN; 8 random 256 px images make
    the line, the bench step's and the eval batch's (32 and 64 images at
    256 px) and the ProHMR path's 224 px at its two batches stand beside
    it."""
    res = he_resnet50(torch, dev, 5)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        cases = [stage1_int8_case(torch, res, torch.randn((bb, px, px, 3), generator=g,
                                                          device=dev))
                 for bb, px in ((BATCH, 256), (BENCH_BATCH, 256), (EVAL_BATCH, 256),
                                *PROHMR_SHAPES)]
    return {"name": "stage1_int8", "source": "mhentropy_tpu_torch/csrc/stage1_int8.cu",
            "replaces": "mhentropy_tpu/models/stage1_int8.py:207", **cases[0],
            "library": "models/quant.py::walk_stage (torch._int_mm)",
            "other_shapes": [side_line(c) for c in cases[1:3]],
            "prohmr_shapes": [side_line(c) for c in cases[3:]]}


# The int8 draw's row counts on the main path, (B, N): the B = 8 request
# (the line's shape), the bench's int8_serving step and the int8 eval batch.
SAMPLER_INT8_SHAPES = ((BATCH, N_HYPO), (BENCH_BATCH, 100), (EVAL_BATCH, N_HYPO))


def sampler_int8_case(torch, flow, tree, feat, z0) -> dict:
    """The int8 sampler at one shape against xla_forward_q: x and the log-det
    each within TOL of its range, timed as ab_ms does, the bound from these
    inputs and the launch plan."""
    from mhentropy_tpu_torch.flows import cuda_sampler_int8

    b, n, d = z0.shape
    cq = cuda_sampler_int8.cond_q(flow, tree, feat)
    z0p = torch.nn.functional.pad(z0, (0, tree.masks.shape[-1] - d))
    x, ld = cuda_sampler_int8.transform_q(tree, z0, cq)
    torch.cuda.synchronize()
    x_ref, ld_ref = cuda_sampler_int8.xla_forward_q(tree, z0p, cq)
    x_ref = x_ref[..., :d]
    check(x.shape == (b, n, d) and ld.shape == (b, n),
          f"int8 sampler: shapes {tuple(x.shape)} {tuple(ld.shape)}")
    err_x = (x - x_ref).abs().max().item()
    err_ld = (ld - ld_ref).abs().max().item()
    tol_x = TOL["realnvp_sampler_int8"] * max(1.0, x_ref.abs().max().item())
    tol_ld = TOL["realnvp_sampler_int8"] * max(1.0, ld_ref.abs().max().item())
    check(err_x <= tol_x, f"int8 sampler at {(b, n)}: x max-abs error {err_x} > {tol_x}")
    check(err_ld <= tol_ld, f"int8 sampler at {(b, n)}: logdet max-abs error {err_ld} > {tol_ld}")
    times = ab_ms(torch, lambda: cuda_sampler_int8.transform_q(tree, z0, cq),
                  lambda: cuda_sampler_int8.xla_forward_q(tree, z0p, cq))
    k = tree.kernel
    n_bytes = (2 * z0.numel() * 4 + b * n * 4 + cq.numel() * 4
               + sum(t.numel() * t.element_size() for t in k))
    n_layers, dp = k.masks.shape
    h = k.w1.shape[-1]
    plan = cuda_sampler_int8.launch_plan(z0.device.index, b * n, h, dp)
    return {"shape": [b, n], "rows": b * n, "max_abs_err": max(err_x, err_ld),
            "max_abs_err_x": err_x, "max_abs_err_logdet": err_ld,
            "mean_abs_err_x": (x - x_ref).abs().mean().item(), "tol": tol_x,
            "plan": plan._asdict(), **times,
            **roofline(n_bytes, 2 * sampler_macs(b * n, d, h, n_layers), "int8")}


def phase_sampler_int8(torch, dev):
    """An O(1) flow (torch-default Linear init), calibrated on its own
    trajectory at temperature 1 on 8 images, at every main-path row count;
    B = 8, N = 200 makes the line."""
    from mhentropy_tpu_torch.flows import cuda_sampler_int8, realnvp

    torch.manual_seed(6)
    cfg = realnvp.RealNVPConfig(dim=45, cond_dim=512, h_dim=512, num_steps=6)
    flow = realnvp.RealNVP(cfg).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(6)
    feat = torch.randn((BATCH, 512), generator=g, device=dev)
    cases = []
    with torch.inference_mode():
        tree = cuda_sampler_int8.quantize_sampler(
            flow, feat, torch.randn((32 * BATCH, 45), generator=g, device=dev))
        for b, n in SAMPLER_INT8_SHAPES:
            if b != BATCH:
                feat = torch.randn((b, 512), generator=g, device=dev)
            z0 = torch.randn((b, n, 45), generator=g, device=dev) * 0.8
            cases.append(sampler_int8_case(torch, flow, tree, feat, z0))
    return {"name": "realnvp_sampler_int8",
            "source": "mhentropy_tpu_torch/csrc/realnvp_sampler_int8.cu",
            "replaces": "mhentropy_tpu/flows/pallas_sampler_int8.py:381", **cases[0],
            "library": None, "other_shapes": [side_line(c) for c in cases[1:]]}


def stage_macs(b: int, g) -> int:
    """Products of a resnet50 stage 2 or 3 (StageGeom g) at its stride-2
    first block's kept pixels: block 0 (conv1 at the input resolution, the
    3x3, conv3 and the downsample at the output's), blocks 1.. at the
    output's."""
    hw_in, hw_out = g.w_in ** 2, (g.w_in // 2) ** 2
    w, cin, cout = g.width, g.cin, g.cout
    first = hw_in * cin * w + hw_out * (9 * w * w + w * cout + cin * cout)
    return b * (first + (g.n_blocks - 1) * hw_out * (cout * w + 9 * w * w + w * cout))


def calibrated_mid(torch, res, images):
    """(spec, qtree) with int8_stem and pallas_mid at q_from = 1, calibrated
    on the images through res, and stage 2's input: those images through the
    float stem and stage-1 kernels."""
    from mhentropy_tpu_torch.models import quant, stage1_cuda, stem_cuda

    spec = quant.QuantSpec(backbone="resnet50", q_from=1, int8_stem=True, pallas_mid=True)
    qtree = quant.prepare(spec, res, quant.calibrate(spec, res, images))
    x = stem_cuda.stem_forward(images.to(torch.bfloat16).contiguous(), *res.folded[0])
    return spec, qtree, stage1_cuda.stage1_forward(x, res.folded[1])


def stem_int8_case(torch, res, images, packed, site) -> dict:
    """The int8 stem kernel against stem_plain on the site calibrated on the
    images; the bf16 stem kernel's graph time on the same images beside."""
    from mhentropy_tpu_torch.models import stem_cuda, stem_int8_cuda

    bb, px = images.shape[:2]
    out = stem_int8_cuda.stem_forward_q(images, packed)
    torch.cuda.synchronize()
    ref = stem_int8_cuda.stem_plain(images, site)
    check(out.shape == (bb, px // 4, px // 4, 64) and out.dtype == torch.bfloat16,
          f"stem int8: {tuple(out.shape)} {out.dtype}")
    err = (out.float() - ref).abs().max().item()
    exact = (out == ref.to(torch.bfloat16)).float().mean().item()
    tol = INT8_KERNEL_TOL * ref.abs().max().item()
    check(err <= tol, f"stem int8 {tuple(images.shape)}: max-abs error {err} > {tol}")
    times = ab_ms(torch, lambda: stem_int8_cuda.stem_forward_q(images, packed),
                  lambda: stem_int8_cuda.stem_plain(images, site), NEW_WINDOW_S)
    image_bf16 = images.to(torch.bfloat16)
    bf16_stem = cuda_ms(torch, graphed(torch, lambda: stem_cuda.stem_forward(
        image_bf16, *res.folded[0])), NEW_WINDOW_S)
    macs = bb * (px // 2) ** 2 * 64 * 147
    n_bytes = (images.numel() * 4 + out.numel() * 2
               + sum(packed[k].numel() * packed[k].element_size()
                     for k in ("wq", "inv_a", "scale", "bias")))
    return {"shape": list(images.shape), "max_abs_err": err, "tol": tol,
            "bf16_exact_share": exact, "window_s": NEW_WINDOW_S, **times,
            "bf16_stem_graph_ms": bf16_stem,
            **roofline(n_bytes, 2 * macs, "int8")}


def stage_int8_case(torch, spec, res, qtree, x, stage: int) -> dict:
    """The stage kernel against stage_plain on one stage's calibrated packed
    sites; the library yardstick is the same stage's `torch._int_mm` walk
    (the route pallas_mid=False runs)."""
    from mhentropy_tpu_torch.models import quant, stage2_int8_cuda

    g = stage2_int8_cuda.GEOMS[stage]
    packed = qtree[f"stage{stage}"]
    out = stage2_int8_cuda.stage_forward_q(x, packed, stage)
    torch.cuda.synchronize()
    ref = stage2_int8_cuda.stage_plain(x, packed)
    bb = x.shape[0]
    check(out.shape == (bb, g.w_in // 2, g.w_in // 2, g.cout) and out.dtype == torch.bfloat16,
          f"stage {stage} int8: {tuple(out.shape)} {out.dtype}")
    err = (out.float() - ref).abs().max().item()
    exact = (out == ref.to(torch.bfloat16)).float().mean().item()
    tol = INT8_KERNEL_TOL * ref.abs().max().item()
    check(err <= tol, f"stage {stage} int8 {tuple(x.shape)}: max-abs error {err} > {tol}")
    times = ab_ms(torch, lambda: stage2_int8_cuda.stage_forward_q(x, packed, stage),
                  lambda: stage2_int8_cuda.stage_plain(x, packed), NEW_WINDOW_S)
    walk_spec = spec._replace(pallas_mid=False)
    walk = lambda: quant.walk_stage(walk_spec, res, qtree["sites"], x, stage - 1)  # noqa: E731
    walk_err = (walk().float() - ref).abs().max().item()
    library = {"library_ms": cuda_ms(torch, walk, NEW_WINDOW_S),
               "library_graph_ms": cuda_ms(torch, graphed(torch, walk), NEW_WINDOW_S),
               "library_max_abs_diff": walk_err}
    n_weights = sum(t.numel() * t.element_size() for blk in packed for t in blk
                    if t is not None)
    n_bytes = x.numel() * 2 + out.numel() * 2 + n_weights
    return {"shape": list(x.shape), "stage": stage, "max_abs_err": err, "tol": tol,
            "bf16_exact_share": exact, "window_s": NEW_WINDOW_S, **times, **library,
            **roofline(n_bytes, 2 * stage_macs(bb, g), "int8")}


def phase_int8_mid_kernels(torch, dev):
    """The int8 stem and stage 2/3 kernels on a He-initialised resnet50 with
    random BN, calibrated (int8_stem, pallas_mid, q_from = 1) on 8 and on 32
    random 256 px images; B = 8 makes each line, B = 32 (and stage 3) stand
    beside it."""
    from mhentropy_tpu_torch.models import stage2_int8_cuda

    res = he_resnet50(torch, dev, 20)
    g = torch.Generator(device=dev).manual_seed(20)
    stems, stages = [], []
    with torch.inference_mode():
        for bb in MID_BATCHES:
            images = torch.randn((bb, 256, 256, 3), generator=g, device=dev)
            spec, qtree, x2 = calibrated_mid(torch, res, images)
            stems.append(stem_int8_case(torch, res, images, qtree["stem"],
                                        qtree["sites"]["stem/conv1"]))
            stages.append(stage_int8_case(torch, spec, res, qtree, x2, 2))
            x3 = stage2_int8_cuda.stage_forward_q(x2, qtree["stage2"], 2)
            stages.append(stage_int8_case(torch, spec, res, qtree, x3, 3))
            if bb == BATCH:
                # Where the two stages' device time goes, launch by launch.
                trace = trace_steps(torch, lambda: (
                    stage2_int8_cuda.stage_forward_q(x2, qtree["stage2"], 2),
                    stage2_int8_cuda.stage_forward_q(x3, qtree["stage3"], 3)),
                    stages[-2]["ms"]["median"] + stages[-1]["ms"]["median"], n=2)
            del images, qtree, x2, x3
    stem = {"name": "stem_int8", "source": "mhentropy_tpu_torch/csrc/stem_int8.cu",
            "replaces": "mhentropy_tpu/models/stem_int8.py:122", **stems[0],
            "library": None, "other_shapes": [side_line(c) for c in stems[1:]]}
    # stages: [stage 2 B=8, stage 3 B=8, stage 2 B=32, stage 3 B=32]
    mid = {"name": "stage2_int8", "source": "mhentropy_tpu_torch/csrc/stage2_int8.cu",
           "replaces": "mhentropy_tpu/models/stage2_int8.py:217", **stages[0],
           "library": "models/quant.py::walk_stage (torch._int_mm)",
           "other_shapes": [side_line(c) for c in stages[1:]], "trace": trace}
    return [stem, mid]


def phase_gemm_probe(torch, dev):
    """The probe's `lower` run (one launch of each kernel, each against its
    plain version), then each side timed against its plain version and its
    library call (torch._int_mm, torch.matmul in bf16)."""
    from mhentropy_tpu_torch import int8_gemm_probe as probe

    reset_launches()
    lowered = probe.main(["lower"])
    launches = read_launches()
    check(lowered["ok"] and launches["int8_gemm_probe_s8"] == 1
          and launches["int8_gemm_probe_bf16"] == 1,
          f"gemm probe: {lowered}, launches {launches}")
    m, k, n = probe.SHAPE
    x8, w8, xb, wb = probe.operands(m, k, n, dev)
    w8_kn, wb_kn = w8.T.contiguous(), wb.T.contiguous()
    sides = {"s8": (lambda: probe.gemm_s8(x8, w8), lambda: probe.plain_s8(x8, w8),
                    lambda: torch._int_mm(x8, w8_kn), "torch._int_mm", m * k + n * k + 4 * m * n,
                    "int8", lowered["max_abs_err_s8"], 0),
             "bf16": (lambda: probe.gemm_bf16(xb, wb), lambda: probe.plain_bf16(xb, wb),
                      lambda: torch.matmul(xb, wb_kn), "torch.matmul (bf16)",
                      2 * (m * k + n * k) + 2 * m * n, "bf16", lowered["max_abs_err_bf16"],
                      lowered["tol_bf16"])}
    out = []
    for side, (kernel_fn, plain_fn, library_fn, library, n_bytes, kind, err, tol) in \
            sides.items():
        times = ab_ms(torch, kernel_fn, plain_fn, NEW_WINDOW_S)
        out.append({"name": f"int8_gemm_probe_{side}",
                    "source": "mhentropy_tpu_torch/csrc/int8_gemm_probe.cu",
                    "replaces": "tools/mosaic_int8_probe.py:23", "shape": [m, k, n],
                    "max_abs_err": err, "tol": tol, "window_s": NEW_WINDOW_S, **times,
                    "library": library,
                    "library_ms": cuda_ms(torch, library_fn, NEW_WINDOW_S),
                    **roofline(n_bytes, 2 * m * k * n, kind)})
    ratio = out[1]["graph_ms"]["median"] / out[0]["graph_ms"]["median"]
    for r in out:
        r["ratio_bf16_over_s8_graph"] = ratio
    return out, launches


def phase_probes(torch, dev):
    """The stem and stage-1 probes: each probe's `check` run (its launches
    counted), then each kernel, and each cut of the stem body, timed against
    its plain version at B = 32 (the stem cuts also at half the conv rows,
    to show that each cut's work scales), with the yardsticks beside: cuDNN's
    stem and the stem kernel (csrc/stem.cu) at (32, 256, 256, 3), cuDNN's
    stage 1 and the stage-1 kernel (csrc/stage1.cu) at (32, 64, 64, 64)."""
    from mhentropy_tpu_torch import stage1_probe, stem_cost_attrib, stem_probe
    from mhentropy_tpu_torch.models import stage1_cuda, stem_cuda

    reset_launches()
    checks = {m.__name__.rsplit(".", 1)[1]: m.main(["check"])
              for m in (stem_probe, stem_cost_attrib, stage1_probe)}
    launches = read_launches()
    want = {"stem_probe": 1, "stem_cost_attrib": 2 * len(stem_probe.PHASES),
            "stage1_probe_a": 3, "stage1_probe_b": 3}
    check(all(c["ok"] for c in checks.values())
          and all(v == want.get(k, 0) for k, v in launches.items()),
          f"probes: check runs {checks}, launches {launches}, expected {want} and no others")
    b = stem_probe.B
    # Yardsticks: cuDNN's stem (probe_xla_step's ops) and the stem kernel.
    image, w, scale, shift = stem_probe.cudnn_stem_operands(b, dev)
    wf, bias = stem_cuda.fold(w.cpu(), scale.cpu(), shift.cpu(), torch.zeros(64),
                              torch.ones(64))
    wf, bias = wf.to(dev), bias.to(dev)
    cudnn = lambda: stem_probe.cudnn_stem(image, w, scale, shift)  # noqa: E731
    stem_yard = {"library": "cuDNN conv 7x7/2 + BN + ReLU + maxpool (bf16)",
                 "library_ms": cuda_ms(torch, cudnn, NEW_WINDOW_S),
                 "library_graph_ms": cuda_ms(torch, graphed(torch, cudnn), NEW_WINDOW_S),
                 "stem_kernel_graph_ms": cuda_ms(torch, graphed(
                     torch, lambda: stem_cuda.stem_forward(image, wf, bias)), NEW_WINDOW_S)}
    out = []
    planes32, a = stem_probe.inputs(b, dev)
    env = stem_probe.stem_probe(planes32, a)
    ref = stem_probe.phase_plain("gemm", planes32, a)
    err, tol = (env - ref).abs().max().item(), 1e-5 * ref.abs().max().item()
    check(err <= tol, f"stem probe: max-abs error {err} > {tol}")
    out.append({"name": "stem_probe", "source": "mhentropy_tpu_torch/csrc/stem_probe.cu",
                "replaces": "tools/stem_probe.py:32", "shape": list(planes32.shape),
                "max_abs_err": err, "tol": tol, "window_s": NEW_WINDOW_S,
                **ab_ms(torch, lambda: stem_probe.stem_probe(planes32, a),
                        lambda: stem_probe.phase_plain("gemm", planes32, a), NEW_WINDOW_S),
                **stem_yard,
                **roofline(planes32.numel() * 4 + a.numel() * 2 + env.numel() * 4,
                           stem_probe.flops(b), "bf16")})
    planes, a = stem_probe.inputs(b, dev, dtype=torch.bfloat16)
    g, bb, s = stem_probe.epilogue_operands(dev)
    cuts = []
    for rows in stem_cost_attrib.CONV_ROWS:
        for phase in stem_probe.PHASES:
            got = stem_cost_attrib.attrib_forward(planes, a, g, bb, s, phase, rows)
            ref = stem_probe.phase_plain(phase, planes, a, g, bb, s, rows)
            err, tol = (got - ref).abs().max().item(), stem_cost_attrib.tolerance(phase, ref)
            check(err <= tol, f"stem cut {phase} at {rows} rows: max-abs error {err} > {tol}")
            gemm = phase in ("gemm", "full")
            n_bytes = planes.numel() * 2 + got.numel() * 4 + (a.numel() * 2 if gemm else 0) + (
                (g.numel() + bb.numel()) * 4 + s.numel() * 2 if phase == "full" else 0)
            cuts.append({"phase": phase, "conv_rows": rows, "shape": list(planes.shape),
                         "max_abs_err": err, "tol": tol,
                         **ab_ms(torch, lambda: stem_cost_attrib.attrib_forward(
                             planes, a, g, bb, s, phase, rows),
                             lambda: stem_probe.phase_plain(phase, planes, a, g, bb, s, rows),
                             NEW_WINDOW_S),
                         **roofline(n_bytes, stem_probe.flops(b, rows) if gemm else 0, "bf16")})
    full = cuts[stem_probe.PHASES.index("full")]
    out.append({"name": "stem_cost_attrib", "source": "mhentropy_tpu_torch/csrc/stem_probe.cu",
                "replaces": "tools/stem_cost_attrib.py:32", **full, "window_s": NEW_WINDOW_S,
                **stem_yard, "other_shapes": [side_line(c) for c in cuts if c is not full]})
    # Stage 1: both layouts, against cuDNN's stage 1 and the stage-1 kernel.
    x, folded = stage1_probe.yardsticks(b, dev)
    stage_yard = {"library": "cuDNN stage 1 (stage1_cuda.stage1_plain, bf16, eval BN)",
                  "library_ms": cuda_ms(torch, lambda: stage1_cuda.stage1_plain(x, folded),
                                        NEW_WINDOW_S),
                  "library_graph_ms": cuda_ms(torch, graphed(
                      torch, lambda: stage1_cuda.stage1_plain(x, folded)), NEW_WINDOW_S),
                  "stage1_kernel_graph_ms": cuda_ms(torch, graphed(
                      torch, lambda: stage1_cuda.stage1_forward(x, folded)), NEW_WINDOW_S)}
    wa = stage1_probe.weights_a(dev)
    wb = stage1_probe.to_b(wa)
    xa = stage1_probe.input_a(b, dev)
    xb = xa.transpose(1, 2).contiguous()
    n_weights = sum(v.numel() * 2 for v in wa.values())
    for name, fwd, plain, xin, ws in (
            ("stage1_probe_a", stage1_probe.forward_a, stage1_probe.plain_a, xa, wa),
            ("stage1_probe_b", stage1_probe.forward_b, stage1_probe.plain_b, xb, wb)):
        got = fwd(xin, ws)
        ref = plain(xin, ws)
        err, tol = (got.float() - ref.float()).abs().max().item(), stage1_probe.tolerance(ref)
        check(err <= tol, f"{name}: max-abs error {err} > {tol}")
        line = (":49" if name.endswith("a") else ":170")
        out.append({"name": name, "source": "mhentropy_tpu_torch/csrc/stage1_probe.cu",
                    "replaces": f"tools/stage1_probe.py{line}", "shape": list(xin.shape),
                    "max_abs_err": err, "tol": tol, "window_s": NEW_WINDOW_S,
                    **ab_ms(torch, lambda: fwd(xin, ws), lambda: plain(xin, ws), NEW_WINDOW_S),
                    **stage_yard,
                    **roofline(xin.numel() * 2 + got.numel() * 2 + n_weights,
                               stage1_probe.flops(b), "bf16")})
    return out, launches


def phase_bench(torch, dev):
    """The port's bench (mhentropy_tpu_torch/bench.py) at its headline shape
    (N = 100, B = 32), BENCH_STEPS steps a round: every section runs, none
    fails, the headline's rate and mfu are finite; the launches of the run."""
    from mhentropy_tpu_torch import bench

    reset_launches()
    out = bench.main(["--steps", str(BENCH_STEPS)])
    torch.cuda.synchronize()
    launches = read_launches()
    check(out["value"] > 0 and math.isfinite(out["mfu"]) and 0 < out["mfu"] < 1,
          f"bench: headline {out['value']}, mfu {out['mfu']}")
    check(not any(k.endswith("_failed") for k in out["skipped"]) and "int8_error" not in out,
          f"bench: sections failed: {out['skipped']} {out.get('int8_error')}")
    for name in ("stem", "stage1", "realnvp_sampler", "stage1_int8", "realnvp_sampler_int8"):
        check(launches[name] > 0 or "int8" in out["skipped"],
              f"bench: {name} not launched: {launches}")
    return {**out, "launches": launches}


def phase_int8_opt_in(torch, dev):
    """mhent.sample_hypotheses(quant=) at B=8, N=200 on configs/ho3d.yaml at
    full width (fresh seeded weights, O(1) flow), with QuantSpec(int8_stem,
    pallas_mid) at q_from 0 and 1, calibrated on that batch: the launches of
    each run, and xyz, uv against the default int8 spec on the same images,
    base noise and int8 sampler tree."""
    from mhentropy_tpu_torch import bench_quant
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import mhent, quant
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    net = mhent.init(engine.build_model_config(load_cfg("configs/ho3d.yaml")), seed=0)
    o1_flow(torch, net, 21)
    mhent.prepare(net, dev)
    model = engine.load_mano_model(device=dev)
    fold = mano.fold_keypoints(model)
    g = torch.Generator(device=dev).manual_seed(21)
    images = torch.rand((BATCH, 256, 256, 3), generator=g, device=dev) * 2 - 1
    noise = torch.randn((N_HYPO * BATCH, 45), generator=g, device=dev) * 0.8
    results = {}
    with torch.inference_mode():
        for q_from in (0, 1):
            default = quant.quantize_sampler_into(*bench_quant.quantize(net, images, q_from),
                                                  net, images, temp=0.8)
            spec, qtree = bench_quant.quantize(net, images, q_from, int8_stem=True,
                                               pallas_mid=True)
            opt = (spec._replace(int8_sampler=True), {**qtree, "flow": default[1]["flow"]})
            outs = {}
            for label, q in (("opt_in", opt), ("default", default)):
                reset_launches()
                out = mhent.sample_hypotheses(model, net, images, n=N_HYPO, temp=0.8,
                                              mods=("xyz", "uv"), base_noise=noise, fold=fold,
                                              quant=q)
                torch.cuda.synchronize()
                outs[label] = ({k: out[k].float().cpu().numpy() for k in ("xyz", "uv")},
                               read_launches())
            launches = outs["opt_in"][1]
            want = {"stem_int8": 1, "stage2_int8": 10, "realnvp_sampler_int8": 1,
                    ("stage1_int8" if q_from == 0 else "stage1"): 3}
            check(all(v == want.get(k, 0) for k, v in launches.items()),
                  f"int8 opt-in q_from={q_from}: launches {launches}, expected {want} and no "
                  "others")
            a, b = outs["opt_in"][0], outs["default"][0]
            for k in ("xyz", "uv"):
                check(np.isfinite(a[k]).all() and np.isfinite(b[k]).all()
                      and a[k].shape == b[k].shape == (N_HYPO, BATCH, 63 if k == "xyz" else 42),
                      f"int8 opt-in q_from={q_from}: {k} shapes {a[k].shape} or non-finite")
            diff = {k: float(np.abs(a[k] - b[k]).max()) for k in ("xyz", "uv")}
            mean = {k: float(np.abs(a[k] - b[k]).mean()) for k in ("xyz", "uv")}
            print(f"int8 opt-in q_from={q_from}: launches {launches}; against the default int8 "
                  f"spec max-abs {diff}, mean {mean} (tolerance {INT8_TOL})", flush=True)
            for k, v in diff.items():
                check(v <= INT8_TOL[k], f"int8 opt-in q_from={q_from}: {k} differs by {v}")
            results[f"q_from_{q_from}"] = {"launches": launches, "default_launches":
                                           outs["default"][1], "max_abs": diff,
                                           "mean_abs": mean}
    return results


def export_variant(torch, export, model, net, quant, images, noise, want: dict) -> dict:
    """One artifact at B = BATCH, N = N_HYPO with EXPORT_MODS: export, save
    and load; its launches against the live sampler's (each as `want`, no
    others), its outputs against the live sampler's, both timed in turns
    with a trace of each (busy share)."""
    live = export.make_sample_fn(model, net, N_HYPO, 0.8, EXPORT_MODS, quant=quant)
    t0 = time.perf_counter()
    blob = export.export_sampler(model, net, BATCH, n=N_HYPO, temp=0.8, mods=EXPORT_MODS,
                                 quant=quant)
    t1 = time.perf_counter()
    sampler = export.load_sampler(blob)
    t2 = time.perf_counter()
    check(sampler.device == "cuda", f"export: artifact recorded {sampler.device!r}")
    outs, launches = {}, {}
    with torch.no_grad():
        for side, fn in (("live", live), ("loaded", sampler.call)):
            fn(images, noise)
            torch.cuda.synchronize()
            reset_launches()
            outs[side] = fn(images, noise)
            torch.cuda.synchronize()
            launches[side] = read_launches()
    check(launches["loaded"] == launches["live"]
          and all(v == want.get(k, 0) for k, v in launches["loaded"].items()),
          f"export: launches loaded {launches['loaded']}, live {launches['live']}, expected "
          f"{want} and no others")
    tol = {**SLICE_TOL, "verts": DET_TOL["verts"]}
    err = {}
    for k in EXPORT_MODS:
        a, b = outs["loaded"][k].float(), outs["live"][k].float()
        check(a.shape == b.shape and bool(a.isfinite().all()),
              f"export: {k} {tuple(a.shape)} against {tuple(b.shape)}, or non-finite")
        err[k] = (a - b).abs().max().item()
        check(err[k] <= tol[k], f"export: the loaded program's {k} differs by {err[k]}")
    t3 = time.perf_counter()
    with torch.no_grad():
        ms = windows_ms(torch, {"live": lambda: live(images, noise),
                                "loaded": lambda: sampler.call(images, noise)}, EXPORT_WINDOW_S)
        busy = {side: {k: v for k, v in trace_steps(
            torch, fn, ms[side]["median"], n=1, top=0).items()
            if k in ("device_ms_per_step", "device_ops_per_step", "busy_share")}
            for side, fn in (("live", lambda: live(images, noise)),
                             ("loaded", lambda: sampler.call(images, noise)))}
    return {"bytes": len(blob), "export_s": t1 - t0, "load_s": t2 - t1,
            "check_s": t3 - t2, "timing_s": time.perf_counter() - t3,
            "launches": launches["loaded"], "max_abs_loaded_vs_live": err, "ms": ms,
            "trace": busy, "sampler": sampler}


def phase_export(torch, dev):
    """mhentropy_tpu_torch/export.py on configs/ho3d.yaml at full width
    (resnet50 at 256 px, 12 x 512 RealNVP, O(1) flow, synthetic MANO, fresh
    seeded weights), B = 8, N = 200, mods xyz, uv and verts: the float
    sampler, int8 (encoder and int8 sampler, calibrated as serve.py does),
    the two opt-ins (int8_stem, pallas_mid; q_from 0) and the glow MHEnt
    (network.regressor glow), each exported, saved to bytes, loaded and
    called (export_variant); a CUDA artifact called with CPU inputs must
    raise. Fails if any part fails or the phase takes more than
    EXPORT_PHASE_S."""
    from mhentropy_tpu_torch import bench_quant, export
    from mhentropy_tpu_torch.models import mhent, quant
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    t0 = time.perf_counter()
    cfg = load_cfg("configs/ho3d.yaml")
    model = engine.load_mano_model(device=dev)
    g = torch.Generator(device=dev).manual_seed(23)
    images = torch.rand((BATCH, 256, 256, 3), generator=g, device=dev) * 2 - 1
    noise = torch.randn((N_HYPO * BATCH, 45), generator=g, device=dev) * 0.8
    net = mhent.init(engine.build_model_config(cfg), seed=0)
    o1_flow(torch, net, 23)
    mhent.prepare(net, dev)
    with torch.no_grad():
        spec, qtree = quant.quantize_encoder(net.feat_extractor, images,
                                             q_from=cfg.tpu.quantize_q_from)
        default = quant.quantize_sampler_into(spec, qtree, net, images, temp=max(1.0, 0.8))
        spec, qtree = bench_quant.quantize(net, images, 0, int8_stem=True, pallas_mid=True)
    opt_in = (spec._replace(int8_sampler=True), {**qtree, "flow": default[1]["flow"]})
    cfg.network.regressor = "glow"
    glow_net = mhent.prepare(mhent.init(engine.build_model_config(cfg), seed=0), dev)
    check(default[0].q_from == 0 and glow_net.packed_flow is not None,
          f"export: int8 q_from {default[0].q_from}; glow packed {glow_net.packed_flow is not None}")
    print(f"export: set-up (two nets, three calibrations) {time.perf_counter() - t0:.1f} s",
          flush=True)
    lbs = {"lbs_blend": 1}
    variants = {
        "float": (net, None, {"stem": 1, "stage1": 3, "realnvp_sampler": 1, **lbs}),
        "int8": (net, default, {"stem": 1, "stage1_int8": 3, "realnvp_sampler_int8": 1, **lbs}),
        "int8_opt_in": (net, opt_in, {"stem_int8": 1, "stage1_int8": 3, "stage2_int8": 10,
                                      "realnvp_sampler_int8": 1, **lbs}),
        "glow": (glow_net, None, {"stem": 1, "stage1": 3, "glow_sampler": 1, **lbs})}
    out = {}
    for label, (n_, q, want) in variants.items():
        r = export_variant(torch, export, model, n_, q, images, noise, want)
        sampler = r.pop("sampler")
        out[label] = r
        ms = r["ms"]
        print(f"export {label}: {r['bytes']} bytes, export {r['export_s']:.1f} s, load "
              f"{r['load_s']:.1f} s, checks {r['check_s']:.1f} s, timing {r['timing_s']:.1f} s; "
              f"launches {r['launches']} (the live call's); loaded vs live "
              f"max-abs {r['max_abs_loaded_vs_live']}; ms a call (B={BATCH}, N={N_HYPO}) loaded "
              f"{ms['loaded']['median']:.3f} [{ms['loaded']['min']:.3f}, "
              f"{ms['loaded']['max']:.3f}], live {ms['live']['median']:.3f} "
              f"[{ms['live']['min']:.3f}, {ms['live']['max']:.3f}]; busy loaded "
              f"{r['trace']['loaded']['busy_share']:.3f}, live "
              f"{r['trace']['live']['busy_share']:.3f}", flush=True)
    try:
        sampler.call(images.cpu(), noise.cpu())
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None, "export: a CUDA artifact served CPU inputs")
    print(f"export: a CUDA artifact called with CPU inputs raises: {raised}", flush=True)
    wall = time.perf_counter() - t0
    print(f"export phase: {wall:.1f} s", flush=True)
    check(wall <= EXPORT_PHASE_S, f"export: the phase took {wall:.1f} s")
    return {"variants": out, "cpu_inputs_raise": raised, "wall_s": wall}

def phase_bench_quant(torch, dev):
    """bench_quant's steps at N=100, B=32 (q_from = 1, its default): the
    bf16, int8, int8 + mid, int8 + int8 stem and int8 + both sides in
    alternating windows of BENCH_QUANT_STEPS steps; a torch.profiler trace
    of two steps of the int8, int8 + mid and int8 + int8 stem sides (the
    last gives the W8A8 stem's device time inside the step)."""
    from mhentropy_tpu_torch import bench_quant

    bb, n = BENCH_QUANT
    model, net = bench_quant.build(dev)
    images = bench_quant.images_pool(net, bb, dev)
    sides = bench_quant.make_sides(net, images, 1, "mid")
    sides["int8_stem"] = bench_quant.quantize(net, images[0], 1, int8_stem=True)
    sides["int8_stem_mid"] = bench_quant.quantize(net, images[0], 1, int8_stem=True,
                                                  pallas_mid=True)
    steps = bench_quant.make_steps(model, net, images, n, sides)
    out = bench_quant.run(steps, BENCH_QUANT_STEPS, True, bb, n)
    for side in ("int8", "int8_mid", "int8_stem"):
        out[side]["trace"] = trace_steps(torch, steps[side], out[side]["ms_per_step"], n=2)
    return out


def time_requests(server, imgs: np.ndarray) -> dict:
    """Request latency through predict (host to host, the results copied
    back), steady state: RUNS windows of at least SLICE_WINDOW_S seconds."""
    server.predict(imgs)
    runs, n_requests = [], 0
    for _ in range(RUNS):
        count, t1 = 0, time.perf_counter()
        while time.perf_counter() - t1 < SLICE_WINDOW_S:
            server.predict(imgs)
            count += 1
        runs.append((time.perf_counter() - t1) * 1e3 / count)
        n_requests += count
    ms = spread(runs)
    return {"ms_per_request": ms, "requests": n_requests,
            "hypotheses_per_s": imgs.shape[0] * N_HYPO / ms["median"] * 1e3}


def o1_flow(torch, net, seed: int) -> None:
    """Redraw the served flow's linears at the torch-default O(1) scale:
    under the near-identity init x stays close to z0, and a comparison
    would hardly test the sampler."""
    torch.manual_seed(seed)
    for m in net.q_z_giv_i.modules():
        if isinstance(m, torch.nn.Linear):
            m.reset_parameters()


def http(url: str, body: bytes | None = None, headers: dict | None = None):
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def phase_slice(torch, dev):
    from mhentropy_tpu_torch import serve
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.utils.config import load_cfg

    cfg = load_cfg("configs/ho3d.yaml")
    t0 = time.perf_counter()
    server = serve.InferenceServer(cfg, max_batch=BATCH, device=dev, seed=0)
    check(server.n_hypo == N_HYPO and server.image_size == 256,
          f"slice: n_hypo {server.n_hypo}, image_size {server.image_size}")
    print(f"slice: server built in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.RandomState(0)
    size = server.image_size
    requests = [(1, "uint8"), (3, "float32"), (BATCH, "uint8"), (BATCH, "uint8")]
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    warm = threading.Event()
    errors = []

    def serve_thread():
        # Warm up in the thread that serves, as serve.main does: cuDNN's plan
        # cache and the cuBLAS handle are per thread.
        try:
            server.warmup()
        except Exception as e:  # re-raised by the main thread
            errors.append(e)
            return
        finally:
            warm.set()
        httpd.serve_forever()

    thread = threading.Thread(target=serve_thread, daemon=True)
    thread.start()
    try:
        check(warm.wait(timeout=600), "slice: warmup did not finish")
        if errors:
            raise errors[0]
        print(f"slice: warmed up after {time.perf_counter() - t0:.1f} s", flush=True)
        reset_launches()
        status, health = http(base + "/healthz")
        check(status == 200 and health.get("ok") is True and health["n_hypo"] == N_HYPO,
              f"slice: /healthz {status} {health}")
        http_ms = []
        for b, dt in requests:
            raw = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
            images = raw if dt == "uint8" else raw.astype(np.float32) * (2 / 255) - 1
            t1 = time.perf_counter()
            status, out = http(base + "/predict", images.tobytes(),
                               {"X-Batch": str(b), "X-Dtype": dt})
            http_ms.append((time.perf_counter() - t1) * 1e3)
            xyz, uv = np.asarray(out["xyz"]), np.asarray(out["uv"])
            check(status == 200, f"slice: /predict B={b} {dt}: HTTP {status}")
            check(xyz.shape == (b, N_HYPO, 21, 3) and uv.shape == (b, N_HYPO, 21, 2),
                  f"slice: /predict B={b} {dt}: shapes {xyz.shape} {uv.shape}")
            check(np.isfinite(xyz).all() and np.isfinite(uv).all(),
                  f"slice: /predict B={b} {dt}: non-finite outputs")
            print(f"slice: POST /predict B={b} {dt}: HTTP {status}, server "
                  f"{out['ms']:.3f} ms, round trip {http_ms[-1]:.3f} ms", flush=True)
        launches = read_launches()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    for name in ("stem", "stage1", "realnvp_sampler"):
        check(launches[name] > 0, f"slice: kernel {name} was not launched on the main path")
    print(f"slice: launches during the requests: {launches}", flush=True)

    # Request latency through predict (host to host), steady state.
    timing = {f"b{b}": time_requests(
        server, rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)) for b in (BATCH, 1)}

    # Kernel path vs plain path on one batch, same base noise, O(1) flow.
    o1_flow(torch, server.net, 7)
    mhent.prepare(server.net, dev)
    images = rng.randint(0, 256, (BATCH, size, size, 3)).astype(np.uint8)
    g = torch.Generator(device=dev).manual_seed(7)
    noise = torch.randn((N_HYPO * BATCH, 45), generator=g, device=dev) * server.temp
    kern = server.predict(images, base_noise=noise)
    server.net.set_kernels(False)
    plain = server.predict(images, base_noise=noise)
    server.net.set_kernels(True)
    for k in ("xyz", "uv"):
        check(np.isfinite(kern[k]).all() and np.isfinite(plain[k]).all(),
              f"slice: non-finite {k} under the O(1) flow")
    agree = {k: float(np.abs(kern[k] - plain[k]).max()) for k in ("xyz", "uv")}
    scale = {k: float(np.abs(plain[k]).max()) for k in ("xyz", "uv")}
    print(f"slice: kernel vs plain path, max-abs difference {agree} (tolerance {SLICE_TOL}; "
          f"largest plain value {scale})", flush=True)
    for k, v in agree.items():
        check(v <= SLICE_TOL[k], f"slice: kernel and plain paths differ in {k} by {v}")
    return launches, agree, http_ms, timing


def phase_int8_serving(torch, dev):
    """InferenceServer(quantize=True, max_batch=8) on configs/ho3d.yaml: a
    B=8 request (int8 bucket, calibrated on it) and a B=1 request (float
    bucket), each path with its launches; B=8 int8 latency; int8 vs float
    on one batch under an O(1) flow, the same base noise."""
    from mhentropy_tpu_torch import serve
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.utils.config import load_cfg

    t0 = time.perf_counter()
    server = serve.InferenceServer(load_cfg("configs/ho3d.yaml"), max_batch=BATCH,
                                   quantize=True, transports=("u8",), device=dev, seed=0)
    server.warmup()
    print(f"int8: server built and warmed up in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.RandomState(1)
    size = server.image_size
    launches = {}
    for b in (BATCH, 1):
        imgs = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
        reset_launches()
        out = server.predict(imgs)
        torch.cuda.synchronize()
        launches[f"b{b}"] = read_launches()
        check(out["xyz"].shape == (b, N_HYPO, 21, 3) and out["uv"].shape == (b, N_HYPO, 21, 2)
              and np.isfinite(out["xyz"]).all() and np.isfinite(out["uv"]).all(),
              f"int8: B={b} outputs {out['xyz'].shape} {out['uv'].shape} or non-finite")
        print(f"int8: B={b} request launches {launches[f'b{b}']}", flush=True)
    spec = server._quant[0]
    check(server._quant_ready and spec.q_from == 0 and spec.int8_sampler,
          f"int8: spec {spec}, calibrated on a real batch: {server._quant_ready}")
    l8, l1 = launches[f"b{BATCH}"], launches["b1"]
    for name in ("stem", "stage1_int8", "realnvp_sampler_int8"):
        check(l8[name] > 0, f"int8: kernel {name} was not launched by the B={BATCH} request")
    check(l8["stage1"] == 0 and l8["realnvp_sampler"] == 0,
          f"int8: the B={BATCH} request ran float kernels {l8}")
    for name in ("stem", "stage1", "realnvp_sampler"):
        check(l1[name] > 0, f"int8: kernel {name} was not launched by the B=1 (float) request")
    check(l1["stage1_int8"] == 0 and l1["realnvp_sampler_int8"] == 0,
          f"int8: the B=1 request ran int8 kernels {l1}")
    timing = time_requests(server, rng.randint(0, 256, (BATCH, size, size, 3)).astype(np.uint8))

    o1_flow(torch, server.net, 8)
    mhent.prepare(server.net, dev)
    server._quant_ready = False  # recalibrate on the next int8 batch
    images = rng.randint(0, 256, (BATCH, size, size, 3)).astype(np.uint8)
    g = torch.Generator(device=dev).manual_seed(8)
    noise = torch.randn((N_HYPO * BATCH, 45), generator=g, device=dev) * server.temp
    q = server.predict(images, base_noise=noise)
    server.quantize = False
    f = server.predict(images, base_noise=noise)
    server.quantize = True
    for k in ("xyz", "uv"):
        check(np.isfinite(q[k]).all() and np.isfinite(f[k]).all(),
              f"int8: non-finite {k} under the O(1) flow")
    diff = {k: float(np.abs(q[k] - f[k]).max()) for k in ("xyz", "uv")}
    mean = {k: float(np.abs(q[k] - f[k]).mean()) for k in ("xyz", "uv")}
    scale = {k: float(np.abs(f[k]).max()) for k in ("xyz", "uv")}
    print(f"int8: int8 vs float serving, max-abs difference {diff}, mean {mean} (tolerance "
          f"{INT8_TOL}; largest float value {scale})", flush=True)
    for k, v in diff.items():
        check(v <= INT8_TOL[k], f"int8: int8 and float serving differ in {k} by {v}")
    return launches, timing, {"max_abs": diff, "mean_abs": mean}


def phase_eval(torch, dev):
    """The run.py path (Experiment.train_baseline, epochs 0) on
    configs/ho3d.yaml, float and with tpu.quantize_encoder, then the eval
    step timed on one batch of the eval split."""
    import tempfile

    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    results = {}
    model_dirs = tempfile.TemporaryDirectory()
    for label, quantize in (("float", False), ("int8", True)):
        cfg = load_cfg("configs/ho3d.yaml")
        cfg.training.seed = 0
        cfg.tpu.quantize_encoder = quantize
        cfg.model_dir = os.path.join(model_dirs.name, label) + "/"
        tr = cfg.training
        check(tr.epochs == 0 and tr.batch_size == EVAL_BATCH and tr.test_samples == N_HYPO,
              f"eval: configs/ho3d.yaml has epochs {tr.epochs}, batch {tr.batch_size}, "
              f"N {tr.test_samples}")
        exp = engine.Experiment(cfg, device=dev)
        t0 = time.perf_counter()
        reset_launches()
        summary = exp.train_baseline()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(all(math.isfinite(v) for v in summary.values()) and len(summary) >= 20,
              f"eval {label}: non-finite or missing metrics {summary}")
        want = ("stem", "stage1_int8", "realnvp_sampler_int8") if quantize else (
            "stem", "stage1", "realnvp_sampler")
        for name in want:
            check(launches[name] > 0, f"eval {label}: kernel {name} was not launched")
        # The reverse-KL draw, one per eval batch, runs the f32 sampler.
        n_batches = -(-128 // EVAL_BATCH)
        check(launches["realnvp_sampler_f32"] == n_batches,
              f"eval {label}: {launches['realnvp_sampler_f32']} f32 sampler launches for "
              f"{n_batches} batches")
        print(f"eval {label}: {wall:.1f} s for the run (dataset, calibration, 2 batches); "
              f"launches {launches}", flush=True)

        _, data = exp.make_datasets(which=("eval",))
        image, target = next(synthetic.batches(data, EVAL_BATCH, pad_remainder=True,
                                               device=dev))
        step = engine.make_eval_step(exp.model, exp.net, N_HYPO, tr.eval_temp,
                                     quant_spec=exp.quant_spec, fold=exp.fold)
        g = torch.Generator(device=dev).manual_seed(9)
        kld = torch.randn((exp.model_cfg.n_train_hypotheses * EVAL_BATCH, 45), generator=g,
                          device=dev)
        hypo = torch.randn((N_HYPO * EVAL_BATCH, 45), generator=g, device=dev) * tr.eval_temp
        from mhentropy_tpu_torch.flows import cuda_sampler, realnvp

        fused_diff = cuda_sampler.sample_fused_diff

        def plain_diff(flow, feat, n, z0_rows):
            cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
            return realnvp.sample(flow, z0_rows, cproj=cproj.repeat(1, 1, n, 1))

        # "plain_kld_draw": the reverse-KL draw (n_kld x B = 640 rows) on the
        # plain f32 flow, the N x B = 12,800-row draw on its kernel: the
        # routing before the f32 sampler kernel existed.
        routes = {"kernel": fused_diff, "plain_kld_draw": plain_diff}

        def run_step(route):
            cuda_sampler.sample_fused_diff = routes[route]
            try:
                step(image, target, kld, hypo, exp.qtree)
            finally:
                cuda_sampler.sample_fused_diff = fused_diff

        for route in routes:
            run_step(route)
        torch.cuda.synchronize()
        timed = ("kernel",) if quantize else tuple(routes)
        runs = {route: [] for route in timed}
        n_batches = 0
        for r in range(RUNS):
            for route in (timed if r % 2 == 0 else timed[::-1]):
                count, t1 = 0, time.perf_counter()
                while time.perf_counter() - t1 < STEP_WINDOW_S:
                    run_step(route)
                    count += 1
                torch.cuda.synchronize()
                runs[route].append((time.perf_counter() - t1) * 1e3 / count)
                n_batches += count
        ms = spread(runs["kernel"])
        results[label] = {"summary": summary, "launches": launches, "run_s": wall,
                          "ms_per_batch": ms, "batches": n_batches,
                          "hypotheses_per_s": EVAL_BATCH * N_HYPO / ms["median"] * 1e3}
        if not quantize:
            results[label]["ms_per_batch_plain_kld_draw"] = spread(runs["plain_kld_draw"])
        exp.close()
    model_dirs.cleanup()
    return results


def phase_verts(torch, dev):
    """mhent.sample_hypotheses with its default mods at B=64, N=200: the
    mesh goes through the LBS blend kernel; the same rows decoded with the
    plain blend give the same vertices."""
    from mhentropy_tpu_torch.core import lbs_cuda, mano
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    model_cfg = engine.build_model_config(load_cfg("configs/ho3d.yaml"))
    net = mhent.prepare(mhent.init(model_cfg, seed=0), dev)
    o1_flow(torch, net, 10)
    mhent.prepare(net, dev)
    model = engine.load_mano_model(device=dev)
    fold = mano.fold_keypoints(model)
    g = torch.Generator(device=dev).manual_seed(10)
    images = torch.randn((EVAL_BATCH, 256, 256, 3), generator=g, device=dev)
    noise = torch.randn((N_HYPO * EVAL_BATCH, 45), generator=g, device=dev) * 0.8
    with torch.inference_mode():
        reset_launches()
        out = mhent.sample_hypotheses(model, net, images, n=N_HYPO, temp=0.8,
                                      base_noise=noise, fold=fold)
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches["lbs_blend"] > 0, "verts: the LBS blend kernel was not launched")
        check(out["verts"].shape == (N_HYPO, EVAL_BATCH, 778 * 3)
              and bool(torch.isfinite(out["verts"]).all()),
              f"verts: shape {tuple(out['verts'].shape)} or non-finite")
        rows = N_HYPO * EVAL_BATCH
        th_bt, logs_t = out["th_bt"].reshape(rows, -1), out["logs_t"].reshape(rows, -1)
        kernel_blend = lbs_cuda.lbs_blend
        lbs_cuda.lbs_blend = lbs_cuda.lbs_blend_plain
        try:
            plain = mhent.decode(model, net.cfg, th_bt, logs_t, mods=("verts",),
                                 inv_norm=True, fold=fold)["verts"].reshape(out["verts"].shape)
        finally:
            lbs_cuda.lbs_blend = kernel_blend
    err = (out["verts"] - plain).abs().max().item()
    print(f"verts: launches {launches}; kernel vs plain blend max-abs {err:.3g} "
          f"(tolerance {VERTS_TOL}, largest {plain.abs().max().item():.3g})", flush=True)
    check(err <= VERTS_TOL, f"verts: kernel and plain blends differ by {err}")
    return launches, err


def max_abs(a: dict, b: dict, keys) -> dict:
    return {k: float((a[k].float() - b[k].float()).abs().max()) for k in keys}


def phase_prohmr(torch, dev):
    """The Humans path: eval_prohmr at B=8, N=100 (resnet50 at 224 px, the
    ConditionalGlow(144, 1024, 4, 2, context 2048), the 6,890-vertex SMPL
    fixture, fresh seeded weights) with its launches counted; the kernel path
    against the plain path and int8 against float on that batch with the
    same base noise; then bench_prohmr's steps at B=32, N=100 for the
    kernel, plain and int8 variants in alternating windows, and the peak
    memory."""
    from mhentropy_tpu_torch import bench_prohmr, eval_prohmr
    from mhentropy_tpu_torch.flows.glow import GlowConfig
    from mhentropy_tpu_torch.models import quant

    t0 = time.perf_counter()
    model, net = eval_prohmr.build(dev)
    check(model.v_template.shape[0] == 6890 and net.cfg.image_size == 224
          and net.cfg.flow == GlowConfig(144, 1024, 4, 2, 2048)
          and net.cfg.encoder.backbone == "resnet50",
          f"prohmr: not the ProHMR geometry: {net.cfg}, V={model.v_template.shape[0]}")
    b, n = PROHMR_EVAL
    image, gt = eval_prohmr.synthetic_batch(model, net, b)
    g = torch.Generator(device=dev).manual_seed(16)
    noise = torch.randn((n * b, 144), generator=g, device=dev)
    eval_prohmr.evaluate(model, net, image, gt, n, noise=noise)  # cuDNN plans, the build
    torch.cuda.synchronize()
    print(f"prohmr: built and warmed up in {time.perf_counter() - t0:.1f} s", flush=True)
    reset_launches()
    samples, mets = eval_prohmr.evaluate(model, net, image, gt, n, noise=noise)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"stem": 1, "stage1": 3, "glow_sampler": 1, "lbs_blend": 1}
    check(all(v == want.get(k, 0) for k, v in launches.items()),
          f"prohmr: launches {launches}, expected {want} and no others")
    shapes = {k: tuple(samples[k].shape) for k in ("pose_6d", "log_q", "verts", "joints3d", "uv")}
    check(shapes == {"pose_6d": (n, b, 144), "log_q": (n, b), "verts": (n, b, 6890, 3),
                     "joints3d": (n, b, 24, 3), "uv": (n, b, 24, 2)}, f"prohmr: shapes {shapes}")
    check(all(bool(torch.isfinite(samples[k]).all()) for k in shapes)
          and all(bool(torch.isfinite(v).all()) for v in mets.values()),
          "prohmr: non-finite samples or metrics")
    metrics = {k: float(v.mean()) for k, v in mets.items()}
    print(f"prohmr: eval_prohmr B={b} N={n}: {metrics}; launches {launches}", flush=True)

    keys = ("joints3d", "uv", "log_q")
    net.set_kernels(False)
    plain, _ = eval_prohmr.evaluate(model, net, image, gt, n, noise=noise)
    net.set_kernels(True)
    agree = max_abs(samples, plain, keys)
    scale = {k: float(plain[k].abs().max()) for k in keys}
    print(f"prohmr: kernel vs plain path, max-abs difference {agree} (tolerance {PROHMR_TOL}; "
          f"largest plain value {scale})", flush=True)
    for k, v in agree.items():
        check(v <= PROHMR_TOL[k], f"prohmr: kernel and plain paths differ in {k} by {v}")

    with torch.inference_mode():
        q = quant.quantize_encoder(net.encoder, image)
    check(q[0].q_from == 0, f"prohmr: int8 spec {q[0]}")
    reset_launches()
    qs, qm = eval_prohmr.evaluate(model, net, image, gt, n, noise=noise, quant=q)
    torch.cuda.synchronize()
    q_launches = read_launches()
    want = {"stem": 1, "stage1_int8": 3, "glow_sampler": 1, "lbs_blend": 1}
    check(all(v == want.get(k, 0) for k, v in q_launches.items()),
          f"prohmr int8: launches {q_launches}, expected {want} and no others")
    check(all(bool(torch.isfinite(qs[k]).all()) for k in keys), "prohmr int8: non-finite")
    q_diff = max_abs(qs, samples, keys)
    q_mean = {k: float((qs[k] - samples[k]).abs().mean()) for k in keys}
    print(f"prohmr: int8 vs float, max-abs difference {q_diff}, mean {q_mean} (tolerance "
          f"{PROHMR_INT8_TOL}); launches {q_launches}", flush=True)
    for k, v in q_diff.items():
        check(v <= PROHMR_INT8_TOL[k], f"prohmr: int8 and float differ in {k} by {v}")
    del plain, qs

    bb, bn = PROHMR_BENCH
    steps = bench_prohmr.make_steps(model, net, bb, bn, ("kernel", "plain", "quant"))
    torch.cuda.reset_peak_memory_stats()
    runs = bench_prohmr.alternate(steps, True, RUNS, SLICE_WINDOW_S)
    peak = torch.cuda.max_memory_allocated() / 1e9
    bench = bench_prohmr.summary(runs, bb, bn)
    trace = trace_steps(torch, steps["kernel"], bench["kernel"]["ms_per_step"])
    net.set_kernels(True)
    return {"trace": trace, "launches": launches, "int8_launches": q_launches, "metrics": metrics,
            "int8_metrics": {k: float(v.mean()) for k, v in qm.items()},
            "kernel_vs_plain_max_abs": agree, "int8_vs_float_max_abs": q_diff,
            "int8_vs_float_mean_abs": q_mean, "bench": bench,
            "bench_runs_ms": runs, "peak_memory_gb": peak}


BN_SHAPES = ((64, 128, 128, 64), (64, 8, 8, 2048))


def phase_bn_sums(torch, dev):
    """Both BN sum kernels against their plain versions at resnet50's first
    and last BN shapes (B=64, 256 px), bf16 channels-last; the first shape's
    times go to the kernels' line, the second's beside them."""
    from mhentropy_tpu_torch.models import bn_cuda

    out = {}
    for i, shape in enumerate(BN_SHAPES):
        g = torch.Generator(device=dev).manual_seed(11 + i)
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        x, dy = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # NCHW views, NHWC memory
        check(x.is_contiguous(memory_format=torch.channels_last), "bn: input not channels-last")
        m, c = x.numel() // shape[-1], shape[-1]
        xf, dyf = x.float(), dy.float()
        scales = {"bn_stats_sums": (xf.abs().sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))),
                  "bn_grad_sums": (dyf.abs().sum((0, 2, 3)), (dyf * xf).abs().sum((0, 2, 3)))}
        del xf, dyf
        mean, invstd = torch.batch_norm_stats(x, 1e-5)
        fns = {"bn_stats_sums": (lambda: bn_cuda.stats_sums(x),
                                 lambda: bn_cuda.stats_sums_plain(x),
                                 lambda: torch.batch_norm_stats(x, 1e-5)),
               "bn_grad_sums": (lambda: bn_cuda.grad_sums(dy, x),
                                lambda: bn_cuda.grad_sums_plain(dy, x),
                                lambda: torch.batch_norm_backward_reduce(
                                    dy, x, mean, invstd, None, True, False, False))}
        for name, (kernel_fn, plain_fn, library_fn) in fns.items():
            got = kernel_fn()
            torch.cuda.synchronize()
            want = plain_fn()
            share = max(float(((a - b).abs() / sc.clamp_min(1e-30)).max())
                        for a, b, sc in zip(got, want, scales[name]))
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            check(share <= BN_TOL, f"{name} {shape}: error {share} of the channel's sum of "
                                   f"absolute values > {BN_TOL}")
            again = kernel_fn()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {shape}: two runs differ")
            times = ab_ms(torch, kernel_fn, plain_fn)
            library = spread([cuda_ms(torch, library_fn) for _ in range(RUNS)])
            reads = (1 if name == "bn_stats_sums" else 2) * m * c * 2
            # Per element: an add and an FMA (3 operations), f32.
            bound = roofline(reads + 2 * c * 4, 3 * m * c, "f32")
            entry = {"shape": list(shape), "max_abs_err": err, "err_share": share,
                     "tol": BN_TOL, **times, "library_ms": library["median"],
                     "library_spread": library, **bound}
            if i == 0:
                out[name] = {"name": name, "source": "mhentropy_tpu_torch/csrc/bn_sums.cu",
                             "replaces": "mhentropy_tpu/models/bn_pallas.py:"
                                         + ("182" if name == "bn_stats_sums" else "187"),
                             "library": "torch.batch_norm_stats" if name == "bn_stats_sums"
                             else "torch.batch_norm_backward_reduce", **entry}
            else:
                out[name]["other_shape"] = {k: (v["median"] if k in TIMES else v)
                                            for k, v in entry.items()}
        del x, dy
    return [out["bn_stats_sums"], out["bn_grad_sums"]]


def phase_sampler_f32(torch, dev):
    """The f32 sampler kernel against transform_plain at the train draw's
    shape (B=64, N=10: 640 rows, L=12, H=512) and at a ragged 7 x 93 = 651
    rows on an O(1) flow, then the autograd Function's values and gradients
    against plain autograd."""
    from mhentropy_tpu_torch.flows import cuda_sampler, realnvp

    torch.manual_seed(12)  # torch-default Linear init: O(1) weights
    cfg = realnvp.RealNVPConfig(dim=45, cond_dim=512, h_dim=512, num_steps=6)
    flow = realnvp.RealNVP(cfg).to(dev)
    b, n = TRAIN_BATCH, N_TRAIN_HYPO
    g = torch.Generator(device=dev).manual_seed(12)
    feat = torch.randn((b, 512), generator=g, device=dev)
    z0 = torch.randn((b, n, 45), generator=g, device=dev)
    with torch.no_grad():
        cproj = realnvp.cond_cache(flow, feat).contiguous()
        packed = cuda_sampler.pack(flow, dtype=torch.float32)
        main = sampler_case(torch, packed, packed, z0, cproj, SAMPLER_F32_TOL, "f32")
        feat_r = torch.randn((7, 512), generator=g, device=dev)
        z0_r = torch.randn((7, 93, 45), generator=g, device=dev)
        ragged = sampler_case(torch, packed, packed, z0_r,
                              realnvp.cond_cache(flow, feat_r).contiguous(), SAMPLER_F32_TOL,
                              "f32")
    noise = z0.transpose(0, 1).reshape(n * b, 45)  # hypothesis-major rows
    w = torch.randn((n * b, 45), generator=g, device=dev)
    outs = []
    for fused in (True, False):
        flow.zero_grad()
        f = feat.clone().requires_grad_()
        nz = noise.clone().requires_grad_()
        if fused:
            xx, lp = cuda_sampler.sample_fused_diff(flow, f, n, nz)
        else:
            xx, lp = realnvp.sample(flow, nz, cproj=realnvp.cond_cache(flow, f).repeat(1, 1, n, 1))
        ((xx * w).sum() + lp.sum()).backward()
        outs.append([xx.detach(), lp.detach(), f.grad, nz.grad]
                    + [p.grad.clone() for p in flow.parameters()])
    grad_err = max(float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                   for a, r in zip(*outs))
    check(grad_err <= SAMPLER_F32_TOL,
          f"f32 sampler Function: values or gradients {grad_err} from plain autograd")
    return {"name": "realnvp_sampler_f32", "source": "mhentropy_tpu_torch/csrc/realnvp_sampler_f32.cu",
            "replaces": "mhentropy_tpu/flows/pallas_sampler.py:304", **main,
            "grad_rel_err": grad_err, "library": None, "other_shapes": [side_line(ragged)]}


def train_cfg(fused, model_dir: str):
    """configs/rhd.yaml cut to one epoch, seed 0, the given train BN mode."""
    from mhentropy_tpu_torch.utils.config import load_cfg

    cfg = load_cfg("configs/rhd.yaml")
    cfg.training.epochs = 1
    cfg.training.seed = 0
    cfg.model_dir = model_dir + "/"
    cfg.tpu.fused_train_bn = fused
    return cfg


def one_step_grads(torch, net, model, fold, image, target, noise, generator=None):
    """One forward and backward of the training loss (no update): the loss,
    every parameter's gradient and the new running statistics. generator:
    the glow regressor's dropout masks."""
    from mhentropy_tpu_torch.models import mhent

    net.train()
    net.zero_grad(set_to_none=True)
    out = mhent.reverse_kld(model, net, target, image, base_noise=noise, train=True,
                            generator=generator, fold=fold)
    loss = -out["log_p"].mean()
    loss.backward()
    grads = {n: p.grad.detach().float().clone() for n, p in net.named_parameters()
             if p.grad is not None}
    stats = {n: t.detach().clone() for n, t in net.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return loss.item(), grads, stats


def trace_steps(torch, step, untraced_ms: float, n: int = 3, top: int = 15,
                label: str | None = None) -> dict:
    """A torch.profiler trace of n steps (profile_step.step_stats): device
    kernel time and operations per step, the busy share against the
    untraced step time, the time by layer, the top operations (printed,
    under a line of the totals when `label` names the step)."""
    from mhentropy_tpu_torch import profile_step

    stats = profile_step.step_stats(step, untraced_ms, n, top)
    if label is not None:
        layers = {k: round(v, 3) for k, v in stats["layer_ms_per_step"].items()}
        print(f"{label} trace: {stats['device_ms_per_step']:.3f} ms device a step, "
              f"{stats['device_ops_per_step']:.0f} operations, busy {stats['busy_share']:.3f} "
              f"of {untraced_ms:.3f} ms; by layer {layers}", flush=True)
    for op in stats["top_ops"]:
        print(f"  {op['ms_per_step']:10.4f} ms {op['calls_per_step']:8.1f}x  "
              f"{op['category']:<20} {op['name']}", flush=True)
    return stats


def windows_ms(torch, fns: dict, seconds: float) -> dict:
    """Spreads of ms a call for each of `fns` (name -> callable), RUNS
    windows of at least `seconds` each, the names in turn (reversed on odd
    runs), every window ending in a synchronise; "calls" counts the timed
    calls of each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    order = tuple(fns)
    runs = {name: [] for name in order}
    calls = dict.fromkeys(order, 0)
    for r in range(RUNS):
        for name in (order if r % 2 == 0 else order[::-1]):
            count, t1 = 0, time.perf_counter()
            while time.perf_counter() - t1 < seconds:
                fns[name]()
                count += 1
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter() - t1) * 1e3 / count)
            calls[name] += count
    return {name: {**spread(v), "calls": calls[name]} for name, v in runs.items()}


def phase_train(torch, dev):
    import tempfile

    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.models import mhent, resnet
    from mhentropy_tpu_torch.train import engine

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fused in (("false", False), ("full", "full")):
            cfg = train_cfg(fused, os.path.join(tmp, label))
            tr = cfg.training
            check(tr.batch_size == TRAIN_BATCH and tr.test_samples == 100
                  and tr.n_train_hypotheses == N_TRAIN_HYPO and tr.lr == 2e-4,
                  f"train: configs/rhd.yaml has batch {tr.batch_size}, N {tr.test_samples}, "
                  f"n_train_hypotheses {tr.n_train_hypotheses}, lr {tr.lr}")
            exp = engine.Experiment(cfg, device=dev)
            n_bn = sum(isinstance(m, resnet.BatchNorm2d) for m in exp.net.modules())
            check(n_bn == 53, f"train: {n_bn} BatchNorms in resnet50")
            t0 = time.perf_counter()
            reset_launches()
            summary = exp.train_baseline()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            losses = exp.losses
            check(len(losses) == 4 and all(math.isfinite(v) for v in losses),
                  f"train {label}: losses {losses}")
            check(all(math.isfinite(v) for v in summary.values()),
                  f"train {label}: non-finite eval metrics {summary}")
            n_eval = -(-128 // TRAIN_BATCH)
            want = {"bn_stats_sums": n_bn * 4, "bn_grad_sums": n_bn * 4 if fused else 0,
                    "realnvp_sampler_f32": 4 + n_eval}
            for name, count in want.items():
                check(launches[name] == count,
                      f"train {label}: {launches[name]} {name} launches, expected {count}")
            for name in ("stem", "stage1", "realnvp_sampler"):
                check(launches[name] > 0, f"train {label}: eval kernel {name} not launched")
            path = os.path.join(cfg.model_dir, "baseline_final.pth")
            reloaded = mhent.init(exp.model_cfg, seed=1)
            engine.Experiment._restore(reloaded, path)
            here = {k: v.cpu() for k, v in exp.net.state_dict().items()}
            check(all(torch.equal(v, here[k]) for k, v in reloaded.state_dict().items()),
                  f"train {label}: {path} does not reload the trained weights")
            print(f"train {label}: {wall:.1f} s for train_baseline (datasets, initial eval, 4 "
                  f"steps, checkpoints); losses {losses}; launches {launches}", flush=True)
            results[label] = {"launches": launches, "losses": losses, "run_s": wall,
                              "eval_summary": summary, "dy_copies": None}

        # One step from the same weights, batch and noise: kernels ("stats",
        # "full") against the plain path.
        from mhentropy_tpu_torch.models import bn_cuda

        train_data, _ = exp.make_datasets(which=("train",))
        image, target = next(synthetic.batches(train_data, TRAIN_BATCH, device=dev))
        image, target = engine._prep_batch(image, target)
        g = torch.Generator(device=dev).manual_seed(13)
        noise = torch.randn((N_TRAIN_HYPO * TRAIN_BATCH, 45), generator=g, device=dev)
        base = copy.deepcopy(exp.net)
        variants = {"kernels_stats": (True, "stats"), "kernels_full": (True, "full"),
                    "plain": (False, "stats")}
        runs_one = {**{k: v + (None, 0.0) for k, v in variants.items()},
                    "plain_again": (False, "stats", None, 0.0),
                    "plain_nudged": (False, "stats", None, TRAIN_NUDGE),
                    "kernels_stats_f32": (True, "stats", torch.float32, 0.0),
                    "plain_f32": (False, "stats", torch.float32, 0.0)}
        steps = {}
        for name, (kernels, mode, dtype, nudge) in runs_one.items():
            net = copy.deepcopy(base)
            net.set_kernels(kernels)
            net.feat_extractor.res.bn_mode = mode
            if dtype is not None:
                net.feat_extractor.res.dtype = dtype
            reset_launches()
            bn_cuda.dy_copies = 0
            steps[name] = one_step_grads(torch, net, exp.model, exp.fold, image + nudge, target,
                                         noise)
            torch.cuda.synchronize()
            steps[name] += (read_launches(), bn_cuda.dy_copies)
            del net
        check(all(v == 0 for v in steps["plain"][3].values()),
              f"train: the plain path launched kernels {steps['plain'][3]}")
        agreement = {}
        for name, ref in (("kernels_stats", "plain"), ("kernels_full", "plain"),
                          ("plain_again", "plain"), ("plain_nudged", "plain"),
                          ("kernels_stats_f32", "plain_f32")):
            loss, grads, stats, launches, copies = steps[name]
            ref_loss, ref_grads, ref_stats = steps[ref][:3]
            rel = abs(loss - ref_loss) / abs(ref_loss)
            cos = {n: float(torch.nn.functional.cosine_similarity(
                grads[n].flatten(), ref_grads[n].flatten(), dim=0)) for n in ref_grads}
            lowest = sorted(cos, key=cos.get)[:4]
            stats_err = max(float(((stats[n] - ref_stats[n]).abs()
                                   / ref_stats[n].abs().clamp_min(1.0)).max())
                            for n in stats)
            print(f"train {name} vs {ref}, one step: loss {loss:.6g} vs {ref_loss:.6g} "
                  f"(rel {rel:.3g}); lowest gradient cosines "
                  f"{[(n, round(cos[n], 6)) for n in lowest]}; median cosine "
                  f"{statistics.median(cos.values()):.6f}; running stats {stats_err:.3g}; "
                  f"launches {launches}; dy copies {copies}", flush=True)
            agreement[name] = {"against": ref, "loss": loss, "ref_loss": ref_loss,
                               "loss_rel": rel, "min_grad_cosine": cos[lowest[0]],
                               "min_grad_cosine_param": lowest[0],
                               "median_grad_cosine": statistics.median(cos.values()),
                               "stats_rel": stats_err, "launches_per_step": launches,
                               "dy_copies_per_step": copies}
        for name in ("kernels_stats", "kernels_full"):
            launches = steps[name][3]
            want = {"bn_stats_sums": 53, "bn_grad_sums": 53 if name == "kernels_full" else 0,
                    "realnvp_sampler_f32": 1}
            for k, count in want.items():
                check(launches[k] == count, f"train {name}: {launches[k]} {k} launches in one "
                                            f"step, expected {count}")
            a = agreement[name]
            check(a["loss_rel"] <= TRAIN_LOSS_TOL, f"train {name}: loss {a}")
            check(a["stats_rel"] <= TRAIN_STATS_TOL, f"train {name}: running stats {a}")
        a = agreement["kernels_stats_f32"]
        check(a["min_grad_cosine"] >= TRAIN_GRAD_COS and a["loss_rel"] <= TRAIN_F32_LOSS_TOL,
              f"train kernels_stats_f32: {a}")
        results["kernels_vs_plain"] = agreement
        results["full"]["dy_copies"] = agreement["kernels_full"]["dy_copies_per_step"]
        del base, steps

        # ms per train step, the three variants in alternating windows.
        net, step = exp.net.train(), exp._train_step
        res = net.feat_extractor.res

        def run(name):
            kernels, mode = variants[name]
            net.set_kernels(kernels)
            res.bn_mode = mode
            return step(image, target, noise)

        torch.cuda.reset_peak_memory_stats()
        results["ms_per_step"] = windows_ms(torch, {name: (lambda name=name: run(name))
                                                    for name in variants}, STEP_WINDOW_S)
        results["steps_timed"] = sum(t["calls"] for t in results["ms_per_step"].values())
        results["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

        # Where a step's time goes: the default variant (kernels, "stats").
        results["trace"] = trace_steps(torch, lambda: run("kernels_stats"),
                                       results["ms_per_step"]["kernels_stats"]["median"])
        net.set_kernels(True)
        res.bn_mode = "full"
    return results


def rel_err(a, b) -> float:
    """max |a - b| over the largest |b| (at least 1)."""
    b = b.float()
    return float((a.float() - b).abs().max() / b.abs().max().clamp_min(1.0))


def cosines(torch, grads: dict, ref: dict) -> dict:
    return {n: float(torch.nn.functional.cosine_similarity(grads[n].flatten(),
                                                           ref[n].flatten(), dim=0))
            for n in ref}


def rle_one_step(torch, net, image, target, draws):
    """One forward and backward of the RLE loss (no update): the loss, log
    p, every parameter's gradient and the new running statistics."""
    from mhentropy_tpu_torch.models import rle

    net.train()
    net.zero_grad(set_to_none=True)
    out = rle.loss_and_predict(net, image, target, *draws, train=True)
    loss = -out["log_p"].mean()
    loss.backward()
    grads = {n: p.grad.detach().double().clone() for n, p in net.named_parameters()
             if p.grad is not None}
    stats = {n: t.detach().clone() for n, t in net.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return loss.item(), out["log_p"].detach(), grads, stats


def _sums_off(stats_sums, rel_sum: float, rel_sumsq: float):
    def faulty(x):
        s, ss = stats_sums(x)
        return s * (1.0 + rel_sum), ss * (1.0 + rel_sumsq)
    return faulty


# Faults planted in the BN sums (name -> a wrapper of bn_cuda.stats_sums),
# each of which the f32 gradient check must catch: the sums leave out the
# batch's first image (the count stays the whole batch's), or the sum or
# the sum of squares is off by 1e-5 of itself.
RLE_F32_FAULTS = {"drop_image": lambda sums: lambda x: sums(x[1:]),
                  "sum_1e-5": lambda sums: _sums_off(sums, 1e-5, 0.0),
                  "sumsq_1e-5": lambda sums: _sums_off(sums, 0.0, 1e-5)}


def phase_rle(torch, dev):
    """The RLE mode (configs/rhd_rle.yaml at its widths: resnet50 at 256 px,
    B = 64, the per-joint RealNVP of dim 3 over 21 joints, H = 256, 12
    layers, K1 = 10, nf_res 'rle'): the run.py path (train_baseline, one
    epoch: the initial eval's 2 batches, 4 train steps, checkpoints) with
    its launches; then from one copy of its weights, kernels against the
    plain path on the same batch and draws: one step's loss, log p, running
    statistics and gradients (bf16; in f32 every parameter's gradient
    against a float64 evaluation, a check that each fault planted in the
    BN sums must fail), RLE_STEPS optimizer steps through
    make_rle_train_step (its launches a step), and one eval batch; ms per
    train step and per eval batch in alternating windows, and a trace of
    each train step."""
    import tempfile

    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.models import bn_cuda, resnet, rle
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_cfg("configs/rhd_rle.yaml")
        cfg.training.epochs = 1
        cfg.training.seed = 0
        cfg.model_dir = tmp + "/"
        mc = engine.build_rle_config(cfg)
        fc = mc.flow
        check(mc.encoder.backbone == "resnet50" and mc.image_size == 256
              and cfg.training.batch_size == TRAIN_BATCH and (fc.dim, fc.h_dim, fc.n_layers,
                                                              fc.joint_n) == (3, 256, 12, 21)
              and fc.tsfm_on == "x" and mc.k1 == 10 and mc.nf_res == "rle",
              f"rle: configs/rhd_rle.yaml reads as {mc}")
        exp = engine.Experiment(cfg, device=dev)
        n_bn = sum(isinstance(m, resnet.BatchNorm2d) for m in exp.net.modules())
        check(isinstance(exp.net, rle.RLE) and n_bn == 53, f"rle: {type(exp.net)}, {n_bn} BNs")
        t0 = time.perf_counter()
        reset_launches()
        summary = exp.train_baseline()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        losses = exp.losses
        check(len(losses) == 4 and all(math.isfinite(v) for v in losses),
              f"rle: losses {losses}")
        check(all(math.isfinite(v) for v in summary.values()) and "sigma_i" in summary,
              f"rle: eval metrics {summary}")
        n_eval = -(-128 // TRAIN_BATCH)
        want = {"bn_stats_sums": 4 * n_bn, "stem": n_eval, "stage1": 3 * n_eval}
        for name, count in launches.items():
            check(count == want.get(name, 0),
                  f"rle: {count} {name} launches, expected {want.get(name, 0)}")
        path = os.path.join(cfg.model_dir, "baseline_final.pth")
        reloaded = rle.init(mc, seed=1)
        engine.Experiment._restore(reloaded, path)
        here = rle.checkpoint(exp.net)
        check(all(torch.equal(v, here[m][k]) for m, sd in rle.checkpoint(reloaded).items()
                  for k, v in sd.items()), f"rle: {path} does not reload the trained weights")
        print(f"rle: {wall:.1f} s for train_baseline (datasets, initial eval, 4 steps, "
              f"checkpoints); losses {losses}; launches {launches}", flush=True)
        out.update(launches=launches, losses=losses, run_s=wall, eval_summary=summary)

        # Kernels against the plain path from the same weights, batch and
        # draws.
        data = synthetic.make_dataset(exp.model, n=2 * TRAIN_BATCH, image_size=256, seed=7,
                                      ds="rhd")
        (image, target), (eval_image, eval_target) = [
            engine._prep_batch(*b) for b in synthetic.batches(data, TRAIN_BATCH, device=dev)]
        g = torch.Generator(device=dev).manual_seed(17)
        draws = [rle.draws(mc, target["pose3d"], g) for _ in range(RLE_STEPS)]
        eval_draws = rle.draws(mc, eval_target["pose3d"], g)
        base = copy.deepcopy(exp.net)
        one = {}
        stats_sums = bn_cuda.stats_sums
        faults = [f"kernels_f32_fault_{f}" for f in RLE_F32_FAULTS]
        for name, kernels, dtype, nudge in (
                ("kernels", True, None, 0.0), ("plain", False, None, 0.0),
                ("plain_nudged", False, None, TRAIN_NUDGE),
                ("kernels_f32", True, torch.float32, 0.0),
                *((f, True, torch.float32, 0.0) for f in faults),
                ("plain_f32", False, torch.float32, 0.0),
                ("plain_f64", False, torch.float64, 0.0)):
            net = copy.deepcopy(base)
            net.set_kernels(kernels)
            args = (image + nudge, target, draws[0])
            if dtype is not None:
                net.encoderRGB.res.dtype = dtype
            if dtype == torch.float64:
                net.double()
                args = (image.double(), {k: v.double() for k, v in target.items()},
                        tuple(d.double() for d in draws[0]))
            if name in faults:
                bn_cuda.stats_sums = RLE_F32_FAULTS[name[len("kernels_f32_fault_"):]](stats_sums)
            reset_launches()
            try:
                one[name] = rle_one_step(torch, net, *args)
                torch.cuda.synchronize()
            finally:
                bn_cuda.stats_sums = stats_sums
            one[name] += (read_launches(),)
            del net
        agreement = {}
        for name, ref in (("kernels", "plain"), ("plain_nudged", "plain"),
                          ("kernels_f32", "plain_f64"), *((f, "plain_f64") for f in faults),
                          ("plain_f32", "plain_f64")):
            loss, lp, grads, stats, launches = one[name]
            ref_loss, ref_lp, ref_grads, ref_stats, _ = one[ref]
            cos = cosines(torch, grads, ref_grads)
            l2 = {n: float((grads[n] - ref_grads[n]).norm()
                           / ref_grads[n].norm().clamp_min(1e-30)) for n in ref_grads}
            lowest = sorted(cos, key=cos.get)[:4]
            a = agreement[name] = {
                "against": ref, "loss": loss, "ref_loss": ref_loss,
                "loss_rel": abs(loss - ref_loss) / abs(ref_loss), "log_p_rel": rel_err(lp, ref_lp),
                "stats_rel": max(float(((stats[n] - ref_stats[n]).abs()
                                        / ref_stats[n].abs().clamp_min(1.0)).max())
                                 for n in stats),
                "min_grad_cosine": cos[lowest[0]], "min_grad_cosine_param": lowest[0],
                "median_grad_cosine": statistics.median(cos.values()),
                "max_grad_rel_l2": max(l2.values()),
                "max_grad_rel_l2_param": max(l2, key=l2.get),
                "launches_per_step": launches}
            print(f"rle {name} vs {ref}, one step: loss {loss:.6g} vs {ref_loss:.6g} (rel "
                  f"{a['loss_rel']:.3g}), log p {a['log_p_rel']:.3g} of its largest, running "
                  f"stats {a['stats_rel']:.3g}; lowest gradient cosines "
                  f"{[(n, round(cos[n], 6)) for n in lowest]}, largest relative L2 error "
                  f"{a['max_grad_rel_l2']:.3g} ({a['max_grad_rel_l2_param']}); launches "
                  f"{launches}", flush=True)
        for name in ("kernels", "kernels_f32", *faults):
            launches = one[name][4]
            check(launches["bn_stats_sums"] == n_bn and sum(launches.values()) == n_bn,
                  f"rle {name}: launches {launches}")
        for name in ("plain", "plain_nudged", "plain_f32", "plain_f64"):
            check(sum(one[name][4].values()) == 0, f"rle {name}: launches {one[name][4]}")
        a = agreement["kernels"]
        check(a["loss_rel"] <= RLE_TOL["loss"] and a["log_p_rel"] <= RLE_TOL["log_p"]
              and a["stats_rel"] <= TRAIN_STATS_TOL, f"rle kernels vs plain, one step: {a}")
        p32 = agreement["plain_f32"]

        def f32_grads_ok(k32):
            return (k32["max_grad_rel_l2"] <= RLE_F32_GRAD_FACTOR * p32["max_grad_rel_l2"] + 1e-4
                    and k32["min_grad_cosine"] >= RLE_F32_GRAD_COS)

        k32 = agreement["kernels_f32"]
        check(f32_grads_ok(k32) and max(k32["loss_rel"], p32["loss_rel"]) <= TRAIN_F32_LOSS_TOL,
              f"rle f32 against float64, one step: kernels {k32}, plain {p32}")
        for f in faults:
            check(not f32_grads_ok(agreement[f]),
                  f"rle f32: the gradient check passes the planted fault {f}: {agreement[f]}")
        out["one_step"] = agreement

        tr = cfg.training
        nets, step_losses, step_launches = {}, {}, {}
        for name, kernels in (("kernels", True), ("plain", False)):
            net = nets[name] = copy.deepcopy(base).train()
            net.set_kernels(kernels)
            step = engine.make_rle_train_step(
                net, engine.make_optimizer(net, tr.lr, tr.milestones, 4))
            reset_launches()
            step_losses[name] = [float(step(image, target, *d)["loss"]) for d in draws]
            torch.cuda.synchronize()
            step_launches[name] = read_launches()
        step_rel = [abs(k - p) / abs(p) for k, p in zip(step_losses["kernels"],
                                                        step_losses["plain"])]
        print(f"rle {RLE_STEPS} steps: losses kernels {step_losses['kernels']}, plain "
              f"{step_losses['plain']} (rel {step_rel}); launches {step_launches}", flush=True)
        check(max(step_rel) <= RLE_TOL["loss"] and all(map(math.isfinite,
                                                           step_losses["kernels"])),
              f"rle: {RLE_STEPS} steps' losses {step_losses}")
        check(step_launches["kernels"]["bn_stats_sums"] == RLE_STEPS * n_bn
              and all(v % RLE_STEPS == 0 for v in step_launches["kernels"].values())
              and sum(step_launches["plain"].values()) == 0, f"rle steps: {step_launches}")
        out["steps"] = {"losses": step_losses, "loss_rel": step_rel, "launches": step_launches,
                        "launches_per_step": {k: v // RLE_STEPS for k, v in
                                              step_launches["kernels"].items()}}

        # One eval batch from the kernel-trained weights, on both paths.
        net = nets["kernels"]
        rle.refresh_kernel_weights(net.eval())
        eval_step = engine.make_rle_eval_step(net)
        ev = {}
        for name, kernels in (("kernels", True), ("plain", False)):
            net.set_kernels(kernels)
            reset_launches()
            with torch.inference_mode():
                mets = eval_step(eval_image, eval_target, *eval_draws)
                torch.cuda.synchronize()
                launches = read_launches()
                pred = rle.loss_and_predict(net, eval_image, eval_target, *eval_draws)
            ev[name] = (mets, pred, launches)
        mets, pred, launches = ev["kernels"]
        ref_mets, ref_pred, ref_launches = ev["plain"]
        check(launches["stem"] == 1 and launches["stage1"] == 3 and sum(launches.values()) == 4
              and sum(ref_launches.values()) == 0,
              f"rle eval step: launches kernels {launches}, plain {ref_launches}")
        check(all(bool(torch.isfinite(v)) for v in mets.values()), f"rle eval: {mets}")
        met_rel = {k: abs(float(mets[k]) - float(ref_mets[k])) / max(abs(float(ref_mets[k])),
                                                                      1e-6)
                   for k in ref_mets}
        diffs = {"log_p_rel": rel_err(pred["log_p"], ref_pred["log_p"]),
                 "xyz": float((pred["xyz"] - ref_pred["xyz"]).abs().max()),
                 "mu": float((pred["pred_jts"] - ref_pred["pred_jts"]).abs().max()),
                 "worst_metric": max(met_rel, key=met_rel.get),
                 "worst_metric_rel": max(met_rel.values())}
        print(f"rle eval batch, kernels vs plain: {diffs} (tolerances {RLE_TOL}); metrics "
              f"{ {k: round(float(v), 6) for k, v in mets.items()} }", flush=True)
        check(diffs["log_p_rel"] <= RLE_TOL["log_p"] and diffs["xyz"] <= RLE_TOL["xyz"]
              and diffs["mu"] <= RLE_TOL["xyz"]
              and diffs["worst_metric_rel"] <= RLE_TOL["metrics"], f"rle eval: {diffs}")
        out["eval_batch"] = {"kernels_vs_plain": diffs, "metrics": {k: float(v) for k, v in
                                                                     mets.items()},
                             "launches": launches}

        # ms per train step and per eval batch, kernels and plain in turns.
        net.train()
        step = engine.make_rle_train_step(net, engine.make_optimizer(net, tr.lr, tr.milestones,
                                                                     4))

        def train_with(kernels):
            def run():
                net.set_kernels(kernels)
                step(image, target, *draws[0])
            return run

        out["ms_per_train_step"] = windows_ms(torch, {"kernels": train_with(True),
                                                      "plain": train_with(False)}, RLE_WINDOW_S)
        out["train_trace"] = {
            name: trace_steps(torch, train_with(name == "kernels"),
                              out["ms_per_train_step"][name]["median"], TRACED, 8,
                              f"rle train step {name}")
            for name in ("kernels", "plain")}
        rle.refresh_kernel_weights(net.eval())

        def eval_with(kernels):
            def run():
                net.set_kernels(kernels)
                eval_step(eval_image, eval_target, *eval_draws)
            return run

        out["ms_per_eval_batch"] = windows_ms(torch, {"kernels": eval_with(True),
                                                      "plain": eval_with(False)}, RLE_WINDOW_S)
        net.set_kernels(True)
    return out


def phase_det(torch, dev):
    """MHEnt with the det regressor at configs/ho3d.yaml's widths (resnet50
    at 256 px, a 61-wide det head, no flow): sample_hypotheses at B = 8, N =
    200 with the mesh (stem, stage 1 and LBS kernels), and one train step at
    B = 64 (the BN sums), each against the plain path on the same weights
    and inputs; ms per call of each, kernels and plain in turns, and a
    trace of each train step."""
    from mhentropy_tpu_torch.core import lbs_cuda, mano
    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    cfg = load_cfg("configs/ho3d.yaml")
    cfg.network.regressor = "det"
    mc = engine.build_model_config(cfg)
    check(mc.det_dims() == 61 and mc.encoder.backbone == "resnet50" and mc.image_size == 256,
          f"det: {mc}")
    model = engine.load_mano_model(device=dev)
    fold = mano.fold_keypoints(model)
    net = mhent.prepare(mhent.init(mc, seed=0), dev)
    check(net.q_z_giv_i is None and net.packed_flow is None, "det: the net carries a flow")
    g = torch.Generator(device=dev).manual_seed(20)
    images = torch.randn((BATCH, 256, 256, 3), generator=g, device=dev)
    kernel_blend = lbs_cuda.lbs_blend

    def sample(kernels):
        net.set_kernels(kernels)
        lbs_cuda.lbs_blend = kernel_blend if kernels else lbs_cuda.lbs_blend_plain
        try:
            with torch.inference_mode():
                return mhent.sample_hypotheses(model, net, images, n=N_HYPO, fold=fold)
        finally:
            lbs_cuda.lbs_blend = kernel_blend

    res = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        reset_launches()
        res[name] = (sample(kernels), read_launches())
        torch.cuda.synchronize()
    got, launches = res["kernels"]
    ref, ref_launches = res["plain"]
    check(launches["stem"] == 1 and launches["stage1"] == 3 and launches["lbs_blend"] == 1
          and sum(launches.values()) == 5 and sum(ref_launches.values()) == 0,
          f"det sample: launches kernels {launches}, plain {ref_launches}")
    check(got["verts"].shape == (N_HYPO, BATCH, 778 * 3)
          and all(bool(torch.isfinite(got[k]).all()) for k in ("xyz", "uv", "verts"))
          and torch.equal(got["xyz"][0], got["xyz"][-1]), "det sample: shapes, finite, rows")
    sample_err = max_abs(got, ref, ("xyz", "uv", "verts"))
    print(f"det sample_hypotheses B={BATCH}, N={N_HYPO}, kernels vs plain: {sample_err} "
          f"(tolerances {DET_TOL}); launches {launches}", flush=True)
    check(all(sample_err[k] <= DET_TOL[k] for k in sample_err), f"det sample: {sample_err}")
    sample_ms = windows_ms(torch, {"kernels": lambda: sample(True),
                                   "plain": lambda: sample(False)}, RLE_WINDOW_S)

    # One train step at B = 64 from the same weights, batch and (unused) noise.
    data = synthetic.make_dataset(model, n=TRAIN_BATCH, image_size=256, seed=21)
    image, target = engine._prep_batch(*next(synthetic.batches(data, TRAIN_BATCH, device=dev)))
    noise = torch.zeros((mc.n_train_hypotheses * TRAIN_BATCH, 45), device=dev)
    tr = cfg.training
    base = mhent.prepare(mhent.init(mc, seed=0), dev, masters=True)
    steps, step_fns = {}, {}
    for name, kernels in (("kernels", True), ("plain", False)):
        tnet = copy.deepcopy(base).train()
        tnet.set_kernels(kernels)
        step_fns[name] = engine.make_train_step(
            model, tnet, engine.make_optimizer(tnet, tr.lr, tr.milestones, 1), fold=fold)
        reset_launches()
        aux = step_fns[name](image, target, noise)
        torch.cuda.synchronize()
        steps[name] = ({k: float(v) for k, v in aux.items()}, read_launches())
    (aux, t_launches), (ref_aux, ref_t_launches) = steps["kernels"], steps["plain"]
    loss_rel = abs(aux["loss"] - ref_aux["loss"]) / abs(ref_aux["loss"])
    print(f"det train step B={TRAIN_BATCH}: loss kernels {aux['loss']:.6g}, plain "
          f"{ref_aux['loss']:.6g} (rel {loss_rel:.3g}); launches {t_launches}", flush=True)
    check(math.isfinite(aux["loss"]) and loss_rel <= TRAIN_LOSS_TOL and aux["h_q"] == 0.0,
          f"det train step: {aux} vs {ref_aux}")
    check(t_launches["bn_stats_sums"] == 53 and sum(t_launches.values()) == 53
          and sum(ref_t_launches.values()) == 0,
          f"det train step: launches {t_launches}, plain {ref_t_launches}")
    train_ms = windows_ms(torch, {k: (lambda f=f: f(image, target, noise))
                                  for k, f in step_fns.items()}, RLE_WINDOW_S)
    train_trace = {k: trace_steps(torch, lambda f=f: f(image, target, noise),
                                  train_ms[k]["median"], TRACED, 8, f"det train step {k}")
                   for k, f in step_fns.items()}
    return {"sample": {"launches": launches, "kernels_vs_plain_max_abs": sample_err,
                       "ms_per_call": sample_ms},
            "train_step": {"launches": t_launches, "loss": aux["loss"],
                           "ref_loss": ref_aux["loss"], "loss_rel": loss_rel,
                           "ms_per_step": train_ms, "trace": train_trace}}


# The glow phase (9f): MHEnt's glow regressor at configs/rhd.yaml's widths,
# its train steps and eval batch, the Glow kernel at the eval batch's rows,
# ProHMR's nll_loss, a resumed run and the learning demo.
GLOW_TRAIN_STEPS = 3
# The train steps compared, kernels against plain, run at this learning rate,
# as tests/test_torch_train.py compares whole steps: at configs/rhd.yaml's
# 2e-4 the loss of fresh weights swings eightfold between steps on one
# batch, and Adam's sign-like first updates carry the BN sums' rounding into
# the next step's loss (2.6 % at the third step on an H100).
GLOW_COMPARE_LR = 1e-6
GLOW_EVAL = {"d": 45, "h": 512, "c": 512, "b": EVAL_BATCH, "n": N_HYPO}  # 12,800 rows
GLOW_METRIC_TOL = 2e-2  # kernels vs plain, relative, each eval metric
# glow_f32_grads holds the f32 kernel path's gradients to a float64
# evaluation of the plain path as the RLE phase does, with its own factor:
# on an H100 (700 W) the kernel path lay 0.0552 (relative L2, the stem's
# bn1 weight; lowest cosine 0.99850) from float64, the plain f32 path
# 0.0290 (0.99960), and the planted faults of RLE_F32_FAULTS 0.130
# (sum of squares, 1e-5), 0.178 (sum, 1e-5) and 1.95 (an image dropped).
# The bound, 3 x the plain path's plus 1e-4 (0.087 there), lies between the
# kernel path and the smallest fault; RLE_F32_GRAD_FACTOR's 2 left the
# kernel path 5 % of room.
GLOW_F32_GRAD_FACTOR = 3.0
PROHMR_NLL_BATCH = 32
GLOW_WINDOW_S = 0.5
GLOW_PHASE_S = 90.0


def phase_glow(torch, dev):
    """The glow MHEnt (configs/rhd.yaml with network.regressor glow: resnet50
    at 256 px, feature 512, ConditionalGlow(45, 512, 4, 2), built by the
    Experiment): GLOW_TRAIN_STEPS train steps at B = 64, N = 10, one f32
    forward and backward with each gradient held to the plain path's, and
    one eval batch at B = 64, N = 200, kernels against plain from one copy
    of the weights, with their launches and ms in alternating windows; the Glow
    kernel alone at the eval batch's 12,800 rows (glow_case); ProHMR's
    nll_loss forward and backward at B = 32, kernels on and off; run.py's
    path twice in one model_dir (configs/smoke.yaml as a glow MHEnt, 1
    epoch, then 2 with tpu.autoresume); the learning demo at its defaults.
    Fails if any part fails or the phase takes more than GLOW_PHASE_S."""
    import tempfile

    from mhentropy_tpu_torch import train_synthetic_demo
    from mhentropy_tpu_torch.core import smpl
    from mhentropy_tpu_torch.flows import glow
    from mhentropy_tpu_torch.models import prohmr
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_cfg(False, os.path.join(tmp, "rhd_glow"))
        cfg.network.regressor = "glow"
        with engine.Experiment(cfg, device=dev) as exp:
            mc, net = exp.model_cfg, exp.net
            check(mc.regressor == "glow" and mc.encoder.backbone == "resnet50"
                  and mc.image_size == 256 and mc.feat_dim == 512
                  and net.q_z_giv_i.cfg == glow.GlowConfig(45, 512, 4, 2, 512, 0.2)
                  and net.packed_flow is not None,
                  f"glow: not the full-width glow MHEnt: {mc}")
            train_data, eval_data = exp.make_datasets()
            out["train_step"] = glow_train_steps(torch, dev, exp, train_data)
            out["eval_batch"] = glow_eval_batch(torch, dev, exp, eval_data)
        out["kernel"] = glow_case(torch, dev, "mhent_glow_eval", GLOW_EVAL)
        out["kernel"]["phase"] = "glow (the glow MHEnt's eval batch)"
        out["prohmr_nll"] = prohmr_nll(torch, dev, smpl, prohmr)
        out["autoresume"] = glow_autoresume(torch, dev, engine, load_cfg,
                                            os.path.join(tmp, "resume"))
    reset_launches()
    demo = train_synthetic_demo.main(device=dev)
    before = demo["before"]["eucLoss_3d_rgb_sample"] * 1000
    after = demo["after"]["eucLoss_3d_rgb_sample"] * 1000
    out["demo"] = {"bh_mpjpe_mm_before": before, "bh_mpjpe_mm_after": after,
                   "int8_delta_mm": (demo["after_int8"]["eucLoss_3d_rgb_sample"] * 1000
                                     - after),
                   "int8_sampler_delta_mm": (demo["after_int8_sampler"]["eucLoss_3d_rgb_sample"]
                                             * 1000 - after
                                             if "after_int8_sampler" in demo else None),
                   "launches": read_launches()}
    check(after < before, f"glow demo: BH-MPJPE {after} mm after training, {before} before")
    out["wall_s"] = time.perf_counter() - t0
    f32 = out["train_step"]["f32_one_step"]
    summary = {"train_loss_rel": out["train_step"]["loss_rel"],
               "train_f32_vs_f64": {k: [v["max_grad_rel_l2"], v["min_grad_cosine"]]
                                    for k, v in f32.items()},
               "train_ms": {k: v["median"] for k, v in out["train_step"]["ms_per_step"].items()},
               "eval_ms": {k: v["median"] for k, v in out["eval_batch"]["ms_per_batch"].items()},
               "eval_metric_rel": out["eval_batch"]["metric_rel_max"],
               "kernel_graph_ms": out["kernel"]["graph_ms"]["median"],
               "kernel_bound_ms": out["kernel"]["bound_ms"],
               "prohmr_nll_loss_rel": out["prohmr_nll"]["loss_rel"],
               "resumed_at_epoch": out["autoresume"]["start_epoch"],
               "steps": [out["autoresume"]["steps_first"], out["autoresume"]["steps_second"]],
               "demo_bh_mpjpe_mm": [before, after], "demo_int8_delta_mm":
               out["demo"]["int8_delta_mm"], "wall_s": out["wall_s"]}
    print(f"glow phase: {json.dumps(summary)}", flush=True)
    check(out["wall_s"] <= GLOW_PHASE_S, f"glow: the phase took {out['wall_s']:.1f} s")
    return out


def glow_train_steps(torch, dev, exp, train_data) -> dict:
    """GLOW_TRAIN_STEPS make_train_step steps at B = 64 on one batch and lr
    GLOW_COMPARE_LR, kernels and plain from one copy of the Experiment's
    weights, the same noise and dropout masks: losses within
    TRAIN_LOSS_TOL, launches a step BN stats sums 53 and nothing else (the
    reverse-KL draw is the plain Glow); ms a step in alternating windows.
    At that rate the three losses are close to three forwards of one set
    of weights: the gradients are held by glow_f32_grads."""
    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.train import engine

    bs, tr = TRAIN_BATCH, exp.cfg.training
    image, target = engine._prep_batch(*next(synthetic.batches(train_data, bs, device=dev)))
    g = torch.Generator(device=dev).manual_seed(30)
    noises = [torch.randn((N_TRAIN_HYPO * bs, 45), generator=g, device=dev)
              for _ in range(GLOW_TRAIN_STEPS)]
    runs, steps = {}, {}
    for name, kernels in (("kernels", True), ("plain", False)):
        net = copy.deepcopy(exp.net).train()
        net.set_kernels(kernels)
        steps[name] = engine.make_train_step(
            exp.model, net, engine.make_optimizer(net, GLOW_COMPARE_LR, tr.milestones, 1),
            fold=exp.fold, generator=torch.Generator(device=dev).manual_seed(31))
        losses, launches = [], []
        for noise in noises:
            reset_launches()
            losses.append(steps[name](image, target, noise)["loss"].item())
            launches.append(read_launches())
        runs[name] = (losses, launches)
    (losses, launches), (ref_losses, ref_launches) = runs["kernels"], runs["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    print(f"glow train steps B={bs}: losses kernels {losses}, plain {ref_losses} (worst rel "
          f"{loss_rel:.3g}, tol {TRAIN_LOSS_TOL}); launches a step {launches[0]}", flush=True)
    check(all(math.isfinite(v) for v in losses) and loss_rel <= TRAIN_LOSS_TOL,
          f"glow train: losses {losses} vs {ref_losses}")
    check(all(c["bn_stats_sums"] == 53 and sum(c.values()) == 53 for c in launches)
          and all(sum(c.values()) == 0 for c in ref_launches),
          f"glow train: launches {launches}, plain {ref_launches}")
    f32 = glow_f32_grads(torch, dev, exp, image, target, noises[0])
    ms = windows_ms(torch, {k: (lambda f=f: f(image, target, noises[0]))
                            for k, f in steps.items()}, GLOW_WINDOW_S)
    return {"losses": losses, "ref_losses": ref_losses, "loss_rel": loss_rel,
            "launches": launches[0], "ms_per_step": ms, "f32_one_step": f32}


def glow_f32_grads(torch, dev, exp, image, target, noise) -> dict:
    """The RLE phase's f32 gradient check on the glow MHEnt: one forward and
    backward of the loss (no update) from one copy of the weights, with the
    same noise and dropout masks, through the kernel path in f32, the plain
    path in f32 and in float64, and the kernel path with each fault of
    RLE_F32_FAULTS planted in the BN sums. The f32 kernel path's gradients
    are held to the float64 plain path's: each parameter's relative L2
    error at most GLOW_F32_GRAD_FACTOR x the plain f32 path's largest plus
    1e-4 and its cosine at least RLE_F32_GRAD_COS; the loss to the plain
    f32 path's within TRAIN_F32_LOSS_TOL. Every planted fault must fail the
    gradient check. Launches:
    BN stats sums 53 a kernel run, none on the plain path. Comparing the
    two f32 paths with each other cannot tell a fault from the f32
    rounding that both carry: they differed by a lowest cosine of 0.99869
    on an H100, a BN weight's."""
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import bn_cuda

    model64 = mano.ManoModel(*(t.double() if t.is_floating_point() else t for t in exp.model))
    args64 = (model64, mano.fold_keypoints(model64), image.double(),
              {k: v.double() if v.is_floating_point() else v for k, v in target.items()},
              noise.double())
    stats_sums = bn_cuda.stats_sums
    faults = [f"kernels_f32_fault_{f}" for f in RLE_F32_FAULTS]
    runs = {}
    for name, kernels, dtype in (("kernels_f32", True, torch.float32),
                                 *((f, True, torch.float32) for f in faults),
                                 ("plain_f32", False, torch.float32),
                                 ("plain_f64", False, torch.float64)):
        net = copy.deepcopy(exp.net)
        net.set_kernels(kernels)
        net.feat_extractor.res.dtype = dtype
        args = (exp.model, exp.fold, image, target, noise)
        if dtype == torch.float64:
            net.double()
            args = args64
        if name in faults:
            bn_cuda.stats_sums = RLE_F32_FAULTS[name[len("kernels_f32_fault_"):]](stats_sums)
        reset_launches()
        try:
            runs[name] = one_step_grads(torch, net, *args,
                                        generator=torch.Generator(device=dev).manual_seed(35))
            torch.cuda.synchronize()
        finally:
            bn_cuda.stats_sums = stats_sums
        runs[name] += (read_launches(),)
        del net
    ref_loss, ref_grads = runs["plain_f64"][:2]
    ref_grads = {n: g.double() for n, g in ref_grads.items()}
    agreement = {}
    for name in ("kernels_f32", *faults, "plain_f32"):
        loss, grads, _, launches = runs[name]
        grads = {n: g.double() for n, g in grads.items()}
        cos = cosines(torch, grads, ref_grads)
        l2 = {n: float((grads[n] - ref_grads[n]).norm() / ref_grads[n].norm().clamp_min(1e-30))
              for n in ref_grads}
        lowest = sorted(cos, key=cos.get)[:4]
        a = agreement[name] = {
            "against": "plain_f64", "loss": loss, "ref_loss": ref_loss,
            "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "min_grad_cosine": cos[lowest[0]], "min_grad_cosine_param": lowest[0],
            "median_grad_cosine": statistics.median(cos.values()),
            "max_grad_rel_l2": max(l2.values()), "max_grad_rel_l2_param": max(l2, key=l2.get),
            "gradients": len(cos), "launches_per_step": launches}
        print(f"glow train {name} vs plain_f64, one step: loss {loss:.6g} vs {ref_loss:.6g} "
              f"(rel {a['loss_rel']:.3g}); lowest gradient cosines "
              f"{[(n, round(cos[n], 6)) for n in lowest]}, largest relative L2 error "
              f"{a['max_grad_rel_l2']:.3g} ({a['max_grad_rel_l2_param']}); launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    p32 = agreement["plain_f32"]

    def f32_grads_ok(k32):
        return (k32["max_grad_rel_l2"] <= GLOW_F32_GRAD_FACTOR * p32["max_grad_rel_l2"] + 1e-4
                and k32["min_grad_cosine"] >= RLE_F32_GRAD_COS)

    k32 = agreement["kernels_f32"]
    flow_grads = [n for n in ref_grads if n.startswith("q_z_giv_i.")]
    loss_rel = abs(k32["loss"] - p32["loss"]) / abs(p32["loss"])
    print(f"glow train kernels_f32 vs plain_f32, one step: loss rel {loss_rel:.3g} (tol "
          f"{TRAIN_F32_LOSS_TOL})", flush=True)
    check(set(runs["kernels_f32"][1]) == set(ref_grads) and flow_grads and f32_grads_ok(k32)
          and loss_rel <= TRAIN_F32_LOSS_TOL,
          f"glow train f32 against float64, one step: kernels {k32}, plain {p32}, loss rel "
          f"{loss_rel}")
    for f in faults:
        check(not f32_grads_ok(agreement[f]),
              f"glow train f32: the gradient check passes the planted fault {f}: "
              f"{agreement[f]}")
    for name in ("kernels_f32", *faults):
        launches = runs[name][3]
        check(launches["bn_stats_sums"] == 53 and sum(launches.values()) == 53,
              f"glow train {name}: launches {launches}")
    for name in ("plain_f32", "plain_f64"):
        check(sum(runs[name][3].values()) == 0, f"glow train {name}: launches {runs[name][3]}")
    agreement["kernels_f32"]["loss_rel_plain_f32"] = loss_rel
    return agreement


def glow_eval_batch(torch, dev, exp, eval_data) -> dict:
    """One eval batch at B = 64, N = 200 through make_eval_step, kernels and
    plain on the same weights, noise and dropout masks: launches stem 1,
    stage 1 3, Glow kernel 1 and nothing else; every metric finite and
    within GLOW_METRIC_TOL of the plain path's; ms a batch in alternating
    windows."""
    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.train import engine

    bs, n, temp = EVAL_BATCH, N_HYPO, exp.cfg.training.eval_temp
    net = exp.net.eval()
    mhent.refresh_kernel_weights(net)
    image, target = next(synthetic.batches(eval_data, bs, pad_remainder=True, device=dev))
    g = torch.Generator(device=dev).manual_seed(32)
    kld = torch.randn((N_TRAIN_HYPO * bs, 45), generator=g, device=dev)
    hypo = torch.randn((n * bs, 45), generator=g, device=dev) * temp

    def run(kernels):
        net.set_kernels(kernels)
        step = engine.make_eval_step(exp.model, net, n, temp, fold=exp.fold,
                                     generator=torch.Generator(device=dev).manual_seed(33))
        try:
            return step(image, target, kld, hypo)
        finally:
            net.set_kernels(True)

    res = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        reset_launches()
        mets = run(kernels)
        torch.cuda.synchronize()
        res[name] = ({k: float(v) for k, v in mets.items()}, read_launches())
    (mets, launches), (ref, ref_launches) = res["kernels"], res["plain"]
    rel = {k: abs(mets[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref}
    worst = max(rel, key=rel.get)
    print(f"glow eval batch B={bs}, N={n}: launches {launches}; eucLoss_3d_rgb_sample "
          f"kernels {mets['eucLoss_3d_rgb_sample']:.6g}, plain "
          f"{ref['eucLoss_3d_rgb_sample']:.6g}; worst metric {worst} rel {rel[worst]:.3g} "
          f"(tol {GLOW_METRIC_TOL})", flush=True)
    check(launches["stem"] == 1 and launches["stage1"] == 3 and launches["glow_sampler"] == 1
          and sum(launches.values()) == 5 and sum(ref_launches.values()) == 0,
          f"glow eval: launches {launches}, plain {ref_launches}")
    check(all(math.isfinite(v) for v in mets.values()) and rel[worst] <= GLOW_METRIC_TOL,
          f"glow eval: metrics {mets} vs {ref}")
    ms = windows_ms(torch, {"kernels": lambda: run(True), "plain": lambda: run(False)},
                    GLOW_WINDOW_S)
    trace = trace_steps(torch, lambda: run(True), ms["kernels"]["median"], TRACED, 8,
                        "glow eval batch kernels")
    return {"launches": launches, "metrics": mets, "ref_metrics": ref,
            "metric_rel_max": rel[worst], "worst_metric": worst, "ms_per_batch": ms,
            "trace": trace}


def prohmr_nll(torch, dev, smpl, prohmr) -> dict:
    """ProHMR's nll_loss in train mode at B = PROHMR_NLL_BATCH (resnet50 at
    224 px with f32 master weights computing in bf16, ConditionalGlow(144,
    1024, 4, 2, context 2048), the 6,890-vertex SMPL fixture, every
    target): forward and backward with kernels on and off from one copy of
    the weights; every gradient finite, the losses within TRAIN_LOSS_TOL,
    the BN stats sums 53 a forward."""
    b = PROHMR_NLL_BATCH
    model = smpl.synthetic_smpl_model(0, device=dev)
    base = prohmr.init(prohmr.ProHMRConfig(), seed=0).to(dev)
    base.encoder.res.place(torch.bfloat16, masters=True)
    g = torch.Generator(device=dev).manual_seed(34)
    image = torch.rand((b, 224, 224, 3), generator=g, device=dev)
    target = {"pose_6d": torch.randn((b, 144), generator=g, device=dev) * 0.3,
              "betas": torch.randn((b, 10), generator=g, device=dev) * 0.1,
              "keypoints3d": torch.randn((b, 24, 3), generator=g, device=dev) * 0.2,
              "keypoints2d": torch.randn((b, 24, 2), generator=g, device=dev) * 0.3}
    noise = torch.randn((b, 144), generator=g, device=dev)
    res = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        net = copy.deepcopy(base).train()
        net.set_kernels(kernels)
        reset_launches()
        t1 = time.perf_counter()
        o = prohmr.nll_loss(model, net, image, target, noise=noise)
        loss = (-o["log_p"].mean() + o["betas_l2"].mean() + o["kp3d_l1"].mean()
                + o["kp2d_l1"].mean())
        loss.backward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        finite = all(bool(torch.isfinite(p.grad).all()) for p in net.parameters()
                     if p.grad is not None)
        n_grads = sum(p.grad is not None for p in net.parameters())
        res[name] = (loss.item(), read_launches(), finite, n_grads, wall)
    (loss, launches, finite, n_grads, wall), ref = res["kernels"], res["plain"]
    loss_rel = abs(loss - ref[0]) / abs(ref[0])
    print(f"prohmr nll_loss B={b}: loss kernels {loss:.6g}, plain {ref[0]:.6g} (rel "
          f"{loss_rel:.3g}); {n_grads} gradients, all finite {finite and ref[2]}; launches "
          f"{launches}; first forward+backward {wall:.1f} ms", flush=True)
    check(finite and ref[2] and n_grads > 0 and loss_rel <= TRAIN_LOSS_TOL,
          f"prohmr nll: loss {loss} vs {ref[0]}, finite {finite}, {ref[2]}")
    check(launches["bn_stats_sums"] == 53 and sum(launches.values()) == 53
          and sum(ref[1].values()) == 0, f"prohmr nll: launches {launches}, plain {ref[1]}")
    return {"loss": loss, "ref_loss": ref[0], "loss_rel": loss_rel, "launches": launches,
            "gradients": n_grads, "first_call_ms": wall}


def glow_autoresume(torch, dev, engine, load_cfg, model_dir: str) -> dict:
    """run.py's path (Experiment.train_baseline, closed after) twice in one
    model_dir: configs/smoke.yaml (resnet18 at 64 px, synthetic data) as a
    glow MHEnt, 1 epoch, then 2 with tpu.autoresume. The second run resumes
    at epoch 1 and ends at twice the first's step; both write their log
    and scalars."""
    records = []
    for epochs in (1, 2):
        cfg = load_cfg("configs/smoke.yaml")
        cfg.network.regressor = "glow"
        cfg.training.epochs = epochs
        cfg.training.seed = 0
        cfg.model_dir = model_dir + "/"
        cfg.tpu.autoresume = True
        with engine.Experiment(cfg, device=dev) as exp:
            exp.train_baseline()
        log = open(os.path.join(model_dir, f"info_{cfg.training.mode}.log")).read()
        ckpt = torch.load(os.path.join(model_dir, "baseline_final.pth"), map_location="cpu")
        with open(os.path.join(model_dir, "scalars.jsonl")) as f:
            n_scalars = sum(1 for _ in f)
        records.append((ckpt["step"], log, n_scalars))
    (first, log1, n1), (second, log2, n2) = records
    resumed = re.search(r"continuing at epoch (\d+)", log2)
    start = int(resumed.group(1)) if resumed else 0
    print(f"glow autoresume: steps {first} then {second}; the second run "
          f"{'resumed at epoch ' + str(start) if resumed else 'did not resume'}; "
          f"scalars {n1} then {n2}", flush=True)
    check(resumed is not None and start == 1 and "autoresume: restored" not in log1
          and "Epoch:0| eval_3d_rgb" not in log2 and first > 0 and second == 2 * first
          and n2 > n1 > 0 and "Epoch:1| Step:0| Avg_Loss:" in log2,
          f"glow autoresume: steps {first}, {second}; scalars {n1}, {n2}")
    return {"steps_first": first, "steps_second": second, "start_epoch": start,
            "scalars": [n1, n2]}


# The loader phase (9e): the RHD tree's train / eval items (RHD's 320 x 320),
# FreiHAND's items (the loader keeps the last 10 % for evaluation) and the
# HO3D tree's train / eval frames; the loader throughput windows.
LOADER_RHD = (128, 64)
LOADER_FREIHAND = 128
LOADER_HO3D = (64, 32)
LOADER_WINDOW_S = 0.5
LOADER_THREADS = 4  # data.common.batches' default pool, as train_epoch runs it


def importable(name: str) -> bool:
    """Whether `import name` succeeds here (the card's image libraries are
    checked up front, once)."""
    import importlib

    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def loader_cfg(yaml: str, data_dir: str, model_dir: str, epochs: int, decode_cache,
               dataset_name: str | None = None):
    """A shipped YAML at full width, trained `epochs` (0: the eval alone)
    from tpu.data_dir, seed 0."""
    from mhentropy_tpu_torch.utils.config import load_cfg

    cfg = load_cfg(yaml)
    cfg.training.epochs = epochs
    cfg.training.seed = 0
    cfg.model_dir = model_dir + "/"
    cfg.tpu.data_dir = data_dir
    cfg.tpu.decode_cache = decode_cache
    if dataset_name:
        cfg.dataset.dataset_name = dataset_name
    return cfg


def loader_run(torch, dev, label: str, cfg) -> dict:
    """Experiment.train_baseline (run.py's path) on a loader tree: finite
    losses and metrics, each kernel launched the counted number of times
    (per eval batch stem 1, stage 1 3, the bf16 draw 1 and the reverse-KL
    f32 draw 1; per train step the BN stats sums 53 and the f32 draw 1;
    none other), and the final checkpoint reloads."""
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.train import engine

    exp = engine.Experiment(cfg, device=dev)
    train, evald = exp.make_datasets(which=("train", "eval") if cfg.training.epochs
                                     else ("eval",))
    bs = cfg.training.batch_size
    n_eval, n_steps = -(-len(evald) // bs), -(-len(train) // bs) if train is not None else 0
    t0 = time.perf_counter()
    reset_launches()
    summary = exp.train_baseline()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(len(exp.losses) == n_steps and all(math.isfinite(v) for v in exp.losses),
          f"loaders {label}: losses {exp.losses}, expected {n_steps} steps")
    check(summary and all(math.isfinite(v) for v in summary.values()),
          f"loaders {label}: eval metrics {summary}")
    want = dict.fromkeys(launches, 0)
    want.update(stem=n_eval, stage1=3 * n_eval, realnvp_sampler=n_eval,
                realnvp_sampler_f32=n_eval + n_steps, bn_stats_sums=53 * n_steps)
    check(launches == want, f"loaders {label}: launches {launches}, expected {want}")
    if n_steps:
        path = os.path.join(cfg.model_dir, "baseline_final.pth")
        reloaded = mhent.init(exp.model_cfg, seed=1)
        engine.Experiment._restore(reloaded, path)
        here = {k: v.cpu() for k, v in exp.net.state_dict().items()}
        check(all(torch.equal(v, here[k]) for k, v in reloaded.state_dict().items()),
              f"loaders {label}: {path} does not reload the trained weights")
    print(f"loaders {label}: {wall:.1f} s for train_baseline ({len(train) if n_steps else 0} "
          f"train / {len(evald)} eval items, {n_steps} steps, {n_eval} eval batches); losses "
          f"{exp.losses}; eucLoss_3d_rgb_sample {summary['eucLoss_3d_rgb_sample']:.6g}; "
          f"launches {launches}", flush=True)
    return {"exp": exp, "train": train, "eval": evald, "launches": launches, "run_s": wall,
            "losses": exp.losses, "eval_summary": summary, "steps": n_steps,
            "eval_batches": n_eval}


def loader_items_per_s(datasets: dict, seconds: float) -> dict:
    """Host items/s of whole epochs of common.batches (LOADER_THREADS
    threads, host numpy, no device), each dataset in turn for RUNS windows
    of at least `seconds` (reversed on odd runs), after one warm epoch that
    fills any cache."""
    from mhentropy_tpu_torch.data import common

    def epoch(ds, e):
        if hasattr(ds, "set_epoch"):
            ds.set_epoch(e)
        n = 0
        for image, _ in common.batches(ds, TRAIN_BATCH, shuffle=True, seed=e,
                                       num_workers=LOADER_THREADS, pad_remainder=True):
            n += image.shape[0]
        return n

    for ds in datasets.values():
        epoch(ds, 0)
    runs = {name: [] for name in datasets}
    order = tuple(datasets)
    for r in range(RUNS):
        for name in (order if r % 2 == 0 else order[::-1]):
            items, e, t1 = 0, 1, time.perf_counter()
            while time.perf_counter() - t1 < seconds:
                items += epoch(datasets[name], e)
                e += 1
            runs[name].append(items / (time.perf_counter() - t1))
    return {name: spread(v) for name, v in runs.items()}


def loader_stream(ds, dev):
    """Train batches on the device for as long as they are drawn: epoch
    after epoch (set_epoch, shuffled) through ONE prefetch thread, so the
    tiny tree's epoch boundaries add no pipeline restarts that a real epoch
    of hundreds of steps would not have."""
    from mhentropy_tpu_torch.data import common

    def epochs():
        e = 0
        while True:
            ds.set_epoch(e)
            yield from common.batches(ds, TRAIN_BATCH, shuffle=True, seed=e, pad_remainder=True,
                                      device=dev)
            e += 1

    return common.prefetch(epochs())


def phase_loaders(torch, dev):
    """9e: the image libraries; the loader trees; run.py's path on each
    dataset that this machine's libraries can read; on the first train run
    the loader's first batch through one step with kernels and the plain
    path; host items/s of the loaders; ms per train step fed by the loader
    against pre-staged synthetic batches, and the busy share of each."""
    import importlib
    import tempfile

    from mhentropy_tpu_torch.data import cached, common, fixtures, synthetic
    from mhentropy_tpu_torch.train import engine

    libs = {name: importable(name) for name in ("PIL", "cv2", "imageio")}
    print(f"loaders: image libraries importable: {libs}", flush=True)
    out = {"libraries": libs, "runs": {}, "not_run": {}}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        fh_root = os.path.join(tmp, "freihand")
        # Without Pillow the images reach the loaders through the decode
        # cache alone: the writers put every array there.
        decode_cache = None if libs["PIL"] else os.path.join(tmp, "decode_cache")
        if decode_cache:
            common.set_decode_cache(decode_cache)
        t0 = time.perf_counter()
        fixtures.write_rhd(data, *LOADER_RHD, cache=bool(decode_cache))
        fixtures.write_freihand(fh_root, LOADER_FREIHAND, cache=bool(decode_cache))
        if libs["cv2"]:
            fixtures.write_ho3d(data, *LOADER_HO3D, cache=bool(decode_cache))
        out["write_s"] = time.perf_counter() - t0
        print(f"loaders: trees written in {out['write_s']:.1f} s", flush=True)
        # RHD's train mode jitters hue through Pillow; HO3D reads its depth
        # with cv2 (and so does the mixed set, with RHD's jitter).
        plan = [("rhd", "configs/rhd.yaml", data, 1 if libs["PIL"] else 0, None),
                ("freihand", "configs/freihand.yaml", fh_root, 1, None)]
        if libs["cv2"]:
            plan.append(("ho3d", "configs/ho3d.yaml", data, 1, None))
            plan.append(("mixed_ho3d_rhd", "configs/rhd.yaml", data, 1 if libs["PIL"] else 0,
                         "mixed_ho3d_rhd"))
        else:
            out["not_run"].update(ho3d="cv2 absent", mixed_ho3d_rhd="cv2 absent")
        if not libs["PIL"]:
            out["not_run"].update(rhd_train="Pillow absent (hue jitter)",
                                  mixed_ho3d_rhd_train="Pillow absent (RHD's hue jitter)")
        runs = {}
        for name, yaml, root, epochs, ds_name in plan:
            cfg = loader_cfg(yaml, root, os.path.join(tmp, "model", name), epochs, decode_cache,
                             ds_name)
            runs[name] = loader_run(torch, dev, name, cfg)
        print(f"loaders: ran {sorted(runs)}; not run: {out['not_run']}", flush=True)

        # The first train run's loader: its first batch through one step,
        # kernels against the plain path (as phase 9 holds a step).
        first = next(r for r in runs.values() if r["steps"])
        exp, train = first["exp"], first["train"]
        train.set_epoch(0)
        batches = common.batches(train, TRAIN_BATCH, shuffle=True, seed=exp.seed,
                                 pad_remainder=True, device=dev)
        image, target = engine._prep_batch(*next(batches))
        batches.close()
        g = torch.Generator(device=dev).manual_seed(13)
        noise = torch.randn((N_TRAIN_HYPO * TRAIN_BATCH, 45), generator=g, device=dev)
        steps = {}
        for kernels in (True, False):
            net = copy.deepcopy(exp.net)
            net.set_kernels(kernels)
            reset_launches()
            steps[kernels] = one_step_grads(torch, net, exp.model, exp.fold, image, target,
                                            noise) + (read_launches(),)
            del net
        (loss, _, stats, launches), (ref_loss, _, ref_stats, plain_launches) = (
            steps[True], steps[False])
        rel = abs(loss - ref_loss) / abs(ref_loss)
        stats_rel = max(float(((stats[n] - ref_stats[n]).abs()
                               / ref_stats[n].abs().clamp_min(1.0)).max()) for n in stats)
        check(all(v == 0 for v in plain_launches.values()),
              f"loaders: the plain step launched kernels {plain_launches}")
        check(launches["bn_stats_sums"] == 53 and launches["realnvp_sampler_f32"] == 1,
              f"loaders: one loader-fed step launched {launches}")
        check(rel <= TRAIN_LOSS_TOL and stats_rel <= TRAIN_STATS_TOL,
              f"loaders: loader-fed step, kernels vs plain: loss {loss} vs {ref_loss} (rel "
              f"{rel}), running stats {stats_rel}")
        print(f"loaders: first {first['train'].__class__.__name__} batch, one step kernels vs "
              f"plain: loss {loss:.6g} vs {ref_loss:.6g} (rel {rel:.3g}), running stats "
              f"{stats_rel:.3g}; launches {launches}", flush=True)
        out["kernels_vs_plain"] = {"dataset": first["train"].__class__.__name__, "loss": loss,
                                   "ref_loss": ref_loss, "loss_rel": rel, "stats_rel": stats_rel,
                                   "launches_per_step": launches}

        # Host items/s: train mode plain and through the prefix cache, eval
        # mode plain and through the sample cache.
        name = "rhd" if "rhd" in runs and runs["rhd"]["steps"] else "freihand"
        tree = data if name == "rhd" else fh_root
        mod = importlib.import_module(f"mhentropy_tpu_torch.data.{name}")
        kw = dict(heavy_fields=set(), image_u8=True, device_st=True)
        prefix = os.path.join(tmp, "prefix_cache")
        datasets = {"train": mod.load(tree, mode="training", **kw),
                    "train_prefix_cache": mod.load(tree, mode="training", prefix_cache=prefix,
                                                   **kw),
                    "eval": mod.load(tree, mode="evaluation", **kw),
                    "eval_sample_cache": cached.SampleCache(mod.load(tree, mode="evaluation",
                                                                     **kw), prefix)}
        rates = loader_items_per_s(datasets, LOADER_WINDOW_S)
        for k, v in rates.items():
            print(f"loaders {name} {k}: median {v['median']:.1f} items/s [{v['min']:.1f}, "
                  f"{v['max']:.1f}] over {RUNS} windows of >= {LOADER_WINDOW_S} s, "
                  f"{LOADER_THREADS} threads", flush=True)
        out["items_per_s"] = {"dataset": name, "threads": LOADER_THREADS, **rates}

        # ms per train step: fed by the loader through prefetch, against the
        # same step on pre-staged synthetic batches, in alternating windows.
        run = runs[name]
        exp, stream = run["exp"], loader_stream(run["train"], dev)
        exp.net.train()
        img = exp.model_cfg.image_size
        staged = list(synthetic.batches(synthetic.make_dataset(
            exp.model, n=2 * TRAIN_BATCH, image_size=img, seed=0, ds=name), TRAIN_BATCH,
            device=dev))
        turn = [0]

        def loader_step():
            image, target = next(stream)
            return exp._train_step(image, target, *exp._draws(target, TRAIN_BATCH))

        def synthetic_step():
            image, target = staged[turn[0] % len(staged)]
            turn[0] += 1
            return exp._train_step(image, target, *exp._draws(target, TRAIN_BATCH))

        try:
            ms = windows_ms(torch, {"loader": loader_step, "synthetic": synthetic_step},
                            STEP_WINDOW_S)
            traces = {k: trace_steps(torch, fn, ms[k]["median"], n=TRACED,
                                     label=f"loaders {name} {k}-fed step")
                      for k, fn in (("loader", loader_step), ("synthetic", synthetic_step))}
        finally:
            stream.close()
        for k, v in ms.items():
            print(f"loaders {name} train step fed by {k}: median {v['median']:.3f} ms/step of "
                  f"B={TRAIN_BATCH} [{v['min']:.3f}, {v['max']:.3f}] over {RUNS} windows of >= "
                  f"{STEP_WINDOW_S} s ({v['calls']} steps); busy {traces[k]['busy_share']:.3f}",
                  flush=True)
        out["ms_per_step"] = {"dataset": name, **ms}
        out["traces"] = {k: {key: t[key] for key in ("device_ms_per_step", "busy_share",
                                                      "device_ops_per_step",
                                                      "layer_ms_per_step")}
                         for k, t in traces.items()}
        out["runs"] = {k: {key: r[key] for key in ("launches", "run_s", "losses", "eval_summary",
                                                   "steps", "eval_batches")}
                       for k, r in runs.items()}
        if decode_cache:
            common.set_decode_cache(None)
        del runs, first, exp, staged
    return out


# 9g: the renderer and the mask likelihood. At 12,800 rows (the eval batch,
# B = 64, N = 200) each (rows, V, S) f32 splat factor is 12,800 x 778 x 64 x
# 4 B = 2.55 GB; the render holds the two factors and up to two temporaries
# of that size, about 10 GB: RENDER_MEM_GB bounds what a render allocates
# beyond what was allocated before it. At a train step's 640 rows each factor
# is 127 MB, and the mask's forward and backward keep a few: 2 GB (the
# (rows, S, S, V) product a three-operand einsum would form is 8.2 GB there).
RENDER_MEM_GB = {"eval": 16.0, "train": 2.0}
# The render on the card (f32, TF32 off) against a float64 evaluation on the
# CPU of the same vertices, over RENDER_CHECK_ROWS rows: the sums over 778
# vertices in another precision. Depth is compared where the float64
# silhouette is outside RENDER_COVER_BAND of the 0.5 cover test, whose side
# a rounding may flip there.
RENDER_TOL = {"mask": 1e-5, "depth": 1e-4}
RENDER_CHECK_ROWS = 64
RENDER_COVER_BAND = 1e-4
# The mask term moves the flow's gradients: their relative L2 change with and
# without use_mask_loss, from the same weights, batch and noise, is at least
# MASK_GRAD_MOVE.
MASK_GRAD_MOVE = 1e-4
MASK_WINDOW_S = 0.5
MASK_PHASE_S = 90.0


def render_bound(rows: int, s: int = 64, v: int = 778, products: int = 4) -> dict:
    """The render's least time: its inputs (vertices and camera) read and its
    outputs (mask and depth) written once, or its f32 products (`products`
    batched (S, V) x (V, S) contractions a row: the mask's one, the depth's
    three) at the f32 peak, whichever is larger."""
    n_bytes = rows * (v * 3 + 3) * 4 + 2 * rows * s * s * 4
    return roofline(n_bytes, 2.0 * rows * s * s * v * products, "f32")


def mask_render(torch, dev) -> dict:
    """configs/ho3d.yaml (resnet50 at 256 px, 12 x 512 RealNVP, seeded weights
    with an O(1) flow): sample_hypotheses at B = 64, N = 200 (xyz, uv), then
    decode(mods=("uv", "m", "depth")) of its 12,800 rows; launches, the
    masks' range and cover of their projected vertices, the render against a
    float64 evaluation, its memory at 12,800 rows and, forward and backward,
    at a train step's 640, and its ms (eager and as a CUDA graph)."""
    from mhentropy_tpu_torch.core import camera, mano, render
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    model_cfg = engine.build_model_config(load_cfg("configs/ho3d.yaml"))
    net = mhent.prepare(mhent.init(model_cfg, seed=0), dev)
    o1_flow(torch, net, 20)
    mhent.prepare(net, dev)
    model = engine.load_mano_model(device=dev)
    fold = mano.fold_keypoints(model)
    g = torch.Generator(device=dev).manual_seed(20)
    images = torch.randn((EVAL_BATCH, 256, 256, 3), generator=g, device=dev)
    noise = torch.randn((N_HYPO * EVAL_BATCH, 45), generator=g, device=dev) * 0.8
    rows = N_HYPO * EVAL_BATCH
    out = {"rows": rows}
    with torch.inference_mode():
        reset_launches()
        hyp = mhent.sample_hypotheses(model, net, images, n=N_HYPO, temp=0.8, mods=("xyz", "uv"),
                                      base_noise=noise, fold=fold)
        th_bt, logs_t = hyp["th_bt"].reshape(rows, -1), hyp["logs_t"].reshape(rows, -1)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dec = mhent.decode(model, net.cfg, th_bt, logs_t, mods=("uv", "m", "depth"), fold=fold)
        torch.cuda.synchronize()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["render_gb"] = out["peak_gb"] - before / 1e9
        out["launches"] = launches = read_launches()
        want = dict.fromkeys(launches, 0)
        want.update(stem=1, stage1=3, realnvp_sampler=1, lbs_blend=1)
        check(launches == want, f"render: launches {launches}, expected {want}")
        mask, depth, verts = dec["mask"], dec["depth"], dec["verts"]
        check(mask.shape == depth.shape == (rows, 64, 64)
              and bool(torch.isfinite(mask).all()) and bool(torch.isfinite(depth).all())
              and float(mask.min()) >= 0.0 and float(mask.max()) <= 1.0,
              f"render: mask {tuple(mask.shape)} in [{float(mask.min())}, "
              f"{float(mask.max())}], depth finite {bool(torch.isfinite(depth).all())}")
        # Each row's mask covers the pixels of its projected vertices.
        uv = camera.orth_project(verts, torch.exp(logs_t[:, :1]), logs_t[:, 1:3], inv_norm=False)
        px = torch.floor((uv + 1.0) / 2.0 * 64).long()
        inb = ((px >= 0) & (px < 64)).all(-1)
        flat = (px[..., 1].clamp(0, 63) * 64 + px[..., 0].clamp(0, 63))
        at_verts = torch.gather(mask.reshape(rows, -1), 1, flat)
        out["in_bounds_vertex_share"] = float(inb.float().mean())
        check(bool(inb.any()), "render: no sampled vertex falls on the mask grid")
        out["min_mask_at_vertices"] = float(at_verts[inb].min())
        check(out["min_mask_at_vertices"] > 0.5,
              f"render: the masks do not cover their vertices: {out}")
        k = RENDER_CHECK_ROWS
        ref = render.render_mods(verts[:k].double().cpu(), logs_t[:k].double().cpu(),
                                 mods=("m", "depth"))
        err_mask = float((mask[:k].cpu().double() - ref["mask"]).abs().max())
        sure = (ref["mask"] - 0.5).abs() > RENDER_COVER_BAND
        err_depth = float(((depth[:k].cpu().double() - ref["depth"]).abs() * sure).max())
        out["max_abs_err"] = {"mask": err_mask, "depth": err_depth,
                              "depth_pixels_in_cover_band": int((~sure).sum())}
        check(err_mask <= RENDER_TOL["mask"] and err_depth <= RENDER_TOL["depth"],
              f"render against float64: {out['max_abs_err']} (tolerance {RENDER_TOL})")
        del dec, mask, depth, ref, uv, px, at_verts
        timings = {}
        for label, mods in (("m", ("m",)), ("m_depth", ("m", "depth"))):
            fn = lambda mods=mods: render.render_mods(verts, logs_t, mods=mods)  # noqa: E731
            timings[label] = {"ms": cuda_ms(torch, fn, MASK_WINDOW_S),
                              "graph_ms": cuda_ms(torch, graphed(torch, fn), MASK_WINDOW_S),
                              **render_bound(rows, products=1 if label == "m" else 4)}
        out["ms"] = timings
    # A train step's 640 rows, forward and backward of the mask.
    n = N_TRAIN_HYPO * TRAIN_BATCH
    v640 = verts[:n].clone().requires_grad_()
    lt640 = logs_t[:n].clone()
    del verts, hyp, th_bt, logs_t, net, images, noise
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def fwd_bwd():
        render.render_mods(v640, lt640, mods=("m",))["mask"].sum().backward()

    fwd_bwd()
    torch.cuda.synchronize()
    out["train_rows"] = n
    out["train_render_gb"] = torch.cuda.max_memory_allocated() / 1e9 - before / 1e9
    check(bool(torch.isfinite(v640.grad).all()), "render: non-finite mask gradient at 640 rows")
    out["train_ms_fwd_bwd"] = cuda_ms(torch, fwd_bwd, MASK_WINDOW_S)
    check(out["render_gb"] <= RENDER_MEM_GB["eval"]
          and out["train_render_gb"] <= RENDER_MEM_GB["train"],
          f"render: {out['render_gb']:.2f} GB at {rows} rows, {out['train_render_gb']:.3f} GB "
          f"at {n} rows forward and backward (bounds {RENDER_MEM_GB})")
    return out


def mask_train_run(torch, dev, label: str, cfg) -> dict:
    """loader_run (run.py's path: every kernel's launches, none of the LBS
    blend, finite losses and metrics, the checkpoint reloads) with every
    forward_log_p's log p(m | z) kept: each present, finite and not 0."""
    from mhentropy_tpu_torch.models import mhent

    seen = []
    flp = mhent.forward_log_p

    def spy(*args, **kwargs):  # keeps each call's log p(m | z), read after the run
        res = flp(*args, **kwargs)
        seen.append(res.get("log_p_m_giv_z"))
        return res

    mhent.forward_log_p = spy
    try:
        run = loader_run(torch, dev, f"mask {label}", cfg)
    finally:
        mhent.forward_log_p = flp
    # One objective a train step and a reverse-KL term an eval batch (the
    # initial eval only: eval_interval 2 and one epoch).
    want = run["steps"] + run["eval_batches"]
    check(len(seen) == want
          and all(t is not None and bool(torch.isfinite(t).all()) and bool((t != 0).all())
                  for t in seen),
          f"mask {label}: log p(m | z) in {len(seen)} objectives, expected {want}, each "
          f"present, finite and not 0")
    run["log_p_m_giv_z"] = [float(t.detach().mean()) for t in seen]
    return run


def mask_step(torch, dev, exp, train) -> dict:
    """The first train batch (with its 64 x 64 masks) through one step from
    the same weights and noise: the kernels against the plain path in bf16
    (loss within TRAIN_LOSS_TOL) and in f32 (each gradient's cosine at least
    TRAIN_GRAD_COS, loss within TRAIN_F32_LOSS_TOL), launches a step BN stats
    sums 53, f32 sampler 1, LBS 0; the mask term moves the flow's gradients;
    ms a step with and without the term in alternating windows, and a trace
    of each (busy share, the term's share of device time)."""
    from mhentropy_tpu_torch.data import common
    from mhentropy_tpu_torch.train import engine

    train.set_epoch(0)
    batches = common.batches(train, TRAIN_BATCH, shuffle=True, seed=exp.seed, pad_remainder=True,
                             device=dev)
    image, target = engine._prep_batch(*next(batches))
    batches.close()
    check(target["mask"].shape == (TRAIN_BATCH, 64, 64),
          f"mask step: the batch's mask {tuple(target['mask'].shape)}")
    g = torch.Generator(device=dev).manual_seed(13)
    noise = torch.randn((N_TRAIN_HYPO * TRAIN_BATCH, 45), generator=g, device=dev)
    mask_cfg = exp.net.cfg
    variants = {"kernels": (True, None, True), "plain": (False, None, True),
                "kernels_f32": (True, torch.float32, True), "plain_f32": (False, torch.float32, True),
                "kernels_f32_no_mask": (True, torch.float32, False)}
    steps = {}
    for name, (kernels, dtype, use_mask) in variants.items():
        net = copy.deepcopy(exp.net)
        net.set_kernels(kernels)
        net.cfg = mask_cfg._replace(use_mask_loss=use_mask)
        if dtype is not None:
            net.feat_extractor.res.dtype = dtype
        reset_launches()
        steps[name] = one_step_grads(torch, net, exp.model, exp.fold, image, target, noise)
        torch.cuda.synchronize()
        steps[name] += (read_launches(),)
        del net
    want = dict.fromkeys(steps["kernels"][3], 0)
    want.update(bn_stats_sums=53, realnvp_sampler_f32=1)
    for name in ("kernels", "kernels_f32"):
        check(steps[name][3] == want, f"mask step {name}: launches {steps[name][3]}, "
                                      f"expected {want}")
    for name in ("plain", "plain_f32"):
        check(not any(steps[name][3].values()), f"mask step {name}: launches {steps[name][3]}")
    out = {"launches_per_step": steps["kernels"][3]}
    for name, ref in (("kernels", "plain"), ("kernels_f32", "plain_f32")):
        loss, grads, _, _ = steps[name]
        ref_loss, ref_grads, _, _ = steps[ref]
        cos = cosines(torch, grads, ref_grads)
        lowest = min(cos, key=cos.get)
        out[name] = {"loss": loss, "ref_loss": ref_loss,
                     "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                     "min_grad_cosine": cos[lowest], "min_grad_cosine_param": lowest,
                     "median_grad_cosine": statistics.median(cos.values())}
        print(f"mask step {name} vs {ref}: {json.dumps(out[name])}", flush=True)
    check(out["kernels"]["loss_rel"] <= TRAIN_LOSS_TOL, f"mask step kernels: {out['kernels']}")
    f32 = out["kernels_f32"]
    check(f32["min_grad_cosine"] >= TRAIN_GRAD_COS and f32["loss_rel"] <= TRAIN_F32_LOSS_TOL,
          f"mask step kernels_f32: {f32}")
    with_m, without = steps["kernels_f32"][1], steps["kernels_f32_no_mask"][1]
    flow = [k for k in with_m if k.startswith("q_z_giv_i.")]
    moved = max(float((with_m[k] - without[k]).norm() / without[k].norm().clamp_min(1e-30))
                for k in flow)
    out["flow_grad_rel_change_from_mask"] = moved
    check(moved >= MASK_GRAD_MOVE, f"mask step: the mask term moves the flow's gradients by "
                                   f"{moved} (at least {MASK_GRAD_MOVE})")
    del steps

    # ms a step with and without the term, alternating, and a trace of each.
    net, step = exp.net.train(), exp._train_step

    def run(use_mask):
        net.cfg = mask_cfg._replace(use_mask_loss=use_mask)
        return step(image, target, noise)

    fns = {"mask": lambda: run(True), "no_mask": lambda: run(False)}
    try:
        out["ms_per_step"] = windows_ms(torch, fns, MASK_WINDOW_S)
        traces = {k: trace_steps(torch, fn, out["ms_per_step"][k]["median"], n=TRACED,
                                 label=f"mask train step ({k})") for k, fn in fns.items()}
    finally:
        net.cfg = mask_cfg
    out["traces"] = {k: {key: t[key] for key in ("device_ms_per_step", "busy_share",
                                                  "device_ops_per_step", "layer_ms_per_step")}
                     for k, t in traces.items()}
    dm, dn = traces["mask"]["device_ms_per_step"], traces["no_mask"]["device_ms_per_step"]
    out["mask_term_device_share"] = (dm - dn) / dm
    return out


def mask_eval_batch(torch, dev, exp, evald) -> dict:
    """One eval batch with its masks through the Experiment's eval step
    (N = training.test_samples): launches stem 1, stage 1 3, the bf16 draw 1,
    the reverse-KL f32 draw 1 and no other (the likelihood's mesh on the
    plain blend); every metric finite."""
    from mhentropy_tpu_torch.data import common
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.train import engine

    tr = exp.cfg.training
    exp.net.eval()
    mhent.refresh_kernel_weights(exp.net)
    step = engine.make_eval_step(exp.model, exp.net, tr.test_samples, tr.eval_temp, fold=exp.fold,
                                 generator=exp.gen)
    batches = common.batches(evald, TRAIN_BATCH, pad_remainder=True, device=dev)
    image, target = next(batches)
    batches.close()
    check("mask" in target, f"mask eval: the batch has no mask: {sorted(target)}")
    draws = exp._draws(target, TRAIN_BATCH)
    hypo = torch.randn((tr.test_samples * TRAIN_BATCH, 45), generator=exp.gen, device=dev)
    reset_launches()
    mets = step(image, target, *draws, hypo * tr.eval_temp)
    torch.cuda.synchronize()
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want.update(stem=1, stage1=3, realnvp_sampler=1, realnvp_sampler_f32=1)
    check(launches == want, f"mask eval batch: launches {launches}, expected {want}")
    mets = {k: float(v) for k, v in mets.items()}
    check(all(math.isfinite(v) for v in mets.values()), f"mask eval batch: metrics {mets}")
    return {"launches": launches, "metrics": mets}


def phase_mask(torch, dev):
    """9g: the render of sampled hypotheses at the eval batch's 12,800 rows
    (mask_render); run.py's path with network.use_mask_loss on the RHD tree
    that 9e writes (configs/rhd.yaml, one epoch) and, where cv2 imports, on
    its HO3D tree (configs/ho3d.yaml, hand_mask at 256 px pooled onto the
    64 x 64 render); one mask train step kernels against plain (mask_step)
    and one eval batch (mask_eval_batch). Fails if any part fails or the
    phase takes more than MASK_PHASE_S."""
    import tempfile

    from mhentropy_tpu_torch.data import fixtures

    t0 = time.perf_counter()
    out = {"render": mask_render(torch, dev)}
    libs = {name: importable(name) for name in ("PIL", "cv2")}
    check(libs["PIL"], "mask: RHD's train mode jitters hue through Pillow, which does not import")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        fixtures.write_rhd(data, *LOADER_RHD)
        plan = [("rhd", "configs/rhd.yaml")]
        if libs["cv2"]:
            fixtures.write_ho3d(data, *LOADER_HO3D)
            plan.append(("ho3d", "configs/ho3d.yaml"))
        out["not_run"] = {} if libs["cv2"] else {"ho3d": "cv2 absent"}
        runs = {}
        for name, yaml in plan:
            cfg = loader_cfg(yaml, data, os.path.join(tmp, "model", name), 1, None)
            cfg.network.use_mask_loss = True
            runs[name] = mask_train_run(torch, dev, name, cfg)
        exp = runs["rhd"]["exp"]
        out["train_step"] = mask_step(torch, dev, exp, runs["rhd"]["train"])
        out["eval_batch"] = mask_eval_batch(torch, dev, exp, runs["rhd"]["eval"])
        out["runs"] = {k: {key: r[key] for key in ("launches", "run_s", "losses", "eval_summary",
                                                   "steps", "eval_batches", "log_p_m_giv_z")}
                       for k, r in runs.items()}
        for r in runs.values():
            r["exp"].close()
        del runs, exp
    out["wall_s"] = time.perf_counter() - t0
    r, s = out["render"], out["train_step"]
    summary = {"render_ms": {k: [v["ms"], v["graph_ms"], v["bound_ms"]]
                             for k, v in r["ms"].items()},
               "render_gb": [r["render_gb"], r["train_render_gb"]],
               "render_err": r["max_abs_err"],
               "train_ms": {k: v["median"] for k, v in s["ms_per_step"].items()},
               "busy": {k: v["busy_share"] for k, v in s["traces"].items()},
               "mask_term_device_share": s["mask_term_device_share"],
               "kernels_vs_plain": {k: s[k]["loss_rel"] for k in ("kernels", "kernels_f32")},
               "f32_min_cos": s["kernels_f32"]["min_grad_cosine"],
               "flow_grad_change": s["flow_grad_rel_change_from_mask"],
               "ran": sorted(out["runs"]), "not_run": out["not_run"], "wall_s": out["wall_s"]}
    print(f"mask phase: {json.dumps(summary)}", flush=True)
    check(out["wall_s"] <= MASK_PHASE_S, f"mask: the phase took {out['wall_s']:.1f} s")
    return out


def parallel_worker(rank: int, world: int, backend: str, port: int, out_dir: str) -> None:
    """One rank of phase_parallel: joins the group (gloo: every rank on
    cuda:0; NCCL: rank r on cuda:r), runs parallel_cases and (rank 0)
    writes their results as JSON."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, "lo")  # the group is on this host
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        from mhentropy_tpu_torch import ext

        ext.load()
        out = parallel_cases(torch, dev, rank)
        if rank == 0:
            with open(os.path.join(out_dir, "parallel.json"), "w") as f:
                json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the rank's failure goes to the parent
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def cosine(a, b) -> float:
    """The cosine of two tensors in float64, for gradients of any size
    (torch's cosine_similarity floors the norms' product at 1e-8)."""
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def lockstep_ms(torch, fns: dict) -> dict:
    """Spreads of ms a call of each of `fns` (name -> (callable, every
    rank calls it)), RUNS windows of PARALLEL_STEPS calls, the names in
    turn (reversed on odd runs), every rank entering each window together;
    a name that rank 0 alone calls leaves the others waiting. Then, for
    each name every rank calls, one more window with the collectives
    timed (`mesh.timed`: the card synchronised around each): their share
    of that window's wall ("collective_share") and their seconds by kind."""
    import torch.distributed as dist

    from mhentropy_tpu_torch.parallel import mesh as mesh_lib

    rank = dist.get_rank()
    order = tuple(fns)
    runs = {name: [] for name in order}

    def window(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PARALLEL_STEPS):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    for r in range(RUNS):
        for name in (order if r % 2 == 0 else order[::-1]):
            fn, everyone = fns[name]
            dist.barrier()
            if everyone or rank == 0:
                runs[name].append(window(fn) * 1e3 / PARALLEL_STEPS)
            dist.barrier()
    out = {name: spread(v) for name, v in runs.items() if v}
    for name in order:
        fn, everyone = fns[name]
        if everyone:
            dist.barrier()
            with mesh_lib.timed() as times:
                wall = window(fn)
            out[name].update(collective_share=sum(times.values()) / wall,
                             collective_ms={k: v * 1e3 / PARALLEL_STEPS
                                            for k, v in times.items()})
    return out


class _NoStep:
    """An optimizer that leaves the weights alone: the sharded step then
    stops at the global gradient, unclipped, in each parameter's .grad."""

    def __init__(self, net):
        self.net = net

    def zero_grad(self) -> None:
        self.net.zero_grad(set_to_none=True)

    def step(self) -> None:
        pass


def grad_errors(torch, g: dict, ref: dict) -> dict:
    """Gradients `g` against `ref` (name -> float64 tensor): the lowest
    cosine and the largest relative L2 over the parameters (with their
    names), the median relative L2 and the relative L2 of all of them
    together."""
    cos = {k: cosine(g[k], v) for k, v in ref.items() if float(v.norm()) > 0}
    l2 = {k: float((g[k] - v).norm() / v.norm()) for k, v in ref.items()
          if float(v.norm()) > 0}
    low, high = min(cos, key=cos.get), max(l2, key=l2.get)
    diff = sum(float((g[k] - v).pow(2).sum()) for k, v in ref.items())
    norm = sum(float(v.pow(2).sum()) for v in ref.values())
    return {"min_grad_cosine": cos[low], "min_grad_cosine_param": low,
            "max_grad_rel_l2": l2[high], "max_grad_rel_l2_param": high,
            "median_grad_rel_l2": float(np.median(list(l2.values()))),
            "all_grad_rel_l2": math.sqrt(diff / norm), "gradients": len(cos),
            "same_params": set(g) == set(ref)}


def parallel_f32_grads(torch, dev, rank, mcfg, base, model, fold, image, target,
                       noise) -> dict:
    """The 2-rank steps' global gradients in f32 (kernels on): data-parallel
    ("two_ranks_kernels_f32"), tensor-parallel at tp = 2 ("tp_kernels_f32":
    the f32 draw whole, its backward recomputed split), and data-parallel
    with a planted fault, BN statistics taken per rank
    ("per_rank_bn_fault": `bn_cuda.global_batch` made a no-op). Each is held
    to a float64 evaluation of the 1-process plain path on the global
    batch, as glow_f32_grads holds the 1-process kernel path: each
    parameter's relative L2 error at most GLOW_F32_GRAD_FACTOR x the
    1-process plain f32 path's largest plus 1e-4, the relative L2 of all
    gradients together at most PARALLEL_F32_ALL_FACTOR x the plain f32
    path's, and each cosine at least RLE_F32_GRAD_COS ("grad_ok"); the loss
    within TRAIN_F32_LOSS_TOL of the 1-process kernel path's ("loss_ok").
    The sound steps must pass both and the fault must fail "grad_ok": the
    gate is shown to see per-rank statistics. The 1-process kernel path's
    errors, and each step's against it, are printed beside."""
    import contextlib
    from unittest import mock

    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import bn_cuda
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.parallel import mesh as mesh_lib
    from mhentropy_tpu_torch.train import engine

    def net_of(kernels: bool, dtype):
        net = mhent.MHEnt(mcfg)
        net.load_state_dict(base)
        net = mhent.prepare(net, dev, masters=True).train()
        net.set_kernels(kernels)
        net.feat_extractor.res.dtype = dtype
        return net

    per_rank_bn = mock.patch.object(bn_cuda, "global_batch",
                                    lambda group: contextlib.nullcontext())
    runs = {}
    for name, mesh, tp, plant in (
            ("two_ranks_kernels_f32", mesh_lib.make_mesh(), False, contextlib.nullcontext()),
            ("tp_kernels_f32", mesh_lib.make_mesh(tp=2), True, contextlib.nullcontext()),
            ("per_rank_bn_fault", mesh_lib.make_mesh(), False, per_rank_bn)):
        net = net_of(True, torch.float32)
        step = engine.make_train_step(model, net, _NoStep(net), fold=fold, mesh=mesh, tp=tp)
        with plant:
            loss = float(step(image, target, noise)["loss"])
        if rank == 0:
            runs[name] = (loss, {k: p.grad.double() for k, p in net.named_parameters()
                                 if p.grad is not None})
        del net, step
    if rank != 0:
        return {}
    model64 = mano.ManoModel(*(t.double() if t.is_floating_point() else t for t in model))
    args64 = (model64, mano.fold_keypoints(model64), image.double(),
              {k: v.double() if v.is_floating_point() else v for k, v in target.items()},
              noise.double())
    for name, kernels, dtype in (("kernels_f32", True, torch.float32),
                                 ("plain_f32", False, torch.float32),
                                 ("plain_f64", False, torch.float64)):
        net = net_of(kernels, dtype)
        args = (model, fold, image, target, noise)
        if dtype == torch.float64:
            net.double()
            args = args64
        loss, g, _ = one_step_grads(torch, net, *args)
        runs[name] = (loss, {k: v.double() for k, v in g.items()})
        del net
    ref_loss, ref = runs.pop("plain_f64")
    one_loss, one = runs["kernels_f32"]
    out = {name: {"loss": loss, "loss_rel_f64": abs(loss - ref_loss) / abs(ref_loss),
                  **grad_errors(torch, g, ref)} for name, (loss, g) in runs.items()}
    plain = out["plain_f32"]
    for name in ("two_ranks_kernels_f32", "tp_kernels_f32", "per_rank_bn_fault"):
        r = out[name]
        r["loss_rel"] = abs(r["loss"] - one_loss) / abs(one_loss)
        r["vs_one_process_kernels"] = {
            k: v for k, v in grad_errors(torch, runs[name][1], one).items()
            if k in ("min_grad_cosine", "max_grad_rel_l2", "all_grad_rel_l2")}
        r["loss_ok"] = r["loss_rel"] <= TRAIN_F32_LOSS_TOL
        r["grad_ok"] = (r["same_params"]
                        and r["max_grad_rel_l2"] <= GLOW_F32_GRAD_FACTOR
                        * plain["max_grad_rel_l2"] + 1e-4
                        and r["all_grad_rel_l2"] <= PARALLEL_F32_ALL_FACTOR
                        * plain["all_grad_rel_l2"]
                        and r["min_grad_cosine"] >= RLE_F32_GRAD_COS)
    return out


def parallel_cases(torch, dev, rank: int) -> dict:
    """phase_parallel's cases on one rank (rank 0 also runs the 1-process
    references)."""
    import torch.distributed as dist

    from mhentropy_tpu_torch.core import mano as mano_lib
    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.flows import realnvp
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.parallel import mesh as mesh_lib
    from mhentropy_tpu_torch.parallel import pipeline
    from mhentropy_tpu_torch.parallel import sharded
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    out = {}
    model = engine.load_mano_model("./mano/", device=dev)
    fold = mano_lib.fold_keypoints(model)

    # --- the configs/rhd.yaml train step -----------------------------------
    cfg = load_cfg("configs/rhd.yaml")
    tr = cfg.training
    check(tr.batch_size == TRAIN_BATCH and tr.n_train_hypotheses == N_TRAIN_HYPO,
          f"parallel: configs/rhd.yaml has batch {tr.batch_size}, N {tr.n_train_hypotheses}")
    mcfg = engine.build_model_config(cfg)
    base = mhent.init(mcfg, seed=0).state_dict()
    data = synthetic.make_dataset(model, n=TRAIN_BATCH, image_size=mcfg.image_size, seed=3,
                                  ds="rhd")
    image, target = next(synthetic.batches(data, TRAIN_BATCH, device=dev))
    g = torch.Generator(device=dev).manual_seed(13)
    noise = torch.randn((N_TRAIN_HYPO * TRAIN_BATCH, 45), generator=g, device=dev)
    dp = mesh_lib.make_mesh()

    def train_step(mesh=None, f32=False, fsdp=False):
        net = mhent.MHEnt(mcfg)
        net.load_state_dict(base)
        net = mhent.prepare(net, dev, masters=True).train()
        if f32:
            net.feat_extractor.res.dtype = torch.float32
        if fsdp:
            opt = engine.ShardedOptimizer(net, mesh, tr.lr, tr.milestones, 10)
        else:
            opt = engine.make_optimizer(net, tr.lr, tr.milestones, 10)
        step = engine.make_train_step(model, net, opt, fold=fold, mesh=mesh)
        return net, lambda: step(image, target, noise), opt

    def one(run):
        net, fn, opt = run
        reset_launches()
        aux = fn()
        torch.cuda.synchronize()
        return float(aux["loss"]), read_launches(), net, opt

    train = {}
    loss, launches, _, _ = one(train_step(dp))
    row = train["bf16"] = {"loss": loss, "launches_per_rank": launches}
    if rank == 0:
        ref_loss = one(train_step(None))[0]
        row.update(ref_loss=ref_loss, loss_rel=abs(loss - ref_loss) / abs(ref_loss))
    dist.barrier()
    train["f32"] = parallel_f32_grads(torch, dev, rank, mcfg, base, model, fold, image,
                                      target, noise)
    dist.barrier()
    fsdp_loss, _, fsdp_net, fsdp_opt = one(train_step(dp, fsdp=True))
    dp_loss, _, dp_net, dp_opt = one(train_step(dp))
    dp_params = dict(dp_net.named_parameters())
    w_diff = max(float((p - dp_params[k]).detach().abs().max())
                 for k, p in fsdp_net.named_parameters())
    fsdp_st, dp_st = fsdp_opt.state_dict()["adam"]["state"], dp_opt.state_dict()["adam"]["state"]
    m_diff = max(float((fsdp_st[i][m] - st[m]).abs().max() / st[m].abs().max().clamp_min(1e-30))
                 for i, st in dp_st.items() for m in ("exp_avg", "exp_avg_sq"))
    train["fsdp"] = {"loss": fsdp_loss, "dp_loss": dp_loss,
                     "loss_rel": abs(fsdp_loss - dp_loss) / abs(dp_loss),
                     "weights_max_abs": w_diff, "moments_max_rel": m_diff,
                     "moments_compared": 2 * len(dp_st),
                     "same_moments": set(fsdp_st) == set(dp_st)}
    del fsdp_net, dp_net, fsdp_opt, dp_opt, dp_params, fsdp_st, dp_st
    sharded_step, fsdp_step = train_step(dp)[1], train_step(dp, fsdp=True)[1]
    single_step = train_step(None)[1] if rank == 0 else None
    train["ms"] = lockstep_ms(torch, {"two_ranks": (sharded_step, True),
                                      "one_process": (single_step, False),
                                      "fsdp": (fsdp_step, True)})
    del sharded_step, fsdp_step, single_step
    out["train"] = train
    torch.cuda.empty_cache()

    # --- the configs/ho3d.yaml eval batch ----------------------------------
    cfg = load_cfg("configs/ho3d.yaml")
    check(cfg.training.batch_size == EVAL_BATCH and cfg.training.test_samples == N_HYPO,
          f"parallel: configs/ho3d.yaml has batch {cfg.training.batch_size}, N "
          f"{cfg.training.test_samples}")
    ecfg = engine.build_model_config(cfg)
    net = mhent.prepare(mhent.init(ecfg, seed=1), dev)
    data = synthetic.make_dataset(model, n=EVAL_BATCH, image_size=ecfg.image_size, seed=4)
    image, target = next(synthetic.batches(data, EVAL_BATCH, device=dev))
    kld = torch.randn((ecfg.n_train_hypotheses * EVAL_BATCH, 45), generator=g, device=dev)
    hypo = torch.randn((N_HYPO * EVAL_BATCH, 45), generator=g, device=dev) * 0.8
    steps = {"hypo": engine.make_eval_step(model, net, N_HYPO, 0.8, fold=fold,
                                           mesh=mesh_lib.make_mesh(hypo=2)),
             "tp": engine.make_eval_step(model, net, N_HYPO, 0.8, fold=fold,
                                         mesh=mesh_lib.make_mesh(tp=2), tp=True)}
    single = engine.make_eval_step(model, net, N_HYPO, 0.8, fold=fold)
    ev = {}
    ref = None
    if rank == 0:
        ref = {k: float(v) for k, v in single(image, target, kld, hypo).items()}
    for label, step in steps.items():
        reset_launches()
        mets = {k: float(v) for k, v in step(image, target, kld, hypo).items()}
        torch.cuda.synchronize()
        row = {"launches_per_rank": read_launches()}
        if rank == 0:
            rel = {k: abs(mets[k] - v) / max(abs(v), 1e-6) for k, v in ref.items()}
            worst = max(rel, key=rel.get)
            row.update(max_rel=rel[worst], max_rel_metric=worst,
                       max_abs=max(abs(mets[k] - v) for k, v in ref.items()))
        ev[label] = row
    ev["metrics"] = ref
    ev["ms"] = lockstep_ms(torch, {
        "hypo_two_ranks": (lambda: steps["hypo"](image, target, kld, hypo), True),
        "one_process": (lambda: single(image, target, kld, hypo), False),
        "tp_two_ranks": (lambda: steps["tp"](image, target, kld, hypo), True)})
    out["eval"] = ev

    # --- one pipelined draw (pp = 2) against the sequential one ------------
    flow = net.q_z_giv_i.float()
    feat = torch.randn((TRAIN_BATCH, ecfg.feat_dim), generator=g, device=dev)
    z0 = torch.randn((N_TRAIN_HYPO * TRAIN_BATCH, 45), generator=g, device=dev)
    pp = mesh_lib.make_mesh(pp=2)
    names = pipeline.stage_names(flow)

    def draw_grads(fn):
        flow.zero_grad(set_to_none=True)
        x, lp = fn()
        ((x ** 2).sum() + lp.sum()).backward()
        pipeline.drain()
        return x.detach(), lp.detach()

    def piped():
        return pipeline.sample_pipelined(flow, z0, feat, pp, 2, n_per_image=N_TRAIN_HYPO,
                                         return_log_prob=True)

    def sequential():
        cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
        return realnvp.sample(flow, z0, cproj=cproj.repeat(1, 1, N_TRAIN_HYPO, 1))

    x_p, lp_p = draw_grads(piped)
    sharded.sync_grads(flow, pp, pipe_names=names)
    g_p = {k: p.grad.clone() for k, p in flow.named_parameters() if p.grad is not None}
    x_s, lp_s = draw_grads(sequential)
    g_s = {k: p.grad.clone() for k, p in flow.named_parameters() if p.grad is not None}
    cos = {k: cosine(g_p[k], v) for k, v in g_s.items() if float(v.norm()) > 0}
    out["pipeline"] = {
        "rows": int(z0.shape[0]), "max_abs_x": float((x_p - x_s).abs().max()),
        "max_abs_log_q": float((lp_p - lp_s).abs().max()),
        "x_scale": float(x_s.abs().max()), "log_q_scale": float(lp_s.abs().max()),
        "min_grad_cosine": min(cos.values()),
        "ms": lockstep_ms(torch, {"pp_two_ranks": (lambda: draw_grads(piped), True),
                                  "sequential": (lambda: draw_grads(sequential), False)})}
    out["staged_collectives"] = sorted(mesh_lib.STAGED)
    return out


def phase_parallel(torch, dev, world: int = PARALLEL_RANKS, backend: str = "gloo"):
    """9h: the parallel cases in a 2-rank gloo group on the card (see the
    module docstring); fails if a rank fails, a bound is missed or the phase
    takes more than PARALLEL_PHASE_S. world / backend "nccl": one rank a
    card on a machine with `world` cards (the meshes then hold 'data' ranks
    beside each layout's two)."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=parallel_worker, args=(r, world, backend, port, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(PARALLEL_PHASE_S + 120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                  if f.startswith("error")]
        check(not errors and all(p.exitcode == 0 for p in procs),
              f"parallel: ranks exited {[p.exitcode for p in procs]}:\n" + "\n".join(errors))
        with open(os.path.join(tmp, "parallel.json")) as f:
            out = json.load(f)
    out["wall_s"] = time.perf_counter() - t0
    tr, ev, pp = out["train"], out["eval"], out["pipeline"]
    print(f"parallel: collectives through host memory under gloo: "
          f"{out['staged_collectives']}", flush=True)
    r = tr["bf16"]
    print(f"parallel train bf16 ({world} data ranks, {backend}, B = {TRAIN_BATCH}): loss "
          f"{r['loss']:.6g} vs "
          f"1-process {r['ref_loss']:.6g} (rel {r['loss_rel']:.3g}); launches a rank "
          f"{ {k: v for k, v in r['launches_per_rank'].items() if v} }", flush=True)
    for name, r in tr["f32"].items():
        print(f"parallel train f32 {name} against the 1-process plain path in float64: loss "
              f"rel {r['loss_rel_f64']:.3g}, lowest gradient cosine {r['min_grad_cosine']:.6f} "
              f"({r['min_grad_cosine_param']}), largest relative L2 {r['max_grad_rel_l2']:.4g} "
              f"({r['max_grad_rel_l2_param']}), median {r['median_grad_rel_l2']:.4g}, all "
              f"together {r['all_grad_rel_l2']:.4g}"
              + (f"; against the 1-process kernel path: loss rel {r['loss_rel']:.3g}, "
                 f"{json.dumps(r['vs_one_process_kernels'])}; loss_ok {r['loss_ok']}, "
                 f"grad_ok {r['grad_ok']}" if "grad_ok" in r else ""), flush=True)
    print(f"parallel fsdp vs dp: {json.dumps(tr['fsdp'])}", flush=True)
    for label in ("hypo", "tp"):
        r = ev[label]
        print(f"parallel eval {label} ({world} ranks, B = {EVAL_BATCH}, N = {N_HYPO}): worst metric "
              f"{r['max_rel_metric']} rel {r['max_rel']:.3g}, max-abs {r['max_abs']:.3g}; "
              f"launches a rank {r['launches_per_rank']}", flush=True)
    print(f"parallel pipeline (pp = 2, {pp['rows']} rows): max-abs x {pp['max_abs_x']:.3g} "
          f"(of {pp['x_scale']:.3g}), log q {pp['max_abs_log_q']:.3g} (of "
          f"{pp['log_q_scale']:.3g}); lowest gradient cosine {pp['min_grad_cosine']:.6f}",
          flush=True)
    for part in (tr, ev, pp):
        print("parallel ms: " + "; ".join(
            f"{k} median {v['median']:.3f} [{v['min']:.3f}, {v['max']:.3f}]"
            + (f" (collectives {v['collective_share']:.3f}: "
               f"{ {c: round(t, 3) for c, t in v['collective_ms'].items()} })"
               if "collective_share" in v else "")
            for k, v in part["ms"].items()) + f" over {RUNS} windows of {PARALLEL_STEPS} "
            f"[{card_line()}]", flush=True)
    for k, n in PARALLEL_TRAIN_LAUNCHES.items():
        got = tr["bf16"]["launches_per_rank"][k]
        check(got == n, f"parallel train: {got} {k} launches a rank, expected {n}")
    for label in ("hypo", "tp"):
        for k, n in PARALLEL_EVAL_LAUNCHES.items():
            got = ev[label]["launches_per_rank"][k]
            check(got == n, f"parallel eval {label}: {got} {k} launches a rank, expected {n}")
    check(tr["bf16"]["loss_rel"] <= TRAIN_LOSS_TOL, f"parallel train bf16: {tr['bf16']}")
    f32 = tr["f32"]
    for name in ("two_ranks_kernels_f32", "tp_kernels_f32"):
        check(f32[name]["loss_ok"] and f32[name]["grad_ok"], f"parallel train f32 {name}: {f32}")
    check(not f32["per_rank_bn_fault"]["grad_ok"],
          f"parallel train f32: the gradient gate passes BN statistics taken per rank: {f32}")
    fs = tr["fsdp"]
    check(fs["loss_rel"] <= TRAIN_F32_LOSS_TOL and fs["same_moments"]
          and fs["weights_max_abs"] <= PARALLEL_FSDP_WEIGHT_TOL
          and fs["moments_max_rel"] <= PARALLEL_FSDP_MOMENT_TOL, f"parallel fsdp: {fs}")
    check(ev["hypo"]["max_rel"] <= PARALLEL_METRIC_TOL, f"parallel eval hypo: {ev['hypo']}")
    check(ev["tp"]["max_rel"] <= PARALLEL_TP_TOL, f"parallel eval tp: {ev['tp']}")
    check(pp["max_abs_x"] <= SAMPLER_F32_TOL * max(pp["x_scale"], 1.0)
          and pp["max_abs_log_q"] <= SAMPLER_F32_TOL * max(pp["log_q_scale"], 1.0)
          and pp["min_grad_cosine"] >= TRAIN_GRAD_COS, f"parallel pipeline: {pp}")
    check(out["wall_s"] <= PARALLEL_PHASE_S, f"parallel: the phase took {out['wall_s']:.1f} s")
    print(f"parallel: the phase took {out['wall_s']:.1f} s", flush=True)
    return out


def phase_released(torch, dev):
    """9i: eval_released_checkpoint's CLI on a fabricated full-schema .pth
    and an HO3D tree at B = 64, N = 200; its four numbers finite and the
    eval kernels launched."""
    import contextlib
    import io
    import tempfile

    from mhentropy_tpu_torch import eval_released_checkpoint as released
    from mhentropy_tpu_torch.data import fixtures
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.train import engine
    from mhentropy_tpu_torch.utils.config import load_cfg

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_cfg("configs/ho3d.yaml")
        net = mhent.init(engine.build_model_config(cfg), seed=11)
        rng = np.random.default_rng(13)
        enc = {k: v.clone() for k, v in net.state_dict().items()}
        for name, shape in (("th_betas", (1, 10)), ("th_shapedirs", (778, 3, 10)),
                            ("th_posedirs", (778, 3, 135)), ("th_v_template", (1, 778, 3)),
                            ("th_J_regressor", (16, 778)), ("th_weights", (778, 16)),
                            ("th_hands_mean", (1, 45)), ("th_comps", (45, 45)),
                            ("th_selected_comps", (45, 45))):
            enc[f"mano_dec.{name}"] = torch.from_numpy(rng.standard_normal(shape).astype("f4"))
        enc["mano_dec.th_faces"] = torch.from_numpy(rng.integers(0, 778, (1538, 3)))
        pth = os.path.join(tmp, "ent_ho3d.pth")
        torch.save({"decoderPose": {}, "encoderRGB": enc}, pth)
        data = fixtures.write_ho3d(os.path.join(tmp, "data"), 1, RELEASED_FRAMES)
        reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = released.main(["--pth", pth, "--data", data, "--mano",
                                     os.path.join(tmp, "no_mano"), "--batch", str(EVAL_BATCH),
                                     "--n", str(N_HYPO)])
        torch.cuda.synchronize()
        launches = read_launches()
    text = buf.getvalue()
    table = [line for line in text.splitlines() if "(reference:" in line]
    vals = [float(line.split(":")[1].split()[0]) for line in table]
    out = {"table": table, "values": vals, "launches": launches,
           "wall_s": time.perf_counter() - t0,
           "summary": {key: summary[key] for _, key, _, _ in released.TABLE}}
    print("released eval: " + " | ".join(table) + f"; launches {launches}; "
          f"{out['wall_s']:.1f} s", flush=True)
    check(len(vals) == 4 and all(math.isfinite(v) for v in vals),
          f"released eval: the table {table}")
    check(f"evaluation split: {RELEASED_FRAMES} samples" in text, f"released eval: {text}")
    for name, n in PARALLEL_EVAL_LAUNCHES.items():
        check(launches[name] == n, f"released eval: {launches[name]} {name} launches for one "
                                   f"batch, expected {n}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    from mhentropy_tpu_torch import ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {name}",
          flush=True)
    print("TF32 off for f32 matmuls and convolutions (the f32 references)", flush=True)

    t0 = time.perf_counter()
    lib = ext.load()
    print(f"build: {lib.path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"build: {line.strip()}", flush=True)
    serialized = lib.wgmma_serialized()
    print(f"build: sources whose wgmma ptxas serialized ({'/'.join(ext.SERIALIZED_WGMMA)}): "
          f"{serialized}", flush=True)
    check("stage2_int8.cu" not in serialized,
          "build: ptxas serialized the wgmma of stage2_int8.cu")
    mma = sass_mma_counts(lib.path, "stage2_int8")
    convs = {fn: c for fn, c in mma.items() if "conv_kernel" in fn}
    print(f"build: stage2_int8.cu's conv kernels in SASS: {len(convs)}, IGMMA "
          f"{sorted({c['IGMMA'] for c in convs.values()})} a kernel, IMMA "
          f"{sum(c['IMMA'] for c in mma.values())}", flush=True)
    check(convs and all(c["IGMMA"] > 0 for c in convs.values())
          and all(c["IMMA"] == 0 for c in mma.values()),
          f"build: stage2_int8.cu's products are not all on wgmma: {mma}")

    results = []
    probe_results, probe_launches = phase_gemm_probe(torch, dev)
    new_probes, new_probe_launches = phase_probes(torch, dev)
    for phase in (phase_stem, phase_stage1, phase_sampler, phase_lbs, phase_stage1_int8,
                  phase_sampler_int8, phase_bn_sums, phase_sampler_f32, phase_glow_sampler,
                  phase_int8_mid_kernels, lambda torch, dev: probe_results,
                  lambda torch, dev: new_probes):
        out = phase(torch, dev)
        for r in (out if isinstance(out, list) else [out]):
            results.append(r)
            err = (f"max-abs error {r['max_abs_err']:.6g}, {r['err_share']:.3g} of the "
                   f"channel's sum of |values| (tol {r['tol']:.3g})" if "err_share" in r
                   else f"max-abs error {r['max_abs_err']:.6g} (tol {r['tol']:.6g})")
            print(f"kernel {r['name']}: {err}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
                  f"median [min, max] of {RUNS} windows of >= "
                  f"{r.get('window_s', KERNEL_WINDOW_S)} s [{card}]:", flush=True)
            for key in TIMES:
                t = r[key]
                print(f"  {key}: {t['median']:.4f} [{t['min']:.4f}, {t['max']:.4f}]", flush=True)
            if "library_ms" in r:
                print(f"  library ({r['library']}): {r['library_ms']:.4f}", flush=True)
            for key in ("other_shape", "smpl_shape"):
                if key in r:
                    print(f"  at {r[key]['shape']}: {json.dumps(r[key])}", flush=True)
            for key in ("library_graph_ms", "library_stage_graph_ms", "stem_kernel_graph_ms",
                        "stage1_kernel_graph_ms"):
                if key in r:
                    print(f"  {key}: {r[key]:.4f}", flush=True)
            for side in r.get("other_shapes", []):
                print(f"  at {side['shape']}{' ' + side['phase'] if 'phase' in side else ''}: "
                      f"{json.dumps(side)}", flush=True)
            for side in r.get("prohmr_shapes", []):
                print(f"  at {side['shape']} (ProHMR): {json.dumps(side)}", flush=True)

    launches, agree, http_ms, timing = phase_slice(torch, dev)
    for b, t in timing.items():
        ms = t["ms_per_request"]
        print(f"slice {b}: median {ms['median']:.3f} ms/request [{ms['min']:.3f}, "
              f"{ms['max']:.3f}] over {t['requests']} requests in {RUNS} windows, "
              f"{t['hypotheses_per_s']:.1f} hypotheses/s [{card}]", flush=True)
    int8_launches, int8_timing, int8_diff = phase_int8_serving(torch, dev)
    ms = int8_timing["ms_per_request"]
    print(f"int8 b{BATCH}: median {ms['median']:.3f} ms/request [{ms['min']:.3f}, "
          f"{ms['max']:.3f}] over {int8_timing['requests']} requests, "
          f"{int8_timing['hypotheses_per_s']:.1f} hypotheses/s [{card}]", flush=True)
    evals = phase_eval(torch, dev)
    for label, e in evals.items():
        ms = e["ms_per_batch"]
        summ = e["summary"]
        print(f"eval {label}: eucLoss_3d_rgb_sample {summ['eucLoss_3d_rgb_sample']:.6g}, "
              f"eucLoss_2d_rgb_sample {summ['eucLoss_2d_rgb_sample']:.6g}, loss_total "
              f"{summ['loss_total']:.6g}; median {ms['median']:.3f} ms/batch of {EVAL_BATCH} "
              f"[{ms['min']:.3f}, {ms['max']:.3f}] over {e['batches']} batches, "
              f"{e['hypotheses_per_s']:.1f} hypotheses/s [{card}]", flush=True)
        if "ms_per_batch_plain_kld_draw" in e:
            old = e["ms_per_batch_plain_kld_draw"]
            print(f"eval {label}, reverse-KL draw on the plain f32 flow (the routing before "
                  f"the f32 kernel), same windows alternating: median {old['median']:.3f} "
                  f"ms/batch [{old['min']:.3f}, {old['max']:.3f}] [{card}]", flush=True)
    opt_in = phase_int8_opt_in(torch, dev)
    exported = phase_export(torch, dev)
    bench_q = phase_bench_quant(torch, dev)
    for side, t in bench_q.items():
        print(f"bench_quant {side}: median {t['ms_per_step']:.3f} ms/step of B={BENCH_QUANT[0]}, "
              f"N={BENCH_QUANT[1]} [{t['ms_min_max'][0]:.3f}, {t['ms_min_max'][1]:.3f}] over "
              f"{RUNS} windows of {BENCH_QUANT_STEPS} steps, {t['hypotheses_per_s']:.1f} "
              f"hypotheses/s, {t['vs_bf16']:.4f} of bf16 [{card}]", flush=True)
        if "trace" in t:
            print(f"bench_quant {side} trace: {json.dumps(t['trace'])}", flush=True)
    verts_launches, verts_err = phase_verts(torch, dev)
    humans = phase_prohmr(torch, dev)
    for variant, t in humans["bench"].items():
        print(f"prohmr {variant}: median {t['ms_per_step']:.3f} ms/step of B={PROHMR_BENCH[0]}, "
              f"N={PROHMR_BENCH[1]} [{t['ms_min_max'][0]:.3f}, {t['ms_min_max'][1]:.3f}] over "
              f"{RUNS} windows of >= {SLICE_WINDOW_S} s, {t['hypotheses_per_s']:.1f} "
              f"hypotheses/s [{card}]", flush=True)
    print(f"prohmr: peak memory {humans['peak_memory_gb']:.2f} GB; trace of the kernel step "
          f"{json.dumps(humans['trace'])}", flush=True)
    train = phase_train(torch, dev)
    for variant, t in train["ms_per_step"].items():
        print(f"train step {variant}: median {t['median']:.3f} ms/step of B={TRAIN_BATCH} "
              f"[{t['min']:.3f}, {t['max']:.3f}] over {RUNS} windows of >= {STEP_WINDOW_S} s "
              f"[{card}]", flush=True)
    print(f"train trace (kernels, stats): {json.dumps(train['trace'])}; peak memory "
          f"{train['peak_memory_gb']:.2f} GB; dy copies per full step "
          f"{train['full']['dy_copies']}", flush=True)
    rle_res = phase_rle(torch, dev)
    det_res = phase_det(torch, dev)
    glow_res = phase_glow(torch, dev)
    glow_line = next(r for r in results if r["name"] == "glow_sampler")
    glow_line.setdefault("other_shapes", []).append(side_line(glow_res["kernel"]))
    for label, t in (("glow train step", glow_res["train_step"]["ms_per_step"]),
                     ("glow eval batch", glow_res["eval_batch"]["ms_per_batch"])):
        print(f"{label}: " + "; ".join(
            f"{k} median {v['median']:.3f} ms [{v['min']:.3f}, {v['max']:.3f}]"
            for k, v in t.items()) + f" over {RUNS} windows of >= {GLOW_WINDOW_S} s [{card}]",
            flush=True)
    k = glow_res["kernel"]
    print(f"glow kernel at {k['shape']}: graph {k['graph_ms']['median']:.4f} ms, eager "
          f"{k['ms']['median']:.4f}, plain graph {k['plain_graph_ms']['median']:.4f}, bound "
          f"{k['bound_ms']:.4f} ({k['bound_by']}), torch.matmul on one hidden product "
          f"{k['library_stage_graph_ms']:.4f} [{card}]", flush=True)
    d = glow_res["demo"]
    print(f"demo: BH-MPJPE {d['bh_mpjpe_mm_before']:.2f} -> {d['bh_mpjpe_mm_after']:.2f} mm, "
          f"int8 delta {d['int8_delta_mm']:+.3f} mm, int8+sampler delta "
          f"{d['int8_sampler_delta_mm']:+.3f} mm [{card}]", flush=True)
    for label, t in (("rle train step", rle_res["ms_per_train_step"]),
                     ("rle eval batch", rle_res["ms_per_eval_batch"]),
                     ("det sample_hypotheses", det_res["sample"]["ms_per_call"]),
                     ("det train step", det_res["train_step"]["ms_per_step"])):
        print(f"{label}: " + "; ".join(
            f"{k} median {v['median']:.3f} ms [{v['min']:.3f}, {v['max']:.3f}]"
            for k, v in t.items()) + f" over {RUNS} windows of >= {RLE_WINDOW_S} s [{card}]",
            flush=True)
    bench_line = phase_bench(torch, dev)
    print(f"bench: {bench_line['value']:.1f} hypotheses/s at N=100, B=32, mfu "
          f"{bench_line['mfu']:.4f}, skipped {bench_line['skipped']} [{card}]", flush=True)
    loaders = phase_loaders(torch, dev)
    print(f"loaders: ran {sorted(loaders['runs'])}, not run {loaders['not_run']} [{card}]",
          flush=True)
    mask = phase_mask(torch, dev)
    for label, t in mask["render"]["ms"].items():
        print(f"render ({label}) at {mask['render']['rows']} rows: {t['ms']:.3f} ms eager, "
              f"{t['graph_ms']:.3f} graph, bound {t['bound_ms']:.3f} ({t['bound_by']}) [{card}]",
              flush=True)
    print(f"render: {mask['render']['render_gb']:.2f} GB at {mask['render']['rows']} rows, "
          f"{mask['render']['train_render_gb']:.3f} GB forward and backward at "
          f"{mask['render']['train_rows']} ({mask['render']['train_ms_fwd_bwd']:.3f} ms) [{card}]",
          flush=True)
    t = mask["train_step"]["ms_per_step"]
    print("mask train step: " + "; ".join(
        f"{k} median {v['median']:.3f} ms [{v['min']:.3f}, {v['max']:.3f}]" for k, v in t.items())
        + f" over {RUNS} windows of >= {MASK_WINDOW_S} s [{card}]", flush=True)
    parallel = phase_parallel(torch, dev)
    released = phase_released(torch, dev)

    path_launches = {"stem": launches, "stage1": launches, "realnvp_sampler": launches,
                     "lbs_blend": verts_launches, "stage1_int8": int8_launches[f"b{BATCH}"],
                     "realnvp_sampler_int8": int8_launches[f"b{BATCH}"],
                     "bn_stats_sums": train["false"]["launches"],
                     "realnvp_sampler_f32": train["false"]["launches"],
                     "bn_grad_sums": train["full"]["launches"],
                     "glow_sampler": humans["launches"],
                     "stem_int8": opt_in["q_from_0"]["launches"],
                     "stage2_int8": opt_in["q_from_0"]["launches"],
                     "int8_gemm_probe_s8": probe_launches,
                     "int8_gemm_probe_bf16": probe_launches,
                     **{k: new_probe_launches for k in ("stem_probe", "stem_cost_attrib",
                                                        "stage1_probe_a", "stage1_probe_b")}}
    # This slice's paths: each kernel's launches on each of them.
    slice_paths = {"rle_train_baseline": rle_res["launches"],
                   "rle_train_step": rle_res["steps"]["launches_per_step"],
                   "rle_eval_batch": rle_res["eval_batch"]["launches"],
                   "det_sample_hypotheses": det_res["sample"]["launches"],
                   "det_train_step": det_res["train_step"]["launches"],
                   "glow_train_step": glow_res["train_step"]["launches"],
                   "glow_eval_batch": glow_res["eval_batch"]["launches"],
                   "prohmr_nll_loss": glow_res["prohmr_nll"]["launches"],
                   **{f"loader_{k}_train_baseline": r["launches"]
                      for k, r in loaders["runs"].items()},
                   "loader_train_step": loaders["kernels_vs_plain"]["launches_per_step"],
                   **{f"export_{k}": r["launches"] for k, r in exported["variants"].items()},
                   "render": mask["render"]["launches"],
                   "mask_train": mask["train_step"]["launches_per_step"],
                   "mask_eval": mask["eval_batch"]["launches"],
                   **{f"mask_{k}_train_baseline": r["launches"] for k, r in mask["runs"].items()},
                   "parallel_train_step_a_rank": parallel["train"]["bf16"]["launches_per_rank"],
                   "parallel_eval_batch_a_rank": parallel["eval"]["hypo"]["launches_per_rank"],
                   "released_eval": released["launches"]}
    kernels = [{"name": r["name"], "route": "cuda", "source": r["source"],
                "replaces": r["replaces"], "launches": path_launches[r["name"]][r["name"]],
                "launches_by_path": {p: c[r["name"]] for p, c in slice_paths.items()
                                     if c[r["name"]]},
                "max_abs_err": r["max_abs_err"],
                **{key: r[key]["median"] for key in TIMES},
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms", r["plain_ms"]["median"]
                                    if r["library"] == "plain" else None),
                **{k: r[k] for k in ("tol", "max_abs_err_x", "max_abs_err_logdet",
                                     "mean_abs_err_x", "mean_abs_err_logdet", "tol_logdet",
                                     "tol_mean", "bf16_exact_share", "err_share", "grad_rel_err",
                                     "other_shape", "smpl_shape", "prohmr_shapes", "trace",
                                     "other_shapes", "bf16_stem_graph_ms", "library_graph_ms",
                                     "library_stage_graph_ms",
                                     "library_max_abs_diff", "ratio_bf16_over_s8_graph",
                                     "library", "stem_kernel_graph_ms", "stage1_kernel_graph_ms",
                                     "phase", "conv_rows", "plan", "bound_ops_type")
                   if k in r},
                **{f"{key}_min_max": [r[key]["min"], r[key]["max"]] for key in TIMES}}
               for r in results]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"slice": {"timing": timing, "http_round_trip_ms": http_ms,
                                "kernel_vs_plain_max_abs": agree},
                      "int8_serving": {"launches": int8_launches, "timing": int8_timing,
                                       "int8_vs_float": int8_diff},
                      "int8_opt_in": opt_in, "export": exported, "bench_quant": bench_q,
                      "eval": evals, "verts": {"launches": verts_launches,
                                               "kernel_vs_plain_max_abs": verts_err},
                      "train": train, "prohmr": humans, "rle": rle_res, "det": det_res,
                      "glow": {k: v for k, v in glow_res.items() if k != "kernel"},
                      "bench": bench_line, "loaders": loaders, "mask": mask,
                      "parallel": parallel, "released": released}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
