"""MHEnt, the probabilistic hand model: the multi-hypothesis inference path.

Port of mhentropy_tpu/models/mhent.py: `MHEntConfig` :48, `make_priors`
:102, `init` :118, `det_head_apply` :149, `extract_feat` :155, `combine_z`
:166, the realnvp branches of `sample_q_z` :181 (the int8 `flow_q` draw
and the plain `differentiable` one included), `decode` :339,
`forward_log_p` :384, `reverse_kld` :446 (the training objective and the
eval step's log p, with the entropy term and the chamfer branch) and
`sample_hypotheses` :496 (with `quant=` and the top-N_quant filter :540),
the det regressor (`det_dims` :94, no flow, `combine_z`'s det branch, zero
log q in `sample_q_z` :221), `log_q_z` :327, `kld_weight` :566,
`sample_p_z` :573, `evidence_from_target` :598 and `set_evidences` :613,
the mask / depth mods of `decode` :375-380 and the mask likelihood of
`forward_log_p` :416-437 (core/render.py), and the glow regressor (`init`
:125-134, `sample_q_z` :293-321, `log_q_z` :332-335): a ConditionalGlow
over theta45, whose eval draw on the card runs the Glow sampler kernel and
whose reverse-KL draw runs the plain Glow in train mode, with the coupling
nets' dropout.

The module's parameter names are the reference's `encoderRGB` state_dict:
`feat_extractor.res.*`, `feat_extractor.l1.0.*`, `q_z_giv_i.*`,
`det_head.0.*` / `det_head.2.*`. torch cannot replay jax.random, so the flow's
base noise is drawn from an explicit `torch.Generator` or passed in.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from mhentropy_tpu_torch.core import camera, mano, render, skeletons
from mhentropy_tpu_torch.core.mano import ManoConfig, ManoModel
from mhentropy_tpu_torch.flows import (cuda_glow_sampler, cuda_sampler, cuda_sampler_int8, glow,
                                       priors, realnvp)
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import quant as quant_mod
from mhentropy_tpu_torch.models.encoder import Encoder, EncoderConfig, init_weights_
from mhentropy_tpu_torch.parallel import pipeline as pipe_lib
from mhentropy_tpu_torch.parallel import sharded
from mhentropy_tpu_torch.train import metrics as metrics_lib

# z layout (network.py:367-373 of the reference).
ZDIMS = (("th3", 3), ("th45", 45), ("bt", 10), ("logs", 1), ("t", 2))
Z_TOTAL = 61
TH_BT = 58  # theta(48) ++ beta(10)


class MHEntConfig(NamedTuple):
    encoder: EncoderConfig = EncoderConfig()
    flow: RealNVPConfig = RealNVPConfig(dim=45, cond_dim=512, h_dim=512, num_steps=6)
    mano: ManoConfig = ManoConfig(use_pca=True, ncomps=45, flat_hand_mean=False)
    regressor: str = "realnvp"
    ds: str = "ho3d"
    image_size: int = 256
    feat_dim: int = 512  # conditioning feature dim (the mu head)
    b_2d: float = 0.03  # Laplace scale for p(uv | z)
    b_3d: float = 0.03  # Laplace scale for p(xyz | z)
    th45_ref_alpha: float = 50.0
    th3_ref_alpha: float = 5.0
    bt_alpha: float = 50.0
    temperature: float = 1.0  # T in log_p / T
    entropy: bool = True
    kld_w: float = 1.0
    kld_w_annealing: tuple = (1.0, 24000)
    n_train_hypotheses: int = 10
    # The glow regressor's ConditionalGlow(45, glow_hidden, glow_layers,
    # glow_blocks, context=feat_dim) and its coupling nets' dropout.
    glow_dropout: float = 0.2
    glow_hidden: int = 512
    glow_layers: int = 4
    glow_blocks: int = 2
    use_chamfer_loss: bool = False
    w_chamfer: float = 10.0
    # The mask likelihood p(m | z): the rendered silhouette against the
    # target's hand mask, a Laplace of scale b_mask per pixel.
    use_mask_loss: bool = False
    b_mask: float = 0.02

    def det_dims(self) -> int:
        """The det head's width: theta3, beta, log s and t, and theta45 too
        for the det regressor."""
        return 3 + 10 + 1 + 2 + (45 if self.regressor == "det" else 0)


class MHEnt(nn.Module):
    def __init__(self, cfg: MHEntConfig):
        super().__init__()
        if cfg.regressor not in ("realnvp", "glow", "det"):
            raise ValueError(f"regressor {cfg.regressor!r}: expected realnvp, glow or det")
        self.cfg = cfg
        self.feat_extractor = Encoder(cfg.encoder)
        # The posterior over theta45; the det regressor has none (its det
        # head regresses theta45 too).
        if cfg.regressor == "realnvp":
            self.q_z_giv_i = realnvp.RealNVP(cfg.flow)
        elif cfg.regressor == "glow":
            self.q_z_giv_i = glow.ConditionalGlow(glow_config(cfg))
        else:
            self.q_z_giv_i = None
        f = cfg.feat_dim
        self.det_head = nn.Sequential(nn.Linear(f, f), nn.ReLU(), nn.Linear(f, cfg.det_dims()))
        self.kernels = True
        self.packed_flow = None  # the flow's weights for the fused sampler (prepare)

    def set_kernels(self, enabled: bool) -> None:
        """Route the float CUDA path through its kernels (stem, stage 1, the
        train-mode BN sums, the bf16 and f32 samplers or the Glow sampler;
        the default) or through their plain PyTorch versions, e.g. to
        compare the two. The int8 path routes by device alone, the LBS
        blend by device and caller (`decode(lbs_kernel=)`: the training
        objective's mesh takes the plain blend)."""
        self.feat_extractor.res.kernels = enabled
        self.kernels = enabled


def glow_config(cfg: MHEntConfig) -> glow.GlowConfig:
    """The glow regressor's flow: ConditionalGlow(45, 512, 4, 2, context
    512, dropout 0.2) at the defaults, the reference's shape."""
    return glow.GlowConfig(features=45, hidden=cfg.glow_hidden, num_layers=cfg.glow_layers,
                           num_blocks=cfg.glow_blocks, context_features=cfg.feat_dim,
                           dropout=cfg.glow_dropout)


@torch.no_grad()
def init(cfg: MHEntConfig, seed: int = 0) -> MHEnt:
    """Fresh weights from `seed`, with the JAX package's init distributions:
    lecun-normal convs, unit BN, torch-default linears, near-identity flow."""
    g = torch.Generator().manual_seed(seed)
    net = MHEnt(cfg)
    init_weights_(net, g)
    if net.q_z_giv_i is not None:
        net.q_z_giv_i.init_params(g)
    return net


def prepare(net: MHEnt, device, masters: bool = False) -> MHEnt:
    """Eval mode on `device`; the backbone in channels_last memory, the flow
    and heads in f32; the kernels' weights folded and packed from the
    module's. The backbone's parameters are cast to its compute dtype in
    place, unless `masters` keeps them f32 for training (each conv then
    casts its weight in the forward). Run it, or `refresh_kernel_weights`,
    again after changing weights."""
    net.eval().to(device)
    net.feat_extractor.res.place(getattr(torch, net.cfg.encoder.dtype), masters)
    return refresh_kernel_weights(net)


@torch.no_grad()
def refresh_kernel_weights(net: MHEnt) -> MHEnt:
    """Fold the stem's and stage 1's eval BN and pack the flow for the eval
    kernels (the RealNVP for the samplers, a Glow the Glow sampler takes
    for it; none for the det regressor), from the module's current
    weights (whole: a net stored split is gathered for it, collective)."""
    with sharded.whole(net):
        net.feat_extractor.res.fold_kernel_weights()
        flow = net.q_z_giv_i
        if isinstance(flow, realnvp.RealNVP):
            net.packed_flow = cuda_sampler.pack(flow)
        elif flow is not None and cuda_glow_sampler.structural_ok(flow.cfg):
            net.packed_flow = cuda_glow_sampler.pack(flow)
        else:
            net.packed_flow = None
    return net


def make_priors(cfg: MHEntConfig, device=None) -> dict:
    """The z-priors: smooth uniforms on theta45 (PCA +-2), theta3 (ball pi)
    and beta (+-0.03)."""
    out = {}
    if cfg.mano.use_pca:
        out["th45_ref"] = priors.ApproxUniform(-2.0, 2.0, alpha=cfg.th45_ref_alpha)
    else:
        out["th45_ref"] = priors.ApproxUniform(torch.zeros(45, device=device), math.pi,
                                               alpha=cfg.th45_ref_alpha, sup="ball")
    out["th3_ref"] = priors.ApproxUniform(torch.zeros(3, device=device), math.pi,
                                          alpha=cfg.th3_ref_alpha, sup="ball")
    out["bt"] = priors.ApproxUniform(-0.03, 0.03, alpha=cfg.bt_alpha)
    return out


def det_head_apply(net: MHEnt, feat: torch.Tensor) -> torch.Tensor:
    """The det head; inside `parallel.sharded.tensor_parallel` its first
    linear computes this rank's columns and the second their part of its
    product, summed over the 'model' line, on the blocks the rank stores."""
    ln = sharded.line()
    if ln is None:
        return net.det_head(feat)
    l0, l2 = net.det_head[0], net.det_head[2]
    h = torch.relu(F.linear(sharded.copy_to(feat, ln), l0.weight, l0.bias))
    return sharded.reduce_from(F.linear(h, l2.weight), ln) + l2.bias


def extract_feat(net: MHEnt, image: torch.Tensor, train: bool = False) -> torch.Tensor:
    """Conditioning feature = the encoder's mu head. train: batch-statistics
    BN that updates the running statistics in place; the encoder must be in
    that mode already (`net.train()` / `net.eval()`)."""
    if net.feat_extractor.training != train:
        raise ValueError(f"extract_feat(train={train}) on an encoder in "
                         f"{'train' if net.feat_extractor.training else 'eval'} mode: call "
                         f"net.{'train' if train else 'eval'}() first")
    mn, _ = net.feat_extractor(image)
    return mn


def combine_z(cfg: MHEntConfig, z_det: torch.Tensor, z_flow: torch.Tensor) -> torch.Tensor:
    """Interleave det-head dims and flow dims into the canonical z layout."""
    parts, p_det = [], 0
    for name, nd in ZDIMS:
        if name != "th45" or cfg.regressor == "det":
            parts.append(z_det[:, p_det:p_det + nd])
            p_det += nd
        else:
            parts.append(z_flow)
    return torch.cat(parts, dim=1)


def sample_q_z(net: MHEnt, feat: torch.Tensor, n: int, temp: float = 1.0,
               base_noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               differentiable: bool = False,
               flow_q: cuda_sampler_int8.FlowQTree | None = None,
               pipeline=None):
    """Draw n hypotheses per image from q(z | I).

    Rows are hypothesis-major (N blocks of B). base_noise: (n * B, 45), already
    times temp; drawn from `generator` when None. flow_q: the int8 sampler's
    tree; the draw then runs the W8A8 sampler (its kernel on the card).
    differentiable: the reverse-KL draw, gradients to the flow, feat and the
    noise; on the card it runs the f32 sampler kernel under autograd
    (`cuda_sampler.sample_fused_diff`), on the CPU the plain f32 flow. The
    JAX package's gates on its fused samplers (`use_pallas_sampler`,
    `pallas_min_rows`, off under grad) were set on the TPU; on the card the
    kernels always run, and `set_kernels(False)` is the A/B switch (PERF.md
    has the H100 A/B).

    The glow regressor: on the card with kernels on, a non-differentiable
    draw runs the Glow sampler kernel (`cuda_glow_sampler`), and raises
    for a flow the kernel does not take (`structural_ok`: two blocks, no
    BatchNorm); otherwise the plain Glow, in train mode when differentiable
    (the coupling nets' dropout at glow_dropout, its masks from
    `generator`), as JAX's draw.

    The det regressor draws nothing: its n rows repeat the det head's z,
    and log q is 0.

    pipeline: (mesh, n_micro): the realnvp draw runs the GPipe schedule over
    the mesh's 'pipe' axis (`parallel.pipeline.sample_pipelined`, the plain
    coupling math, differentiable), as JAX's `sample_q_z(pipeline=)`; it
    raises for another regressor and with flow_q. The kernels read whole
    weights, so inside `parallel.sharded.tensor_parallel` they run outside
    the split (`sharded.whole`) on the packed weights (whole: folded from
    gathered ones) and on conditioning caches gathered over the line; the
    f32 draw packs the transform's gathered weights, and its backward
    recomputes split on the blocks (`cuda_sampler.TransformDiff`).

    Returns z (n * B, 61) and log q (n * B,).
    """
    cfg = net.cfg
    b = feat.shape[0]
    flow = net.q_z_giv_i
    if pipeline is not None and cfg.regressor != "realnvp":
        raise NotImplementedError(f"pipeline parallelism covers the realnvp regressor; got "
                                  f"{cfg.regressor!r}")
    if pipeline is not None and flow_q is not None:
        raise NotImplementedError("pipeline= and flow_q= are mutually exclusive: the int8 "
                                  "fused eval draw is not pipelined")
    if flow is None:
        z_det = det_head_apply(net, feat).repeat(n, 1)
        return combine_z(cfg, z_det, None), feat.new_zeros(n * b)
    if base_noise is None:
        base_noise = torch.randn((n * b, cfg.flow.dim), generator=generator,
                                 device=feat.device) * temp
    fused = feat.is_cuda and net.kernels
    if isinstance(flow, glow.ConditionalGlow):
        if fused and not differentiable:
            if net.packed_flow is None:
                raise RuntimeError("the Glow sampler kernel needs the packed flow "
                                   "(mhent.prepare) and a flow it takes "
                                   f"({flow.cfg}); set_kernels(False) runs the plain flow")
            z_flow, log_q = cuda_glow_sampler.sample_and_log_prob_fused(
                flow, net.packed_flow, feat, n, base_noise)
        else:
            z_flow, log_q = glow.sample_and_log_prob(flow, feat, n, noise=base_noise,
                                                     generator=generator, train=differentiable)
    elif pipeline is not None:
        mesh, n_micro = pipeline
        z_flow, log_q = pipe_lib.sample_pipelined(flow, base_noise, feat, mesh, n_micro,
                                                  n_per_image=n, return_log_prob=True)
    elif flow_q is not None and not differentiable:
        with sharded.whole(flow):
            z_flow, log_q = cuda_sampler_int8.sample_fused_q(flow, flow_q, feat, n, base_noise)
    elif fused and differentiable:
        z_flow, log_q = cuda_sampler.sample_fused_diff(flow, feat, n, base_noise)
    elif fused:
        if net.packed_flow is None:
            raise RuntimeError("the fused sampler needs the packed flow; run mhent.prepare")
        z_flow, log_q = cuda_sampler.sample_fused(flow, net.packed_flow, feat, n, base_noise)
    else:
        cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
        z_flow, log_q = realnvp.sample(flow, base_noise, cproj=cproj.repeat(1, 1, n, 1))
    z_det = det_head_apply(net, feat).repeat(n, 1)
    return combine_z(cfg, z_det, z_flow), log_q


def log_q_z(net: MHEnt, z: torch.Tensor, feat_rows: torch.Tensor) -> torch.Tensor:
    """log q of the flow block (theta45) of z rows (R, 61), conditioned on
    the (R, C) feature rows (the Glow in eval mode); zeros for the det
    regressor."""
    flow = net.q_z_giv_i
    if flow is None:
        return z.new_zeros(z.shape[0])
    if isinstance(flow, glow.ConditionalGlow):
        return glow.log_prob(flow, z[:, 3:48], feat_rows)
    return realnvp.log_prob(flow, z[:, 3:48], feat=feat_rows)


def decode(model: ManoModel, cfg: MHEntConfig, th_bt: torch.Tensor, logs_t: torch.Tensor,
           mods=("uv",), inv_norm: bool = False,
           fold: mano.KeypointFold | None = None, lbs_kernel: bool = True) -> dict:
    """MANO decode + normalisation + orthographic projection.

    th_bt (R, 58), logs_t (R, 3) -> xyz (R, K, 3) normalised-relative,
    bone (R,), uv (R, K, 2) if requested, verts (R, 778, 3) if requested or
    rendered, and the rendered mask / depth (R, 64, 64) for the "m" /
    "depth" mods. lbs_kernel: the mesh's blend through the `lbs_blend`
    operator, or the plain einsums that autograd differentiates (JAX's
    `pallas_lbs`; mano.mano_decode).
    """
    rendered = "m" in mods or "depth" in mods
    with_mesh = rendered or "verts" in mods
    theta, beta = th_bt[:, :48], th_bt[:, -10:]
    out = mano.mano_decode(model, theta, beta, skeidx="RHD", fold=fold, with_mesh=with_mesh,
                           lbs_kernel=lbs_kernel)
    normed, root, bone = camera.batch_normalize_pose3d(
        out["mano_joints"], skeletons.ROOT_IDX[cfg.ds],
        norm_idx=skeletons.NORM_IDX[cfg.ds], return_st=True)
    result = {"xyz": normed, "bone": bone}
    if with_mesh:
        result["verts"] = (out["mesh"] - root) / bone[:, None, None]
    if "uv" in mods:
        scale = torch.exp(logs_t[:, 0:1])
        result["uv"] = camera.orth_project(normed, scale, logs_t[:, 1:3], cfg.image_size,
                                           inv_norm=inv_norm)
    if rendered:
        result.update(render.render_mods(result["verts"], logs_t, mods=mods))
    return result


def forward_log_p(model: ManoModel, cfg: MHEntConfig, z: torch.Tensor, y: dict,
                  mods=("uv",), fold: mano.KeypointFold | None = None) -> dict:
    """log p(y | z) + log p~(z) per row: the Laplace-with-deadzone
    reprojection likelihoods on visible keypoints, with cfg.use_mask_loss
    the mask likelihood, and the three z-priors, over the temperature.

    z: (N * B, 61) hypothesis-major rows; y: crop_uv (B, 42), pose3d (B, 63),
    vis (B, 21), and for the mask likelihood hand_mask (HO3D's spelling,
    at the crop's side) or mask (RHD's, 64 x 64), (B, S', S'); without
    either the term is absent. The mesh is decoded through the plain blend,
    as JAX's training decode does: the term is differentiated.
    """
    pr = make_priors(cfg, z.device)
    mask_key = "hand_mask" if "hand_mask" in y else ("mask" if "mask" in y else None)
    with_mask = cfg.use_mask_loss and mask_key is not None
    logs_t = z[:, -3:]
    dec = decode(model, cfg, z[:, :TH_BT], logs_t,
                 mods=tuple(mods) + (("verts",) if with_mask else ()), inv_norm=False, fold=fold,
                 lbs_kernel=False)
    b = y["crop_uv"].shape[0]
    n = z.shape[0] // b
    out = {}
    for mod, gt_key, d, b_scale in (("uv", "crop_uv", 2, cfg.b_2d),
                                    ("xyz", "pose3d", 3, cfg.b_3d)):
        if mod not in mods:
            continue
        mu = dec[mod].reshape(z.shape[0], -1)
        weights = y["vis"].repeat(n, 1).repeat_interleave(d, dim=1)
        out[f"log_p_{mod}_giv_z"] = priors.laplace_deadzone_log_prob(
            y[gt_key].repeat(n, 1), mu, b_scale, weights=weights)
    if with_mask:
        mask = render.render_mods(dec["verts"], logs_t, mods=("m",))["mask"]
        gt = y[mask_key].to(mask.dtype)
        s = mask.shape[-1]
        if gt.shape[-1] != s:
            # The crop-resolution mask, max-pooled onto the render grid.
            f = gt.shape[-1] // s
            gt = gt.reshape(b, s, f, s, f).amax((2, 4))
        err = (mask - gt.repeat(n, 1, 1)).reshape(z.shape[0], -1)
        out["log_p_m_giv_z"] = priors.laplace_deadzone_log_prob(
            err, torch.zeros_like(err), cfg.b_mask) / err.shape[1]
    out["log_p_th3"] = pr["th3_ref"].log_prob(z[:, :3])
    out["log_p_th45"] = pr["th45_ref"].log_prob(z[:, 3:48])
    out["log_p_bt"] = pr["bt"].log_prob(z[:, 48:58])
    out["log_p"] = sum(v for k, v in out.items() if k != "log_p") / cfg.temperature
    return out


def reverse_kld(model: ManoModel, net: MHEnt, y: dict, image: torch.Tensor,
                base_noise: torch.Tensor | None = None, train: bool = False, mods=("uv",),
                generator: torch.Generator | None = None,
                fold: mano.KeypointFold | None = None,
                feat: torch.Tensor | None = None, pipeline=None) -> dict:
    """-KL(q(z|I) || p(y|z) p~(z)) up to a constant, per image: the
    training objective and the eval step's log p. base_noise:
    (n_train_hypotheses * B, 45) standard normal (temperature 1), drawn from
    `generator` when None; the glow regressor's dropout masks come from
    `generator` too. train: batch-statistics BN (the net in train mode, its
    running statistics updated in place); differentiate the result under
    autograd for the training step. feat: the conditioning feature
    `extract_feat(net, image, train)` already computed (the eval step
    shares one encoder pass with `sample_hypotheses`). pipeline: (mesh,
    n_micro), the draw through the GPipe schedule (`sample_q_z`)."""
    cfg = net.cfg
    if feat is None:
        feat = extract_feat(net, image, train=train)
    n, b = cfg.n_train_hypotheses, feat.shape[0]
    # Always the differentiable draw, in the eval step too, as JAX's
    # reverse_kld (mhentropy_tpu/models/mhent.py:464-465): for the glow
    # regressor that is the Glow in train mode, with its coupling nets'
    # dropout (:314-321), whatever `train` says.
    z, log_q = sample_q_z(net, feat, n, temp=1.0, base_noise=base_noise, generator=generator,
                          differentiable=True, pipeline=pipeline)
    th_bt = z[:, :TH_BT]
    out = {"th_norm": torch.linalg.norm(th_bt[:, :48], dim=1),
           "bt_norm": torch.linalg.norm(th_bt[:, -10:], dim=1)}
    flp = forward_log_p(model, cfg, z, y, mods=mods, fold=fold)
    log_p = out["q_log_p_z_giv_y"] = flp["log_p"].reshape(n, b).mean(0)
    if cfg.entropy:
        h = out["h_q_z_giv_i"] = (-log_q).reshape(n, b).mean(0)
        log_p = log_p + h
    if cfg.use_chamfer_loss:
        dec = decode(model, cfg, th_bt, z[:, -3:], mods=(), fold=fold)
        chamfer = out["chamfer"] = metrics_lib.chamfer_dist(
            dec["xyz"].reshape(n, b, -1, 3), y).mean(0)
        log_p = log_p - cfg.w_chamfer * chamfer
    out["log_p"] = log_p
    return out


def sample_hypotheses(model: ManoModel, net: MHEnt, image: torch.Tensor, n: int = 200,
                      n_quant: int | None = None, temp: float = 0.8,
                      mods=("xyz", "uv", "verts"),
                      base_noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      fold: mano.KeypointFold | None = None, quant=None,
                      feat: torch.Tensor | None = None, keep_log_q: bool = False) -> dict:
    """Multi-hypothesis inference on a (B, H, W, 3) NHWC image batch.

    quant: optional (QuantSpec, qtree) of models/quant.py: the conditioning
    feature comes from the int8 encoder, and with spec.int8_sampler the
    draw runs the int8 sampler on qtree["flow"]. feat: the float feature
    `extract_feat(net, image)` already computed; not with quant.
    keep_log_q: also return each kept hypothesis's log q (N', B).

    Returns th_bt / logs_t (N', B, .), xyz (N', B, 63), uv (N', B, 42) in
    pixels, verts (N', B, 2334) and faces, for the requested mods.
    """
    cfg = net.cfg
    flow_q = None
    if quant is not None:
        if feat is not None:
            raise ValueError("sample_hypotheses: feat is the float feature; with quant the "
                             "int8 encoder computes its own")
        spec, qtree = quant
        with sharded.whole(net.feat_extractor):
            feat = quant_mod.encoder_feat(spec, qtree, net.feat_extractor, image)
        if spec.int8_sampler:
            flow_q = qtree.get("flow")
            if flow_q is None:
                raise ValueError("QuantSpec.int8_sampler is set but the qtree carries no 'flow' "
                                 "tree: calibrate one with quant.quantize_sampler_into")
    elif feat is None:
        feat = extract_feat(net, image)
    b = image.shape[0]
    z, log_q = sample_q_z(net, feat, n, temp=temp, base_noise=base_noise, generator=generator,
                          flow_q=flow_q)
    z = z.reshape(n, b, Z_TOTAL)
    if n_quant is not None and n_quant < n:
        # Keep the n_quant most likely hypotheses per image.
        idx = torch.topk(log_q.reshape(n, b).T, n_quant).indices  # (B, Q)
        z = torch.take_along_dim(z, idx.T[:, :, None], dim=0)
        log_q = torch.take_along_dim(log_q.reshape(n, b), idx.T, dim=0)
        n = n_quant
    out = {"th_bt": z[..., :TH_BT], "logs_t": z[..., -3:]}
    if keep_log_q:
        out["log_q"] = log_q.reshape(n, b)
    rows = z.reshape(n * b, Z_TOTAL)
    dec = decode(model, cfg, rows[:, :TH_BT], rows[:, -3:], mods=mods, inv_norm=True,
                 fold=fold)
    for mod in ("verts", "xyz", "uv"):
        if mod in mods:
            out[mod] = dec[mod].reshape(n, b, -1)
    if "verts" in mods:
        out["faces"] = model.faces
    return out


def kld_weight(cfg: MHEntConfig, step) -> torch.Tensor:
    """Linear KLD-weight annealing from kld_w_annealing[0] to kld_w over
    kld_w_annealing[1] steps."""
    w0, steps = cfg.kld_w_annealing
    frac = torch.clamp(torch.as_tensor(step, dtype=torch.float32) / steps, max=1.0)
    return w0 + (cfg.kld_w - w0) * frac


def sample_p_z(cfg: MHEntConfig, n: int, b: int, generator: torch.Generator | None = None,
               device=None, draws: dict | None = None, **means) -> torch.Tensor:
    """Ancestral draw of (n * B, 61) z rows from the z-priors: each block
    from its prior when there is one (the theta3 ball, the theta45 box or
    ball, the beta box), else N(0, 1); a `<name>_mean` array instead
    perturbs that mean by 0.3 x its batch std (ddof 0) times N(0, 1).

    draws: {block name: {"u": uniforms, "normal": standard normals}}, the
    standard draws of a block (a ball prior takes both, a box prior "u",
    the others "normal"); a block without them draws from `generator`.
    """
    pr = make_priors(cfg, device)
    rows = n * b
    draws = draws or {}
    parts = []
    for name, nd in ZDIMS:
        d = draws.get(name, {})
        if f"{name}_mean" in means:
            mean = means[f"{name}_mean"]
            eps = d.get("normal")
            if eps is None:
                eps = torch.randn(mean.shape, generator=generator, device=mean.device)
            parts.append(mean + eps * mean.std(0, correction=0) * 0.3)
        elif f"{name}_ref" in pr or name in pr:
            sampler = pr.get(f"{name}_ref", pr.get(name))
            shape = (rows,) if sampler.sup == "ball" else (rows, nd)
            parts.append(sampler.sample(shape, generator, device, **d).reshape(rows, nd))
        else:
            eps = d.get("normal")
            if eps is None:
                eps = torch.randn((rows, nd), generator=generator, device=device)
            parts.append(eps)
    return torch.cat(parts, dim=1)


def evidence_from_target(y: dict, use_gt, n: int) -> dict:
    """GT evidence blocks of (n * B,) rows for ancestral conditioning: 'bt'
    zeros, 'logs' and 't' from the fitted orthographic camera y["st"]."""
    ev = {}
    st = y["st"].repeat(n, 1)
    if "bt" in use_gt:
        ev["bt"] = st.new_zeros((st.shape[0], 10))
    if "logs" in use_gt:
        ev["logs"] = torch.log(st[:, 0:1])
    if "t" in use_gt:
        ev["t"] = st[:, 1:3]
    return ev


def set_evidences(z: torch.Tensor, evidences: dict | None) -> torch.Tensor:
    """z with its beta, log s and t blocks replaced by the given evidence (a
    new tensor)."""
    if not evidences:
        return z
    z = z.clone()
    for name, (lo, hi) in (("bt", (48, 58)), ("logs", (58, 59)), ("t", (59, 61))):
        if name in evidences:
            z[:, lo:hi] = evidences[name]
    return z
