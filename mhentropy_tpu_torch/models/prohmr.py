"""ProHMR, the Humans variant: a conditional Glow over the SMPL pose.

Port of mhentropy_tpu/models/prohmr.py, eval mode: `ProHMRConfig` :36,
`init` :56, `_context_from_feats` :77, `context_features` :89, `heads` :98,
`sample_hypotheses` :174 (with `quant=`) and `multi_hypothesis_metrics`
:247. A resnet50 feature conditions a ConditionalGlow over the 144-dim 6D
rotations of SMPL's 24 joints; linear heads give betas and a
weak-perspective camera; every hypothesis decodes through SMPL and projects
its joints. Training (`nll_loss` :109 with the flow's DDI, BN statistics
and dropout) is not ported yet (ROADMAP queue 1, item 9).

The module's parameter names: `encoder.res.*` (torchvision names),
`encoder.l1.0.*` / `encoder.l2.0.*` (the unused 1-wide mu / sigma heads
of the JAX init), `flow._transform._transforms.*` (the nflows fork's
ConditionalGlow, as a released ProHMR checkpoint stores it under `flow.`),
`betas_head.*`, `cam_head.*`. torch cannot replay jax.random, so the
flow's base noise is passed in or drawn from an explicit
`torch.Generator`.

On the card the backbone runs the stem and stage-1 kernels, the flow the
Glow sampler kernel (flows/cuda_glow_sampler.py) and the SMPL decode the
LBS blend kernel; `set_kernels(False)` routes the first three through their
plain versions (the blend routes by device alone, as for MANO).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from mhentropy_tpu_torch.core import camera
from mhentropy_tpu_torch.core import smpl as smpl_lib
from mhentropy_tpu_torch.flows import cuda_glow_sampler, glow
from mhentropy_tpu_torch.flows.glow import GlowConfig
from mhentropy_tpu_torch.models import quant as quant_mod
from mhentropy_tpu_torch.models.encoder import (Encoder, EncoderConfig, backbone_features,
                                                init_weights_)

POSE_DIM = 24 * 6  # 6D rotations


class ProHMRConfig(NamedTuple):
    # n_latent=(1, 1): the mu / sigma heads are unused; the flow conditions
    # on the raw pooled backbone feature.
    encoder: EncoderConfig = EncoderConfig(backbone="resnet50", n_latent=(1, 1),
                                           sigma_act="exp")
    flow: GlowConfig = GlowConfig(features=POSE_DIM, hidden=1024, num_layers=4,
                                  num_blocks=2, context_features=2048)
    image_size: int = 224


class ProHMR(nn.Module):
    def __init__(self, cfg: ProHMRConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg.encoder)
        self.flow = glow.ConditionalGlow(cfg.flow)
        c = cfg.flow.context_features
        self.betas_head = nn.Linear(c, 10)
        self.cam_head = nn.Linear(c, 3)
        self.kernels = True
        self.packed_flow = None  # the flow's weights for the Glow sampler (prepare)

    def set_kernels(self, enabled: bool) -> None:
        """Route the CUDA path through its kernels (stem, stage 1, the Glow
        sampler; the default) or through their plain PyTorch versions, e.g.
        to compare the two. The LBS blend and the int8 path route by device
        alone."""
        self.encoder.res.kernels = enabled
        self.kernels = enabled


@torch.no_grad()
def init(cfg: ProHMRConfig, seed: int = 0) -> ProHMR:
    """Fresh weights from `seed`, with the JAX package's init distributions:
    lecun-normal convs, unit BN, torch-default encoder heads, the Glow's own
    init (flows/glow.py) and N(0, 1e-2) betas / cam heads with zero bias."""
    g = torch.Generator().manual_seed(seed)
    net = ProHMR(cfg)
    init_weights_(net.encoder, g)
    net.flow.init_params(g)
    for head in (net.betas_head, net.cam_head):
        head.weight.normal_(0.0, 1e-2, generator=g)
        head.bias.zero_()
    return net


def prepare(net: ProHMR, device) -> ProHMR:
    """Eval mode on `device`: the backbone in its compute dtype and
    channels_last memory, the flow and heads in f32, the stem's and stage
    1's eval BN folded and the flow packed for the kernels. Run it again
    after changing weights."""
    net.eval().to(device)
    net.encoder.res.to(dtype=getattr(torch, net.cfg.encoder.dtype),
                       memory_format=torch.channels_last)
    net.encoder.res.fold_kernel_weights()
    net.packed_flow = (cuda_glow_sampler.pack(net.flow)
                       if cuda_glow_sampler.structural_ok(net.cfg.flow) else None)
    return net


def _context_from_feats(net: ProHMR, feats: torch.Tensor) -> torch.Tensor:
    """At the ProHMR geometry (pooled width == the flow's context width) the
    raw backbone feature is the context; a narrower test geometry projects
    it through the l1 head."""
    if feats.shape[-1] == net.cfg.flow.context_features:
        return feats
    return net.encoder.l1(feats)


def context_features(net: ProHMR, image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC image -> the flow context (B, C), eval BN."""
    if net.encoder.training:
        raise NotImplementedError("train-mode ProHMR is not ported yet (ROADMAP queue 1, "
                                  "item 9); call net.eval()")
    return _context_from_feats(net, backbone_features(net.encoder, image))


def heads(net: ProHMR, feat: torch.Tensor):
    """betas (B, 10) and the camera (B, 3): log-scale, then the 2D shift."""
    return net.betas_head(feat), net.cam_head(feat)


def sample_hypotheses(model: smpl_lib.SmplModel, net: ProHMR, image: torch.Tensor,
                      n: int = 100, temp: float = 1.0, noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None, quant=None) -> dict:
    """N SMPL hypotheses per image: flow sample -> 6D -> rotation matrices ->
    LBS -> weak-perspective projection of the 24 joints.

    noise: (n * B, 144) hypothesis-major base noise, already times temp;
    drawn from `generator` when None. quant: optional (QuantSpec, qtree) of
    models/quant.py, the int8 W8A8 context encoder.

    Returns pose_6d (N, B, 144), log_q (N, B), verts (N, B, V, 3),
    joints3d (N, B, 24, 3), uv (N, B, 24, 2), betas (B, 10), cam (B, 3).
    """
    b = image.shape[0]
    if quant is not None:
        spec, qtree = quant
        feat = _context_from_feats(net, quant_mod.encoder_feat(spec, qtree, net.encoder, image,
                                                               head=False))
    else:
        feat = context_features(net, image)
    if noise is None:
        noise = torch.randn((n * b, net.cfg.flow.features), generator=generator,
                            device=feat.device) * temp
    if feat.is_cuda and net.kernels:
        if net.packed_flow is None:
            raise RuntimeError("the Glow sampler kernel needs the packed flow (prohmr.prepare) "
                               f"and a flow it takes ({net.cfg.flow}); set_kernels(False) runs "
                               f"the plain flow")
        pose, log_q = cuda_glow_sampler.sample_and_log_prob_fused(net.flow, net.packed_flow,
                                                                  feat, n, noise)
    else:
        pose, log_q = glow.sample_and_log_prob(net.flow, feat, n, noise=noise)
    betas, cam = heads(net, feat)
    verts, joints = smpl_lib.smpl_forward_6d(model, pose, betas.repeat(n, 1))
    uv = camera.orth_project(joints, torch.exp(cam[:, 0:1]).repeat(n, 1),
                             cam[:, 1:3].repeat(n, 1), inv_norm=False)
    return {
        "pose_6d": pose.reshape(n, b, POSE_DIM),
        "log_q": log_q.reshape(n, b),
        "verts": verts.reshape(n, b, *verts.shape[1:]),
        "joints3d": joints.reshape(n, b, smpl_lib.N_JOINTS, 3),
        "uv": uv.reshape(n, b, smpl_lib.N_JOINTS, 2),
        "betas": betas,
        "cam": cam,
    }


def multi_hypothesis_metrics(samples: dict, target: dict) -> dict:
    """Best / mean-hypothesis MPJPE over the 24 SMPL joints (mm), pelvis
    (joint 0) aligned on both sides, and the 3D PJD: the per-joint volume of
    the hypotheses' spread (ddof = 1) to the power 1/3, then the joint mean,
    times sqrt(3); zeros at N == 1."""
    gt = target["joints3d"]  # (B, 24, 3) metres
    pred = samples["joints3d"]  # (N, B, 24, 3)
    pred_a = pred - pred[..., 0:1, :]
    gt_a = gt - gt[:, 0:1, :]
    err = torch.linalg.norm(pred_a - gt_a[None], dim=-1).mean(-1) * 1000.0
    if pred.shape[0] > 1:
        vol = (pred_a * 1000.0).std(0, correction=1).prod(-1)  # (B, 24) mm^3
        pjd = (vol ** (1.0 / 3.0)).mean(-1) * 3.0 ** 0.5
    else:
        pjd = torch.zeros(pred.shape[1], dtype=pred.dtype, device=pred.device)
    return {"mpjpe_bh": err.min(0).values, "mpjpe_mean": err.mean(0), "pjd_3d": pjd}
