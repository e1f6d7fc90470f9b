"""RLE-style flow density regression: the non-integrated BasicEnc + p_nf mode.

Port of mhentropy_tpu/models/rle.py: `RLEConfig` :34, `init` :44, `_encode`
:53, `loss_and_predict` :63 and `best_hypothesis_uvd` :144. The encoder
predicts (mu, logvar) for the actnorm mode (tsfm_on 'x' or 'z') or a
feature for a conditional flow; the per-joint RealNVP gives the density of
the ground-truth pose (smoothed by 1e-4 noise); the point estimate is the
mean of K1 tempered draws, with their per-joint spread as sigma_i; with
nf_res 'rle' the Gaussian-Q residual's log q comes along.

The module's names are the reference's RLE checkpoint
({'encoderRGB': BasicEnc, 'p_nf': RealNVP}, which `checkpoint` writes and
`load_checkpoint` reads). torch cannot replay jax.random, so both draws
(the smoothing noise and the K1 base draws) come in as arguments or from a
`torch.Generator`. The encoder's eval mode on the card runs the stem and
stage-1 kernels on the weights `refresh_kernel_weights` folds; its train
mode runs the BN-sum kernels. The flow is plain PyTorch, as it is plain XLA
in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from mhentropy_tpu_torch.flows import realnvp
from mhentropy_tpu_torch.flows.priors import std_normal_logp
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models.encoder import Encoder, EncoderConfig, init_weights_


class RLEConfig(NamedTuple):
    encoder: EncoderConfig = EncoderConfig(backbone="resnet18", n_latent=(63, 63))
    flow: RealNVPConfig = RealNVPConfig(dim=3, tsfm_on="x", h_dim=64, num_steps=3)
    pe: str = "3d"  # '3d' (pose3d) or '2d' (crop_uv)
    k1: int = 10  # draws for the point estimate
    sample_temp: float = 0.8
    nf_res: str | None = None  # 'rle' -> the Gaussian-Q term
    image_size: int = 256


class RLE(nn.Module):
    def __init__(self, cfg: RLEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoderRGB = Encoder(cfg.encoder)
        self.p_nf = realnvp.RealNVP(cfg.flow)

    def set_kernels(self, enabled: bool) -> None:
        """Route the encoder through its kernels (eval: stem and stage 1;
        train: the BN sums; the default) or their plain PyTorch versions."""
        self.encoderRGB.res.kernels = enabled


@torch.no_grad()
def init(cfg: RLEConfig, seed: int = 0) -> RLE:
    """Fresh weights from `seed`, with the JAX package's init distributions."""
    g = torch.Generator().manual_seed(seed)
    net = RLE(cfg)
    init_weights_(net, g)
    net.p_nf.init_params(g)
    return net


def prepare(net: RLE, device, masters: bool = False) -> RLE:
    """Eval mode on `device`, the backbone channels_last (cast to its compute
    dtype unless `masters` keeps f32 parameters for training), the stem's and
    stage 1's BN folded for the eval kernels. Run it, or
    `refresh_kernel_weights`, again after changing weights."""
    net.eval().to(device)
    net.encoderRGB.res.place(getattr(torch, net.cfg.encoder.dtype), masters)
    return refresh_kernel_weights(net)


@torch.no_grad()
def refresh_kernel_weights(net: RLE) -> RLE:
    net.encoderRGB.res.fold_kernel_weights()
    return net


def checkpoint(net: RLE) -> dict:
    """{'encoderRGB': ..., 'p_nf': ...} state_dicts on the CPU."""
    return {name: {k: v.detach().cpu() for k, v in getattr(net, name).state_dict().items()}
            for name in ("encoderRGB", "p_nf")}


def load_checkpoint(net: RLE, ckpt: dict) -> None:
    """Load both modules of a checkpoint in the reference's RLE schema."""
    for name in ("encoderRGB", "p_nf"):
        getattr(net, name).load_state_dict(ckpt[name], strict=True)


def draws(cfg: RLEConfig, pose: torch.Tensor, generator: torch.Generator | None = None):
    """A batch's two draws for `loss_and_predict`: standard-normal smoothing
    noise of the (B, D * K') GT pose's shape, and the (K1, B * K', D) base
    draws times sample_temp."""
    d = cfg.flow.dim
    noise = torch.randn(pose.shape, generator=generator, device=pose.device)
    base = torch.randn((cfg.k1, pose.shape[0] * (pose.shape[1] // d), d), generator=generator,
                       device=pose.device) * cfg.sample_temp
    return noise, base


def _encode(net: RLE, image: torch.Tensor, train: bool):
    """(mu, logvar = 2 log sd) of the encoder's heads. train: batch-statistics
    BN updating the running statistics in place; the encoder must already
    be in that mode."""
    enc = net.encoderRGB
    if enc.training != train:
        raise ValueError(f"rle: train={train} on an encoder in "
                         f"{'train' if enc.training else 'eval'} mode: call "
                         f"net.{'train' if train else 'eval'}() first")
    mu, sd = enc(image)
    return mu, 2.0 * torch.log(sd)


def loss_and_predict(net: RLE, image: torch.Tensor, target: dict,
                     noise: torch.Tensor | None = None,
                     base_noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None,
                     train: bool = False) -> dict:
    """The RLE output for a (B, H, W, 3) image batch.

    noise: standard normal of the GT pose's shape, times 1e-4 the smoothing
    of the pose whose density is taken. base_noise: (K1, B * K', D) base
    draws, already times sample_temp. Both are drawn from `generator`
    (`draws`) when None.

    Returns log_p (B,) (the loss is -log_p.mean()) and log_phi, the K1 draws
    (without gradient) as xyz (K1, B, D * K') or uv in pixels, their mean
    pose_rgb_sample, sigma_i (their std, ddof 1, averaged), pred_jts (mu in
    the 'x' mode, with pose_rgb_mu, else the mean draw), and log_q (B,) with
    nf_res 'rle'.
    """
    cfg = net.cfg
    fcfg = cfg.flow
    flow = net.p_nf
    pose_gt = target["pose3d"] if cfg.pe == "3d" else target["crop_uv"]
    vis = target.get("target_uv_weight") if cfg.pe == "2d" else None
    mu, logvar = _encode(net, image, train)

    if noise is None or base_noise is None:
        drawn = draws(cfg, pose_gt, generator)
        noise = drawn[0] if noise is None else noise
        base_noise = drawn[1] if base_noise is None else base_noise
    feat = logvar if fcfg.cond_dim else None
    cproj = None
    if flow.conditional:
        cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
    log_p = realnvp.log_prob(flow, pose_gt + noise * 1e-4, mu=mu, logvar=logvar, weights=vis,
                             cproj=cproj)
    out = {"log_p": log_p, "log_phi": log_p}

    # The point estimate: K1 tempered draws in one pass of K1 x B x K' rows.
    b, k1, d = pose_gt.shape[0], cfg.k1, fcfg.dim
    rows = b * (pose_gt.shape[1] // d)
    with torch.no_grad():
        samples = realnvp.sample(
            flow, base_noise.reshape(k1 * rows, d),
            cproj=None if cproj is None else cproj.repeat(1, 1, k1, 1),
            mu=mu.repeat(k1, 1), logvar=logvar.repeat(k1, 1),
            return_log_prob=False).reshape(k1, b, -1)
    out["pose_rgb_sample"] = samples.mean(0)
    out["sigma_i"] = samples.std(0).mean()
    if fcfg.tsfm_on == "x":
        out["pose_rgb_mu"] = mu
        out["pred_jts"] = mu
    else:
        out["pred_jts"] = out["pose_rgb_sample"]
    if cfg.pe == "3d":
        out["xyz"] = samples
    else:
        out["uv"] = (samples + 1.0) / 2.0 * cfg.image_size

    if cfg.nf_res == "rle":
        # Only the actnorm mode's (mu, logvar) are density statistics.
        if fcfg.tsfm_on != "x":
            raise NotImplementedError("nf_res='rle' needs tsfm_on='x' (mu/logvar actnorm mode)")
        bar_mu = ((pose_gt - mu) * torch.exp(-0.5 * logvar)).reshape(-1, d)
        w_row = bar_mu.new_ones(bar_mu.shape[0]) if vis is None else vis.reshape(-1, d)[:, 0]
        out["log_q"] = (std_normal_logp(bar_mu) * w_row).reshape(b, -1).sum(1)
    return out


def best_hypothesis_uvd(samples: torch.Tensor, target: dict) -> torch.Tensor:
    """Relative xyz draws -> the best draw's uvd: the per-image draw closest
    to the GT pose3d, lifted by pose3d_root to millimetres, projected with
    st_cam = (fx, fy, cx, cy), depth kept relative, all halved.

    samples: (K1, B, 3K); target: pose3d (B, 3K), pose3d_root (B, 3),
    st_cam (B, 4). Returns (B, 3K).
    """
    k1, b, _ = samples.shape
    jpe = (samples - target["pose3d"][None]).reshape(k1, b, -1, 3)
    bh = torch.linalg.norm(jpe, dim=-1).mean(-1).argmin(0)  # (B,)
    rel = samples[bh, torch.arange(b, device=samples.device)].reshape(b, -1, 3)
    abs_xyz = (rel + target["pose3d_root"][:, None, :]) * 1000.0
    st = target["st_cam"]
    uv = st[:, None, :2] / (abs_xyz[..., 2:3] + 1e-16) * abs_xyz[..., :2] + st[:, None, 2:4]
    return (torch.cat([uv, rel[..., 2:3]], -1) / 2.0).reshape(b, -1)
