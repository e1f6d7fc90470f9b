"""MHEnt, the probabilistic hand model: the multi-hypothesis inference path.

Port of mhentropy_tpu/models/mhent.py: `MHEntConfig` :48, `init` :118,
`det_head_apply` :149, `extract_feat` :155, `combine_z` :166, the realnvp
branch of `sample_q_z` :181, `decode` :339 and `sample_hypotheses` :496
(with the top-N_quant filter :540). Training (`reverse_kld`,
`forward_log_p`, the priors) and the Glow / det regressors are not ported
yet (ROADMAP queue 1, items 4 and 9).

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

from mhentropy_tpu_torch.core import camera, mano, skeletons
from mhentropy_tpu_torch.core.mano import ManoConfig, ManoModel
from mhentropy_tpu_torch.flows import cuda_sampler, realnvp
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models.encoder import Encoder, EncoderConfig

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

    def det_dims(self) -> int:
        return 3 + 10 + 1 + 2 + (45 if self.regressor == "det" else 0)


class MHEnt(nn.Module):
    def __init__(self, cfg: MHEntConfig):
        super().__init__()
        if cfg.regressor != "realnvp":
            raise NotImplementedError(
                f"regressor {cfg.regressor!r} is not ported yet (ROADMAP queue 1, "
                f"item 9 for glow); the port serves realnvp")
        self.cfg = cfg
        self.feat_extractor = Encoder(cfg.encoder)
        self.q_z_giv_i = realnvp.RealNVP(cfg.flow)
        f = cfg.feat_dim
        self.det_head = nn.Sequential(nn.Linear(f, f), nn.ReLU(), nn.Linear(f, cfg.det_dims()))
        self.kernels = True
        self.packed_flow = None  # the flow's weights for the fused sampler (prepare)

    def set_kernels(self, enabled: bool) -> None:
        """Route the CUDA eval path through the three kernels (the default)
        or through their plain PyTorch versions, e.g. to compare the two."""
        self.feat_extractor.res.kernels = enabled
        self.kernels = enabled


@torch.no_grad()
def init(cfg: MHEntConfig, seed: int = 0) -> MHEnt:
    """Fresh weights from `seed`, with the JAX package's init distributions:
    lecun-normal convs, unit BN, torch-default linears, near-identity flow."""
    g = torch.Generator().manual_seed(seed)
    net = MHEnt(cfg)
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=g)
        elif isinstance(m, nn.Linear):
            lim = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-lim, lim, generator=g)
            m.bias.uniform_(-lim, lim, generator=g)
    net.q_z_giv_i.init_params(g)
    return net


def prepare(net: MHEnt, device) -> MHEnt:
    """Eval mode on `device`; the backbone in its compute dtype and in
    channels_last memory, the flow and heads in f32; the kernels' weights
    folded and packed from the module's. Run it again after changing weights."""
    net.eval().to(device)
    dtype = getattr(torch, net.cfg.encoder.dtype)
    net.feat_extractor.res.to(dtype=dtype, memory_format=torch.channels_last)
    net.feat_extractor.res.fold_kernel_weights()
    net.packed_flow = cuda_sampler.pack(net.q_z_giv_i)
    return net


def det_head_apply(net: MHEnt, feat: torch.Tensor) -> torch.Tensor:
    return net.det_head(feat)


def extract_feat(net: MHEnt, image: torch.Tensor) -> torch.Tensor:
    """Conditioning feature = the encoder's mu head."""
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
               generator: torch.Generator | None = None):
    """Draw n hypotheses per image from q(z | I).

    Rows are hypothesis-major (N blocks of B). base_noise: (n * B, 45), already
    times temp; drawn from `generator` when None.

    Returns z (n * B, 61) and log q (n * B,).
    """
    cfg = net.cfg
    b = feat.shape[0]
    flow = net.q_z_giv_i
    if base_noise is None:
        base_noise = torch.randn((n * b, cfg.flow.dim), generator=generator,
                                 device=feat.device) * temp
    if feat.is_cuda and net.kernels:
        if net.packed_flow is None:
            raise RuntimeError("the fused sampler needs the packed flow; run mhent.prepare")
        z_flow, log_q = cuda_sampler.sample_fused(flow, net.packed_flow, feat, n, base_noise)
    else:
        cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
        z_flow, log_q = realnvp.sample(flow, base_noise, cproj=cproj.repeat(1, 1, n, 1))
    z_det = det_head_apply(net, feat).repeat(n, 1)
    return combine_z(cfg, z_det, z_flow), log_q


def decode(model: ManoModel, cfg: MHEntConfig, th_bt: torch.Tensor, logs_t: torch.Tensor,
           mods=("uv",), inv_norm: bool = False,
           fold: mano.KeypointFold | None = None) -> dict:
    """MANO decode + normalisation + orthographic projection.

    th_bt (R, 58), logs_t (R, 3) -> xyz (R, K, 3) normalised-relative,
    bone (R,), uv (R, K, 2) if requested, verts (R, 778, 3) if requested.
    """
    if "m" in mods or "depth" in mods:
        raise NotImplementedError("the mask/depth renderer is not ported yet (ROADMAP queue 1, item 10)")
    theta, beta = th_bt[:, :48], th_bt[:, -10:]
    out = mano.mano_decode(model, theta, beta, skeidx="RHD", fold=fold,
                           with_mesh="verts" in mods)
    normed, root, bone = camera.batch_normalize_pose3d(
        out["mano_joints"], skeletons.ROOT_IDX[cfg.ds],
        norm_idx=skeletons.NORM_IDX[cfg.ds], return_st=True)
    result = {"xyz": normed, "bone": bone}
    if "verts" in mods:
        result["verts"] = (out["mesh"] - root) / bone[:, None, None]
    if "uv" in mods:
        scale = torch.exp(logs_t[:, 0:1])
        result["uv"] = camera.orth_project(normed, scale, logs_t[:, 1:3], cfg.image_size,
                                           inv_norm=inv_norm)
    return result


def sample_hypotheses(model: ManoModel, net: MHEnt, image: torch.Tensor, n: int = 200,
                      n_quant: int | None = None, temp: float = 0.8,
                      mods=("xyz", "uv", "verts"),
                      base_noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      fold: mano.KeypointFold | None = None) -> dict:
    """Multi-hypothesis inference on a (B, H, W, 3) NHWC image batch.

    Returns th_bt / logs_t (N', B, .), xyz (N', B, 63), uv (N', B, 42) in
    pixels, verts (N', B, 2334) and faces, for the requested mods.
    """
    cfg = net.cfg
    feat = extract_feat(net, image)
    b = image.shape[0]
    z, log_q = sample_q_z(net, feat, n, temp=temp, base_noise=base_noise, generator=generator)
    z = z.reshape(n, b, Z_TOTAL)
    if n_quant is not None and n_quant < n:
        # Keep the n_quant most likely hypotheses per image.
        idx = torch.topk(log_q.reshape(n, b).T, n_quant).indices  # (B, Q)
        z = torch.take_along_dim(z, idx.T[:, :, None], dim=0)
        n = n_quant
    out = {"th_bt": z[..., :TH_BT], "logs_t": z[..., -3:]}
    rows = z.reshape(n * b, Z_TOTAL)
    dec = decode(model, cfg, rows[:, :TH_BT], rows[:, -3:], mods=mods, inv_norm=True,
                 fold=fold)
    for mod in ("verts", "xyz", "uv"):
        if mod in mods:
            out[mod] = dec[mod].reshape(n, b, -1)
    if "verts" in mods:
        out["faces"] = model.faces
    return out
