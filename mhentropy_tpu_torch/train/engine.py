"""Model assembly from the YAML schema, and the MANO asset loader.

Port of two functions of mhentropy_tpu/train/engine.py: `build_model_config`
(:63) and `load_mano_model` (:330, with `_mano_fingerprint` :308). The
training engine itself is not ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import os

from mhentropy_tpu_torch.core import mano as mano_lib
from mhentropy_tpu_torch.core.mano import ManoConfig, ManoModel
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.models.mhent import MHEntConfig


def build_model_config(cfg) -> MHEntConfig:
    """YAML schema -> MHEntConfig (the fields the inference path reads)."""
    net = cfg.network
    n_latent = net.nums_latent if net.nums_latent else net.num_latent
    enc = EncoderConfig(
        backbone=net.backbone,
        n_latent=(n_latent, n_latent) if isinstance(n_latent, int) else tuple(n_latent),
        feat_dim=net.feat_dim,
        sigma_act=net.acts,
        deterministic=net.deterministic,
        dtype=cfg.tpu.compute_dtype,
    )
    flow = RealNVPConfig(
        dim=45,
        cond_dim=net.num_latent,
        h_dim=net.h_dims[0],
        num_steps=net.num_steps,
        joint_n=cfg.dataset.jointN,
    )
    return MHEntConfig(
        encoder=enc,
        flow=flow,
        mano=ManoConfig(use_pca=True, ncomps=45, flat_hand_mean=False),
        regressor=net.regressor,
        ds=cfg.dataset.dataset_name,
        image_size=max(cfg.dataset.image_size),
        feat_dim=net.num_latent,
    )


def mano_fingerprint(mano_dir: str):
    """(abspath, mtime_ns, size) of the resolved MANO asset, or None for the
    synthetic stand-in."""
    path = mano_lib.find_mano_assets(mano_dir)
    if not path:
        return None
    path = os.path.abspath(path)
    st = os.stat(path)
    return (path, st.st_mtime_ns, st.st_size)


def load_mano_model(mano_dir: str = "./mano/", device="cpu") -> ManoModel:
    """MANO_RIGHT.pkl from `mano_dir`, or the synthetic stand-in (seed 0)
    when there is none."""
    fp = mano_fingerprint(mano_dir)
    if fp:
        return mano_lib.load_mano_pkl(fp[0], device=device)
    return mano_lib.synthetic_mano_model(seed=0, device=device)
