"""Synthetic fixture dataset: random MANO poses rendered to analytically
consistent targets, the stand-in when no dataset directory is configured.

Port of mhentropy_tpu/data/synthetic.py: `_render_keypoint_splats` :30,
`make_dataset` :50 and `batches` :110 (with the batch-order shuffle of
data/common.py :145-151). The draws come from numpy's
RandomState in the JAX package's order and the decode runs the port's MANO
(on the CPU), so both packages build the same dataset for the same seed.
Targets stay numpy; `batches` yields torch tensors on the requested device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mhentropy_tpu_torch.core import camera, mano, skeletons
from mhentropy_tpu_torch.core.mano import ManoConfig, ManoModel


class SyntheticHandData(NamedTuple):
    images: np.ndarray  # (N, S, S, 3) float32 in [-1, 1]
    targets: dict  # numpy arrays keyed like the HO3D target dict


def _render_keypoint_splats(uv_px: np.ndarray, image_size: int) -> np.ndarray:
    """Per-joint Gaussian splats with joint-identifying colours (channel =
    joint % 3, intensity graded by joint index), so images encode the pose."""
    n, k, _ = uv_px.shape
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    imgs = np.zeros((n, image_size, image_size, 3), np.float32)
    sigma2 = 2 * (image_size / 32.0) ** 2
    levels = 0.4 + 0.6 * (np.arange(k) // 3) / max(1, (k - 1) // 3)
    for i in range(n):
        d2 = (xx[None] - uv_px[i, :, 0, None, None]) ** 2 + (
            yy[None] - uv_px[i, :, 1, None, None]) ** 2
        splat = np.exp(-d2 / sigma2) * levels[:, None, None]  # (K, S, S)
        for c in range(3):
            imgs[i, :, :, c] = splat[c::3].max(0)
    return imgs * 2.0 - 1.0


@torch.no_grad()
def make_dataset(model: ManoModel, n: int = 32, image_size: int = 64, seed: int = 0,
                 occlusion_rate: float = 0.3,
                 mano_config: ManoConfig = ManoConfig(use_pca=True, ncomps=45,
                                                      flat_hand_mean=False),
                 ds: str = "ho3d") -> SyntheticHandData:
    """Sample GT (theta, beta, s, t), decode through the MANO layer the model
    uses, and project, so a perfect model can reach zero error."""
    model = mano.ManoModel(*(t.cpu() for t in model))
    rng = np.random.RandomState(seed)
    theta = np.concatenate([rng.randn(n, 3) * 0.3, rng.randn(n, 45) * 0.5],
                           axis=1).astype(np.float32)
    beta = (rng.randn(n, 10) * 0.01).astype(np.float32)
    out = mano.mano_decode(model, torch.from_numpy(theta), torch.from_numpy(beta),
                           skeidx="RHD", config=mano_config, with_mesh=True)
    xyz = out["mano_joints"].numpy()  # (n, 21, 3) mm
    normed, _, bone = camera.batch_normalize_pose3d(
        torch.from_numpy(xyz), skeletons.ROOT_IDX[ds], skeletons.NORM_IDX[ds], return_st=True)
    normed, bone = normed.numpy(), bone.numpy()

    s_cam = rng.uniform(0.25, 0.45, (n, 1)).astype(np.float32)
    t_cam = rng.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    crop_uv = normed[..., :2] * s_cam[:, None] + t_cam[:, None]  # [-1, 1)
    uv_px = (crop_uv + 1.0) / 2.0 * image_size

    # 3-state visibility: 1 visible, 0 patch-occluded, 2 out of bounds; only
    # visible joints demote to 2.
    vis = np.ones((n, 21), np.float32)
    vis[rng.rand(n, 21) < occlusion_rate] = 0.0
    oob = (crop_uv < -1.0).any(-1) | (crop_uv >= 1.0).any(-1)
    vis[oob & (vis == 1.0)] = 2.0

    targets = {
        "crop_uv": crop_uv.reshape(n, -1).astype(np.float32),
        "pose3d": normed.reshape(n, -1).astype(np.float32),
        "vis": vis,
        "scale": (bone / 1000.0).astype(np.float32),  # metres (HO3D)
        "st": np.concatenate([s_cam, t_cam], axis=1),
        "original_pose3d": xyz.astype(np.float32),
        "verts": out["mesh"].numpy().reshape(n, -1).astype(np.float32),
        "theta_gt": theta,
        "beta_gt": beta,
        "object_verts": rng.randn(n, 1000 * 3).astype(np.float32) * 50.0,
    }
    return SyntheticHandData(images=_render_keypoint_splats(uv_px, image_size), targets=targets)


def batches(data: SyntheticHandData, batch_size: int, pad_remainder: bool = False,
            device="cpu", shuffle: bool = False, seed: int = 0):
    """Yield (image, target) batches as tensors on `device`.

    pad_remainder=True keeps the tail: the last short batch is padded to
    batch_size by wrapping, and every target carries a `valid` (B,) mask.
    shuffle=True permutes the ORDER of the batches with
    RandomState(seed).permutation, as the JAX package's data/common.py
    `batches` does for this container (:145-151); their composition stays.
    """
    n = data.images.shape[0]
    end = n if pad_remainder else n - batch_size + 1
    starts = list(range(0, end, batch_size))
    if shuffle:
        starts = [starts[i] for i in np.random.RandomState(seed).permutation(len(starts))]
    for i in starts:
        idx = np.arange(i, min(i + batch_size, n))
        k = idx.shape[0]
        if k < batch_size:
            idx = np.concatenate([idx, np.arange(batch_size - k) % n])
        target = {key: torch.from_numpy(v[idx]).to(device) for key, v in data.targets.items()}
        if pad_remainder:
            target["valid"] = torch.from_numpy(
                (np.arange(batch_size) < k).astype(np.float32)).to(device)
        yield torch.from_numpy(data.images[idx]).to(device), target
