"""Camera / coordinate transforms on torch tensors.

Port of mhentropy_tpu/core/camera.py: `batch_normalize_pose3d` :22 and
`orth_project` :52, the two the serving decode uses.
"""

from __future__ import annotations

import torch


def batch_normalize_pose3d(pose3d: torch.Tensor, root_idx: int,
                           norm_idx: int | None = None,
                           return_st: bool = False):
    """Root-relative, bone-normalised 3D pose.

    Args:
        pose3d: (B, K, 3).
        root_idx: joint subtracted as origin.
        norm_idx: joint whose root-relative length normalises the scale.

    Returns:
        (B, K, 3); with return_st also root (B, 1, 3) and bone length (B,).
    """
    root = pose3d[:, root_idx:root_idx + 1, :]
    rel = pose3d - root
    if norm_idx is not None:
        bone = torch.sqrt(torch.sum(rel[:, norm_idx, :] ** 2, -1))
        out = rel / bone[:, None, None]
    else:
        bone = torch.ones(pose3d.shape[0], dtype=pose3d.dtype,
                          device=pose3d.device)
        out = rel
    if return_st:
        return out, root, bone
    return out


def orth_project(xyz: torch.Tensor, scale: torch.Tensor, trans: torch.Tensor,
                 image_size: int = 256, inv_norm: bool = True) -> torch.Tensor:
    """uv = s * xyz[..., :2] + t; with inv_norm, [-1, 1) -> [0, image_size).

    xyz (..., K, 3); scale (..., 1); trans (..., 2).
    """
    uv = scale[..., None, :] * xyz[..., :2] + trans[..., None, :]
    if inv_norm:
        uv = (uv + 1.0) / 2.0 * image_size
    return uv
