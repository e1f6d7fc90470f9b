"""Camera / coordinate transforms on torch tensors.

Port of mhentropy_tpu/core/camera.py: `batch_normalize_pose3d` :22,
`orth_project` :52, `procrustes_align` :73 and `compute_st` :105 (the eval
step fits the orthographic camera when a batch lacks `st`).
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


def procrustes_align(mtx1: torch.Tensor, mtx2: torch.Tensor, return_trafo: bool = False):
    """Similarity-transform alignment of mtx2 onto mtx1 per batch element
    ((..., K, D) point sets), the criterion of
    scipy.linalg.orthogonal_procrustes on the centred, Frobenius-normalised
    sets, solved with one batched SVD.

    Returns aligned mtx2; with return_trafo also (R, s, s1, s2, t1, t2).
    """
    t1 = mtx1.mean(-2, keepdim=True)
    t2 = mtx2.mean(-2, keepdim=True)
    a = mtx1 - t1
    b = mtx2 - t2
    s1 = torch.linalg.norm(a, dim=(-2, -1), keepdim=True) + 1e-8
    s2 = torch.linalg.norm(b, dim=(-2, -1), keepdim=True) + 1e-8
    a = a / s1
    b = b / s2
    u, sv, vt = torch.linalg.svd(torch.einsum("...ki,...kj->...ij", a, b))
    r = u @ vt
    s = sv.sum(-1)[..., None, None]
    aligned = torch.einsum("...ki,...ji->...kj", b, r) * s * s1 + t1
    if return_trafo:
        return aligned, r, s, s1, s2, t1, t2
    return aligned


def compute_st(pose3d: torch.Tensor, crop_uv: torch.Tensor) -> torch.Tensor:
    """The orthographic camera (s, tx, ty) with uv = s * xyz[:, :2] + t:
    the Procrustes fit restricted to scale and translation.

    pose3d (B, K, 3) normalised-relative, crop_uv (B, K, 2) -> st (B, 3).
    """
    _, _, s, s1, s2, t1, t2 = procrustes_align(crop_uv, pose3d[..., :2], return_trafo=True)
    scale = (s * s1 / s2)[..., 0, 0]
    t = -t2[..., 0, :] / s2[..., 0, :] * s[..., 0, :] * s1[..., 0, :] + t1[..., 0, :]
    return torch.cat([scale[..., None], t], dim=-1)
