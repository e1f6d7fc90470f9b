"""Camera / coordinate transforms on torch tensors.

Port of mhentropy_tpu/core/camera.py: `batch_normalize_pose3d` :22,
`orth_project` :52, `procrustes_align` :73 and `compute_st` :105 (the eval
step fits the orthographic camera when a batch lacks `st`), and the
perspective and crop conversions `uvd_to_xyz` :126, `xyz_to_uvd` :143,
`relocate_uv` :150, `crop_to_original_uv` :157, `xyz_to_crop` :180 and
`crop_to_xyz` :215.
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


def uvd_to_xyz(uvd: torch.Tensor, k_mat: torch.Tensor) -> torch.Tensor:
    """Perspective back-projection: uvd (B, K, 3) pixel coords and metric
    depth, k_mat (B, 3, 3) intrinsics -> xyz (B, K, 3)."""
    fx = k_mat[:, 0, 0][:, None, None]
    fy = k_mat[:, 1, 1][:, None, None]
    u0 = k_mat[:, 0, 2][:, None, None]
    v0 = k_mat[:, 1, 2][:, None, None]
    u, v, z = uvd[..., 0:1], uvd[..., 1:2], uvd[..., 2:3]
    return torch.cat([(u - u0) * z / fx, (v - v0) * z / fy, z], -1)


def xyz_to_uvd(xyz: torch.Tensor, k_mat: torch.Tensor) -> torch.Tensor:
    """Perspective projection, the inverse of uvd_to_xyz."""
    proj = torch.einsum("bij,bkj->bki", k_mat, xyz)
    uv = proj[..., :2] / (proj[..., 2:3] + 1e-16)
    return torch.cat([uv, xyz[..., 2:3]], -1)


def relocate_uv(uv: torch.Tensor, crop_center: torch.Tensor, resized_size: int,
                crop_scale: torch.Tensor) -> torch.Tensor:
    """Full-image uv -> crop uv."""
    return (uv - crop_center[:, None, :]) * crop_scale[:, None, None] + resized_size // 2


def crop_to_original_uv(uv: torch.Tensor, crop_center: torch.Tensor, crop_size: torch.Tensor,
                        hand_side: torch.Tensor, resized_size: int) -> torch.Tensor:
    """Crop-space uv -> original-image uv, undoing the left-hand flip.

    The un-flip is `resized_size - u` while the loaders flip with
    `(size - 1) - u`: the reference's 1 px inconsistency on left hands,
    kept as the JAX package keeps it so the metrics match."""
    u = torch.where(hand_side[:, None] > 0.5, resized_size - uv[..., 0], uv[..., 0])
    uv = torch.stack([u, uv[..., 1]], -1)
    scale = (2.0 * crop_size / resized_size)[:, None, None]
    return (uv - resized_size / 2.0) * scale + crop_center[:, None, :]


def xyz_to_crop(pose3d: torch.Tensor, target: dict, resized_size: int = 256,
                root_idx: int = 12, norm_idx: int = 11):
    """Scale-normalised 3D pose (B, K, 3) or (B, 3K) -> crop-space uv and
    normalised depth, with the hand-side flip. target: crop_center (B, 2),
    crop_size (B,), hand_side (B,) or (B, 2), bone_length (B,),
    pose3d_root (B, 3), camera (B, 3, 3)."""
    b = pose3d.shape[0]
    pose3d = pose3d.reshape(b, -1, 3)
    pose3d = pose3d - pose3d[:, root_idx:root_idx + 1]
    bone = target["bone_length"]
    pose3d = pose3d * bone[:, None, None] + target["pose3d_root"][:, None, :]
    uvd = xyz_to_uvd(pose3d, target["camera"])
    crop_d = batch_normalize_pose3d(pose3d, root_idx, norm_idx)[..., 2:3]
    crop_scale = resized_size / (target["crop_size"] * 2.0)
    crop_uv = relocate_uv(uvd[..., :2], target["crop_center"], resized_size, crop_scale)
    side = target["hand_side"]
    if side.dim() == 2:
        side = side[:, 0]
    # > 0.5, as crop_to_original_uv tests it, so the round trip holds.
    u = torch.where(side[:, None] > 0.5, resized_size - crop_uv[..., 0], crop_uv[..., 0])
    return torch.stack([u, crop_uv[..., 1]], -1), crop_d


def crop_to_xyz(uv_crop: torch.Tensor, norm_depth: torch.Tensor, target: dict,
                resized_size: int = 256, uv_norm: bool = False):
    """Crop-space uv and normalised depth -> metric xyz, undoing the
    rotation augmentation (target["rot_mat_inv"]), the crop and the
    left-hand flip. Returns (uv_original (B, K, 2), xyz (B, K, 3) metres)."""
    b = uv_crop.shape[0]
    uv = uv_crop.reshape(b, -1, 2)
    if uv_norm:
        uv = (uv + 1.0) / 2.0 * resized_size
    ones = torch.ones((*uv.shape[:2], 1), dtype=uv.dtype, device=uv.device)
    uv_unrot = torch.einsum("bki,bij->bkj", torch.cat([uv, ones], -1), target["rot_mat_inv"])
    side = target["hand_side"]
    if side.dim() == 2:
        side = (side[:, 0] == 1.0).to(uv.dtype)
    uv_orig = crop_to_original_uv(uv_unrot, target["crop_center"], target["crop_size"], side,
                                  resized_size)
    depth = (norm_depth.reshape(b, -1, 1) * target["bone_length"][:, None, None]
             + target["pose3d_root"][:, 2][:, None, None]) * 1000.0
    xyz = uvd_to_xyz(torch.cat([uv_orig, depth], -1), target["camera"]) / 1000.0
    return uv_orig, xyz
