"""Batched rotation math on torch tensors.

Port of mhentropy_tpu/core/rotations.py (`quat_to_rotmat` :22,
`batch_rodrigues` :49, `rotmat_from_6d` :68, `project_rotmat` :90,
`posemap_axisang` :103): axis-angle -> rotation matrix through the
quaternion path, with the reference's `+ eps` norm, the 6D representation
-> rotation matrix, the projection onto the closest rotation, and the full
pose's per-joint matrices with the pose-blendshape features.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z), not necessarily unit -> (..., 3, 3)."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = torch.stack(
        [
            w2 + x2 - y2 - z2, 2.0 * (xy - wz), 2.0 * (wy + xz),
            2.0 * (wz + xy), w2 - x2 + y2 - z2, 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (wx + yz), w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return rows.reshape(*quat.shape[:-1], 3, 3)


def batch_rodrigues(axisang: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrices; the norm is taken
    of `axisang + eps` so the zero rotation stays smooth."""
    angle = torch.linalg.norm(axisang + eps, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def rotmat_from_6d(x6d: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 6) = two stacked 3-vectors (a1, a2) -> (..., 3, 3) whose COLUMNS
    are [b1 | b2 | b3] (Gram-Schmidt, then the cross product): the ProHMR
    convention. Stacking them as rows instead returns the transpose, which
    decodes every joint rotation of a released checkpoint as its inverse
    without any error showing."""
    a1, a2 = x6d[..., :3], x6d[..., 3:]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + eps)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / (torch.linalg.norm(b2, dim=-1, keepdim=True) + eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def project_rotmat(mats: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) arbitrary matrices -> the closest rotations (SVD, the last
    singular direction's sign set so the determinant is +1)."""
    u, _, vt = torch.linalg.svd(mats)
    det = torch.sign(torch.linalg.det(u @ vt))
    fix = torch.cat([torch.ones((*det.shape, 2), dtype=mats.dtype, device=mats.device),
                     det[..., None]], dim=-1)
    return (u * fix[..., None, :]) @ vt


def posemap_axisang(pose_vectors: torch.Tensor):
    """(B, 3 * J) axis-angle pose -> (pose_map (B, J * 9) = R - I flattened,
    rot_mats (B, J, 3, 3))."""
    b = pose_vectors.shape[0]
    nj = pose_vectors.shape[1] // 3
    rots = batch_rodrigues(pose_vectors.reshape(b, nj, 3))
    pose_map = (rots - torch.eye(3, dtype=rots.dtype, device=rots.device)).reshape(b, nj * 9)
    return pose_map, rots
