"""Batched rotation math on torch tensors.

Port of mhentropy_tpu/core/rotations.py (`quat_to_rotmat` :22,
`batch_rodrigues` :49): axis-angle -> rotation matrix through the
quaternion path, with the reference's `+ eps` norm.
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
