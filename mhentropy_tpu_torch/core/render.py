"""Differentiable silhouette / depth splatting renderer on torch tensors.

Port of mhentropy_tpu/core/render.py: `_gaussians` :30, `splat_silhouette`
:40, `splat_depth` :64 and `render_mods` :105. Each vertex is splatted as a
separable Gaussian onto the S x S mask grid, so every sum over the V
vertices is one batched product of two (rows, V, S) factors:
`bmm(gy^T, gx)`, with the depth's per-vertex weights folded into gy
first. No tensor larger than (rows, V, S) is formed: a three-operand
einsum contracted left to right would materialise (rows, S, S, V), 8.2 GB
at a train step's 640 rows and 163 GB at an eval batch's 12,800.

The products run in f32 (torch's default `allow_tf32 = False` for
matmuls): the JAX module computes them at `Precision.HIGH` because they
feed the mask likelihood's gradient, and TF32 would not keep that.
"""

from __future__ import annotations

import torch

from mhentropy_tpu_torch.core import camera


def _gaussians(verts_uv: torch.Tensor, s: int, sigma_px: float):
    """Separable per-axis Gaussian splat factors: (gy, gx), each (B, V, S)."""
    px = (verts_uv + 1.0) / 2.0 * s  # pixel coords
    grid = torch.arange(s, dtype=verts_uv.dtype, device=verts_uv.device) + 0.5
    gx = torch.exp(-((px[..., 0:1] - grid) ** 2) / (2 * sigma_px**2))
    gy = torch.exp(-((px[..., 1:2] - grid) ** 2) / (2 * sigma_px**2))
    return gy, gx


def splat_silhouette(verts_uv: torch.Tensor, mask_size: int = 64,
                     sigma_px: float = 1.5) -> torch.Tensor:
    """Soft silhouette from projected vertices: (B, V, 2) in [-1, 1) crop
    coordinates -> (B, S, S) in [0, 1], the saturated sum of the vertices'
    Gaussians, 1 - exp(-sum_v g_v)."""
    gy, gx = _gaussians(verts_uv, mask_size, sigma_px)
    return 1.0 - torch.exp(-torch.bmm(gy.transpose(1, 2), gx))


def splat_depth(verts_uv: torch.Tensor, verts_z: torch.Tensor, mask_size: int = 64,
                sigma_px: float = 1.5, background: float = 0.0,
                beta: float = 10.0) -> torch.Tensor:
    """Soft depth map: the per-pixel softmin of the vertices' depths
    (smaller = closer), weighted by their splats; `background` where the
    silhouette is below 0.5.

    verts_uv (B, V, 2) in [-1, 1); verts_z (B, V) in units where beta times
    the hand's extent is O(10): `render_mods` passes bone-normalised z, for
    which beta = 10 separates the front surface from the back (see the JAX
    function for other units). Returns (B, S, S).
    """
    gy, gx = _gaussians(verts_uv, mask_size, sigma_px)
    zs = torch.exp(-beta * (verts_z - verts_z.amin(1, keepdim=True)))
    gyt = gy.transpose(1, 2)  # (B, S, V)
    denom = torch.bmm(gyt * zs[:, None, :], gx)
    num = torch.bmm(gyt * (zs * verts_z)[:, None, :], gx)
    # The floor sits just above f32 underflow: pixels that only back-surface
    # vertices reach carry weights near 1e-26, which a 1e-8 floor would swamp.
    depth = num / torch.clamp(denom, min=1e-37)
    cover = 1.0 - torch.exp(-torch.bmm(gyt, gx))
    return torch.where(cover > 0.5, depth, torch.full_like(depth, background))


def render_mods(verts_normed: torch.Tensor, logs_t: torch.Tensor, mods=("m",),
                mask_size: int = 64) -> dict:
    """The 'm' (mask) and 'depth' mods of (R, V, 3) normalised-relative
    vertices under the (R, 3) orthographic camera (log s, tx, ty), projected
    as the uv head projects its keypoints."""
    uv = camera.orth_project(verts_normed, torch.exp(logs_t[:, 0:1]), logs_t[:, 1:3],
                             inv_norm=False)
    out = {}
    if "m" in mods:
        out["mask"] = splat_silhouette(uv, mask_size)
    if "depth" in mods:
        out["depth"] = splat_depth(uv, verts_normed[..., 2], mask_size)
    return out
