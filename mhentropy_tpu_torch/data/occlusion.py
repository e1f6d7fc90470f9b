"""Visibility annotation: depth/mask occlusion tests, bounds checks, and the
deterministic synthetic patch occluder.

Port of mhentropy_tpu/data/occlusion.py, line for line: the reference's
visibility machinery (the heart of the weak supervision):
- HO3D depth-vs-mask test, +-5px window, 40 mm tolerance
  (ho3d_dataloader.py:360-377)
- post-augmentation out-of-bounds demotion (:389-402)
- RHD depth occlusion check and within-bounds check
  (rhddataloader.py:272-310)
- deterministic circular patch occlusion keyed by sample index
  (rhddataloader.py:331-404)

All tests are vectorised window reductions instead of nested per-joint pixel
loops.

3-state visibility encoding (rhddataloader.py:169-173):
    0 = patch/depth occluded, 1 = visible, 2 = out of bounds.
"""

from __future__ import annotations

import numpy as np


def _window_offsets(quant: int):
    r = np.arange(-quant + 1, quant)
    dv, du = np.meshgrid(r, r, indexing="ij")
    return du.ravel(), dv.ravel()


def depth_mask_visibility(
    uvd: np.ndarray,
    hand_mask: np.ndarray,
    depth_m: np.ndarray,
    quant: int = 5,
    tol_mm: float = 40.0,
) -> np.ndarray:
    """HO3D visibility: a joint is visible if some hand-mask pixel within a
    +-quant window has depth within tol_mm in front of the joint
    (ho3d_dataloader.py:360-377; the reference's condition is signed:
    d_joint - d_pixel*1000 < tol).

    Args:
        uvd: (K, 3) pixel coords + depth in mm.
        hand_mask: (H, W) bool.
        depth_m: (H, W) depth in metres.

    Returns:
        (K,) bool.
    """
    from mhentropy_tpu_torch.data.transforms import _hostops

    ho = _hostops()
    if ho:
        # The C++ host op (native/hostops.cc), held to the numpy body by
        # tests/test_native_hostops.py.
        return ho.depth_mask_visibility(uvd, hand_mask, depth_m,
                                        quant=quant, tol_mm=tol_mm)
    return _depth_mask_visibility_np(uvd, hand_mask, depth_m, quant, tol_mm)


def _depth_mask_visibility_np(uvd, hand_mask, depth_m, quant, tol_mm):
    h, w = hand_mask.shape
    du, dv = _window_offsets(quant)
    u = uvd[:, 0].astype(int)[:, None] + du[None]
    v = uvd[:, 1].astype(int)[:, None] + dv[None]
    in_bounds = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    uc, vc = np.clip(u, 0, w - 1), np.clip(v, 0, h - 1)
    on_hand = hand_mask[vc, uc] & in_bounds
    close = (uvd[:, 2:3] - depth_m[vc, uc] * 1000.0) < tol_mm
    return np.any(on_hand & close, axis=1)


def check_wib(uv: np.ndarray, shape, quant: int = 1) -> np.ndarray:
    """Within-bounds check: any window pixel inside the image
    (rhddataloader.py:272-285; note the reference probes (round(v), round(u))
    against (shape[1], shape[0]) — equivalent on square crops)."""
    du, dv = _window_offsets(quant)
    x = np.round(uv[:, 1]).astype(int)[:, None] + du[None]
    y = np.round(uv[:, 0]).astype(int)[:, None] + dv[None]
    ok = (x >= 0) & (x <= shape[1] - 1) & (y >= 0) & (y <= shape[0] - 1)
    return np.any(ok, axis=1).astype(np.float32)


def check_occlusion(
    uv: np.ndarray,
    depthmap: np.ndarray,
    pose3d: np.ndarray,
    delta: float = 0.1,
    quant: int = 1,
) -> np.ndarray:
    """RHD depth-agreement visibility: some window pixel's depth within delta
    of the joint depth (rhddataloader.py:288-310).

    Args:
        uv: (K, 2) pixel coords; depthmap (H, W) metres; pose3d (K, 3) camera
        coords (z used).

    Replicated quirk (like check_wib's): the reference's in-bounds test
    swaps width/height (row vs w, col vs h) — exact only on SQUARE
    depthmaps (RHD is 320x320). The clip below keeps non-square inputs
    crash-free where the reference would IndexError, but the test
    semantics off the square case are the reference's, not corrected.
    """
    h, w = depthmap.shape
    du, dv = _window_offsets(quant)
    row = np.round(uv[:, 1]).astype(int)[:, None] + du[None]
    col = np.round(uv[:, 0]).astype(int)[:, None] + dv[None]
    in_bounds = (row >= 0) & (row <= w - 1) & (col >= 0) & (col <= h - 1)
    rc, cc = np.clip(row, 0, h - 1), np.clip(col, 0, w - 1)
    close = np.abs(depthmap[rc, cc] - pose3d[:, 2:3]) <= delta
    return np.any(in_bounds & close, axis=1).astype(np.float32)


PATCH_KP_CYCLE = (2, 6, 10, 14, 18)  # rhddataloader.py:347-349


def patch_occlusion(
    image_crop: np.ndarray,
    crop_uv: np.ndarray,
    idx: int,
    size: int = 50,
    vis: np.ndarray | None = None,
    copy: bool = True,
):
    """Deterministic circular occluder centred on keypoint
    PATCH_KP_CYCLE[idx % 5]: zeroes the pixels, demotes covered joints to
    vis=0 (rhddataloader.py:331-404, rnd_patchtype=1 circle branch).

    Returns:
        (occluded image, vis, (cx, cy, r, occluder mask)).
    """
    k_idx = PATCH_KP_CYCLE[idx % len(PATCH_KP_CYCLE)]
    cx, cy = crop_uv[k_idx].astype(int)
    r = size
    from mhentropy_tpu_torch.data import common

    # The circle only touches its bounding box — build the full-frame mask
    # from a windowed test, not by full-frame boolean indexing.
    h, w = image_crop.shape[:2]
    y0, y1 = max(cy - r, 0), min(cy + r + 1, h)
    x0, x1 = max(cx - r, 0), min(cx + r + 1, w)
    occ_img = np.zeros((h, w), bool)
    # copy=False lets a caller that owns a freshly-materialized crop
    # (e.g. RHDDataset.__getitem__) take the occlusion in place.
    out = image_crop.copy() if copy else image_crop
    if y0 < y1 and x0 < x1:
        yy, xx = common.grid2d(y1 - y0, x1 - x0)
        win = ((xx + x0 - cx) ** 2 + (yy + y0 - cy) ** 2) <= r * r
        occ_img[y0:y1, x0:x1] = win
        out[y0:y1, x0:x1][win] = 0
    occ_kp = (crop_uv[:, 0] - cx) ** 2 + (crop_uv[:, 1] - cy) ** 2 <= r * r
    vis = vis.copy() if vis is not None else np.ones(crop_uv.shape[0], np.float32)
    vis[occ_kp] = 0.0
    return out, vis, (cx, cy, r, occ_img.astype(np.float32))


def demote_out_of_bounds(vis: np.ndarray, uv: np.ndarray, shape, quant: int = 2):
    """vis==1 joints that left the crop become vis=2 (rhddataloader.py:168-173,
    ho3d_dataloader.py:389-402)."""
    wib = check_wib(uv, shape, quant=quant)
    vis = vis.copy()
    vis[np.logical_and(vis == 1.0, wib == 0.0)] = 2.0
    return vis
