"""SK (stereo hand benchmark) preprocessing + ColorHandPose3D canonical frame.

Port of mhentropy_tpu/data/sk.py (:38-267), on the port's
`data/rhd.py::view_correction` helpers (`rot_x`, `rot_y`,
`depth_to_cloud`, `gaussian_heatmaps`) and `data/common.py::grid2d`. The
JAX module's counterparts of the reference's shipped-but-orphaned modules
(never imported by its trainer):
  - hand/dataloader/dataPreprocess/canonical_trafo.py:96-162
    (canonical_trafo, flip_right_hand)
  - hand/dataloader/dataPreprocess/preprocessingSK.py:57-326
    (viewCorrection, imcrop, depth2mask, convert_kp, preprocessSampleSK)

Host-side numpy (cv2 for the crops' padding and resizes, imported where
used). The reference's defects that the JAX module handles rather than
replicates are handled the same way here:
  - `_stitch_mat_from_vecs` hardcodes batch_size=1 (canonical_trafo.py:52);
    the rotation matrices here are batched.
  - `flip_right_hand` calls the TensorFlow `.get_shape()` on numpy arrays
    (canonical_trafo.py:148) and crashes on any input; `.shape` here.
  - `depth2mask` zeroes its crop window with raw negative indices
    (preprocessingSK.py:164-167), which wipes almost the whole mask when the
    crop overruns the top/left edge; the window is clamped here.
"""

from __future__ import annotations

import numpy as np

from mhentropy_tpu_torch.data import common, rhd

# SK annotation order -> RHD-style order: wrist stays, fingers reverse
# (preprocessingSK.py:215-225).
_SK_KP_PERM = np.array([0] + list(range(20, 0, -1)))

# RealSense F200 working range in mm (preprocessingSK.py:297).
SK_DEPTH_RANGE_MM = (400.0, 650.0)


def _atan2(y, x):
    """The reference's arctan quadrant-corrected atan2 (canonical_trafo.py:
    21-38) equals the standard atan2 with its 1e-8 guard on x."""
    return np.arctan2(y, x + 1e-8)


def _rot_z(a):
    """Batched (B,3,3), row-major layout of canonical_trafo.py:86-93 (the
    transpose of the standard Rz, applied as coords @ R)."""
    c, s, z, o = np.cos(a), np.sin(a), np.zeros_like(a), np.ones_like(a)
    return np.stack(
        [c, s, z, -s, c, z, z, z, o], axis=-1
    ).reshape(*a.shape, 3, 3)


def _rot_x(a):
    c, s, z, o = np.cos(a), np.sin(a), np.zeros_like(a), np.ones_like(a)
    return np.stack(
        [o, z, z, z, c, s, z, -s, c], axis=-1
    ).reshape(*a.shape, 3, 3)


def _rot_y(a):
    c, s, z, o = np.cos(a), np.sin(a), np.zeros_like(a), np.ones_like(a)
    return np.stack(
        [c, z, -s, z, o, z, s, z, c], axis=-1
    ).reshape(*a.shape, 3, 3)


def canonical_trafo(coords_xyz):
    """Rotate 21-keypoint hands into the ColorHandPose3D canonical frame
    (canonical_trafo.py:96-137): root (kp 0) at the origin, middle-finger
    MCP (kp 12) on the -y axis, pinky MCP (kp 20) fixing the y-rotation.

    Args:
        coords_xyz: (..., 21, 3).

    Returns:
        (coords_canonical (B, 21, 3), total_rot (B, 3, 3)) with
        coords_canonical = (coords - root) @ total_rot. Properly batched
        (the reference only works at B=1).
    """
    coords = np.reshape(np.asarray(coords_xyz, np.float64), (-1, 21, 3))
    t = coords - coords[:, :1]

    p = t[:, 12]
    rot = _rot_z(_atan2(p[:, 0], p[:, 1]))
    t = t @ rot
    total = rot

    p = t[:, 12]
    rot = _rot_x(-_atan2(p[:, 2], p[:, 1]) + np.pi)
    t = t @ rot
    total = total @ rot

    p = t[:, 20]
    rot = _rot_y(_atan2(p[:, 2], p[:, 0]))
    return t @ rot, total @ rot


def flip_right_hand(coords_xyz_canonical, cond_right):
    """Mirror canonical coords across the xy-plane where cond_right, so every
    hand is represented as a left hand (canonical_trafo.py:140-162, with its
    TF .get_shape() crash fixed)."""
    coords = np.asarray(coords_xyz_canonical)
    expanded = coords.ndim == 2
    if expanded:
        coords = coords[None]
        cond_right = np.expand_dims(cond_right, 0)
    cond = np.asarray(cond_right)
    if cond.ndim == 1 and cond.shape[0] == coords.shape[0]:
        cond = cond[:, None, None]  # per-sample flags broadcast over (N, 3)
    mirrored = np.concatenate([coords[..., :2], -coords[..., 2:]], -1)
    out = np.where(cond, mirrored, coords)
    return out[0] if expanded else out


def convert_kp(keypoints):
    """SK keypoint order -> RHD-style order (preprocessingSK.py:215-225)."""
    return np.asarray(keypoints)[_SK_KP_PERM]


def imcrop(img, center, crop_size):
    """Square crop of half-width crop_size around center, constant-padded
    when it overruns the image (preprocessingSK.py:74-103)."""
    import cv2

    x1 = int(np.round(center[0] - crop_size))
    y1 = int(np.round(center[1] - crop_size))
    x2 = int(np.round(center[0] + crop_size))
    y2 = int(np.round(center[1] + crop_size))
    if x1 < 0 or y1 < 0 or x2 > img.shape[1] or y2 > img.shape[0]:
        fill = [0] if img.ndim < 3 else [127, 127, 127]
        img = cv2.copyMakeBorder(
            img, -min(0, y1), max(y2 - img.shape[0], 0),
            -min(0, x1), max(x2 - img.shape[1], 0),
            cv2.BORDER_CONSTANT, value=fill,
        )
        x2 += -min(0, x1)
        x1 += -min(0, x1)
        y2 += -min(0, y1)
        y1 += -min(0, y1)
    return img[y1:y2, x1:x2]


def depth2mask(depth, threshold, center, crop_size):
    """Boolean hand mask: inside the crop window and inside the depth working
    range (preprocessingSK.py:151-167)."""
    lo, hi = threshold
    h, w = depth.shape
    x1 = int(np.round(center[0] - crop_size))
    y1 = int(np.round(center[1] - crop_size))
    x2 = int(np.round(center[0] + crop_size))
    y2 = int(np.round(center[1] + crop_size))
    v, u = common.grid2d(h, w)
    window = (u >= max(x1, 0)) & (u < x2) & (v >= max(y1, 0)) & (v < y2)
    return window & (depth >= lo) & (depth <= hi)


def view_correction_sk(crop_center, cam, cloud, joints):
    """SK view correction (preprocessingSK.py:57-72). Differs from the RHD
    variant (rhd.view_correction) in using the true principal point v0 for
    the y-coordinate (the RHD reference assumes u0 == v0)."""
    f, u0, v0 = cam[0, 0], cam[0, 2], cam[1, 2]
    ay = np.arctan((crop_center[0] - u0) / f)
    c3d = np.array([crop_center[0] - u0, crop_center[1] - v0, f])
    c3d = c3d @ rhd.rot_y(-ay).T
    ax = np.arctan(c3d[1] / c3d[2])
    rot = rhd.rot_x(ax) @ rhd.rot_y(-ay)
    return rot, cloud @ rot.T, joints @ rot.T


def preprocess_sample_sk(
    image, depth, kp_coord_xyz, cam_rgb, cam_depth, rotation, translation,
    rng=None,
):
    """Full SK stereo sample preprocessing (preprocessingSK.py:227-326):
    project the mm-scale 3D annotation into both the RGB and depth views,
    reorder keypoints, synthesise the RHD-style wrist, root-relative
    bone-normalise, crop both images, lift the masked depth to a normalised
    point cloud, view-correct, and rasterise 64px heatmaps.

    Args:
        image: (H, W, 3) uint8 RGB. depth: (H, W) mm. kp_coord_xyz: (3, 21)
        mm in the depth-camera frame. cam_rgb/cam_depth: 3x3 intrinsics.
        rotation/translation: depth->RGB extrinsics (3,3) / (3,1).

    Returns a dict: image_crop (256², uint8), depth_crop (256², mm),
    cloud/pose3d (+ the view-corrected _vc pair, bone-normalised),
    view_rot, scale (m), hand_side (all left: [1, 0]), heatmaps (64,64,21).
    """
    import cv2

    uv_rgb = (cam_rgb @ (rotation.T @ (kp_coord_xyz - translation))).T
    uv_depth = (cam_depth @ kp_coord_xyz).T
    xyz = convert_kp(kp_coord_xyz.T) / 1000.0
    uv_rgb = convert_kp(uv_rgb)
    uv_depth = convert_kp(uv_depth)
    uv_rgb = uv_rgb / uv_rgb[:, 2:]
    uv_depth = uv_depth / uv_depth[:, 2:]
    # After the perspective divide z == 1 except for degenerate points
    # (preprocessingSK.py:248).
    vis = np.equal(uv_rgb[:, 2], 1.0) & np.equal(uv_depth[:, 2], 1.0)
    uv_rgb, uv_depth = uv_rgb[:, :2], uv_depth[:, :2]

    # RHD-style wrist from palm + first annotated point
    # (preprocessingSK.py:253-266).
    xyz = np.concatenate([(xyz[16] + 2.0 * (xyz[0] - xyz[16]))[None], xyz[1:]])
    vis = np.concatenate([[vis[16] | vis[0]], vis[1:]])
    uv_rgb = np.concatenate(
        [(uv_rgb[16] + 2.0 * (uv_rgb[0] - uv_rgb[16]))[None], uv_rgb[1:]]
    )
    uv_depth = np.concatenate(
        [(uv_depth[16] + 2.0 * (uv_depth[0] - uv_depth[16]))[None], uv_depth[1:]]
    )

    root = xyz[12]
    rel = xyz - root
    scale = np.sqrt(np.sum((rel[12] - rel[11]) ** 2))
    pose3d_normed = rel / scale

    def _crop_geometry(uv):
        center = uv[12]
        half = np.max(np.abs(uv[vis] - center))
        return center, float(np.clip(half, 25.0, 200.0))

    center_rgb, half_rgb = _crop_geometry(uv_rgb)
    center_depth, half_depth = _crop_geometry(uv_depth)
    image_crop = cv2.resize(
        imcrop(image, center_rgb, half_rgb), (256, 256),
        interpolation=cv2.INTER_NEAREST,
    )
    depth_crop = cv2.resize(
        imcrop(depth, center_depth, half_depth), (256, 256),
        interpolation=cv2.INTER_NEAREST,
    )

    mask = depth2mask(depth, SK_DEPTH_RANGE_MM, center_depth, half_depth)
    # rhd.depth_to_cloud works in metres; mm depth / intrinsics scale
    # linearly, reproducing preprocessingSK.py:116-149's mm->m conversion.
    cloud = rhd.depth_to_cloud(
        depth / 1000.0, mask, root, cam_depth, cloud_size=4000, rng=rng
    )
    cloud_normed = (cloud - root) / scale

    view_rot, cloud_vc, pose3d_vc = view_correction_sk(
        center_depth, cam_depth, cloud, xyz
    )
    cloud_vc_normed = (cloud_vc - pose3d_vc[12]) / scale
    pose3d_vc_normed = (pose3d_vc - pose3d_vc[12]) / scale

    heat_size = 64
    crop_scale = heat_size / (half_rgb * 2.0)
    uv_heat = (uv_rgb - center_rgb) * crop_scale + heat_size // 2
    heatmaps = rhd.gaussian_heatmaps(uv_heat, heat_size, vis, sigma=6.0)

    return {
        "image_crop": image_crop,
        "depth_crop": np.float32(depth_crop),
        "cloud": np.float32(cloud_normed),
        "pose3d": np.float32(pose3d_normed),
        "cloud_vc": np.float32(cloud_vc_normed),
        "pose3d_vc": np.float32(pose3d_vc_normed),
        "view_rot": np.float32(view_rot),
        "scale": np.float32(scale),
        "hand_side": np.float32([1.0, 0.0]),
        "heatmaps": heatmaps,
    }
