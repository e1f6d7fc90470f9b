"""Host-side preprocessing toolbox (numpy/cv2), shared by the dataset loaders.

Port of mhentropy_tpu/data/transforms.py, line for line: the reference's
preprocessing (ho3d_dataloader.py:32-198, dataPreprocess/preprocess.py,
dataPreprocess/augment.py, dataset_transforms.py) as vectorised numpy.
cv2 where it imports; otherwise the crops and warps go through the native
host ops (native/hostops.py, ctypes), and warp_image raises without both.
"""

from __future__ import annotations

import math

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from scipy.linalg import orthogonal_procrustes

# HO3D hand-frame convention: OpenGL coords, hand along -z
# (ho3d_dataloader.py:32-36).
COORD_CHANGE = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)


def coord_change(xyz: np.ndarray) -> np.ndarray:
    return xyz @ COORD_CHANGE.T


def xyz2uvd_gl(xyz: np.ndarray, k: np.ndarray) -> np.ndarray:
    """OpenGL-coord xyz -> pixel uvd (ho3d_dataloader.py:74-81)."""
    p = coord_change(xyz)
    fx, fy, fu, fv = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    uvd = np.empty_like(p, dtype=np.float32)
    uvd[:, 0] = p[:, 0] * fx / p[:, 2] + fu
    uvd[:, 1] = p[:, 1] * fy / p[:, 2] + fv
    uvd[:, 2] = p[:, 2]
    return uvd


def uvd2xyz_gl(uvd: np.ndarray, k: np.ndarray) -> np.ndarray:
    fx, fy, fu, fv = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    xyz = np.empty_like(uvd, dtype=np.float32)
    xyz[:, 0] = (uvd[:, 0] - fu) * uvd[:, 2] / fx
    xyz[:, 1] = (uvd[:, 1] - fv) * uvd[:, 2] / fy
    xyz[:, 2] = uvd[:, 2]
    return coord_change(xyz)


def xyz2uvd_cv(xyz: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Camera-coord xyz (metres) -> pixel uvd (preprocess.py:150-162)."""
    fx, fy, fu, fv = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    uvd = np.empty_like(xyz, dtype=np.float32)
    z = xyz[:, 2] + 1e-16
    uvd[:, 0] = xyz[:, 0] * fx / z + fu
    uvd[:, 1] = xyz[:, 1] * fy / z + fv
    uvd[:, 2] = xyz[:, 2]
    return uvd


def uvd2xyz_cv(uvd: np.ndarray, k: np.ndarray) -> np.ndarray:
    fx, fy, fu, fv = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    xyz = np.empty_like(uvd, dtype=np.float32)
    xyz[:, 0] = (uvd[:, 0] - fu) * uvd[:, 2] / fx
    xyz[:, 1] = (uvd[:, 1] - fv) * uvd[:, 2] / fy
    xyz[:, 2] = uvd[:, 2]
    return xyz


# --------------------------------------------------------------------- bboxes


def bbox_from_joints(joints2d: np.ndarray, factor: float = 1.1) -> np.ndarray:
    """(xmin, ymin, xmax, ymax) around keypoints (ho3d_dataloader.py:84-95)."""
    lo, hi = joints2d.min(0), joints2d.max(0)
    centre = ((hi + lo) / 2).astype(int).astype(np.float32)
    delta = (hi - lo) * factor / 2
    return np.array([*(centre - delta), *(centre + delta)], np.float32)


def fuse_bbox(bbox_1, bbox_2, img_shape, scale_factor: float = 1.0):
    """Square crop covering both boxes (ho3d_dataloader.py:97-112)."""
    pts = np.concatenate([np.reshape(bbox_1, (2, 2)), np.reshape(bbox_2, (2, 2))])
    lo = np.maximum(pts.min(0), 0.0)
    hi = np.minimum(pts.max(0), [img_shape[0], img_shape[1]])
    centre = ((hi + lo) / 2).astype(int).astype(np.float32)
    scale = float((hi - lo).max()) * scale_factor
    return centre, scale


def crop_with_padding(img: np.ndarray, centre, half_size, pad_rgb=127):
    """Square crop, constant-padding out-of-frame regions
    (ho3d_dataloader.py:114-143)."""
    x1 = int(np.round(centre[0] - half_size))
    y1 = int(np.round(centre[1] - half_size))
    x2 = int(np.round(centre[0] + half_size))
    y2 = int(np.round(centre[1] + half_size))
    h, w = img.shape[:2]
    pad_l, pad_t = max(0, -x1), max(0, -y1)
    pad_r, pad_b = max(0, x2 - w), max(0, y2 - h)
    if pad_l or pad_t or pad_r or pad_b:
        # Honor pad_rgb for ANY rank (a 2-D branch hardcoding 0 made the
        # native and fallback crop paths pad differently for masks when
        # a caller relied on the 127 default).
        pad_spec = [(pad_t, pad_b), (pad_l, pad_r)] + [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pad_spec, constant_values=pad_rgb)
        x1, x2 = x1 + pad_l, x2 + pad_l
        y1, y2 = y1 + pad_t, y2 + pad_t
    return img[y1:y2, x1:x2]


_HOSTOPS = None


def _hostops():
    """Native host-op library (native/hostops.cc), lazily loaded."""
    global _HOSTOPS
    if _HOSTOPS is None:
        try:
            from native import hostops

            _HOSTOPS = hostops if hostops.available() else False
        except Exception:
            _HOSTOPS = False
    return _HOSTOPS


def crop_resize(img: np.ndarray, centre, half, size: int, pad=127.0) -> np.ndarray:
    """Fused padded-crop + nearest-resize; native fast path when built."""
    ho = _hostops()
    if ho:
        return ho.crop_resize_nearest(img, centre, half, size, pad_value=pad)
    return resize_nearest(crop_with_padding(img, centre, half, pad_rgb=pad), size)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    if cv2 is not None:
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_NEAREST)
    ys = (np.arange(size) * img.shape[0] / size).astype(int)
    xs = (np.arange(size) * img.shape[1] / size).astype(int)
    return img[ys][:, xs]


# ---------------------------------------------------------------- pose utils


def normalize_pose3d_np(pose3d: np.ndarray, root_idx: int, norm_idx: int):
    """Root-relative + bone-normalised (preprocess.py:280-284)."""
    root = pose3d[root_idx]
    rel = pose3d - root
    bone = float(np.sqrt(np.sum((rel[root_idx] - rel[norm_idx]) ** 2)))
    return rel / bone, root, bone


def compute_st_np(pose3d: np.ndarray, crop_uv: np.ndarray) -> np.ndarray:
    """Orthographic (s, t) fit (rhddataloader.py:237-269) on host."""
    p = pose3d.reshape(-1, 3)[:, :2]
    uv = crop_uv.reshape(-1, 2)
    t1, t2 = uv.mean(0), p.mean(0)
    a, b = uv - t1, p - t2
    s1 = np.linalg.norm(a) + 1e-8
    s2 = np.linalg.norm(b) + 1e-8
    _, s = orthogonal_procrustes(a / s1, b / s2)
    t = -t2 / s2 * s * s1 + t1
    return np.concatenate([[s * s1 / s2], t]).astype(np.float32)


# ------------------------------------------------------------- augmentation


def make_aug_params(rng: np.random.RandomState, trans_std: float = 10.0):
    """Scale U(0.8,1.0), full 2pi rotation, clipped normal translation
    (ho3d_dataloader.py:162-198 uses std 10, augment.py:59-60 uses 22)."""
    return {
        "scale": rng.uniform(0.8, 1.0),
        "angle": 2.0 * math.pi * rng.rand(),
        "tx": float(np.clip(rng.normal(0.0, trans_std), -40.0, 40.0)),
        "ty": float(np.clip(rng.normal(0.0, trans_std), -40.0, 40.0)),
    }


def aug_rot_mat(params: dict, size: int = 256) -> np.ndarray:
    """2x3 affine for the image (rotation about the crop centre + scale +
    translation), matching cv2.getRotationMatrix2D semantics."""
    c = size / 2.0
    a = params["angle"]
    s = params["scale"]
    # cv2.getRotationMatrix2D(center, -deg(angle), scale): note image-space
    # y-down means -angle in cv2 == +angle in math convention below.
    cos, sin = s * math.cos(a), s * math.sin(a)
    m = np.array(
        [[cos, -sin, (1 - cos) * c + sin * c + params["tx"]],
         [sin, cos, (1 - cos) * c - sin * c + params["ty"]]],
        np.float32,
    )
    return m


def rotate_xy(points: np.ndarray, angle: float) -> np.ndarray:
    """Rotate xy coords about the origin (augment.py:13-25); z untouched."""
    out = points.copy()
    c, s = math.cos(angle), math.sin(angle)
    x, y = points[:, 0].copy(), points[:, 1].copy()
    out[:, 0] = c * x - s * y
    out[:, 1] = s * x + c * y
    return out


def apply_affine_uv(uv: np.ndarray, m: np.ndarray) -> np.ndarray:
    ones = np.ones((uv.shape[0], 1), uv.dtype)
    return np.concatenate([uv, ones], 1) @ m.T


def warp_image(img: np.ndarray, m: np.ndarray, size: int = 256, border=0.0,
               linear: bool = False):
    # cv2's SIMD fixed-point warp is faster than the scalar native kernel;
    # the native path is the cv2-absent fallback. linear=True matches the reference's heatmap
    # warp (augment.py:67, INTER_LINEAR); the nearest fallback is the
    # cv2-absent approximation for those smooth Gaussian targets.
    if cv2 is not None:
        flags = cv2.INTER_LINEAR if linear else cv2.INTER_NEAREST
        return cv2.warpAffine(
            img, m, (size, size), flags=flags, borderValue=border
        )
    ho = _hostops()
    if ho:  # pragma: no cover — exercised only when cv2 is absent
        out = ho.warp_affine_nearest(img, np.asarray(m, np.float32), size,
                                     border=float(border))
        # cv2.warpAffine preserves the input dtype; keep the fallback's
        # contract identical (nearest warp copies pixels, so the cast back
        # from the kernel's float32 output is exact for integer sources).
        return out if out.dtype == img.dtype else out.astype(img.dtype)
    raise RuntimeError("cv2 or native hostops required for image warping")


def pixel_noise_params(rng: np.random.RandomState, factor=0.4) -> np.ndarray:
    """The (3,) per-channel multiplicative draw of `pixel_noise`, exposed so
    uint8-transport loaders can consume the SAME rng-stream position and ship
    the factors for device-side application (engine._prep_image applies
    clip(u8 * pn, 0, 255) before normalisation — pointwise, so it commutes
    exactly with the nearest-gather warp that follows the host-side apply)."""
    # f32 noise: a float64 pn promoted every augmented image to f64 for
    # the rest of the host chain (2x the pixel bytes on the tracked
    # imgs/s/core bottleneck).
    return rng.uniform(1 - factor, 1 + factor, 3).astype(np.float32)


def pixel_noise(rng: np.random.RandomState, rgb: np.ndarray, factor=0.4):
    """Channel-wise multiplicative pixel noise (ho3d_dataloader.py:191-198)."""
    pn = pixel_noise_params(rng, factor)
    return np.clip(rgb * pn[None, None, :], 0.0, 255.0)


def flip_left_to_right(image, uv, pose3d, masks=(), size: int = 256):
    """Left-hand mirror (augment.py:31-40)."""
    image = image[:, ::-1].copy()
    uv = uv.copy()
    uv[:, 0] = (size - 1) - uv[:, 0]
    pose3d = pose3d.copy()
    pose3d[:, 0] = -pose3d[:, 0]
    masks = tuple(m[:, ::-1].copy() for m in masks)
    return image, uv, pose3d, masks


# -------------------------------------------------------------- batch adapter


def target_transform(data: tuple, dataset_name: str):
    """Normalise per-dataset batch tuples to the common target dict
    (dataset_transforms.py:4-36), including the RLE coco / human3.6m
    branches."""
    if dataset_name in ("rhd", "freihand", "ho3d", "mixed_ho3d_rhd", "synthetic"):
        image, target = data
        target = dict(target)
        target["target_uvd_weight"] = np.ones_like(target["pose3d"])
    elif dataset_name == "coco":
        # (dataset_transforms.py:15-18)
        image, src, _, bboxes = data
        target = {
            "crop_uv": np.asarray(src["target_uv"]),
            "target_uv_weight": np.asarray(src["target_uv_weight"]),
        }
    elif dataset_name == "human3.6m":
        # (dataset_transforms.py:19-33)
        image, src, _, bboxes = data
        b = np.asarray(image).shape[0]
        pose3d = np.asarray(src["target_xyz"])
        uvd = np.asarray(src["target_uvd"]).reshape(b, -1, 3)
        uvd_w = np.asarray(src["target_uvd_weight"])
        vis = uvd_w.reshape(b, -1, 3)[..., 0].copy()
        vis[vis == 0] = 2
        target = {
            "pose3d": pose3d,
            "target_uvd_weight": uvd_w,
            "scale": np.ones(pose3d.shape[0], np.float32),
            "crop_uv": uvd[..., :2].reshape(b, -1),
            "vis": vis,
            "st": np.asarray(src["st"]),
            "st_cam": np.asarray(src["st_cam"]),
            "action": np.asarray(src["action"]),
            "pose3d_root": np.asarray(src["root_xyz"]),
        }
    else:
        raise NotImplementedError(dataset_name)
    # The collator's tail-padding mask must survive the rebuild in the
    # coco/h36m branches, or padded duplicates double-count in metrics.
    if len(data) > 1 and isinstance(data[1], dict) and "valid" in data[1] \
            and "valid" not in target:
        target["valid"] = np.asarray(data[1]["valid"])
    target["image"] = image
    return image, target
