"""RLE human-pose data stack: COCO-format dataset, affine crop transforms,
heatmap / integral targets, and coordinate decode.

Port of mhentropy_tpu/data/pose_pipeline.py (:38-1076), on the port's
`data/transforms.py::compute_st_np` and `data/common.py::item_rng`:
  * affine geometry + heatmap decode     (the reference's hand/utils.py:
    373-498, hand/dataloader/dataPreprocess/transforms.py:102-472)
  * bbox helpers                         (dataPreprocess/bbox.py:43-254)
  * SimpleTransform :674 / SimpleTransform3D :773 (dataPreprocess/
    simple_transform.py:15-276, simple_transform_3d.py:24-406)
  * camera / Procrustes utilities        (dataPreprocess/pose_utils.py:6-153)
  * PoseDataset :948, the COCO-format CustomDataset (hand/dataloader/
    custom.py:16-147), and HeatmapToCoord :1061

Host-side numpy, vectorised where the reference loops per joint. The
affine matrices are solved directly (the 3-point system
cv2.getAffineTransform solves). The crops warp with cv2 where it imports,
as the port's other loaders do; without it `_warp` raises (the bilinear
warp has no other implementation here) and `PoseDataset` decodes its
images through `common.imread`. The reference-order global RNG
(`_GlobalRng`) is kept, so a seed gives the JAX module's draws.
"""

from __future__ import annotations

import json
import math
import random

import numpy as np

from mhentropy_tpu_torch.data import common
from mhentropy_tpu_torch.data import transforms as hand_transforms

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# --------------------------------------------------------------------------
# Affine geometry (utils.py:373-478, transforms.py:102-117, 391-472)
# --------------------------------------------------------------------------


def get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [src_point[0] * cs - src_point[1] * sn,
         src_point[0] * sn + src_point[1] * cs], dtype=np.float64
    )


def get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine from 3 point pairs — the exact system
    cv2.getAffineTransform solves."""
    a = np.zeros((6, 6), dtype=np.float64)
    b = np.zeros(6, dtype=np.float64)
    for i in range(3):
        a[2 * i, 0:2] = src[i]
        a[2 * i, 2] = 1.0
        a[2 * i + 1, 3:5] = src[i]
        a[2 * i + 1, 5] = 1.0
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    x = np.linalg.solve(a, b)
    return x.reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32), inv=0,
                         align=False):
    """Crop-box -> output-patch affine (utils.py:439-473)."""
    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale])
    scale_tmp = np.asarray(scale, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float64)

    src = np.zeros((3, 2), dtype=np.float64)
    dst = np.zeros((3, 2), dtype=np.float64)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2, :] = get_3rd_point(src[0], src[1])
    dst[2, :] = get_3rd_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform(pt, t):
    """Apply a 2x3 affine to points (..., 2) (utils.py:476-479), vectorised
    over any leading dims."""
    pt = np.asarray(pt, dtype=np.float64)
    return pt @ t[:, :2].T + t[:, 2]


def transform_preds(coords, center, scale, output_size):
    """Patch coords -> original image coords (utils.py:432-436), vectorised
    over (..., 2)."""
    trans = get_affine_transform(center, scale, 0, output_size, inv=1)
    return affine_transform(np.asarray(coords, dtype=float), trans)


def heatmap_to_coord(pred_jts, pred_scores, hm_shape, bbox, output_3d=False):
    """Normalised integral coords -> original-image coords
    (utils.py:390-429), vectorised over (B, K, D).

    bbox: (xmin, ymin, xmax, ymax).
    """
    hm_height, hm_width = hm_shape[0] * 4, hm_shape[1] * 4
    coords = np.asarray(pred_jts, dtype=float)
    scores = np.asarray(pred_scores, dtype=float)
    squeeze = coords.ndim == 2
    if squeeze:
        coords, scores = coords[None], scores[None]
    coords = coords.copy()
    coords[:, :, 0] = (coords[:, :, 0] + 0.5) * hm_width
    coords[:, :, 1] = (coords[:, :, 1] + 0.5) * hm_height

    xmin, ymin, xmax, ymax = bbox
    w, h = xmax - xmin, ymax - ymin
    center = np.array([xmin + w * 0.5, ymin + h * 0.5])
    scale = np.array([w, h])
    preds = np.zeros_like(coords)
    preds[..., 0:2] = transform_preds(
        coords[..., 0:2], center, scale, [hm_width, hm_height]
    )
    if output_3d:
        preds[..., 2] = coords[..., 2]
    return preds, scores


def get_max_pred(heatmaps):
    """(K, H, W) -> argmax coords (K, 2) + maxvals (K, 1)
    (transforms.py:346-365), vectorised."""
    k, h, w = heatmaps.shape
    flat = heatmaps.reshape(k, -1)
    idx = flat.argmax(1)
    maxvals = flat.max(1).reshape(k, 1)
    preds = np.stack([idx % w, idx // w], axis=1).astype(np.float32)
    preds = preds * (maxvals > 0)
    return preds, maxvals


def get_max_pred_batch(batch_heatmaps):
    b, k, h, w = batch_heatmaps.shape
    flat = batch_heatmaps.reshape(b, k, -1)
    idx = flat.argmax(2)
    maxvals = flat.max(2)[..., None]
    preds = np.stack([idx % w, idx // w], axis=2).astype(np.float32)
    preds = preds * (maxvals > 0)
    return preds, maxvals


def heatmap_to_coord_simple(hms, bbox, **kwargs):
    """Argmax heatmap decode with quarter-pixel refinement
    (transforms.py:268-299)."""
    coords, maxvals = get_max_pred(hms)
    hm_h, hm_w = hms.shape[1], hms.shape[2]

    # Quarter-offset toward the higher neighbour.
    for p in range(coords.shape[0]):
        hm = hms[p]
        px = int(round(float(coords[p][0])))
        py = int(round(float(coords[p][1])))
        if 1 < px < hm_w - 1 and 1 < py < hm_h - 1:
            diff = np.array(
                (hm[py][px + 1] - hm[py][px - 1],
                 hm[py + 1][px] - hm[py - 1][px])
            )
            coords[p] += np.sign(diff) * 0.25

    xmin, ymin, xmax, ymax = bbox
    w, h = xmax - xmin, ymax - ymin
    center = np.array([xmin + w * 0.5, ymin + h * 0.5])
    scale = np.array([w, h])
    preds = transform_preds(coords, center, scale, [hm_w, hm_h]).astype(
        np.float32
    )
    return preds[None], maxvals[None]


def get_warpmatrix(theta, size_input, size_dst, size_target,
                   pixel_std=1.0):
    """(transforms.py:428-443): rotation/scale warp in target coords,
    the reference's rotation sense and pixel_std scaling."""
    size_target = np.asarray(size_target, np.float64) * pixel_std
    theta = theta / 180.0 * math.pi
    m = np.zeros((2, 3), dtype=np.float32)
    scale_x = size_target[0] / size_dst[0]
    scale_y = size_target[1] / size_dst[1]
    m[0, 0] = math.cos(theta) * scale_x
    m[0, 1] = math.sin(theta) * scale_y
    m[0, 2] = (
        -0.5 * size_target[0] * math.cos(theta)
        - 0.5 * size_target[1] * math.sin(theta) + 0.5 * size_input[0]
    )
    m[1, 0] = -math.sin(theta) * scale_x
    m[1, 1] = math.cos(theta) * scale_y
    m[1, 2] = (
        0.5 * size_target[0] * math.sin(theta)
        - 0.5 * size_target[1] * math.cos(theta) + 0.5 * size_input[1]
    )
    return m


def get_warpmatrix_inverse(theta, size_input, size_dst, size_target):
    """(transforms.py:446-465), including the reference's *200 box
    scaling."""
    size_target = np.asarray(size_target, np.float64) * 200.0
    theta = theta / 180.0 * math.pi
    m = np.zeros((2, 3), dtype=np.float32)
    scale_x = size_dst[0] / size_target[0]
    scale_y = size_dst[1] / size_target[1]
    m[0, 0] = math.cos(theta) * scale_x
    m[0, 1] = -math.sin(theta) * scale_x
    m[0, 2] = scale_x * (
        -0.5 * size_input[0] * math.cos(theta)
        + 0.5 * size_input[1] * math.sin(theta) + 0.5 * size_target[0]
    )
    m[1, 0] = math.sin(theta) * scale_y
    m[1, 1] = math.cos(theta) * scale_y
    m[1, 2] = scale_y * (
        -0.5 * size_input[0] * math.sin(theta)
        - 0.5 * size_input[1] * math.cos(theta) + 0.5 * size_target[1]
    )
    return m


# --------------------------------------------------------------------------
# Bounding boxes (bbox.py:43-254)
# --------------------------------------------------------------------------


def bbox_xywh_to_xyxy(xywh):
    if isinstance(xywh, (tuple, list)):
        w = max(xywh[2] - 1, 0)
        h = max(xywh[3] - 1, 0)
        return (xywh[0], xywh[1], xywh[0] + w, xywh[1] + h)
    xywh = np.asarray(xywh)
    return np.hstack((xywh[:, :2], xywh[:, :2] + np.maximum(0, xywh[:, 2:4] - 1)))


def bbox_xyxy_to_xywh(xyxy):
    if isinstance(xyxy, (tuple, list)):
        return (xyxy[0], xyxy[1], xyxy[2] - xyxy[0] + 1, xyxy[3] - xyxy[1] + 1)
    xyxy = np.asarray(xyxy)
    return np.hstack((xyxy[:, :2], xyxy[:, 2:4] - xyxy[:, :2] + 1))


def bbox_clip_xyxy(xyxy, width, height):
    if isinstance(xyxy, (tuple, list)):
        x1 = min(width - 1, max(0, xyxy[0]))
        y1 = min(height - 1, max(0, xyxy[1]))
        x2 = min(width - 1, max(0, xyxy[2]))
        y2 = min(height - 1, max(0, xyxy[3]))
        return (x1, y1, x2, y2)
    xyxy = np.asarray(xyxy)
    return np.stack([
        np.clip(xyxy[:, 0], 0, width - 1), np.clip(xyxy[:, 1], 0, height - 1),
        np.clip(xyxy[:, 2], 0, width - 1), np.clip(xyxy[:, 3], 0, height - 1),
    ], axis=1)


def bbox_iou(bbox_a, bbox_b, offset=0):
    tl = np.maximum(bbox_a[:, None, :2], bbox_b[:, :2])
    br = np.minimum(bbox_a[:, None, 2:4], bbox_b[:, 2:4])
    area_i = np.prod(br - tl + offset, axis=2) * (tl < br).all(axis=2)
    area_a = np.prod(bbox_a[:, 2:4] - bbox_a[:, :2] + offset, axis=1)
    area_b = np.prod(bbox_b[:, 2:4] - bbox_b[:, :2] + offset, axis=1)
    return area_i / (area_a[:, None] + area_b - area_i)


def box_to_center_scale(x, y, w, h, aspect_ratio=1.0, scale_mult=1.25):
    """(bbox.py:202-219)."""
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w, h], dtype=np.float32)
    if center[0] != -1:
        scale = scale * scale_mult
    return center, scale


def center_scale_to_box(center, scale):
    """(bbox.py:222-231)."""
    w, h = scale[0], scale[1]
    xmin = center[0] - w * 0.5
    ymin = center[1] - h * 0.5
    return [xmin, ymin, xmin + w, ymin + h]


# --------------------------------------------------------------------------
# Flips (transforms.py:119-265)
# --------------------------------------------------------------------------


def flip_joints_3d(joints_3d, width, joint_pairs):
    """(K, 3, 2) horizontal flip + left/right swap (transforms.py:190-220)."""
    joints = joints_3d.copy()
    joints[:, 0, 0] = width - joints[:, 0, 0] - 1
    pairs = np.asarray(joint_pairs, dtype=int)
    if pairs.size:
        a, b = pairs[:, 0], pairs[:, 1]
        joints[a], joints[b] = joints[b].copy(), joints[a].copy()
    joints[:, :, 0] *= joints[:, :, 1]
    return joints


def flip_heatmap(heatmap, joint_pairs, shift=False):
    """(..., K, H, W) mirror + pair swap (transforms.py:152-187).

    shift=True shifts one column right (the half-pixel correction for
    test-time flips). Note the reference's torch in-place
    `out[..., 1:] = out[..., :-1]` writes overlapping memory — undefined
    behaviour that smears in practice; this implements the intended shift.
    """
    out = np.flip(np.asarray(heatmap), axis=-1).copy()
    pairs = np.asarray(joint_pairs, dtype=int)
    if pairs.size:
        idx = np.arange(out.shape[-3])
        idx[pairs[:, 0]], idx[pairs[:, 1]] = pairs[:, 1], pairs[:, 0]
        out = out[..., idx, :, :]
    if shift:
        out[..., 1:] = out[..., :-1].copy()
    return out


def flip_coord(preds, joint_pairs, width_dim, shift=False, flatten=True):
    """Flip normalised integral coords (transforms.py:223-265). preds is
    (pred_jts (B, K*3) when flatten else (B, K, D), pred_scores (B, K, 1))."""
    pred_jts, pred_scores = preds
    pred_jts = np.asarray(pred_jts).copy()
    pred_scores = np.asarray(pred_scores).copy()
    b = pred_jts.shape[0]
    if flatten:
        pred_jts = pred_jts.reshape(b, -1, 3)
    if shift:
        pred_jts[:, :, 0] = -pred_jts[:, :, 0] - 1 / (width_dim * 4)
    else:
        pred_jts[:, :, 0] = -1 / width_dim - pred_jts[:, :, 0]
    pairs = np.asarray(joint_pairs, dtype=int)
    if pairs.size:
        a, c = pairs[:, 0], pairs[:, 1]
        pred_jts[:, a], pred_jts[:, c] = (
            pred_jts[:, c].copy(), pred_jts[:, a].copy()
        )
        pred_scores[:, a], pred_scores[:, c] = (
            pred_scores[:, c].copy(), pred_scores[:, a].copy()
        )
    return pred_jts, pred_scores


def flip_output(output: dict, joint_pairs, width_dim, shift=False) -> dict:
    """Test-time flip merge (transforms.py:141-149)."""
    output = dict(output)
    if "heatmap" in output:
        output["heatmap"] = flip_heatmap(output["heatmap"], joint_pairs, shift)
    if "pred_jts" in output:
        output["pred_jts"], output["maxvals"] = flip_coord(
            (output["pred_jts"], output["maxvals"]), joint_pairs, width_dim,
            shift, flatten=False,
        )
    return output


class _GlobalRng:
    """Delegates to the module-global random/np.random streams: the
    reference's draw sources and order, so a seed gives the JAX module's
    (and the reference's) draws. PoseDataset passes a per-item
    common.item_rng instead: per-item seeding is thread-safe and
    order-independent, where the global streams would be consumed in
    thread-pool order under common.batches."""

    @staticmethod
    def uniform(a, b):
        return random.uniform(a, b)

    @staticmethod
    def random_sample():
        return random.random()

    @staticmethod
    def randn():
        return np.random.randn()

    @staticmethod
    def rand():
        return np.random.rand()


_GLOBAL_RNG = _GlobalRng()


def box_transform(bbox, sf, imgwidth, imght, train, rng=_GLOBAL_RNG):
    """Random bbox scaling (transforms.py:15-34)."""
    bbox = list(bbox)
    width = bbox[2] - bbox[0]
    ht = bbox[3] - bbox[1]
    if train:
        scale_rate = 0.25 * np.clip(rng.randn() * sf, -sf, sf)
        bbox[0] = max(0, bbox[0] - width * scale_rate / 2)
        bbox[1] = max(0, bbox[1] - ht * scale_rate / 2)
        bbox[2] = min(imgwidth, bbox[2] + width * scale_rate / 2)
        bbox[3] = min(imght, bbox[3] + ht * scale_rate / 2)
    else:
        scale_rate = 0.25
        bbox[0] = max(0, bbox[0] - width * scale_rate / 2)
        bbox[1] = max(0, bbox[1] - ht * scale_rate / 2)
        bbox[2] = min(imgwidth, max(bbox[2] + width * scale_rate / 2, bbox[0] + 5))
        bbox[3] = min(imght, max(bbox[3] + ht * scale_rate / 2, bbox[1] + 5))
    return bbox


def count_visible(bbox, joints_3d):
    """Number of joints inside a bbox (transforms.py:119-131)."""
    vis = (
        (joints_3d[:, 0, 0] > 0)
        & (joints_3d[:, 0, 0] > bbox[0])
        & (joints_3d[:, 0, 0] < bbox[2])
        & (joints_3d[:, 1, 0] > 0)
        & (joints_3d[:, 1, 0] > bbox[1])
        & (joints_3d[:, 1, 0] < bbox[3])
        & (joints_3d[:, 0, 1] > 0)
        & (joints_3d[:, 1, 1] > 0)
    )
    return int(np.sum(vis)), vis


# --------------------------------------------------------------------------
# Training targets (simple_transform.py:91-155, simple_transform_3d.py:111-171)
# --------------------------------------------------------------------------


def gaussian_heatmap_target(joints_3d, num_joints, heatmap_size, feat_stride,
                            sigma):
    """Windowed per-joint Gaussian heatmaps, exact reference semantics
    (simple_transform.py:91-125) vectorised over joints."""
    hm_h, hm_w = heatmap_size[0], heatmap_size[1]
    target_weight = np.ones((num_joints, 1), dtype=np.float32)
    target_weight[:, 0] = joints_3d[:, 0, 1]
    target = np.zeros((num_joints, hm_h, hm_w), dtype=np.float32)
    tmp_size = sigma * 3

    mu_x = (joints_3d[:, 0, 0] / feat_stride[0] + 0.5).astype(int)
    mu_y = (joints_3d[:, 1, 0] / feat_stride[1] + 0.5).astype(int)
    ul = np.stack([mu_x - tmp_size, mu_y - tmp_size], 1).astype(int)
    br = np.stack([mu_x + tmp_size + 1, mu_y + tmp_size + 1], 1).astype(int)
    oob = (ul[:, 0] >= hm_w) | (ul[:, 1] >= hm_h) | (br[:, 0] < 0) | (br[:, 1] < 0)
    target_weight[oob] = 0

    # One (6*sigma+1)^2 Gaussian window shared by every joint (the
    # reference's scheme), not a full H x W grid and masks per joint.
    size = 2 * tmp_size + 1
    ax = np.arange(size, dtype=np.float32) - tmp_size
    g = np.exp(-(ax[None, :] ** 2 + ax[:, None] ** 2) / (2 * sigma**2))
    for i in np.nonzero((~oob) & (target_weight[:, 0] > 0.5))[0]:
        x0, x1 = max(0, ul[i, 0]), min(br[i, 0], hm_w)
        y0, y1 = max(0, ul[i, 1]), min(br[i, 1], hm_h)
        target[i, y0:y1, x0:x1] = g[y0 - ul[i, 1]:y1 - ul[i, 1],
                                    x0 - ul[i, 0]:x1 - ul[i, 0]]
    return target, np.expand_dims(target_weight, -1)


def integral_target_2d(joints_3d, num_joints, patch_height, patch_width):
    """(simple_transform.py:127-155): normalised [-0.5, 0.5) uv targets."""
    target_weight = np.ones((num_joints, 2), dtype=np.float32)
    target_weight[:, 0] = joints_3d[:, 0, 1]
    target_weight[:, 1] = joints_3d[:, 0, 1]
    target_visible = np.ones((num_joints, 1), dtype=np.float32)
    target_visible[:, 0] = target_weight[:, 0]

    target = np.zeros((num_joints, 2), dtype=np.float32)
    target[:, 0] = joints_3d[:, 0, 0] / patch_width - 0.5
    target[:, 1] = joints_3d[:, 1, 0] / patch_height - 0.5

    oob = (np.abs(target[:, 0]) > 0.5) | (np.abs(target[:, 1]) > 0.5)
    target_visible[oob] = 0
    target_visible_weight = target_weight[:, :1].copy()
    return (target.reshape(-1), target_weight.reshape(-1), target_visible,
            target_visible_weight)


def integral_target_3d(joints_3d, num_joints, patch_height, patch_width,
                       bbox_3d_depth):
    """(simple_transform_3d.py:149-171): normalised uvd targets; weight
    zeroed per-joint when ANY channel is out of range (the reference zeroes
    the whole row via boolean indexing)."""
    target_weight = np.ones((num_joints, 3), dtype=np.float32)
    target_weight[:] = joints_3d[:, 0:1, 1]

    target = np.zeros((num_joints, 3), dtype=np.float32)
    target[:, 0] = joints_3d[:, 0, 0] / patch_width - 0.5
    target[:, 1] = joints_3d[:, 1, 0] / patch_height - 0.5
    target[:, 2] = joints_3d[:, 2, 0] / bbox_3d_depth

    oob = (np.abs(target) > 0.5).any(1)
    target_weight[oob] = 0
    return target.reshape(-1), target_weight.reshape(-1)


def half_body_transform(joints, joints_vis, num_joints, upper_body_ids,
                        aspect_ratio, pixel_std=1.0, rng=_GLOBAL_RNG):
    """(simple_transform.py:231-276). joints: (K, 2+) pixel coords."""
    upper, lower = [], []
    for j in range(num_joints):
        if joints_vis[j][0] > 0:
            (upper if j in upper_body_ids else lower).append(joints[j])
    if rng.randn() < 0.5 and len(upper) > 2:
        selected = upper
    else:
        selected = lower if len(lower) > 2 else upper
    if len(selected) < 2:
        return None, None
    selected = np.array(selected, dtype=np.float32)
    center = selected.mean(axis=0)[:2]
    lt, rb = selected.min(0), selected.max(0)
    w, h = rb[0] - lt[0], rb[1] - lt[1]
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    return center, np.array([w / pixel_std, h / pixel_std], np.float32) * 1.5


# --------------------------------------------------------------------------
# Camera / Procrustes utilities (pose_utils.py:6-153)
# --------------------------------------------------------------------------


def compute_similarity_transform(s1, s2):
    """Procrustes (sR, t) aligning s1 to s2 (pose_utils.py:6-54)."""
    transposed = False
    if s1.shape[0] not in (2, 3):
        s1, s2 = s1.T, s2.T
        transposed = True
    mu1 = s1.mean(axis=1, keepdims=True)
    mu2 = s2.mean(axis=1, keepdims=True)
    x1, x2 = s1 - mu1, s2 - mu2
    var1 = np.sum(x1**2)
    k = x1 @ x2.T
    u, _, vh = np.linalg.svd(k)
    v = vh.T
    z = np.eye(u.shape[0])
    z[-1, -1] *= np.sign(np.linalg.det(u @ v.T))
    r = v @ z @ u.T
    scale = np.trace(r @ k) / var1
    t = mu2 - scale * (r @ mu1)
    s1_hat = scale * r @ s1 + t
    return s1_hat.T if transposed else s1_hat


def compute_similarity_transform_batch(s1, s2):
    if s1.ndim == 2:
        return compute_similarity_transform(s1.copy(), s2.copy())
    return np.stack([
        compute_similarity_transform(s1[i], s2[i]) for i in range(s1.shape[0])
    ])


def reconstruction_error(s1, s2):
    return compute_similarity_transform_batch(s1, s2)


def world2cam(world_coord, r, t):
    return np.dot(r, world_coord - t)


def weak_cam2pixel(cam_coord, root_z, f, c):
    x = cam_coord[:, 0] / (root_z + 1e-8) * f[0] + c[0]
    y = cam_coord[:, 1] / (root_z + 1e-8) * f[1] + c[1]
    img_coord = np.stack([x, y, cam_coord[:, 2]], 1)
    avg_f = (f[0] + f[1]) / 2
    return img_coord, np.array([avg_f / (root_z + 1e-8), c[0], c[1]])


def cam2pixel(cam_coord, f, c):
    z = cam_coord[:, 2]
    x = cam_coord[:, 0] / (z + 1e-8) * f[0] + c[0]
    y = cam_coord[:, 1] / (z + 1e-8) * f[1] + c[1]
    return np.stack([x, y, z], 1)


def cam2pixel_matrix(cam_coord, intrinsic_param):
    cam_coord = cam_coord.T
    homo = np.concatenate(
        (cam_coord, np.ones((1, cam_coord.shape[1]), dtype=np.float32)), axis=0
    )
    img = np.dot(intrinsic_param, homo) / (cam_coord[2, :] + 1e-8)
    return np.concatenate((img[:2], cam_coord[2:3]), axis=0).T


def pixel2cam(pixel_coord, f, c):
    x = (pixel_coord[:, 0] - c[0]) / f[0] * pixel_coord[:, 2]
    y = (pixel_coord[:, 1] - c[1]) / f[1] * pixel_coord[:, 2]
    return np.stack([x, y, pixel_coord[:, 2]], 1)


def pixel2cam_matrix(pixel_coord, intrinsic_param):
    x = (pixel_coord[:, 0] - intrinsic_param[0][2]) / intrinsic_param[0][0] * pixel_coord[:, 2]
    y = (pixel_coord[:, 1] - intrinsic_param[1][2]) / intrinsic_param[1][1] * pixel_coord[:, 2]
    return np.stack([x, y, pixel_coord[:, 2]], 1)


def rigid_transform_3d(a, b):
    centroid_a = np.mean(a, axis=0)
    centroid_b = np.mean(b, axis=0)
    h = np.dot((a - centroid_a).T, b - centroid_b)
    u, _, v = np.linalg.svd(h)
    r = np.dot(v.T, u.T)
    if np.linalg.det(r) < 0:
        v[2] = -v[2]
        r = np.dot(v.T, u.T)
    t = -np.dot(r, centroid_a.T) + centroid_b.T
    return r, t


def rigid_align(a, b):
    r, t = rigid_transform_3d(a, b)
    return np.dot(r, a.T).T + t


def get_intrinsic_metrix(f, c, inv=False):
    k = np.zeros((3, 3), dtype=np.float32)
    k[0, 0], k[0, 2] = f[0], c[0]
    k[1, 1], k[1, 2] = f[1], c[1]
    k[2, 2] = 1
    return np.linalg.inv(k).astype(np.float32) if inv else k


# --------------------------------------------------------------------------
# SimpleTransform (2D, simple_transform.py:15-276)
# --------------------------------------------------------------------------

_MEAN_2D = np.array([0.406, 0.457, 0.480], np.float32)  # per-channel RGB
_STD_3D = np.array([0.225, 0.224, 0.229], np.float32)


def _normalize_image(img, with_std=False):
    """uint8 HWC RGB -> float32 HWC, [0, 1] minus the reference means
    (im_to_torch + the per-channel add_/div_ at simple_transform.py:220-224);
    layout stays HWC, as the JAX module keeps it."""
    img = np.asarray(img, np.float32)
    if img.max() > 1:
        img = img / 255.0
    img = img - _MEAN_2D
    if with_std:
        img = img / _STD_3D
    return img


def _warp(src, trans, inp_w, inp_h):
    if cv2 is None:
        raise RuntimeError("the pose pipeline's bilinear crop warp needs cv2, which is not "
                           "installed")
    return cv2.warpAffine(
        src, np.asarray(trans, np.float64), (int(inp_w), int(inp_h)),
        flags=cv2.INTER_LINEAR,
    )


class SimpleTransform:
    """Crop + augment + target generation for 2D COCO-style labels
    (simple_transform.py:15-229)."""

    def __init__(self, dataset, scale_factor, input_size, output_size, rot,
                 sigma, train, loss_type="heatmap"):
        self._joint_pairs = dataset.joint_pairs
        self._scale_factor = scale_factor
        self._rot = rot
        self._input_size = input_size
        self._heatmap_size = output_size
        self._sigma = sigma
        self._train = train
        self._loss_type = loss_type
        self._aspect_ratio = float(input_size[1]) / input_size[0]  # w / h
        self._feat_stride = np.array(input_size) / np.array(output_size)
        self.pixel_std = 1
        if train:
            self.num_joints_half_body = dataset.num_joints_half_body
            self.prob_half_body = dataset.prob_half_body
            self.upper_body_ids = dataset.upper_body_ids
            self.lower_body_ids = dataset.lower_body_ids

    def test_transform(self, src, bbox):
        xmin, ymin, xmax, ymax = bbox
        center, scale = box_to_center_scale(
            xmin, ymin, xmax - xmin, ymax - ymin, self._aspect_ratio,
            scale_mult=1.25,
        )
        inp_h, inp_w = self._input_size
        trans = get_affine_transform(center, scale, 0, [inp_w, inp_h])
        img = _warp(src, trans, inp_w, inp_h)
        return _normalize_image(img), center_scale_to_box(center, scale)

    def __call__(self, src, label, rng=_GLOBAL_RNG):
        bbox = list(label["bbox"])
        gt_joints = label["joints_3d"].copy()
        imgwidth, imght = label["width"], label["height"]
        num_joints = gt_joints.shape[0]
        joints_vis = gt_joints[:, 0:1, 1].copy()

        xmin, ymin, xmax, ymax = bbox
        center, scale = box_to_center_scale(
            xmin, ymin, xmax - xmin, ymax - ymin, self._aspect_ratio,
            scale_mult=1.25,
        )
        if self._train and (
            np.sum(joints_vis[:, 0]) > self.num_joints_half_body
            and rng.rand() < self.prob_half_body
        ):
            c_half, s_half = half_body_transform(
                gt_joints[:, :, 0], joints_vis, num_joints,
                self.upper_body_ids, self._aspect_ratio, self.pixel_std,
                rng=rng,
            )
            if c_half is not None:
                center, scale = c_half, s_half

        if self._train:
            sf = self._scale_factor
            scale = scale * rng.uniform(1 - sf, 1 + sf)
            r = (rng.uniform(-self._rot, self._rot)
                 if rng.random_sample() <= 0.5 else 0)
        else:
            r = 0

        joints = gt_joints
        if rng.random_sample() > 0.5 and self._train:
            src = src[:, ::-1, :]
            joints = flip_joints_3d(joints, imgwidth, self._joint_pairs)
            center[0] = imgwidth - center[0] - 1

        inp_h, inp_w = self._input_size
        trans = get_affine_transform(center, scale, r, [inp_w, inp_h])
        img = _warp(src, trans, inp_w, inp_h)

        vis_mask = joints[:, 0, 1] > 0
        joints[vis_mask, 0:2, 0] = affine_transform(
            joints[vis_mask, 0:2, 0], trans
        )

        target_hm, target_hm_weight = gaussian_heatmap_target(
            joints.copy(), num_joints, self._heatmap_size, self._feat_stride,
            self._sigma,
        )
        target_uv, target_uv_weight, _, _ = integral_target_2d(
            joints.copy(), num_joints, inp_h, inp_w
        )
        return {
            "type": "2d_data",
            "image": _normalize_image(img),
            "target_hm": target_hm,
            "target_hm_weight": target_hm_weight,
            "target_uv": target_uv,
            "target_uv_weight": target_uv_weight,
            "bbox": np.asarray(center_scale_to_box(center, scale), np.float32),
        }


class SimpleTransform3D:
    """Crop + augment + integral uvd targets + orthographic camera fit for
    3D (H36M-style) labels (simple_transform_3d.py:24-406); functional here
    where the reference's is vestigial."""

    def __init__(self, dataset, scale_factor, color_factor, occlusion,
                 add_dpg, input_size, output_size, bbox_3d_shape, rot, sigma,
                 train, loss_type="coord", scale_mult=1.25):
        self._dataset = dataset
        self._joint_pairs = dataset.joint_pairs
        self._scale_factor = scale_factor
        self._color_factor = color_factor
        if occlusion or add_dpg:
            # Silently ignoring these trained without the requested
            # augmentations; the reference refuses too
            # (simple_transform_3d.py:219-241 occlusion path unported).
            raise NotImplementedError(
                "SimpleTransform3D occlusion/add_dpg augmentation is not "
                "ported; pass False")
        self._occlusion = occlusion
        self._rot = rot
        self._input_size = input_size
        self._heatmap_size = output_size
        self._sigma = sigma
        self._train = train
        self._loss_type = loss_type
        self._aspect_ratio = float(input_size[1]) / input_size[0]
        self._feat_stride = np.array(input_size) / np.array(output_size)
        self.bbox_3d_shape = bbox_3d_shape
        self._scale_mult = scale_mult

    def test_transform(self, src, bbox):
        xmin, ymin, xmax, ymax = bbox
        center, scale = box_to_center_scale(
            xmin, ymin, xmax - xmin, ymax - ymin, self._aspect_ratio,
            scale_mult=self._scale_mult,
        )
        inp_h, inp_w = self._input_size
        trans = get_affine_transform(center, scale, 0, [inp_w, inp_h])
        img = _warp(src, trans, inp_w, inp_h)
        return (
            _normalize_image(img, with_std=True),
            center_scale_to_box(center, scale),
        )

    def __call__(self, src, label, rng=_GLOBAL_RNG):
        bbox = list(label["bbox"])
        joint_img = label["joint_img"].copy()
        joints_vis = label["joint_vis"].copy()
        root_cam = label["root_cam"].copy()
        num_joints = joint_img.shape[0]

        gt_joints = np.zeros((num_joints, 3, 2), dtype=np.float32)
        gt_joints[:, :, 0] = joint_img
        gt_joints[:, :, 1] = joints_vis

        imgwidth, imght = label["width"], label["height"]
        xmin, ymin, xmax, ymax = bbox
        center, scale = box_to_center_scale(
            xmin, ymin, xmax - xmin, ymax - ymin, self._aspect_ratio,
            scale_mult=self._scale_mult,
        )

        if self._train:
            sf = self._scale_factor
            scale = scale * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            rf = self._rot
            r = (np.clip(rng.randn() * rf, -rf * 2, rf * 2)
                 if rng.random_sample() <= 0.6 else 0)
        else:
            r = 0

        joints = gt_joints
        if rng.random_sample() > 0.5 and self._train:
            src = src[:, ::-1, :]
            joints = flip_joints_3d(joints, imgwidth, self._joint_pairs)
            center[0] = imgwidth - center[0] - 1

        inp_h, inp_w = self._input_size
        trans = get_affine_transform(center, scale, r, [inp_w, inp_h])
        img = _warp(src, trans, inp_w, inp_h)

        # Rotation aug applied to the absolute 2.5D coords around the bbox
        # centre (simple_transform_3d.py:261-267).
        abs_25d = joints[..., 0].copy()
        th = -r / 180 * np.pi
        rot_m = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        abs_25d[:, :2] = center + (abs_25d[:, :2] - center) @ rot_m.T

        vis_mask = joints[:, 0, 1] > 0
        joints[vis_mask, 0:2, 0] = affine_transform(
            joints[vis_mask, 0:2, 0], trans
        )

        # Normalised uvd coords exist in both modes: the st fit below
        # needs them, and the heatmap branch's (K, H, W) tensor is not
        # coords.
        coord_uvd, coord_weight = integral_target_3d(
            joints, num_joints, inp_h, inp_w, self.bbox_3d_shape[0]
        )
        if self._loss_type == "heatmap":
            target, target_weight = gaussian_heatmap_target(
                joints, num_joints, self._heatmap_size, self._feat_stride,
                self._sigma,
            )
            # (K, 1, 1) per-joint weight x per-joint visibility — the flat
            # reshape below would broadcast (K,1,1)x(3K,) into garbage.
            target_weight = target_weight * joints_vis[:, :1, None]
        else:
            target = coord_uvd
            target_weight = coord_weight * joints_vis.reshape(-1)
        out_bbox = center_scale_to_box(center, scale)

        if self._train:
            c_high = 1 + self._color_factor
            c_low = 1 - self._color_factor
            img = img.astype(np.float32)
            for ch in range(3):
                img[:, :, ch] = np.clip(
                    img[:, :, ch] * rng.uniform(c_low, c_high), 0, 255
                )
        img = _normalize_image(img, with_std=True)

        # [-0.5, 0.5) -> [-1, 1); depth /2000 -> /1000
        # (simple_transform_3d.py:355). Coord-space only — heatmaps keep
        # their Gaussian scale.
        coord_uvd = coord_uvd * 2
        if self._loss_type != "heatmap":
            target = coord_uvd

        abs_25d[:, 2] = abs_25d[:, 2] + root_cam[2]
        abs_3d = pixel2cam(abs_25d, label["f"], label["c"])
        root_idx = self._dataset.root_idx
        rel_3d = (abs_3d - abs_3d[root_idx]) / 1000.0

        rel_3d = rel_3d.reshape(-1)
        abs_25d_flat = abs_25d.reshape(-1)
        uv = coord_uvd.reshape(-1, 3)[:, :2].reshape(-1)
        st = hand_transforms.compute_st_np(rel_3d, uv)
        st_cam = hand_transforms.compute_st_np(abs_25d_flat, uv)
        # Compose the orthographic fit with the intrinsics
        # (simple_transform_3d.py:372-383).
        k = np.array([
            [label["f"][0], 0, label["c"][0]],
            [0, label["f"][1], label["c"][1]],
            [0, 0, 1],
        ], dtype=np.float32)
        a = np.array([
            [st_cam[0], 0, st_cam[1]],
            [0, st_cam[0], st_cam[2]],
            [0, 0, 1],
        ], dtype=np.float32)
        c_mat = a @ k
        st_cam = np.concatenate((c_mat[[0], 0], c_mat[[1], 1], c_mat[:2, 2]))

        return {
            "type": "3d_keypoint_data",
            "image": img,
            "target_uvd": target.astype(np.float32),
            "target_uvd_weight": target_weight.astype(np.float32),
            "bbox": np.asarray(out_bbox, np.float32),
            "target_xyz": rel_3d.astype(np.float32),
            "st": st,
            "st_cam": st_cam.astype(np.float32),
            "root_xyz": (abs_3d[root_idx] / 1000.0).astype(np.float32),
            "action": label.get("action", 0),
        }


# --------------------------------------------------------------------------
# COCO-format dataset (custom.py:16-147) — stdlib json, no pycocotools
# --------------------------------------------------------------------------


class PoseDataset:
    """COCO-keypoint-format dataset (the reference's CustomDataset rebuilt
    without the pycocotools dependency): reads the annotation JSON directly,
    builds (items, labels), and applies SimpleTransform per sample.

    Parameters mirror the RLE cfg dict: ROOT/IMG_PREFIX/ANN +
    PRESET{IMAGE_SIZE, HEATMAP_SIZE, SIGMA} + AUG{...}.
    """

    CLASSES = ["person"]
    num_joints = 17
    joint_pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]]
    upper_body_ids = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
    lower_body_ids = (11, 12, 13, 14, 15, 16)

    def __init__(self, train=True, skip_empty=True, seed=0, **cfg):
        import os

        self._cfg = cfg
        # Per-item augmentation RNG stream (common.item_rng discipline —
        # the transforms' global-RNG mode stays for reference parity, but
        # the product path must be thread-safe and epoch-varied).
        self._seed = int(seed)
        self._epoch = 0
        preset = cfg["PRESET"]
        self._root = cfg["ROOT"]
        self._img_prefix = cfg.get("IMG_PREFIX", "")
        self._ann_file = os.path.join(self._root, cfg["ANN"])
        self._skip_empty = skip_empty
        self._train = train
        aug = cfg.get("AUG", {})
        self._scale_factor = aug.get("SCALE_FACTOR", 0)
        self._rot = aug.get("ROT_FACTOR", 0)
        self.num_joints_half_body = aug.get("NUM_JOINTS_HALF_BODY", -1)
        self.prob_half_body = aug.get("PROB_HALF_BODY", -1)
        self._input_size = preset["IMAGE_SIZE"]
        self._output_size = preset["HEATMAP_SIZE"]
        self._sigma = preset["SIGMA"]
        self._loss_type = cfg.get("heatmap2coord", "coord")
        if "NUM_JOINTS" in preset:
            self.num_joints = preset["NUM_JOINTS"]
        if "JOINT_PAIRS" in preset:
            self.joint_pairs = preset["JOINT_PAIRS"]

        self.transformation = SimpleTransform(
            self, scale_factor=self._scale_factor,
            input_size=self._input_size, output_size=self._output_size,
            rot=self._rot, sigma=self._sigma, train=train,
            loss_type=self._loss_type,
        )
        self._items, self._labels = self._load_jsons()

    def _load_jsons(self):
        import os

        with open(self._ann_file) as fp:
            coco = json.load(fp)
        images = {im["id"]: im for im in coco["images"]}
        items, labels = [], []
        for ann in coco.get("annotations", []):
            im = images[ann["image_id"]]
            width, height = im["width"], im["height"]
            xmin, ymin, xmax, ymax = bbox_clip_xyxy(
                bbox_xywh_to_xyxy(ann["bbox"]), width, height
            )
            kps = np.array(ann["keypoints"], np.float32).reshape(-1, 3)
            if self._skip_empty and (kps[:, 2] == 0).all():
                continue
            if xmax <= xmin or ymax <= ymin:
                continue
            joints_3d = np.zeros((self.num_joints, 3, 2), np.float32)
            joints_3d[:, 0, 0] = kps[:, 0]
            joints_3d[:, 1, 0] = kps[:, 1]
            joints_3d[:, :2, 1] = (kps[:, 2:3] > 0).astype(np.float32)
            items.append(os.path.join(
                self._root, self._img_prefix, im["file_name"]
            ))
            labels.append({
                "bbox": (xmin, ymin, xmax, ymax),
                "width": width,
                "height": height,
                "joints_3d": joints_3d,
            })
        return items, labels

    def __len__(self):
        return len(self._items)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation RNG stream (engine.train_epoch calls
        this on every loader that exposes it)."""
        self._epoch = int(epoch)

    def __getitem__(self, idx):
        import copy
        import os

        img_path = self._items[idx]
        img_id = int(os.path.splitext(os.path.basename(img_path))[0])
        label = copy.deepcopy(self._labels[idx])
        if cv2 is not None:
            img = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
        else:  # pragma: no cover
            img = np.asarray(common.imread(img_path))[..., :3]
        target = self.transformation(
            img, label, rng=common.item_rng(self._seed, self._epoch, idx))
        img = target.pop("image")
        bbox = target.pop("bbox")
        return img, target, img_id, bbox


class HeatmapToCoord:
    """The reference's `get_coord` callable (utils.py:483-498)."""

    def __init__(self, norm_size, output_3d=False, decode_type="coord"):
        self.type = decode_type
        self.norm_size = norm_size
        self.output_3d = output_3d

    def __call__(self, output, bbox, idx):
        if self.type == "coord":
            return heatmap_to_coord(
                np.asarray(output["pred_jts"][idx]),
                np.asarray(output["maxvals"][idx]),
                self.norm_size, bbox, self.output_3d,
            )
        raise NotImplementedError(self.type)
