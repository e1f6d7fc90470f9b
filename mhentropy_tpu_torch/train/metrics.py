"""Multi-hypothesis evaluation metrics on torch tensors.

Port of mhentropy_tpu/train/metrics.py: `mean_euclidean` :20,
`_group_stats` :35, `chamfer_dist` :53 and `mhent_metrics` :73 (with the
`valid` mask of padded tail batches), and the host-numpy
`calc_coord_accuracy` :183 and `evaluate_map` :259 (its lazy pycocotools
import and refusal; COCO mAP is the RLE human-pose stack's).
"""

from __future__ import annotations

import numpy as np
import torch

ROOT_IDX = 12


def mean_euclidean(pred: torch.Tensor, gt: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(R, K*3) pred and gt, (R,) scale -> (R, K) metric-scale distances."""
    p = pred.reshape(pred.shape[0], -1, 3)
    g = gt.reshape(pred.shape[0], -1, 3)
    return torch.sqrt(torch.sum((p - g) ** 2, dim=2)) * scale[:, None]


def _group_stats(stats: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted per-image mean over joints ((N,) B, K) -> ((N,) B), with the
    reference's renormalisation over images whose group is not empty."""
    num_vis = weight.sum(-1)
    mpj = (stats * weight).sum(-1) / (num_vis + 1e-16)
    nv = num_vis[0] if num_vis.dim() == 2 else num_vis
    b = nv.shape[0]
    num_valid = (nv > 0.0).sum()
    return torch.where(num_valid > 0, mpj * b / (num_valid + 1e-16), mpj * 0.0)


def chamfer_dist(norm_rel_xyz: torch.Tensor, target: dict) -> torch.Tensor:
    """Symmetric hand-joint <-> object-vertex chamfer; xyz ((N,) B, K, 3),
    target scale (B,), original_pose3d (B, K, 3), object_verts (B, V*3)."""
    squeeze = norm_rel_xyz.dim() == 3
    if squeeze:
        norm_rel_xyz = norm_rel_xyz[None]
    b = target["scale"].shape[0]
    abs_xyz = norm_rel_xyz * target["scale"][:, None, None] * 1000.0
    abs_xyz = abs_xyz + target["original_pose3d"][:, ROOT_IDX][None, :, None, :]
    obj = target["object_verts"].reshape(b, -1, 3)
    d = torch.linalg.norm(abs_xyz[:, :, :, None, :] - obj[None, :, None, :, :], dim=-1)
    dist = d.min(-1).values.mean(-1) + d.min(-2).values.mean(-1)
    return dist[0] if squeeze else dist


def mhent_metrics(output: dict, target: dict, image_size: int = 256):
    """MHEntLoss.forward: (total loss, losses, metrics).

    output: log_p (B,), hypothesis-major xyz (N, B, 63) normalised-relative
    and uv (N, B, 42) in pixels (uv derived from the GT camera when absent).
    target: pose3d (B, 63), crop_uv (B, 42) in [-1, 1), vis (B, 21),
    scale (B,), st (B, 3), optional valid (B,).
    Metric names are the reference's (eucLoss_{3d,2d}_rgb_{sample,vis,invis}
    with _std, _mean and _rd).
    """
    valid = target.get("valid")
    losses = {"neg_log_p": -output["log_p"]}
    src = output["xyz"] if "xyz" in output else output["uv"]
    n, b = src.shape[:2]

    metrics, euc = {}, {}
    if "xyz" in output:
        xyz = output["xyz"].reshape(n * b, -1)
        euc["3d"] = mean_euclidean(xyz, target["pose3d"].repeat(n, 1),
                                   target["scale"].repeat(n)).reshape(n, b, -1)
    uv_gt = (target["crop_uv"] + 1.0) / 2.0 * image_size
    if "uv" in output:
        uv_pred = output["uv"]
    else:
        xyz3 = output["xyz"].reshape(n, b, -1, 3)
        st = target["st"]
        uv_pred = st[None, :, None, 0:1] * xyz3[..., :2] + st[None, :, None, 1:3]
        uv_pred = ((uv_pred + 1.0) / 2.0 * image_size).reshape(n, b, -1)
        output["uv"] = uv_pred
    euc["2d"] = torch.linalg.norm((uv_pred - uv_gt[None]).reshape(n, b, -1, 2), dim=-1)

    vis = target["vis"]
    weights = {
        "sample": torch.ones_like(vis),
        "vis": (vis == 1.0).float(),
        "invis": (vis != 1.0).float(),
    }
    weights["vis"][:, ROOT_IDX] = 0.0
    weights["invis"][:, ROOT_IDX] = 0.0
    if valid is not None:
        weights = {k: w * valid[:, None] for k, w in weights.items()}

    for sup in euc:
        d = int(sup[0])
        coord = output["xyz"] * target["scale"][None, :, None] if sup == "3d" else output["uv"]
        coord = coord.reshape(n, b, -1, d)
        for attr, weight in weights.items():
            key = f"eucLoss_{sup}_rgb_{attr}"
            mpjpe = _group_stats(euc[sup], weight[None].repeat(n, 1, 1))
            # Worst hypothesis for 2D-vis, best for everything else.
            metrics[key] = mpjpe.max(0).values if (sup == "2d" and attr == "vis") \
                else mpjpe.min(0).values
            # Per-joint diversity: std-ellipsoid volume^(1/D) * sqrt(D).
            if n == 1:
                spspe = coord.new_zeros((b, coord.shape[-2]))
            else:
                spspe = coord.std(0, unbiased=True).prod(-1)
            spspe = spspe ** (1.0 / d) * (d ** 0.5)
            metrics[f"{key}_std"] = _group_stats(spspe, weight)
            mh = _group_stats(euc[sup].mean(0), weight)
            if attr == "vis":
                metrics[f"{key}_mean"] = mh
            metrics[f"{key}_rd"] = metrics[f"{key}_std"] / (mh + 1e-16)

    if valid is None:
        total = sum(v.mean() for v in losses.values())
    else:
        denom = valid.sum() + 1e-16
        total = sum((v * valid).sum() / denom for v in losses.values())
        metrics["n_valid"] = valid.sum()
    return total, losses, metrics


def calc_coord_accuracy(
    coords,
    target: dict,
    hm_shape=(64, 48, 64),
    output_3d: bool = False,
    root_idx: int | None = None,
    thr: float = 0.5,
    ds_type: str = "human",
    output_normalized: bool = True,
):
    """Integral-coordinate PCK accuracy (utils.py:187-323 'calc_coord_accuracy'
    + calc_dist + dist_acc), vectorised on host numpy.

    Args:
        coords: (B, K*D) predicted coords (normalised to [-0.5, 0.5) when
            output_normalized).
        target: pose3d/crop_uv (+ target_uv(d)_weight masks).

    Returns:
        Mean per-joint PCK@thr over joints with any valid sample.
    """
    # np.array (not asarray): float64 inputs would otherwise alias the
    # caller's buffers and the in-place scaling below would corrupt the
    # target dict for later consumers.
    coords = np.array(coords, dtype=float)
    d = 3 if output_3d else 2
    if output_3d:
        labels = np.array(target["pose3d"], dtype=float)
        masks = np.ones_like(labels)
    else:
        labels = np.array(target["crop_uv"], dtype=float)
        masks = np.array(target["target_uv_weight"], dtype=float)
        if masks.ndim == 2 and masks.shape[1] * 2 == labels.shape[1]:
            masks = np.repeat(masks, 2, axis=1)
    b = coords.shape[0]
    coords = coords.reshape(b, -1, d)
    labels = labels.reshape(b, -1, d)
    masks = masks.reshape(b, -1, d)

    hm = np.asarray(hm_shape, dtype=float)
    if output_normalized:
        coords[..., 0] = (coords[..., 0] + 0.5) * hm[0]
        coords[..., 1] = (coords[..., 1] + 0.5) * hm[1]
        if output_3d:
            coords[..., 2] = (coords[..., 2] + 0.5) * hm[2]
    if output_3d:
        if output_normalized:
            labels[..., 0] = (labels[..., 0] + 0.5) * hm[0]
            labels[..., 1] = (labels[..., 1] + 0.5) * hm[1]
            labels[..., 2] = (labels[..., 2] + 0.5) * hm[2]
    else:
        # The reference scales 2D labels UNCONDITIONALLY
        # (utils.py:255-256) — output_normalized only gates the coords.
        labels[..., 0] = (labels[..., 0] + 0.5) * hm[0]
        labels[..., 1] = (labels[..., 1] + 0.5) * hm[1]
    if output_3d and root_idx is not None:
        labels = labels - labels[:, root_idx : root_idx + 1]
        coords = coords - coords[:, root_idx : root_idx + 1]

    coords = coords * masks
    labels = labels * masks
    norm = np.ones((b, 1, d))
    if ds_type == "human":
        norm = norm * hm[:d] / 10.0

    valid = (labels[..., 0] > 1) & (labels[..., 1] > 1)  # calc_dist gating
    dists = np.linalg.norm((coords - labels) / norm, axis=-1)
    hits = (dists < thr) & valid
    per_joint_n = valid.sum(0)
    per_joint_acc = np.where(per_joint_n > 0, hits.sum(0) / np.maximum(per_joint_n, 1), -1.0)
    used = per_joint_acc >= 0
    return float(per_joint_acc[used].mean()) if used.any() else 0.0


def evaluate_map(res_file: str, ann_file: str, ann_type: str = "keypoints"):
    """COCO mAP via pycocotools (utils.py:327-370), lazily imported — the
    environment ships without pycocotools; the COCO branch is vestigial in
    the reference too (SURVEY.md §2 'RLE-ported human-pose stack')."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "pycocotools is required for COCO mAP evaluation; install it or "
            "use the hand/PCK metrics"
        ) from e
    gt = COCO(ann_file)
    dt = gt.loadRes(res_file)
    ev = COCOeval(gt, dt, ann_type)
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    names = ["AP", "Ap .5", "AP .75", "AP (M)", "AP (L)",
             "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]
    return dict(zip(names, ev.stats))
