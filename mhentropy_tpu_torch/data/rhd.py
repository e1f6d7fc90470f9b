"""RHD dataset pipeline (host side, numpy/cv2).

Port of mhentropy_tpu/data/rhd.py, line for line (its items equal the JAX
package's), with the reference's rhddataloader.py:32-404 and
dataPreprocess/preprocess.py behind both: pickle annotations, hand-side selection by
mask pixel count, depth-based occlusion + within-bounds checks, deterministic
synthetic patch occlusion, root-relative bone-normalised pose (root 12, bone
12-11), x1.3 crop around the root, depth->point-cloud, view-correction
rotation, 64^2 Gaussian heatmaps, left-hand flip + scale/rot/trans
augmentation, 3-state visibility encoding, orthographic (s,t) fit.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from mhentropy_tpu_torch.data import common, occlusion, transforms as T

BAD_TRAIN = (20500, 28140)  # rhddataloader.py:77
BAD_EVAL = (1012, 1324)


def depth_two_uint8_to_float(top, bottom) -> np.ndarray:
    """RGB-coded depth -> metres (rhddataloader.py:24-29)."""
    d = (top.astype(np.float32) * 256.0 + bottom.astype(np.float32))
    return d / float(2**16 - 1) * 5.0


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], float)


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], float)


def view_correction(crop_center, cam, cloud, joints):
    """Rotate the camera ray through the crop centre onto the optical axis
    (preprocess.py:64-77; note the reference uses u0 for BOTH axes here —
    'for RHD, fx = fy and u0 = v0' — kept for parity)."""
    f, u0 = cam[0, 0], cam[0, 2]
    ay = np.arctan((crop_center[0] - u0) / f)
    c3d = np.array([crop_center[0] - u0, crop_center[1] - u0, f])
    c3d = c3d @ rot_y(-ay).T
    ax = np.arctan(c3d[1] / c3d[2])
    rot = rot_x(ax) @ rot_y(-ay)
    return rot, cloud @ rot.T, joints @ rot.T


def view_correction_joint(crop_center, cam, joints):
    """Joints-only view correction (preprocess.py:51-62). Unlike its cloud
    sibling above, the reference's joint variant uses the true principal
    point v0 for the y axis."""
    f, u0, v0 = cam[0, 0], cam[0, 2], cam[1, 2]
    ay = np.arctan((crop_center[0] - u0) / f)
    c3d = np.array([crop_center[0] - u0, crop_center[1] - v0, f])
    c3d = c3d @ rot_y(-ay).T
    ax = np.arctan(c3d[1] / c3d[2])
    rot = rot_x(ax) @ rot_y(-ay)
    return rot, joints @ rot.T


def depth_to_cloud(depth, mask, center3d, cam, cloud_size=4000, rng=None):
    """Masked depth -> point cloud, box-filtered around the root, resampled
    to cloud_size (preprocess.py:178-210)."""
    h, w = depth.shape
    v, u = common.grid2d(h, w)
    sel = mask.reshape(-1)
    uvd = np.stack(
        [u.reshape(-1)[sel], v.reshape(-1)[sel], depth.reshape(-1)[sel]], 1
    ).astype(np.float32)
    cloud = T.uvd2xyz_cv(uvd, cam)
    rel = cloud - center3d
    ok = np.all(np.abs(rel) < 0.2, axis=1)
    cloud = cloud[ok]
    if len(cloud) == 0:
        return np.zeros((cloud_size, 3), np.float32)
    while len(cloud) < cloud_size:
        cloud = np.repeat(cloud, 2, axis=0)
    rng = rng or np.random
    idx = rng.permutation(len(cloud))[:cloud_size]
    return cloud[idx]


def gaussian_heatmaps(uv, size, vis, sigma=6.0):
    """Per-joint Gaussian heatmaps, visible joints only
    (preprocess.py:212-255)."""
    k = uv.shape[0]
    coords = uv.astype(np.int32).astype(np.float32)
    in_bounds = (
        (coords[:, 0] > 0) & (coords[:, 0] < size - 1)
        & (coords[:, 1] > 0) & (coords[:, 1] < size - 1)
    )
    cond = (np.asarray(vis, np.float32) > 0.5) & in_bounds
    # heatmap[row, col, k] peaks at (v, u) — the reference swaps uv to (v, u)
    # before the grid subtraction (preprocess.py:216-219, 244-251).
    # The Gaussian is separable: exp(-(dr^2+dc^2)) == exp(-dr^2)*exp(-dc^2)
    # to ~1 ulp, so exp runs over 2*size*k values instead of size^2*k.
    grid = np.arange(size, dtype=np.float32)[:, None]
    er = np.exp(-((grid - coords[None, :, 1]) ** 2) / sigma**2)  # (size, k)
    ec = np.exp(-((grid - coords[None, :, 0]) ** 2) / sigma**2)
    return er[:, None, :] * (ec[None, :, :] * cond.astype(np.float32))


class RHDDataset:
    #: Target keys that cost real host time / H2D bytes but are consumed by
    #: no shipped train or eval path (models/, train/, core/ never read
    #: them — they exist for reference parity, rhddataloader.py:220-228).
    HEAVY_FIELDS = frozenset({"cloud", "heatmap", "object_mask", "mask"})

    def __init__(
        self,
        data_root: str,
        mode: str = "training",
        view_correction_on: bool = False,
        uv_norm: bool = True,
        patch_occlude: bool = True,
        image_size: int = 256,
        seed: int = 0,
        heavy_fields: frozenset | set | None = None,
        image_u8: bool = False,
        device_st: bool = False,
        prefix_cache: str | None = None,
        color_jitter: bool = True,
    ):
        """heavy_fields: which of HEAVY_FIELDS to compute and emit. None
        (default) keeps the full reference-parity target; the Experiment
        passes the empty set (cfg.tpu.target_fields='auto') since nothing
        downstream consumes them. Note the train-mode augmentation RNG stream differs between field
        configurations (skipped fields skip their rng draws)."""
        assert mode in ("training", "evaluation")
        self.mode = mode
        self.aug = mode == "training"
        self.vc = view_correction_on
        self.uv_norm = uv_norm
        self.patch_occlude = patch_occlude
        self.size = image_size
        self.heavy = None if heavy_fields is None else frozenset(heavy_fields)
        # uint8 image transport: every pixel op in this chain copies u8
        # integer values (nearest crop/warp, blackout, flip), so shipping
        # u8 and normalising on device (engine._prep_image) preserves
        # values exactly (the device affine is within 1 ulp of the host
        # division) and cuts the image H2D 4x. The per-sample
        # _img_scale/_img_bias affine rides the target.
        self.image_u8 = image_u8
        # device_st: omit the per-item scipy Procrustes (s, t) fit — the
        # steps reconstruct st from pose3d/crop_uv with the batched
        # core.camera.compute_st (engine._prep_batch).
        self.device_st = device_st
        # Deterministic-prefix disk cache (training counterpart of
        # data/cached.SampleCache): everything up to and including the
        # flip — decode, hand side, crop, idx-seeded patch occlusion —
        # is a pure function of the index; only the
        # augmentation suffix draws RNG. With the prefix served from
        # disk, a train item costs one pickle read + the warp/rotate
        # suffix. Auto-disabled when the RNG-consuming cloud field is
        # requested. Cached/uncached items are bit-identical (the
        # prefix draws no RNG, so the stream is unchanged).
        self.prefix_cache = prefix_cache
        self.seed = seed
        # Reference parity: RHD training applies torchvision ColorJitter
        # before ToTensor (rhddataloader.py:153-155); data/colorjitter.py
        # reproduces the PIL-exact u8 arithmetic. Train-mode only.
        self.color_jitter = color_jitter
        self.epoch = 0  # advanced by set_epoch (engine.train_epoch)
        self.rng = np.random.RandomState(seed)  # legacy users only
        self.root = self._find_root(data_root)
        anno_path = os.path.join(self.root, mode, f"anno_{mode}.pickle")
        st = os.stat(anno_path)
        # Annotation content identity for the prefix-cache fingerprint:
        # replacing annotation files in place (same count) must miss.
        self._anno_stat = (int(st.st_mtime), st.st_size)
        with open(anno_path, "rb") as f:
            self.anno = pickle.load(f)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation RNG stream (common.item_rng)."""
        self.epoch = int(epoch)

    @staticmethod
    def _find_root(data_root):
        for cand in (
            data_root,
            os.path.join(data_root, "RHD_published_v2"),
        ):
            if os.path.isdir(os.path.join(cand, "training")):
                return cand
        raise FileNotFoundError(data_root)

    def __len__(self):
        return len(self.anno)

    @property
    def _prefix_cacheable(self) -> bool:
        # The cloud resample draws from the stream RNG inside the prefix
        # region; caching it would freeze the draw AND desync the stream.
        return self.prefix_cache is not None and (
            self.heavy is not None and "cloud" not in self.heavy
        )

    def _prefix_dir(self):
        d = getattr(self, "_prefix_dir_memo", None)
        if d is not None:
            return d
        from mhentropy_tpu_torch.data import cached

        fp = cached.config_fingerprint({
            "cls": "RHDDataset.prefix", "mode": self.mode, "n": len(self),
            "root": os.path.abspath(self.root),  # two roots never collide
            "size": self.size, "vc": self.vc,
            "patch_occlude": self.patch_occlude,
            "heavy": cached.heavy_field_tag(self.heavy),
            "anno": self._anno_stat,  # in-place annotation swaps miss
            "v": 2,  # prefix schema/semantics version (v2: patch-only vis)
        })
        d = os.path.join(self.prefix_cache, fp)
        os.makedirs(d, exist_ok=True)
        self._prefix_dir_memo = d
        return d

    def _prefix(self, idx: int) -> dict:
        """Everything deterministic in the item pipeline (decode through
        flip). The returned dict is private mutable state for the suffix;
        cache hits deserialize fresh arrays."""
        if self._prefix_cacheable:
            from mhentropy_tpu_torch.data import cached

            return cached.read_or_compute_pickle(
                os.path.join(self._prefix_dir(), f"{idx}.pkl"),
                lambda: self._compute_prefix(idx),
            )
        return self._compute_prefix(idx)

    def _compute_prefix(self, idx: int) -> dict:
        anno = self.anno[idx]
        base = os.path.join(self.root, self.mode)
        need = common.field_gate(self.heavy)
        image = common.imread(os.path.join(base, "color", f"{idx:05d}.png"))
        mask = common.imread(os.path.join(base, "mask", f"{idx:05d}.png"))
        if need("cloud"):  # depth feeds only the point cloud now
            depth_png = common.imread(
                os.path.join(base, "depth", f"{idx:05d}.png"))
            depth = depth_two_uint8_to_float(
                depth_png[:, :, 0], depth_png[:, :, 1])

        kp_uv = anno["uv_vis"][:, :2]
        kp_vis = anno["uv_vis"][:, 2] == 1
        kp_xyz = anno["xyz"]
        cam = anno["K"]

        # Hand side by mask pixel count (preprocess.py:264-278).
        cond_l = (mask > 1) & (mask < 18)
        cond_r = mask > 17
        left = cond_l.sum() > cond_r.sum()
        sl = slice(0, 21) if left else slice(-21, None)
        pose3d = kp_xyz[sl]
        uv_all = kp_uv[sl]
        uv_vis = kp_vis[sl]
        hand_mask_full = cond_l if left else cond_r

        # The reference computes a depth-agreement vis (check_occlusion,
        # rhddataloader.py:95) and then DISCARDS it: the emitted vis is
        # rebuilt from ones by patch_occlusion(vis=None) (:133-134), or
        # set to ones outright when the patch branch is off (:136). The
        # operative RHD vis is therefore patch(0)/visible(1)/oob(2) only
        # — replicated below (composing depth AND patch would skew the
        # vis/invis metric split).

        pose3d_normed, pose3d_root, bone = T.normalize_pose3d_np(pose3d, 12, 11)

        # Crop around the root, x1.3 of the visible-keypoint extent
        # (preprocess.py:299-304).
        crop_center = uv_all[12].astype(np.float64)
        crop_size = float(np.max(np.abs(uv_all[uv_vis] - crop_center))) * 1.3
        s = self.size
        image_crop = T.crop_resize(image, crop_center, crop_size, s)
        hand_mask_crop = (
            T.crop_resize(hand_mask_full.astype(np.float32), crop_center,
                          crop_size, s, pad=0.0)
            if need("mask") else None
        )

        if need("cloud"):
            cloud = depth_to_cloud(
                depth, hand_mask_full, pose3d_root, cam, 4000,
                common.item_rng(self.seed, 0, idx),
            )
            cloud_normed = (cloud - pose3d[12]) / bone
        else:
            cloud = cloud_normed = np.zeros((1, 3), np.float32)

        crop_scale = s / (crop_size * 2.0)
        crop_uv = (uv_all - crop_center) * crop_scale + s // 2

        vc_rot = np.eye(3)
        if self.vc:
            vc_rot, cloud_vc, pose_vc = view_correction(
                crop_center, cam, cloud, pose3d
            )
            pose3d_normed = (pose_vc - pose_vc[12]) / bone
            cloud_normed = (cloud_vc - pose_vc[12]) / bone

        heatmap = (
            gaussian_heatmaps(
                (uv_all - crop_center) * (64.0 / (crop_size * 2)) + 32, 64, uv_vis
            )
            if need("heatmap") else None
        )

        # Patch occlusion before augmentation (rhddataloader.py:131-137);
        # vis=None starts from ones — see the parity note above.
        patch_cx = patch_cy = patch_r = 0
        object_mask = np.zeros(image_crop.shape[:2], np.float32)
        if self.patch_occlude:
            image_crop, vis, (patch_cx, patch_cy, patch_r, object_mask) = (
                occlusion.patch_occlusion(image_crop, crop_uv, idx=idx,
                                          size=50, vis=None, copy=False)
            )
        else:
            vis = np.ones((21,), dtype=np.float32)

        # Only the requested masks ride the flip/warp chain; image/uv/pose
        # always do. (depth/hand-mask crops that no output ever carried were
        # dead work — rhddataloader.py's target has no depth either.)
        masks = {}
        if need("mask"):
            masks["mask"] = hand_mask_crop
        if need("object_mask"):
            masks["object_mask"] = object_mask
        if left:
            image_crop, crop_uv, pose3d_normed, flipped = T.flip_left_to_right(
                image_crop, crop_uv, pose3d_normed, tuple(masks.values()), s
            )
            masks = dict(zip(masks.keys(), flipped))
            cloud_normed[:, 0] = -cloud_normed[:, 0]
        return {
            # u8 storage is exact: every prefix pixel op copies u8
            # integer values (see the image_u8 note in __init__).
            "image": image_crop.astype(np.uint8),
            "crop_uv": crop_uv,
            "pose3d_normed": pose3d_normed,
            "vis": vis,
            "masks": masks,
            "cloud_normed": cloud_normed,
            "patch_raw": (patch_cx, patch_cy, patch_r),
            "left": left,
            "bone": bone,
            "pose3d_root": pose3d_root,
            "crop_center": crop_center,
            "crop_size": crop_size,
            "cam": cam,
            "vc_rot": vc_rot,
            "uv_vis": uv_vis,
            "heatmap": heatmap,
            "original_pose3d": kp_xyz[:21] if left else kp_xyz[-21:],
        }

    def __getitem__(self, idx: int):
        ori_idx = idx
        if self.mode == "training" and idx in BAD_TRAIN:
            idx = 0
        if self.mode == "evaluation" and idx in BAD_EVAL:
            idx = 0
        pre = self._prefix(idx)
        s = self.size
        need = common.field_gate(self.heavy)
        image_crop = pre["image"]
        crop_uv, pose3d_normed = pre["crop_uv"], pre["pose3d_normed"]
        vis, masks, cloud_normed = pre["vis"], pre["masks"], pre["cloud_normed"]
        patch_cx, patch_cy, patch_r = pre["patch_raw"]
        left, bone = pre["left"], pre["bone"]
        pose3d_root, crop_center = pre["pose3d_root"], pre["crop_center"]
        crop_size, cam, vc_rot = pre["crop_size"], pre["cam"], pre["vc_rot"]
        uv_vis, heatmap = pre["uv_vis"], pre["heatmap"]

        rot_mat = np.eye(2, 3, dtype=np.float32)
        hand_side = np.float32(left)
        rng = common.item_rng(self.seed, self.epoch, idx)
        if self.aug:
            params = T.make_aug_params(rng, trans_std=22.0)
            rot_mat = T.aug_rot_mat(params, s)
            pose3d_normed = T.rotate_xy(pose3d_normed, params["angle"])
            cloud_normed = T.rotate_xy(cloud_normed, params["angle"])
            crop_uv = T.apply_affine_uv(crop_uv, rot_mat)
            image_crop = T.warp_image(image_crop, rot_mat, s)
            masks = {k: T.warp_image(m, rot_mat, s) for k, m in masks.items()}
            if heatmap is not None:
                # Reference train path flips + warps the heatmap too
                # (augment.py:34, 52, 64-67: same angle/scale about the
                # 64px centre, translation x0.25, INTER_LINEAR). The
                # prefix keeps it unwarped because the reference EVAL
                # path ('processing') leaves the heatmap unflipped — a
                # reference defect kept for parity there.
                if left:
                    heatmap = heatmap[:, ::-1, :].copy()
                hm_params = dict(params, tx=params["tx"] * 0.25,
                                 ty=params["ty"] * 0.25)
                heatmap = T.warp_image(
                    heatmap, T.aug_rot_mat(hm_params, 64), 64, linear=True)
        cloud_out = (
            cloud_normed[rng.permutation(len(cloud_normed))[:256]]
            if need("cloud") else cloud_normed
        )

        vis = occlusion.demote_out_of_bounds(vis, crop_uv, (s, s), quant=2)

        patch_center = np.array([patch_cx, patch_cy], np.float32)
        if self.aug:
            patch_center = rot_mat[:, :2] @ patch_center + rot_mat[:, 2]
        if left:
            patch_center[0] = (s - 1) - patch_center[0]
        patch = np.array([*patch_center, patch_r], np.float32)

        uv_out = crop_uv.copy()
        if self.uv_norm:
            uv_out = uv_out / s * 2.0 - 1.0
            patch[:2] = patch[:2] / s * 2.0 - 1.0
            patch[2] = patch[2] / s * 2.0

        rot3 = np.eye(3)
        rot3[:2, :] = rot_mat
        rot_mat_inv = np.linalg.inv(rot3.T)[:, :2]

        if self.aug and self.color_jitter:
            # The reference's appearance augmentation, at its exact
            # position: after the geometric augmentation, before ToTensor
            # (rhddataloader.py:153-155 — ColorJitter(brightness=0.8,
            # contrast=[0.4,1.6], saturation=[0.4,1.6], hue=0.1) on the u8
            # image). u8-in/u8-out, so BOTH transports stay value-exact.
            # Dedicated stream: drawing from the main item stream would
            # shift every existing draw and change all seeded items.
            from mhentropy_tpu_torch.data import colorjitter

            jrng = common.item_rng_stream(self.seed, self.epoch, idx, 1)
            image_crop = colorjitter.color_jitter(
                jrng, image_crop.astype(np.uint8)).astype(image_crop.dtype)

        st = None if self.device_st else T.compute_st_np(pose3d_normed, uv_out)
        if self.image_u8:
            # Exact: the crop kernel gathers u8 values into f32 and every
            # later op (patch blackout, flip, NEAREST warp) copies pixels,
            # so each value is still an exact u8 integer. The device
            # applies x/255 (engine._prep_image).
            image_out = image_crop.astype(np.uint8)
        else:
            image_out = image_crop.astype(np.float32) / 255.0  # ToTensor parity

        target = {
            "pose3d": pose3d_normed.reshape(-1).astype(np.float32),
            "scale": np.float32(bone),
            "viewRotation": vc_rot.astype(np.float32),
            "crop_uv": uv_out.reshape(-1).astype(np.float32),
            "target_uv_weight": uv_vis.astype(np.float32),
            "crop_center": crop_center.astype(np.float32),
            "crop_size": np.float32(crop_size),
            "hand_side": hand_side,
            "bone_length": np.float32(bone),
            "pose3d_root": pose3d_root.astype(np.float32),
            "camera": cam.astype(np.float32),
            "rot_mat_inv": rot_mat_inv.astype(np.float32),
            "original_pose3d": pre["original_pose3d"].astype(np.float32),
            # rhddataloader.py:216-218 extras: the unit-normalised aug
            # rotation and the fused uv+depth regression target.
            "_rot_mat": (
                rot_mat[:, :2] / np.linalg.norm(rot_mat[0, :2])
            ).astype(np.float32),
            "uvd": np.concatenate(
                [uv_out.reshape(21, 2), pose3d_normed.reshape(21, 3)[:, -1:]], 1
            ).ravel().astype(np.float32),
            "st": st,
            "_idx": ori_idx,
            "_split": int(self.mode == "evaluation"),
            "vis": vis.astype(np.float32),
            "patch": patch,
            "dataset": "rhd",
        }
        if self.device_st:
            del target["st"]  # engine._prep_batch reconstructs it on device
        if self.image_u8:
            target["_img_scale"] = np.float32(1.0 / 255.0)
            target["_img_bias"] = np.float32(0.0)
        if need("cloud"):
            target["cloud"] = cloud_out.astype(np.float32)
        if need("heatmap"):
            target["heatmap"] = heatmap.astype(np.float32)
        if need("object_mask"):
            target["object_mask"] = masks["object_mask"].astype(np.float32)
        if need("mask"):
            # 64x64 nearest hand mask (rhddataloader.py:196, 223).
            target["mask"] = T.resize_nearest(
                masks["mask"].astype(np.float32), 64
            )
        return image_out, target


def load(data_dir: str, mode: str = "training", **kw) -> RHDDataset:
    return RHDDataset(data_dir, mode=mode, **kw)
