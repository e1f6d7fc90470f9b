"""FreiHAND dataset pipeline (host side).

Port of mhentropy_tpu/data/freihand.py, line for line (its items equal the
JAX package's).

The reference carries FreiHAND index maps (utils.py:15,17) and a freihand
branch in its z-normalisation (network.py:476-478) but never wires a loader
(make_ds_dl raises NotImplementedError, CrossModalHand.py:168-174).
BASELINE.json config 3 requires FreiHAND mesh recovery, so this loader makes
it real: standard FreiHAND layout (training_K.json / training_xyz.json /
training_verts.json / training/rgb/*.jpg), keypoints projected with the
per-sample intrinsics, crop around the root with the same conventions as the
other hand sets, root/norm joints 9/10 in FreiHAND order
(skeletons.ROOT_IDX['freihand']).
"""

from __future__ import annotations

import json
import os

import numpy as np

from mhentropy_tpu_torch.data import common, occlusion, transforms as T

ROOT_IDX_FH = 9
NORM_IDX_FH = 10
N_UNIQUE = 32560  # unique poses; the dataset repeats them with 4 backgrounds


class FreiHANDDataset:
    #: No per-pixel extras here — the param exists for loader-interface
    #: uniformity with RHD/HO3D (the Experiment passes one field set).
    HEAVY_FIELDS = frozenset()

    def __init__(
        self,
        data_root: str,
        mode: str = "training",
        image_size: int = 224,
        seed: int = 0,
        eval_fraction: float = 0.1,
        heavy_fields: frozenset | set | None = None,
        image_u8: bool = False,
        device_st: bool = False,
        prefix_cache: str | None = None,
    ):
        # FreiHAND has no per-pixel extras (HEAVY_FIELDS is empty), so the
        # request only lands in the cache fingerprint. Foreign keys (e.g.
        # "hand_mask" for HO3D) are tolerated by the engine contract —
        # each loader gates on its own field names.
        self.heavy = None if heavy_fields is None else frozenset(heavy_fields)
        # Deterministic-prefix cache, same contract as RHD/HO3D: the jpg
        # decode + projection + crop (everything before the aug RNG) is a
        # pure function of idx, so items are bit-identical cached or not.
        self.prefix_cache = prefix_cache
        # uint8 image transport, both modes (train-mode pixel noise ships
        # as a `_pixel_noise` target factor applied on device); the device
        # applies x/255 via _img_scale/_img_bias (engine._prep_image).
        self.image_u8 = image_u8
        # Omit the host (s, t) fit; engine._prep_batch reconstructs it.
        self.device_st = device_st
        self.root = data_root
        self.size = image_size
        self.mode = mode
        self.aug = mode == "training"
        self.seed = seed
        self.epoch = 0  # advanced by set_epoch (engine.train_epoch)
        k_path = os.path.join(data_root, "training_K.json")
        xyz_path = os.path.join(data_root, "training_xyz.json")
        with open(k_path) as f:
            self.k_mats = np.asarray(json.load(f), np.float32)
        with open(xyz_path) as f:
            self.xyz = np.asarray(json.load(f), np.float32)
        verts_path = os.path.join(data_root, "training_verts.json")
        self.verts = None
        if os.path.exists(verts_path):
            with open(verts_path) as f:
                self.verts = np.asarray(json.load(f), np.float32)
        # In-place annotation swaps (same root/count) must miss both the
        # prefix cache and SampleCache (cached.fingerprint reads this).
        # verts included: items carry them, and the file appearing or
        # vanishing under a cached root changes the target schema.
        self._anno_stat = tuple(
            (os.path.getmtime(p), os.path.getsize(p))
            if os.path.exists(p) else None
            for p in (k_path, xyz_path, verts_path)
        )
        n = len(self.xyz)
        split = int(n * (1.0 - eval_fraction))
        self.indices = (
            np.arange(split) if mode == "training" else np.arange(split, n)
        )

    def __len__(self):
        return len(self.indices)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation RNG stream (common.item_rng)."""
        self.epoch = int(epoch)

    @property
    def _prefix_cacheable(self) -> bool:
        # The whole prefix is RNG-free for FreiHAND (no cloud resample),
        # so a configured cache dir is the only condition.
        return self.prefix_cache is not None

    def _prefix_dir(self):
        d = getattr(self, "_prefix_dir_memo", None)
        if d is not None:
            return d
        from mhentropy_tpu_torch.data import cached

        # mode deliberately absent: the prefix (decode -> crop) is
        # mode-independent, so train and eval share one cache.
        fp = cached.config_fingerprint({
            "cls": "FreiHANDDataset.prefix",
            "root": os.path.abspath(self.root),
            "size": self.size,
            "anno": self._anno_stat,
            "v": 1,
        })
        d = os.path.join(self.prefix_cache, fp)
        os.makedirs(d, exist_ok=True)
        self._prefix_dir_memo = d
        return d

    def _prefix(self, idx: int) -> dict:
        if self._prefix_cacheable:
            from mhentropy_tpu_torch.data import cached

            return cached.read_or_compute_pickle(
                os.path.join(self._prefix_dir(), f"{idx}.pkl"),
                lambda: self._compute_prefix(idx),
            )
        return self._compute_prefix(idx)

    def _compute_prefix(self, idx: int) -> dict:
        """Deterministic item prefix keyed on the RAW dataset index: jpg
        decode (the dominant host cost), projection, pose normalisation,
        crop/resize. The image ships as the decoded u8 crop — exact for
        both transports (the f32 path normalises after the aug suffix)."""
        image = common.imread(
            os.path.join(self.root, "training", "rgb", f"{idx:08d}.jpg")
        )
        cam = self.k_mats[idx]
        xyz = self.xyz[idx]  # metres, camera coords
        uv = T.xyz2uvd_cv(xyz, cam)[:, :2]

        pose3d_normed, root, bone = T.normalize_pose3d_np(
            xyz, ROOT_IDX_FH, NORM_IDX_FH)

        centre = uv[ROOT_IDX_FH].astype(np.float64)
        half = float(np.max(np.abs(uv - centre))) * 1.3
        s = self.size
        image_crop = T.resize_nearest(
            T.crop_with_padding(image, centre, half), s)
        crop_uv = (uv - centre) * (s / (2 * half)) + s // 2
        return {
            "image_crop": image_crop.astype(np.uint8),
            "crop_uv": crop_uv,
            "pose3d_normed": pose3d_normed,
            "root": root,
            "bone": bone,
            "cam": cam,
            "centre": centre,
            "half": half,
            "xyz": xyz,
        }

    def __getitem__(self, i: int):
        idx = int(self.indices[i])
        pre = self._prefix(idx)
        cam, xyz = pre["cam"], pre["xyz"]
        pose3d_normed, root, bone = (
            pre["pose3d_normed"], pre["root"], pre["bone"])
        centre, half = pre["centre"], pre["half"]
        image_crop, crop_uv = pre["image_crop"], pre["crop_uv"]
        s = self.size

        rot_mat = np.eye(2, 3, dtype=np.float32)
        pixel_noise = None
        if self.aug:
            rng = common.item_rng(self.seed, self.epoch, i)
            params = T.make_aug_params(rng, trans_std=10.0)
            rot_mat = T.aug_rot_mat(params, s)
            pose3d_normed = T.rotate_xy(pose3d_normed, params["angle"])
            crop_uv = T.apply_affine_uv(crop_uv, rot_mat)
            if self.image_u8:
                # Same rng position as the f32 path's pixel_noise draw;
                # applied on device (engine._prep_image). Exact: the
                # nearest warp is a pure gather with 0 border fill and
                # noise(0) == 0, so noise-then-warp == warp-then-noise.
                pixel_noise = T.pixel_noise_params(rng)
                image_crop = T.warp_image(image_crop, rot_mat, s)
            else:
                image_crop = T.warp_image(
                    T.pixel_noise(rng, image_crop.astype(np.float32)),
                    rot_mat, s,
                )

        vis = np.ones(21, np.float32)
        vis = occlusion.demote_out_of_bounds(vis, crop_uv, (s, s), quant=2)
        uv_norm = crop_uv / s * 2.0 - 1.0
        st = None if self.device_st else \
            T.compute_st_np(pose3d_normed, uv_norm)

        rot3 = np.eye(3)
        rot3[:2, :] = rot_mat
        rot_mat_inv = np.linalg.inv(rot3.T)[:, :2]

        target = {
            "crop_uv": uv_norm.reshape(-1).astype(np.float32),
            "pose3d": pose3d_normed.reshape(-1).astype(np.float32),
            "vis": vis,
            "scale": np.float32(bone),
            "st": st,
            "original_pose3d": (xyz * 1000.0).astype(np.float32),
            "pose3d_root": root.astype(np.float32),
            "crop_center": centre.astype(np.float32),
            "crop_size": np.float32(half),
            "hand_side": np.float32(0.0),
            "bone_length": np.float32(bone),
            "camera": cam,
            "rot_mat_inv": rot_mat_inv.astype(np.float32),
            "patch": np.zeros(3, np.float32),
            "dataset": "freihand",
        }
        if self.device_st:
            del target["st"]  # engine._prep_batch reconstructs it on device
        if self.verts is not None:
            target["verts"] = (self.verts[idx % N_UNIQUE] * 1000.0).reshape(-1)
        if self.image_u8:
            # Crop/warp = NEAREST gather of u8 pixels -> exact integers;
            # train-mode noise rides the target for device-side apply.
            target["_img_scale"] = np.float32(1.0 / 255.0)
            target["_img_bias"] = np.float32(0.0)
            if pixel_noise is not None:
                target["_pixel_noise"] = pixel_noise
            return image_crop.astype(np.uint8), target
        return image_crop.astype(np.float32) / 255.0, target


def load(data_dir: str, mode: str = "training", **kw) -> FreiHANDDataset:
    return FreiHANDDataset(data_dir, mode=mode, **kw)
