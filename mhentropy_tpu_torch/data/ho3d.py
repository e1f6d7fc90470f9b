"""HO3D v3 dataset pipeline (host side, numpy/cv2).

Port of mhentropy_tpu/data/ho3d.py, line for line (its items equal the JAX
package's), with the reference's ho3d_dataloader.py:200-459 behind both: train/val split by held-out sequences, precomputed joint/mesh .npy
annotations, YCB object meshes, hand+object fused bbox crop to 256, depth-vs-
mask visibility with out-of-bounds demotion after augmentation, scale/rot/
trans/pixel-noise augmentation, RHD joint reorder, [-1,1) uv, orthographic
(s,t) fit, and the ~25-key target dict.

Requires the HO3D_v3 download; every path is checked lazily so the module
imports (and the rest of the framework runs on the synthetic fixture) without
the data.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from mhentropy_tpu_torch.data import common, occlusion, transforms as T

HO3D2RHD = np.array(
    [0, 16, 15, 14, 13, 17, 3, 2, 1, 18, 6, 5, 4, 19, 12, 11, 10, 20, 9, 8, 7]
)
EVAL_SEQS = ("ABF14", "MC5", "SB14", "ShSu13")  # ho3d_dataloader.py:243
ROOT_IDX_HO3D = 4  # in native HO3D order; maps to RHD 12 (ho3d2RHD[12]=4)
NORM_IDX_HO3D = 5


def read_depth_img(base_dir, seq, frame_id, split) -> np.ndarray:
    """16-bit RGB-packed depth, scale 0.00012498664727900177
    (ho3d_vis_utils.py:457-469)."""
    import cv2

    path = os.path.join(base_dir, split, seq, "depth", f"{frame_id}.png")
    depth_img = cv2.imread(path)
    depth = (
        depth_img[:, :, 2] + depth_img[:, :, 1] * 256.0
    ) * 0.00012498664727900177
    return depth.astype(np.float32)


def read_annotation(base_dir, seq, frame_id, split) -> dict:
    path = os.path.join(base_dir, split, seq, "meta", f"{frame_id}.pkl")
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def read_obj(path: str) -> dict:
    """Wavefront obj: vertices + normals (ho3d_vis_utils.py:332-377 subset)."""
    v, vn = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                v.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                vn.append([float(x) for x in line.split()[1:4]])
    return {"v": np.asarray(v, np.float32), "vn": np.asarray(vn, np.float32)}


class HO3DDataset:
    """Index-addressable dataset; collate with data.common.batches."""

    #: Per-pixel target fields no shipped train/eval path consumes
    #: (hand_mask only when cfg.network.use_mask_loss — the Experiment
    #: requests it then). Gating them skips their crops/warps and ~0.8 MB
    #: of per-sample H2D.
    HEAVY_FIELDS = frozenset({"depth", "hand_mask", "object_mask"})

    def __init__(
        self,
        data_root: str,
        mode: str = "training",
        image_size: int = 256,
        seed: int = 0,
        heavy_fields: frozenset | set | None = None,
        image_u8: bool = False,
        device_st: bool = False,
        prefix_cache: str | None = None,
    ):
        import cv2  # noqa: F401 — required for image IO / warps

        assert mode in ("training", "evaluation")
        self.mode = mode
        self.aug = mode == "training"
        self.image_size = image_size
        self.heavy = None if heavy_fields is None else frozenset(heavy_fields)
        # uint8 image transport, BOTH modes: the crop/warp chain is a
        # nearest gather of u8 pixels, and the train-mode pixel noise
        # (ho3d_dataloader.py aug) ships as a `_pixel_noise` target factor
        # applied on device. The device normalises x*2/255-1 via the
        # target's _img_scale/_img_bias (engine._prep_image).
        self.image_u8 = image_u8
        # Omit the host (s, t) fit; engine._prep_batch reconstructs it on
        # device from pose3d/crop_uv (core.camera.compute_st).
        self.device_st = device_st
        # Deterministic-prefix disk cache (same design as the RHD
        # loader's): the reads (jpg/depth/seg), crops, visibility test,
        # and normalisation draw no RNG; only the augmentation suffix
        # (pixel noise, warps) and the train-mode object subsample do.
        # Cached/uncached items are bit-identical.
        self.prefix_cache = prefix_cache
        self.seed = seed
        self.epoch = 0  # advanced by set_epoch (engine.train_epoch)
        self.rng = np.random.RandomState(seed)  # legacy users only

        self.base = os.path.join(data_root, "HO3D_v3", "HO3D_v3")
        self.ycb_root = os.path.join(data_root, "HO3D_v3", "models")
        self.gt_root = os.path.join(data_root, "HO3D_v3", "HO3D", "data")
        self.seg_root = os.path.join(data_root, "HO3D_v3")
        for p in (self.base, self.gt_root):
            if not os.path.isdir(p):
                raise FileNotFoundError(p)

        # Annotation content identity for the prefix-cache fingerprint:
        # in-place re-downloads with the same sample count must miss.
        anno_files = [os.path.join(self.base, "train.txt")] + [
            os.path.join(self.gt_root, f"{kind}_train_{s}.npy")
            for kind in ("handJoints3D", "ho3d_mesh")  # meshes feed 'verts'
            for s in ("4w", "8w", "left")
        ]
        self._anno_stat = tuple(
            (int(os.stat(p).st_mtime), os.stat(p).st_size)
            for p in anno_files if os.path.isfile(p)
        )
        with open(os.path.join(self.base, "train.txt")) as f:
            files = np.array([ln.strip() for ln in f if ln.strip()])
        joints = np.concatenate(
            [
                np.load(os.path.join(self.gt_root, f"handJoints3D_train_{s}.npy"))
                for s in ("4w", "8w", "left")
            ]
        )
        meshes = np.concatenate(
            [
                np.load(os.path.join(self.gt_root, f"ho3d_mesh_train_{s}.npy"))
                for s in ("4w", "8w", "left")
            ]
        )
        # Custom split: the four held-out sequences are the eval set
        # (ho3d_dataloader.py:243-255).
        in_eval = np.array([f.split("/")[0] in EVAL_SEQS for f in files])
        keep = in_eval if mode == "evaluation" else ~in_eval
        self.files = files[keep]
        self.joints3d = joints[keep]
        self.meshes = meshes[keep]

        self.obj_meshes = {}
        if os.path.isdir(self.ycb_root):
            for name in sorted(os.listdir(self.ycb_root)):
                path = os.path.join(self.ycb_root, name, "textured_simple.obj")
                if os.path.isfile(path):
                    self.obj_meshes[name] = read_obj(path)

    def __len__(self):
        return len(self.files)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation RNG stream (common.item_rng)."""
        self.epoch = int(epoch)

    def _prefix_dir(self):
        d = getattr(self, "_prefix_dir_memo", None)
        if d is not None:
            return d
        from mhentropy_tpu_torch.data import cached

        # heavy_field_tag keeps heavy=None ("full") distinct from
        # heavy=set(): the full target's prefix carries depth/mask crops
        # the minimal one stores as None, so a collision would serve
        # None crops into a full-target run.
        fp = cached.config_fingerprint({
            "cls": "HO3DDataset.prefix", "mode": self.mode, "n": len(self),
            "root": os.path.abspath(self.base),  # two roots never collide
            "size": self.image_size,
            "heavy": cached.heavy_field_tag(self.heavy),
            "anno": self._anno_stat,  # in-place annotation swaps miss
            "v": 2,  # prefix schema version (v2: pose3d_root dropped)
        })
        d = os.path.join(self.prefix_cache, fp)
        os.makedirs(d, exist_ok=True)
        self._prefix_dir_memo = d
        return d

    def _prefix(self, idx: int) -> dict:
        if self.prefix_cache is not None:
            from mhentropy_tpu_torch.data import cached

            return cached.read_or_compute_pickle(
                os.path.join(self._prefix_dir(), f"{idx}.pkl"),
                lambda: self._compute_prefix(idx),
            )
        return self._compute_prefix(idx)

    def _compute_prefix(self, idx: int) -> dict:
        import cv2
        seq, frame = self.files[idx].split("/")
        image = common.imread(
            os.path.join(self.base, "train", seq, "rgb", frame + ".jpg")
        )
        depth = read_depth_img(self.base, seq, frame, "train")
        seg = common.imread(
            os.path.join(self.seg_root, "train", seq, "seg", frame + ".png")
        )
        seg = cv2.resize(seg, (640, 480), interpolation=cv2.INTER_NEAREST)
        anno = read_annotation(self.base, seq, frame, "train")
        cam = anno["camMat"]

        joints_gl = self.joints3d[idx] * 1000.0  # mm, OpenGL coords
        mesh_gl = self.meshes[idx] * 1000.0
        obj = self.obj_meshes.get(anno["objName"])
        rot = cv2.Rodrigues(anno["objRot"])[0]
        obj_v = (obj["v"] @ rot.T + anno["objTrans"]) * 1000.0 if obj else None

        uvd = T.xyz2uvd_gl(joints_gl, cam)
        joints_cv = T.coord_change(joints_gl)
        mesh_cv = T.coord_change(mesh_gl)
        obj_cv = T.coord_change(obj_v) if obj_v is not None else np.zeros((1000, 3))

        # Fused hand+object crop (ho3d_dataloader.py:317-341).
        bbox_hand = T.bbox_from_joints(uvd[:, :2], factor=1.5)
        if obj_v is not None:
            obj_uv = T.xyz2uvd_gl(obj_v, cam)[:, :2]
            bbox_obj = T.bbox_from_joints(obj_uv, factor=1.0)
        else:
            bbox_obj = bbox_hand
        centre, scale = T.fuse_bbox(bbox_hand, bbox_obj, image.shape)
        half = scale / 2.0

        s = self.image_size
        need = common.field_gate(self.heavy)
        image_crop = T.crop_resize(image, centre, half, s)
        depth_crop = (
            T.crop_resize(depth, centre, half, s, pad=0.0)
            if need("depth") else None
        )
        if need("hand_mask") or need("object_mask"):
            seg_crop = T.crop_resize(seg, centre, half, s)
            obj_mask = seg_crop[:, :, 1] > 200
            hand_mask_crop = seg_crop[:, :, 2] > 200
        else:
            obj_mask = hand_mask_crop = None
        hand_mask_full = seg[:, :, 2] > 200  # full-frame: visibility test

        # Crop-space uv (ho3d_dataloader.py:356-358).
        uv_crop = (uvd[:, :2] - centre[None] + half) * (s / (2.0 * half))

        # Visibility: depth-vs-mask window test on the full image
        # (ho3d_dataloader.py:360-377), then aug, then oob demotion.
        vis = occlusion.depth_mask_visibility(
            uvd, hand_mask_full, depth, quant=5, tol_mm=40.0
        ).astype(np.float32)

        # normalize's root return is unused: the target derives the root
        # from joints_cv_r[12]/1000 after the RHD reorder.
        pose3d_normed, _, bone_mm = T.normalize_pose3d_np(
            joints_cv, ROOT_IDX_HO3D, NORM_IDX_HO3D
        )
        return {
            # u8 storage is exact: the crop is a NEAREST gather of u8
            # pixels (integers in f32).
            "image": image_crop.astype(np.uint8),
            "depth_crop": depth_crop,
            "obj_mask": obj_mask,
            "hand_mask_crop": hand_mask_crop,
            "uv_crop": uv_crop,
            "vis": vis,
            "pose3d_normed": pose3d_normed,
            "bone_mm": bone_mm,
            "centre": centre,
            "half": half,
            "cam": cam,
            "joints_cv": joints_cv,
            "mesh_cv": mesh_cv,
            "obj_cv": obj_cv.astype(np.float32),
        }

    def __getitem__(self, idx: int):
        pre = self._prefix(idx)
        s = self.image_size
        need = common.field_gate(self.heavy)
        image_crop = pre["image"]
        depth_crop, obj_mask = pre["depth_crop"], pre["obj_mask"]
        hand_mask_crop, uv_crop = pre["hand_mask_crop"], pre["uv_crop"]
        vis, pose3d_normed = pre["vis"], pre["pose3d_normed"]
        bone_mm = pre["bone_mm"]
        centre, half, cam = pre["centre"], pre["half"], pre["cam"]
        joints_cv, mesh_cv, obj_cv = (
            pre["joints_cv"], pre["mesh_cv"], pre["obj_cv"]
        )

        rot_mat = np.eye(2, 3, dtype=np.float32)
        rng = common.item_rng(self.seed, self.epoch, idx)
        pixel_noise = None
        if self.aug:
            if self.image_u8:
                # uint8 transport for TRAINING too: draw the noise factors
                # at the f32 path's exact rng-stream position but apply
                # them on DEVICE (engine._prep_image). Valid because the
                # nearest warp below is a pure gather whose border fill is
                # 0 and noise(0) == 0, so noise-then-warp (the reference
                # order, ho3d_dataloader.py:191-198) == warp-then-noise
                # pointwise — the crop stays exact u8 integers on the wire
                # (4x less host-to-device traffic).
                pixel_noise = T.pixel_noise_params(rng)
            else:
                image_crop = T.pixel_noise(rng, image_crop.astype(np.float32))
            params = T.make_aug_params(rng, trans_std=10.0)
            rot_mat = T.aug_rot_mat(params, s)
            pose3d_normed = T.rotate_xy(pose3d_normed, params["angle"])
            uv_crop = T.apply_affine_uv(uv_crop, rot_mat)
            image_crop = T.warp_image(image_crop, rot_mat, s)
            if need("depth"):
                depth_crop = T.warp_image(depth_crop, rot_mat, s)
            if hand_mask_crop is not None:
                hand_mask_crop = T.warp_image(
                    hand_mask_crop.astype(np.float32), rot_mat, s
                ).astype(bool)
                obj_mask = T.warp_image(
                    obj_mask.astype(np.float32), rot_mat, s
                ).astype(bool)

        vis = occlusion.demote_out_of_bounds(vis, uv_crop, (s, s), quant=5)

        # RHD joint order + [-1,1) uv (ho3d_dataloader.py:412-418).
        uv_crop = uv_crop[HO3D2RHD]
        joints_cv_r = joints_cv[HO3D2RHD]
        pose3d_normed = pose3d_normed[HO3D2RHD]
        vis = vis[HO3D2RHD]
        uv_norm = uv_crop / s * 2.0 - 1.0

        rot3 = np.eye(3)
        rot3[:2, :] = rot_mat
        rot_mat_inv = np.linalg.inv(rot3.T)[:, :2]

        st = None if self.device_st else \
            T.compute_st_np(pose3d_normed, uv_norm)

        # [-1, 1] image normalisation (ho3d_dataloader.py:404-405).
        # Both modes ship u8 exactly: the crop/warp chain is a NEAREST
        # gather of u8 pixels, and the train-mode pixel noise rides the
        # target as `_pixel_noise` for device-side application (above).
        u8 = self.image_u8
        if u8:
            image_out = image_crop.astype(np.uint8)  # device: x*2/255-1
        else:
            image_out = image_crop.astype(np.float32) / 255.0 * 2.0 - 1.0

        if obj_cv.shape[0] >= 1000:
            # Eval subsampling is idx-seeded: deterministic metrics across
            # epochs/runs, and the one RNG draw that would otherwise block
            # the eval sample cache (data/cached.py). Training uses the
            # per-(seed, epoch, idx) stream like the other aug draws.
            sub_rng = rng if self.aug else \
                np.random.RandomState((idx * 2654435761) & 0x7FFFFFFF)
            sel = np.sort(sub_rng.choice(obj_cv.shape[0], 1000, replace=False))
            obj_sel = obj_cv[sel]
        else:
            obj_sel = np.resize(obj_cv, (1000, 3))

        target = {
            "crop_uv": uv_norm.reshape(-1).astype(np.float32),
            "vis": vis.astype(np.float32),
            "original_pose3d": joints_cv_r.astype(np.float32),
            "verts": mesh_cv.reshape(-1).astype(np.float32),
            "pose3d": pose3d_normed.reshape(-1).astype(np.float32),
            "pose3d_root": (joints_cv_r[12] / 1000.0).astype(np.float32),
            "st": st,
            "patch": np.zeros(3, np.float32),
            "scale": np.float32(bone_mm / 1000.0),  # metres
            "object_verts": obj_sel.reshape(-1).astype(np.float32),
            "crop_center": centre.astype(np.float32),
            "crop_size": np.float32(half),
            "hand_side": np.float32(0.0),
            "bone_length": np.float32(bone_mm / 1000.0),
            "camera": cam.astype(np.float32),
            "rot_mat_inv": rot_mat_inv.astype(np.float32),
            "dataset": "ho3d",
            "idx": idx,
        }
        if self.device_st:
            del target["st"]  # engine._prep_batch reconstructs it on device
        if u8:
            target["_img_scale"] = np.float32(2.0 / 255.0)
            target["_img_bias"] = np.float32(-1.0)
            if pixel_noise is not None:
                target["_pixel_noise"] = pixel_noise
        if need("depth"):
            target["depth"] = depth_crop.astype(np.float32)
        if need("hand_mask"):
            target["hand_mask"] = hand_mask_crop
        if need("object_mask"):
            target["object_mask"] = obj_mask
        return image_out, target


def load(data_dir: str, mode: str = "training", **kw) -> HO3DDataset:
    return HO3DDataset(data_dir, mode=mode, **kw)
