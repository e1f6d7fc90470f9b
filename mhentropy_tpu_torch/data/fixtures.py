"""Miniature RHD, FreiHAND and HO3D trees, in each dataset's own layout and
file formats, written from a seed: what chip_smoke.py's loader phase and the
card tests train on, where no download is at hand.

The annotations follow tests/fixtures_data.py (hands about 0.5 m in front of
a 300 px focal camera, random pixels); the trees are larger and the RHD
evaluation split has samples of its own. Images are written as PNG by a
small encoder here (zlib, no filter), so writing needs no image library;
a ".jpg" name holds PNG bytes, which Pillow decodes by their content. With
`cache=True` every image's array is also written into the decode cache
(`common.set_decode_cache` must be set), so the loaders read them without
Pillow.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import zlib

import numpy as np

from mhentropy_tpu_torch.data import common

CAM = np.array([[300.0, 0, 160.0], [0, 300.0, 160.0], [0, 0, 1.0]], np.float32)


def write_png(path: str, arr: np.ndarray, cache: bool = False) -> None:
    """(H, W) or (H, W, 3) uint8 -> an 8-bit grey or RGB PNG at `path`."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], 1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                                    0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))
    if cache:
        np.save(common.decode_cache_file(path), arr)


def write_rhd(root: str, n_train: int, n_eval: int, seed: int = 0, size: int = 320,
              cache: bool = False) -> str:
    """An RHD_published_v2 tree: training/ and evaluation/, each with
    color/, mask/ and depth/ PNGs and anno_<split>.pickle. The right hand
    (joints 21-41) is the one the mask marks."""
    rng = np.random.RandomState(seed)
    for split, n in (("training", n_train), ("evaluation", n_eval)):
        annos = {}
        for idx in range(n):
            xyz_r = np.stack([rng.uniform(-0.05, 0.05, 21), rng.uniform(-0.05, 0.05, 21),
                              rng.uniform(0.45, 0.55, 21)], 1).astype(np.float32)
            xyz = np.concatenate([xyz_r + np.array([0.5, 0.5, 0.5]), xyz_r])
            uv = (xyz[:, :2] / xyz[:, 2:3]) * CAM[0, 0] + CAM[0, 2]
            annos[idx] = {"uv_vis": np.concatenate([uv, np.ones((42, 1))], 1).astype(np.float32),
                          "xyz": xyz.astype(np.float32), "K": CAM}
            base = os.path.join(root, split)
            write_png(os.path.join(base, "color", f"{idx:05d}.png"),
                      rng.randint(0, 255, (size, size, 3), np.uint8), cache)
            mask = np.zeros((size, size), np.uint8)
            for uu, vv in np.clip(uv[21:].astype(int), 0, size - 1):
                mask[max(0, vv - 6):vv + 6, max(0, uu - 6):uu + 6] = 20
            write_png(os.path.join(base, "mask", f"{idx:05d}.png"), mask, cache)
            depth_m = np.where(mask > 17, 0.5, 2.0)
            code = (depth_m / 5.0 * (2 ** 16 - 1)).astype(np.int64)
            dp = np.zeros((size, size, 3), np.uint8)
            dp[..., 0], dp[..., 1] = code // 256, code % 256
            write_png(os.path.join(base, "depth", f"{idx:05d}.png"), dp, cache)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        with open(os.path.join(root, split, f"anno_{split}.pickle"), "wb") as f:
            pickle.dump(annos, f)
    return root


def write_freihand(root: str, n: int, seed: int = 1, size: int = 224,
                   cache: bool = False) -> str:
    """A FreiHAND tree: training_K.json, training_xyz.json and
    training/rgb/<8 digits>.jpg (the loader splits off the last 10 % for
    evaluation)."""
    rng = np.random.RandomState(seed)
    ks, xyzs = [], []
    for idx in range(n):
        xyzs.append(np.stack([rng.uniform(-0.05, 0.05, 21), rng.uniform(-0.05, 0.05, 21),
                              rng.uniform(0.4, 0.5, 21)], 1).tolist())
        ks.append(CAM.tolist())
        write_png(os.path.join(root, "training", "rgb", f"{idx:08d}.jpg"),
                  rng.randint(0, 255, (size, size, 3), np.uint8), cache)
    for name, data in (("training_K.json", ks), ("training_xyz.json", xyzs)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(data, f)
    return root


def write_ho3d(root: str, n_train: int, n_eval: int, seed: int = 2,
               cache: bool = False) -> str:
    """An HO3D_v3 tree: n_train frames of sequence ABF10 and n_eval of ABF14
    (a held-out evaluation sequence), each with rgb, packed depth, seg and a
    meta pickle, the chunked joint and mesh .npy files and one YCB object.
    The depth PNGs are read by cv2, so the cache does not cover them."""
    base = os.path.join(root, "HO3D_v3", "HO3D_v3")
    gt = os.path.join(root, "HO3D_v3", "HO3D", "data")
    ycb = os.path.join(root, "HO3D_v3", "models", "003_box")
    rng = np.random.RandomState(seed)
    files = ([f"ABF10/{i:04d}" for i in range(n_train)]
             + [f"ABF14/{n_train + i:04d}" for i in range(n_eval)])
    os.makedirs(gt, exist_ok=True)
    os.makedirs(ycb, exist_ok=True)
    code = (np.full((480, 640), 0.5) / 0.00012498664727900177).astype(np.int64)
    depth = np.zeros((480, 640, 3), np.uint8)
    depth[..., 2], depth[..., 1] = code % 256, code // 256 % 256
    seg = np.zeros((120, 160, 3), np.uint8)
    seg[40:80, 50:110, 2] = 255  # hand
    seg[20:40, 20:60, 1] = 255  # object
    meta = {"camMat": CAM.astype(np.float64), "objName": "003_box", "objRot": np.zeros((3, 1)),
            "objTrans": np.array([0.0, 0.0, -0.5])}
    joints, meshes = [], []
    for seq_frame in files:
        seq, frame = seq_frame.split("/")
        j = np.stack([rng.uniform(-0.04, 0.04, 21), rng.uniform(-0.04, 0.04, 21),
                      -rng.uniform(0.45, 0.55, 21)], 1)  # OpenGL: the hand along -z
        joints.append(j)
        meshes.append(rng.uniform(-0.05, 0.05, (778, 3)) + j.mean(0))
        write_png(os.path.join(base, "train", seq, "rgb", frame + ".jpg"),
                  rng.randint(0, 255, (480, 640, 3), np.uint8), cache)
        write_png(os.path.join(base, "train", seq, "depth", frame + ".png"), depth)
        write_png(os.path.join(root, "HO3D_v3", "train", seq, "seg", frame + ".png"), seg, cache)
        os.makedirs(os.path.join(base, "train", seq, "meta"), exist_ok=True)
        with open(os.path.join(base, "train", seq, "meta", frame + ".pkl"), "wb") as f:
            pickle.dump(meta, f)
    with open(os.path.join(base, "train.txt"), "w") as f:
        f.write("\n".join(files) + "\n")
    for kind, arr in (("handJoints3D", np.asarray(joints)), ("ho3d_mesh", np.asarray(meshes))):
        for tag, part in (("4w", arr[:n_train]), ("8w", arr[n_train:]), ("left", arr[:0])):
            np.save(os.path.join(gt, f"{kind}_train_{tag}.npy"), part)
    with open(os.path.join(ycb, "textured_simple.obj"), "w") as f:
        for _ in range(12):
            v = rng.uniform(-0.05, 0.05, 3)
            f.write(f"v {v[0]} {v[1]} {v[2] - 0.5}\nvn 0 0 1\n")
    return root
