"""MANO hand model on torch tensors: the decode the server runs.

Port of mhentropy_tpu/core/mano.py: `ManoModel` :88, `load_mano_pkl` :151
(with the chumpy stub :112), `find_mano_assets` :173, `synthetic_mano_model`
:184, `_chain_nl` :227, `_lbs_blend_nl` :313, `mano_forward` :366,
`_folded_kp26_nl` :404 and `mano_decode` :449. The blend runs the port's
`lbs_blend` kernel on CUDA tensors (core/lbs_cuda.py), unless the caller
asks for the plain einsums (`mano_decode(lbs_kernel=False)`, JAX's
`pallas_lbs=False`), as the training objective does.

Tensors keep the reference's batch-last layout ((3, 16, B) joints, (3, 778, B)
mesh planes), so each step reads like its JAX counterpart. Keypoints come from
the folded regressor: the model-only contractions (`fold_keypoints`) are
computed once per model and passed in, since eager PyTorch would otherwise
redo them on every call. PyTorch does not dead-code either: the 778-vertex
mesh is computed only when the caller asks for it (`with_mesh=True`).
"""

from __future__ import annotations

import io
import os
import pickle
import sys
import types
from typing import NamedTuple

import numpy as np
import torch

from mhentropy_tpu_torch.core import lbs_cuda, skeletons
from mhentropy_tpu_torch.core.rotations import batch_rodrigues

N_VERTS = 778
N_JOINTS = 16  # wrist + 15 articulated
N_POSE = 45  # 15 joints x 3 axis-angle dims

# Finger chains: level-k joint indices in MANO ordering.
LEV1 = [1, 4, 7, 10, 13]
LEV2 = [2, 5, 8, 11, 14]
LEV3 = [3, 6, 9, 12, 15]
# Interleave (root, lev1[f], lev2[f], lev3[f]) back to MANO joint order.
CHAIN_REORDER = [0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15]


class ManoModel(NamedTuple):
    """Frozen MANO constants (float32 tensors unless noted)."""

    v_template: torch.Tensor  # (778, 3)
    shapedirs: torch.Tensor  # (778, 3, 10)
    posedirs: torch.Tensor  # (778, 3, 135)
    j_regressor: torch.Tensor  # (16, 778)
    lbs_weights: torch.Tensor  # (778, 16)
    hands_mean: torch.Tensor  # (45,)
    hands_components: torch.Tensor  # (45, 45) PCA basis rows
    faces: torch.Tensor  # (1538, 3) int32
    tips: torch.Tensor  # (5,) int64 fingertip vertex ids


class ManoConfig(NamedTuple):
    use_pca: bool = True
    ncomps: int = 45
    flat_hand_mean: bool = False
    center_idx: int | None = 9
    side: str = "right"


class KeypointFold(NamedTuple):
    """Model-only contractions of the keypoint decode (see fold_keypoints)."""

    j_rest: torch.Tensor  # (3, 16) regressed rest joints of the template
    j_dirs: torch.Tensor  # (16, 3, 10) their shape directions
    c_t: torch.Tensor  # (16, 26, 3)
    c_s: torch.Tensor  # (16, 26, 3, 10)
    c_p: torch.Tensor  # (16, 26, 3, 135)
    w1: torch.Tensor  # (26, 16)
    rowsum: torch.Tensor  # (26,)


def _install_chumpy_stub() -> None:
    """Register a minimal 'chumpy' so MANO pkls unpickle without the package.

    Chumpy Ch objects pickle as plain attribute dicts holding a numpy array
    under 'x'; only `.r` is read afterwards.
    """
    if "chumpy" in sys.modules:
        return

    class _Ch:
        def __init__(self, *args, **kwargs):
            if args:
                self.x = np.asarray(args[0])

        def __setstate__(self, state):
            self.__dict__.update(state)

        @property
        def r(self):
            return np.asarray(self.x)

    mod = types.ModuleType("chumpy")
    mod.Ch = _Ch
    sys.modules["chumpy"] = mod
    for sub in ("ch", "reordering", "ch_ops", "utils"):
        m = types.ModuleType(f"chumpy.{sub}")
        m.Ch = _Ch
        sys.modules[f"chumpy.{sub}"] = m
        setattr(mod, sub, m)


def _as_np(x) -> np.ndarray:
    if hasattr(x, "r"):
        return np.asarray(x.r)
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


def _model_from_numpy(device, **arrays) -> ManoModel:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ManoModel(
        v_template=f32(arrays["v_template"]),
        shapedirs=f32(arrays["shapedirs"]),
        posedirs=f32(arrays["posedirs"]),
        j_regressor=f32(arrays["j_regressor"]),
        lbs_weights=f32(arrays["lbs_weights"]),
        hands_mean=f32(arrays["hands_mean"]),
        hands_components=f32(arrays["hands_components"]),
        faces=torch.as_tensor(np.asarray(arrays["faces"], np.int32), device=device),
        tips=torch.as_tensor(np.asarray(arrays["tips"], np.int64), device=device),
    )


def load_mano_pkl(path: str, side: str = "right", device="cpu") -> ManoModel:
    """Load MANO_{RIGHT,LEFT}.pkl (the fields the reference reads)."""
    _install_chumpy_stub()
    with open(path, "rb") as f:
        data = pickle.load(io.BytesIO(f.read()), encoding="latin1")
    tips = skeletons.MANO_TIPS_RIGHT if side == "right" else skeletons.MANO_TIPS_LEFT
    return _model_from_numpy(
        device,
        v_template=_as_np(data["v_template"]),
        shapedirs=_as_np(data["shapedirs"])[..., :10],
        posedirs=_as_np(data["posedirs"]),
        j_regressor=_as_np(data["J_regressor"]),
        lbs_weights=_as_np(data["weights"]),
        hands_mean=_as_np(data["hands_mean"]).ravel(),
        hands_components=_as_np(data["hands_components"]),
        faces=_as_np(data["f"]),
        tips=tips,
    )


def find_mano_assets(mano_dir: str = "./mano/", side: str = "right") -> str | None:
    name = f"MANO_{side.upper()}.pkl"
    for cand in (
        os.path.join(mano_dir, name),
        os.path.join(mano_dir, "models", name),
    ):
        if os.path.exists(cand):
            return cand
    return None


def synthetic_mano_model(seed: int = 0, device="cpu") -> ManoModel:
    """A structurally valid random MANO for asset-free tests and serving.

    Draws from numpy's RandomState(seed) in exactly the JAX package's order,
    so both packages build the same constants for the same seed.
    """
    rng = np.random.RandomState(seed)
    joints = np.zeros((N_JOINTS, 3), np.float32)
    for f in range(5):
        angle = (f - 2) * 0.3
        direction = np.array([np.cos(angle), np.sin(angle), 0.0])
        for lev, dist in zip((LEV1[f], LEV2[f], LEV3[f]), (0.05, 0.08, 0.10)):
            joints[lev] = direction * dist + rng.randn(3) * 0.002
    owner = rng.randint(0, N_JOINTS, N_VERTS)
    v_template = joints[owner] + rng.randn(N_VERTS, 3).astype(np.float32) * 0.01
    j_reg = np.zeros((N_JOINTS, N_VERTS), np.float32)
    for j in range(N_JOINTS):
        dists = np.linalg.norm(v_template - joints[j], axis=1)
        near = np.argsort(dists)[:8]
        j_reg[j, near] = 1.0 / 8.0
    d = np.linalg.norm(v_template[:, None] - joints[None], axis=-1)
    w = np.exp(-d / 0.02)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    comps = np.linalg.qr(rng.randn(N_POSE, N_POSE))[0].astype(np.float32)
    faces = rng.randint(0, N_VERTS, (1538, 3)).astype(np.int32)
    shapedirs = rng.randn(N_VERTS, 3, 10).astype(np.float32) * 0.001
    posedirs = rng.randn(N_VERTS, 3, 135).astype(np.float32) * 0.0005
    hands_mean = rng.randn(45).astype(np.float32) * 0.1
    return _model_from_numpy(
        device, v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=j_reg, lbs_weights=w, hands_mean=hands_mean,
        hands_components=comps, faces=faces, tips=skeletons.MANO_TIPS_RIGHT,
    )


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(3, 3, ...) @ (3, 3, ...) over the leading matrix dims (broadcasting)."""
    return (a[:, :, None] * b[None]).sum(1)


def mv3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3, 3, ...) @ (3, ...) over the leading matrix dims (broadcasting)."""
    return (a * v[None]).sum(1)


def _kp_regressor_matrix(model: ManoModel) -> torch.Tensor:
    """(26, 778): rows 0-20 the FreiHAND 21-keypoint assembly (16 regressor
    rows, the 5 fingertip slots as one-hot vertex selectors), rows 21-25
    one-hot selectors of the kinematic-chain tip vertices."""
    kp_src, tip_ids, tip_verts = skeletons.freihand_gather_indices()
    dev = model.j_regressor.device
    m21 = model.j_regressor[torch.as_tensor(kp_src, device=dev)].clone()
    m21[torch.as_tensor(tip_ids, device=dev)] = torch.nn.functional.one_hot(
        torch.as_tensor(tip_verts, device=dev), N_VERTS).to(m21.dtype)
    m5 = torch.nn.functional.one_hot(model.tips, N_VERTS).to(m21.dtype)
    return torch.cat([m21, m5], dim=0)


def fold_keypoints(model: ManoModel) -> KeypointFold:
    """Fold the keypoint regressor through LBS, once per model.

    Keypoints are linear in the skinned vertices and LBS is linear in the
    rest-pose vertices, so with M the (26, 778) regressor and W the skinning
    weights:  kp[k] = sum_j (C_T[j,k] + C_S[j,k] beta + C_P[j,k] f) R_j^T
    + (M W)[k, j] t_j, where C_* = (M diag(w_j)) {template, shapedirs,
    posedirs}. See mhentropy_tpu/core/mano.py:404-445.
    """
    m = _kp_regressor_matrix(model)
    mw = m[:, :, None] * model.lbs_weights[None]  # (26, 778, 16)
    return KeypointFold(
        j_rest=torch.einsum("jv,vd->dj", model.j_regressor, model.v_template),
        j_dirs=torch.einsum("jv,vds->jds", model.j_regressor, model.shapedirs),
        c_t=torch.einsum("kvj,vc->jkc", mw, model.v_template),
        c_s=torch.einsum("kvj,vcs->jkcs", mw, model.shapedirs),
        c_p=torch.einsum("kvj,vcp->jkcp", mw, model.posedirs),
        w1=mw.sum(1),
        rowsum=m.sum(1),
    )


def _chain_nl(model: ManoModel, fold: KeypointFold, theta: torch.Tensor,
              beta: torch.Tensor, config: ManoConfig):
    """Pose -> rotations -> kinematic chain, batch-last.

    Returns (chain_r_nl (3, 3, 16, B), chain_t_nl (3, 16, B),
    skin_t_nl (3, 16, B), pose_map (B, 135)).
    """
    b = theta.shape[0]
    root_aa = theta[:, :3]
    coeffs = theta[:, 3:3 + config.ncomps]
    if config.use_pca:
        hand_pose = coeffs @ model.hands_components[:config.ncomps]
    else:
        hand_pose = coeffs
    if not config.flat_hand_mean:
        hand_pose = hand_pose + model.hands_mean

    full_aa = torch.cat([root_aa, hand_pose], dim=1).reshape(b, 16, 3)
    rots = batch_rodrigues(full_aa)  # (B, 16, 3, 3)
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_map = (rots[:, 1:] - eye).reshape(b, N_POSE * 3)

    joints_nl = fold.j_rest[:, :, None] + torch.einsum("jds,bs->djb", fold.j_dirs, beta)

    rots_nl = rots.permute(2, 3, 1, 0)  # (3, 3, 16, B)

    def compose(r_par, t_par, level, parent):
        return (mm3(r_par, rots_nl[:, :, level]),
                mv3(r_par, joints_nl[:, level] - joints_nl[:, parent]) + t_par)

    root_rot_nl = rots_nl[:, :, 0]  # (3, 3, B)
    root_j_nl = joints_nl[:, 0]  # (3, B)
    r1, t1 = compose(root_rot_nl[:, :, None], root_j_nl[:, None], LEV1, [0])
    r2, t2 = compose(r1, t1, LEV2, LEV1)
    r3, t3 = compose(r2, t2, LEV3, LEV2)
    chain_r_nl = torch.cat([root_rot_nl[:, :, None], r1, r2, r3], dim=2)[:, :, CHAIN_REORDER]
    chain_t_nl = torch.cat([root_j_nl[:, None], t1, t2, t3], dim=1)[:, CHAIN_REORDER]

    # LBS rest-pose removal: A_j = G_j - [0 | R_j @ j_j].
    skin_t_nl = chain_t_nl - mv3(chain_r_nl, joints_nl)
    return chain_r_nl, chain_t_nl, skin_t_nl, pose_map


def _folded_kp26_nl(fold: KeypointFold, chain_r_nl, skin_t_nl, beta, pose_map):
    """All 26 decode keypoints without the 778-vertex mesh: (3, 26, B) in
    metres, uncentred."""
    q = (
        fold.c_t[..., None]
        + torch.einsum("jkcs,bs->jkcb", fold.c_s, beta)
        + torch.einsum("jkcp,bp->jkcb", fold.c_p, pose_map)
    )  # (16, 26, 3, B)
    kp = torch.einsum("kj,rjb->rkb", fold.w1, skin_t_nl)
    return kp + torch.einsum("rcjb,jkcb->rkb", chain_r_nl, q)


def _lbs_blend_nl(model: ManoModel, chain_r_nl, skin_t_nl, v_posed_nl, kernel: bool = True):
    """Per-vertex LBS blend, batch-last (3, 778, B): with `kernel`, the
    `lbs_blend` operator (its kernel on CUDA tensors, the einsums on CPU
    ones; core/lbs_cuda.py), which has no autograd formula; without, the
    einsums on any device, as JAX's `pallas_lbs=False` (its training path's
    decode)."""
    if kernel:
        return lbs_cuda.lbs_blend(model.lbs_weights, chain_r_nl, skin_t_nl, v_posed_nl)
    return lbs_cuda.lbs_blend_plain(model.lbs_weights, chain_r_nl, skin_t_nl, v_posed_nl)


def _mesh_nl(model: ManoModel, chain_r_nl, skin_t_nl, beta, pose_map, lbs_kernel: bool = True):
    """Skinned mesh (3, 778, B) in metres, uncentred."""
    v_shaped_nl = model.v_template.T[:, :, None] + torch.einsum(
        "vdc,bc->dvb", model.shapedirs, beta)
    v_posed_nl = v_shaped_nl + torch.einsum("vdp,bp->dvb", model.posedirs, pose_map)
    return _lbs_blend_nl(model, chain_r_nl, skin_t_nl, v_posed_nl, lbs_kernel)


def mano_forward(model: ManoModel, theta: torch.Tensor, beta: torch.Tensor,
                 config: ManoConfig = ManoConfig(), fold: KeypointFold | None = None):
    """(B, 3 + ncomps) pose, (B, 10) shape -> (verts (B, 778, 3), joints21
    (B, 21, 3)) in mm: the kinematic-chain joints and the five fingertip
    vertices in the FreiHAND order, centred on config.center_idx."""
    if fold is None:
        fold = fold_keypoints(model)
    chain_r_nl, chain_t_nl, skin_t_nl, pose_map = _chain_nl(model, fold, theta, beta, config)
    verts_nl = _mesh_nl(model, chain_r_nl, skin_t_nl, beta, pose_map)
    chain_joints = chain_t_nl.permute(2, 1, 0)  # (B, 16, 3)
    tips = verts_nl[:, model.tips].permute(2, 1, 0)  # (B, 5, 3)
    joints21 = torch.cat([chain_joints, tips], dim=1)[:, skeletons.MANOCHAIN2VIZ]
    if config.center_idx is not None:
        center = joints21[:, config.center_idx:config.center_idx + 1]
        joints21 = joints21 - center
        verts_nl = verts_nl - center.permute(2, 1, 0)
    return (verts_nl * 1000.0).permute(2, 1, 0), joints21 * 1000.0


def mano_decode(model: ManoModel, theta: torch.Tensor, beta: torch.Tensor,
                skeidx: str = "RHD", config: ManoConfig = ManoConfig(),
                fold: KeypointFold | None = None, with_mesh: bool = False,
                lbs_kernel: bool = True) -> dict:
    """(B, 48) pose, (B, 10) shape -> keypoints in mm (parity:
    hand/ManoLayer.py:45-60 of the reference).

    Returns 'joints' (regressed 21 keypoints) and 'mano_joints' (kinematic
    chain 21 keypoints), both (B, 21, 3) in the requested skeleton order, and
    'mesh' (B, 778, 3) when with_mesh. lbs_kernel: the mesh's blend through
    the `lbs_blend` operator (the default), or through the plain einsums,
    which autograd differentiates (JAX's `pallas_lbs`).
    """
    if skeidx not in ("RHD", "BigHand", "FreiHand"):
        raise ValueError(f"unknown skeidx {skeidx!r}; expected RHD | BigHand | FreiHand")
    if fold is None:
        fold = fold_keypoints(model)
    chain_r_nl, chain_t_nl, skin_t_nl, pose_map = _chain_nl(
        model, fold, theta, beta, config)
    kp26_nl = _folded_kp26_nl(fold, chain_r_nl, skin_t_nl, beta, pose_map)

    chain21_nl = torch.cat([chain_t_nl, kp26_nl[:, 21:]], dim=1)[
        :, skeletons.MANOCHAIN2VIZ]  # (3, 21, B)
    if config.center_idx is not None:
        center_nl = chain21_nl[:, config.center_idx]  # (3, B)
    else:
        center_nl = torch.zeros_like(chain21_nl[:, 0])
    chain21_nl = chain21_nl - center_nl[:, None]
    joints_nl = kp26_nl[:, :21] - fold.rowsum[:21][None, :, None] * center_nl[:, None]
    joints = joints_nl.permute(2, 1, 0) * 1000.0  # (B, 21, 3) mm
    chain21 = chain21_nl.permute(2, 1, 0) * 1000.0

    out = {"beta": beta, "theta": theta}
    if with_mesh:
        verts_nl = _mesh_nl(model, chain_r_nl, skin_t_nl, beta, pose_map, lbs_kernel)
        out["mesh"] = ((verts_nl - center_nl[:, None]) * 1000.0).permute(2, 1, 0)

    if skeidx == "RHD":
        out["joints"] = joints[:, skeletons.FREIHAND2RHD]
        out["mano_joints"] = chain21[:, skeletons.FREIHAND2RHD]
    elif skeidx == "BigHand":
        out["joints"] = joints[:, skeletons.FREIHAND2RHD][:, skeletons.RHD2BIGHAND]
        out["mano_joints"] = chain21[:, skeletons.FREIHAND2RHD][:, skeletons.RHD2BIGHAND]
    else:
        out["joints"] = joints
        out["mano_joints"] = chain21
    return out
