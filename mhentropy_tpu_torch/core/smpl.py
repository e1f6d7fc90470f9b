"""SMPL body model on torch tensors: the decode of the Humans (ProHMR) path.

Port of mhentropy_tpu/core/smpl.py: `SmplModel` :35 and `PARENTS` :29,
`load_smpl_pkl` :44, `synthetic_smpl_model` :61, `smpl_forward` :89,
`smpl_forward_axis_angle` :161 and `smpl_forward_6d` :174.

Tensors keep the JAX package's batch-last layout ((3, 24, B) joints,
(3, V, B) mesh planes), and the blend is core/mano.py's `_lbs_blend_nl`:
the `lbs_blend` kernel on CUDA tensors (core/lbs_cuda.py, which tiles the
vertices, so SMPL's 6,890 fit), the einsums on CPU ones. PyTorch does not
dead-code the mesh, so a joints-only caller passes `with_mesh=False`.
"""

from __future__ import annotations

import io
import pickle
from typing import NamedTuple

import numpy as np
import torch

from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.core.mano import _as_np, _install_chumpy_stub, mm3, mv3
from mhentropy_tpu_torch.core.rotations import batch_rodrigues, rotmat_from_6d

N_VERTS = 6890
N_JOINTS = 24
# SMPL kinematic tree (parent of joint i).
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21]
)


class SmplModel(NamedTuple):
    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, 10)
    posedirs: torch.Tensor  # (V, 3, 207)
    j_regressor: torch.Tensor  # (24, V)
    lbs_weights: torch.Tensor  # (V, 24)
    faces: torch.Tensor  # (F, 3) int32


def _model_from_numpy(device, v_template, shapedirs, posedirs, j_regressor, lbs_weights,
                      faces) -> SmplModel:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SmplModel(v_template=f32(v_template), shapedirs=f32(shapedirs),
                     posedirs=f32(posedirs), j_regressor=f32(j_regressor),
                     lbs_weights=f32(lbs_weights),
                     faces=torch.as_tensor(np.asarray(faces, np.int32), device=device))


def load_smpl_pkl(path: str, device="cpu") -> SmplModel:
    """Load SMPL_{NEUTRAL,MALE,FEMALE}.pkl (the first 10 shape directions)."""
    _install_chumpy_stub()
    with open(path, "rb") as f:
        data = pickle.load(io.BytesIO(f.read()), encoding="latin1")
    return _model_from_numpy(
        device, _as_np(data["v_template"]), _as_np(data["shapedirs"])[..., :10],
        _as_np(data["posedirs"]), _as_np(data["J_regressor"]), _as_np(data["weights"]),
        _as_np(data["f"]).astype(np.int32))


def synthetic_smpl_model(seed: int = 0, n_verts: int = 1024, device="cpu") -> SmplModel:
    """A structurally valid random SMPL. Draws from numpy's RandomState(seed)
    in exactly the JAX package's order, so both packages build the same
    constants for the same seed and size; `n_verts=N_VERTS` is SMPL's size."""
    rng = np.random.RandomState(seed)
    # Plausible rest skeleton: pelvis at origin, limbs fanning out.
    joints = rng.randn(N_JOINTS, 3).astype(np.float32) * 0.05
    for i in range(1, N_JOINTS):
        joints[i] = joints[PARENTS[i]] + rng.randn(3) * 0.12
    owner = rng.randint(0, N_JOINTS, n_verts)
    v_template = joints[owner] + rng.randn(n_verts, 3).astype(np.float32) * 0.03
    j_reg = np.zeros((N_JOINTS, n_verts), np.float32)
    for j in range(N_JOINTS):
        near = np.argsort(np.linalg.norm(v_template - joints[j], axis=1))[:6]
        j_reg[j, near] = 1.0 / 6.0
    d = np.linalg.norm(v_template[:, None] - joints[None], axis=-1)
    w = np.exp(-d / 0.05)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    shapedirs = rng.randn(n_verts, 3, 10).astype(np.float32) * 0.003
    posedirs = rng.randn(n_verts, 3, 207).astype(np.float32) * 0.0005
    faces = rng.randint(0, n_verts, (2000, 3)).astype(np.int32)
    return _model_from_numpy(device, v_template, shapedirs, posedirs, j_reg, w, faces)


def _chain_nl(model: SmplModel, rotmats: torch.Tensor, betas: torch.Tensor):
    """Rest joints and the kinematic chain, batch-last.

    Returns (chain_r_nl (3, 3, 24, B), chain_t_nl (3, 24, B), joints_nl
    (3, 24, B) the shaped rest joints).
    """
    # The regressor folded into the template and shapedirs: joints-only
    # callers never build the (3, V, B) planes.
    joints_nl = (torch.einsum("jv,vd->dj", model.j_regressor, model.v_template)[:, :, None]
                 + torch.einsum("jds,bs->djb",
                                torch.einsum("jv,vds->jds", model.j_regressor,
                                             model.shapedirs), betas))
    rots_nl = rotmats.permute(2, 3, 1, 0)  # (3, 3, 24, B)
    rel_t = joints_nl - torch.cat(
        [torch.zeros_like(joints_nl[:, :1]), joints_nl[:, PARENTS[1:]]], 1)  # (3, 24, B)
    # Sequential composition (parents[i] < i) on (R, t) pairs.
    chain_r = [rots_nl[:, :, 0]]  # each (3, 3, B)
    chain_t = [rel_t[:, 0]]  # each (3, B)
    for i in range(1, N_JOINTS):
        par_r, par_t = chain_r[PARENTS[i]], chain_t[PARENTS[i]]
        chain_r.append(mm3(par_r, rots_nl[:, :, i]))
        chain_t.append(mv3(par_r, rel_t[:, i]) + par_t)
    return torch.stack(chain_r, dim=2), torch.stack(chain_t, dim=1), joints_nl


def _v_posed_nl(model: SmplModel, rotmats: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Shape and pose blendshapes on the template: (3, V, B)."""
    b = rotmats.shape[0]
    v_shaped_nl = model.v_template.T[:, :, None] + torch.einsum(
        "vdc,bc->dvb", model.shapedirs, betas)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_map = (rotmats[:, 1:] - eye).reshape(b, 207)
    return v_shaped_nl + torch.einsum("vdp,bp->dvb", model.posedirs, pose_map)


def smpl_forward(model: SmplModel, rotmats: torch.Tensor, betas: torch.Tensor,
                 transl: torch.Tensor | None = None, with_mesh: bool = True):
    """SMPL LBS from per-joint rotation MATRICES (the ProHMR convention).

    rotmats (B, 24, 3, 3): global orient ++ 23 body rotations; betas (B, 10).
    Returns verts (B, V, 3) (None without the mesh) and joints (B, 24, 3),
    in metres.
    """
    chain_r_nl, chain_t_nl, joints_nl = _chain_nl(model, rotmats, betas)
    joints = chain_t_nl.permute(2, 1, 0)  # (B, 24, 3)
    verts = None
    if with_mesh:
        skin_t_nl = chain_t_nl - mv3(chain_r_nl, joints_nl)
        verts_nl = mano._lbs_blend_nl(model, chain_r_nl, skin_t_nl,
                                      _v_posed_nl(model, rotmats, betas))
        verts = verts_nl.permute(2, 1, 0)  # (B, V, 3)
    if transl is not None:
        joints = joints + transl[:, None]
        if verts is not None:
            verts = verts + transl[:, None]
    return verts, joints


def smpl_forward_axis_angle(model: SmplModel, pose_aa: torch.Tensor, betas: torch.Tensor,
                            transl: torch.Tensor | None = None, with_mesh: bool = True):
    """(B, 72) axis-angle pose (the standard SMPL ingestion format)."""
    b = pose_aa.shape[0]
    rotmats = batch_rodrigues(pose_aa.reshape(b, N_JOINTS, 3))
    return smpl_forward(model, rotmats, betas, transl=transl, with_mesh=with_mesh)


def smpl_forward_6d(model: SmplModel, pose_6d: torch.Tensor, betas: torch.Tensor,
                    transl: torch.Tensor | None = None, with_mesh: bool = True):
    """(B, 144) 6D-rotation pose (the ProHMR flow's output space)."""
    b = pose_6d.shape[0]
    rotmats = rotmat_from_6d(pose_6d.reshape(b, N_JOINTS, 6))
    return smpl_forward(model, rotmats, betas, transl=transl, with_mesh=with_mesh)
