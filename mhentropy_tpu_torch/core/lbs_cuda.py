"""LBS blend: the CUDA kernel and its plain version.

Replaces mhentropy_tpu/core/lbs_pallas.py::lbs_blend (:56; Pallas `_kernel`
:33). The kernel is `csrc/lbs_blend.cu`; its header says what bounds it on
the H100 and how its design answers that. `lbs_blend` takes batch-last
planes, as the JAX function does: W (V, J), R (3, 3, J, rows),
t (3, J, rows), v_posed (3, V, rows) -> verts (3, V, rows), all f32,
through the operator `mhent::lbs_blend` (mhentropy_tpu_torch/ops.py): CPU
tensors take `lbs_blend_plain`; CUDA tensors launch the kernel, and
anything it does not take raises. The kernel tiles the vertices (up to
256 a block), so it takes any V and row count, MANO's 778 and SMPL's 6,890
vertices alike, and J up to 150 (the C entry point's vertex tile says
what fits). No row-count gate: the TPU's 8M-element gate was measured on
the TPU.
"""

from __future__ import annotations

import torch

from mhentropy_tpu_torch import ext, ops

# Kernel launches since the count was last reset; nothing else touches it.
launches = 0


def lbs_blend(lbs_weights: torch.Tensor, chain_r_nl: torch.Tensor, skin_t_nl: torch.Tensor,
              v_posed_nl: torch.Tensor) -> torch.Tensor:
    return _op(lbs_weights, chain_r_nl, skin_t_nl, v_posed_nl)


def lbs_blend_plain(lbs_weights, chain_r_nl, skin_t_nl, v_posed_nl) -> torch.Tensor:
    """The einsum path: nine per-vertex rotation planes and three
    translation planes, then the blend."""
    per_vert_r_nl = torch.einsum("vj,rcjb->rcvb", lbs_weights, chain_r_nl)
    per_vert_t_nl = torch.einsum("vj,rjb->rvb", lbs_weights, skin_t_nl)
    return torch.einsum("rcvb,cvb->rvb", per_vert_r_nl, v_posed_nl) + per_vert_t_nl


def check_shapes(w, rot, trans, vposed) -> None:
    """The kernel's shape and dtype checks (the fake implementation's too)."""
    v, j = w.shape
    rows = vposed.shape[-1]
    ext.require(rot.shape == (3, 3, j, rows) and trans.shape == (3, j, rows)
                and vposed.shape == (3, v, rows),
                f"lbs blend: shapes W {tuple(w.shape)}, R {tuple(rot.shape)}, "
                f"t {tuple(trans.shape)}, v_posed {tuple(vposed.shape)} do not fit")
    for name, t in (("W", w), ("R", rot), ("t", trans), ("v_posed", vposed)):
        ext.require(t.dtype == torch.float32 and t.device == vposed.device,
                    f"lbs blend: {name} must be float32 on {vposed.device}")


def _lbs_kernel(w, rot, trans, vposed) -> torch.Tensor:
    global launches
    ext.require(vposed.is_cuda, f"lbs blend: unsupported device {vposed.device}")
    check_shapes(w, rot, trans, vposed)
    v, j = w.shape
    rows = vposed.shape[-1]
    w, rot, trans, vposed = (t.contiguous() for t in (w, rot, trans, vposed))
    lib = ext.load()
    ext.require(lib.mhent_lbs_vertex_tile(v, j) >= 1,
                f"lbs blend: W {tuple(w.shape)} has {j} joints, too many for one vertex's "
                f"weights beside the rows' transforms in a block's shared memory "
                f"(R {tuple(rot.shape)}, v_posed {tuple(vposed.shape)})")
    out = torch.empty_like(vposed)
    err = lib.mhent_lbs_blend(w.data_ptr(), rot.data_ptr(), trans.data_ptr(), vposed.data_ptr(),
                              out.data_ptr(), v, j, rows, ext.stream_of(vposed))
    ext.check(err, "mhent_lbs_blend")
    launches += 1
    return out


def _lbs_fake(w, rot, trans, vposed) -> torch.Tensor:
    ops.require_device(vposed, "lbs blend")
    if vposed.is_cuda:
        check_shapes(w, rot, trans, vposed)
    return vposed.new_empty(vposed.shape)


_op = ops.define(
    "lbs_blend(Tensor lbs_weights, Tensor chain_r_nl, Tensor skin_t_nl, Tensor v_posed_nl) "
    "-> Tensor",
    cpu=lambda *args: lbs_blend_plain(*args).contiguous(), cuda=_lbs_kernel, fake=_lbs_fake)
