"""Fused RealNVP hypothesis sampler: the CUDA kernel and its plain version.

Replaces mhentropy_tpu/flows/pallas_sampler.py::sample_fused (:191; Pallas
`_kernel` :64 via `_fused_transform` :115). The kernel is
`csrc/realnvp_sampler.cu`; its header says what bounds it on the H100 and
how its design answers that. Here:

* `pack` lays a flow's weights out for the kernel once (D padded to a
  multiple of 16 with mask = 1 on the padding, the s and t nets stacked).
* `transform` is the wrapper: image-major base samples (B, R, D) and the
  per-image conditioning cache (L, 4, B, H) -> (x (B, R, D), logdet (B, R)).
  CPU tensors take `transform_plain`; CUDA tensors launch the kernel, and
  anything it does not take raises.
* `sample_fused` is the drop-in for the flow draw: hypothesis-major rows in,
  hypothesis-major rows and log q out.

The kernel reads bf16 weights and accumulates in f32, with x and the log-det
in f32, as the JAX path runs the fused sampler at h <= 512.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext
from mhentropy_tpu_torch.flows import realnvp
from mhentropy_tpu_torch.flows.priors import std_normal_logp

# Kernel launches since the count was last reset; nothing else touches it.
launches = 0


class Packed(NamedTuple):
    masks: torch.Tensor  # (L, Dp) f32, 1 on padded dims
    w0: torch.Tensor  # (L, 2, Dp, H)   net 0 = s, 1 = t; [in, out]
    w1: torch.Tensor  # (L, 2, H, H)
    w2: torch.Tensor  # (L, 2, H, Dp)
    b0: torch.Tensor  # (L, 2, H) f32
    b1: torch.Tensor  # (L, 2, H) f32
    b2: torch.Tensor  # (L, 2, Dp) f32
    dim: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@torch.no_grad()
def pack(flow: realnvp.RealNVP, dtype=torch.bfloat16) -> Packed:
    d = flow.cfg.dim
    dp = _round_up(d, 16)
    pad = dp - d
    lays = realnvp.layers(flow)

    def padded(t, rows, cols):
        return F.pad(t.float(), (0, cols) if t.dim() == 1 else (0, cols, 0, rows))

    def stack(name, rows=0, cols=0, out_dtype=dtype):
        return torch.stack([
            torch.stack([padded(getattr(lay, f"{net}_{name}"), rows, cols) for net in "st"])
            for lay in lays
        ]).to(out_dtype).contiguous()

    return Packed(
        masks=F.pad(flow.mask.float(), (0, pad), value=1.0).contiguous(),
        w0=stack("w0", rows=pad),
        w1=stack("w1"),
        w2=stack("w2", cols=pad),
        b0=stack("b0", out_dtype=torch.float32),
        b1=stack("b1", out_dtype=torch.float32),
        b2=stack("b2", cols=pad, out_dtype=torch.float32),
        dim=d,
    )


def transform(packed: Packed, z0: torch.Tensor, cproj: torch.Tensor):
    """(B, R, D) image-major base samples through every coupling layer.

    cproj: (L, 4, B, H) per-image conditioning projections.
    Returns (x (B, R, D) f32, logdet (B, R) f32).
    """
    if z0.device.type == "cpu":
        return transform_plain(packed, z0, cproj)
    return _transform_kernel(packed, z0, cproj)


def transform_plain(packed: Packed, z0: torch.Tensor, cproj: torch.Tensor):
    """The Python loop over `realnvp.forward_layer`, on the packed weights
    widened to f32 (padded dims pass through exactly)."""
    b, r, d = z0.shape
    dp = packed.masks.shape[1]
    x = F.pad(z0.float(), (0, dp - d)).reshape(b * r, dp)
    logdet = x.new_zeros(b * r)
    for l in range(packed.masks.shape[0]):
        ws = [getattr(packed, n)[l].float() for n in ("w0", "b0", "w1", "b1", "w2", "b2")]
        layer = realnvp.Layer(packed.masks[l], *(w[0] for w in ws), *(w[1] for w in ws))
        cp = cproj[l].repeat_interleave(r, dim=1)  # image-major row alignment
        x, logdet = realnvp.forward_layer(layer, cp, x, logdet)
    return x.reshape(b, r, dp)[..., :d], logdet.reshape(b, r)


def _transform_kernel(packed: Packed, z0: torch.Tensor, cproj: torch.Tensor):
    global launches
    ext.require(z0.is_cuda, f"fused sampler: unsupported device {z0.device}")
    b, r, d = z0.shape
    n_layers, dp = packed.masks.shape
    h = packed.w1.shape[-1]
    ext.require(z0.dtype == torch.float32 and z0.is_contiguous(),
                "fused sampler: z0 must be contiguous float32 (B, R, D)")
    ext.require(d == packed.dim, f"fused sampler: z0 has D={d}, flow has {packed.dim}")
    ext.require(cproj.shape == (n_layers, 4, b, h) and cproj.dtype == torch.float32
                and cproj.is_contiguous(),
                f"fused sampler: cproj must be contiguous float32 {(n_layers, 4, b, h)}, "
                f"got {tuple(cproj.shape)} {cproj.dtype}")
    ext.require(h % 64 == 0, f"fused sampler: hidden width {h} is not a multiple of 64")
    for name in ("w0", "w1", "w2"):
        t = getattr(packed, name)
        ext.require(t.dtype == torch.bfloat16 and t.is_contiguous(),
                    f"fused sampler: packed {name} must be contiguous bfloat16")
    for t in (cproj, *packed[:7]):
        ext.require(t.device == z0.device, "fused sampler: tensors on different devices")
    x = torch.empty_like(z0)
    logdet = torch.empty((b, r), dtype=torch.float32, device=z0.device)
    lib = ext.load()
    err = lib.mhent_realnvp_sample(
        z0.data_ptr(), cproj.data_ptr(), packed.masks.data_ptr(),
        packed.w0.data_ptr(), packed.w1.data_ptr(), packed.w2.data_ptr(),
        packed.b0.data_ptr(), packed.b1.data_ptr(), packed.b2.data_ptr(),
        x.data_ptr(), logdet.data_ptr(), b, r, d, dp, h, n_layers, ext.stream_of(z0))
    ext.check(err, "mhent_realnvp_sample")
    launches += 1
    return x, logdet


def sample_fused(flow: realnvp.RealNVP, packed: Packed, feat: torch.Tensor,
                 n: int, z0_rows: torch.Tensor):
    """The flow draw for n hypotheses of each of B images.

    Args:
        feat: (B, C) conditioning features.
        z0_rows: (n * B, D) hypothesis-major base noise, already times temp.

    Returns:
        x (n * B, D) hypothesis-major and log q (n * B,).
    """
    b = feat.shape[0]
    d = flow.cfg.dim
    cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat)).float().contiguous()
    z0 = z0_rows.reshape(n, b, d).transpose(0, 1).contiguous()  # image-major
    x, logdet = transform(packed, z0, cproj)
    lp = std_normal_logp(z0) - logdet
    return x.transpose(0, 1).reshape(n * b, d), lp.transpose(0, 1).reshape(n * b)
