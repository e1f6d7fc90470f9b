"""Fused ConditionalGlow sampler: the CUDA kernel and its plain version.

Replaces mhentropy_tpu/flows/pallas_glow_sampler.py::sample_and_log_prob_fused
(:324; Pallas `_kernel` :169 via `_fused_transform` :257) with
`csrc/glow_sampler.cu`, whose header says what bounds it on the H100 and
how its design answers that. Here:

* `pack` folds a flow's weights for the kernel as `pack_glow_weights` :54
  does: the layers reversed (sampling runs the nflows inverse), the
  identity-split initial matmul scattered to full-D rows, the final Linear
  de-interleaved into shift and scale matrices at the transformed lanes,
  the LU inverse precomputed in f32 per layer, the actnorm as
  exp(-log_scale), D padded to a multiple of 16. Beside those (in, out)
  weights, which `transform_plain` reads, it keeps the kernel's K-major
  copies (out, in) that its TMA loads feed to wgmma: `big_t`, `w_in_t`
  and `w_ss_t` ([W_shift | W_scale] transposed).
* `pack_context` is `pack_glow_context` :149: the per-image context
  projections, plain matmuls outside the kernel as in JAX, as
  (L, 3, B, H) [initial, block-0 gate, block-1 gate] per reversed layer.
* `transform` is the wrapper: image-major base samples (B, N, D) -> (x
  (B, N, D), sum of log scale (B, N)), through the operator
  `mhent::glow_sample` (mhentropy_tpu_torch/ops.py) on the kernel's
  operands (`KERNEL_FIELDS`): CPU tensors take `transform_plain` (on the
  (in, out) weights, transposed back from the K-major copies);
  CUDA tensors launch the kernel, and anything it does not take raises.
* `sample_and_log_prob_fused` is the drop-in for `glow.sample_and_log_prob`:
  hypothesis-major rows in and out, log q = std_normal_logp(z0) + sum log
  scale + the input-independent LU and actnorm terms.

Numerics: x and the log-det in f32, every product's operands rounded to the
packed weights' dtype (bf16 for the kernel) and summed in f32, as the TPU
kernel casts every dot operand; `transform_plain` rounds at the same
places, so the two differ by the order of f32 sums only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch import ext, ops
from mhentropy_tpu_torch.flows import glow
from mhentropy_tpu_torch.flows.priors import std_normal_logp
from mhentropy_tpu_torch.parallel import sharded

# Kernel launches since the count was last reset; nothing else touches it.
launches = 0
D_ALIGN = 16
MAX_DP = 256
H_ALIGN = 64  # the kernel's 64-deep stages and 64-column epilogue groups


class Packed(NamedTuple):
    """Per reversed layer l (weights (in, out))."""

    big: torch.Tensor  # (L, 4, H, H) block 0 l0, l1, block 1 l0, l1
    b_big: torch.Tensor  # (L, 4, H)
    w_in: torch.Tensor  # (L, Dp, H) initial Linear's x half, 0 at transform rows
    b_in: torch.Tensor  # (L, H)
    w_shift: torch.Tensor  # (L, H, Dp) shift columns at the transformed lanes
    b_shift: torch.Tensor  # (L, Dp)
    w_scale: torch.Tensor  # (L, H, Dp) unconstrained-scale columns
    b_scale: torch.Tensor  # (L, Dp)
    lu_inv_t: torch.Tensor  # (L, Dp, Dp) (L U)^-T
    lu_bias: torch.Tensor  # (L, Dp)
    an_shift: torch.Tensor  # (L, Dp)
    an_scale: torch.Tensor  # (L, Dp) exp(-log_scale), 1 on the padding
    mask_tr: torch.Tensor  # (L, Dp) 1 at the transformed lanes
    big_t: torch.Tensor  # (L, 4, H, H) big's K-major copy: (out, in)
    w_in_t: torch.Tensor  # (L, H, Dp) w_in's: (out, in)
    w_ss_t: torch.Tensor  # (L, 2 Dp, H) [w_shift | w_scale]'s: (out, in)
    ld_const: torch.Tensor  # () sum of the LU log-diagonals and actnorm log-scales
    dim: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def structural_ok(cfg: glow.GlowConfig) -> bool:
    """The kernel's architectural constraints (`structural_ok` :378)."""
    return cfg.num_blocks == 2 and not cfg.use_batch_norm


@torch.no_grad()
def pack(flow: glow.ConditionalGlow, dtype=torch.bfloat16) -> Packed:
    """Weights in `dtype`; biases, masks and actnorm in f32."""
    cfg = flow.cfg
    if not structural_ok(cfg):
        raise ValueError(f"the fused Glow sampler takes num_blocks == 2 and no BatchNorm, "
                         f"not {cfg}")
    d, h = cfg.features, cfg.hidden
    dp = _round_up(d, D_ALIGN)
    dev = flow.step(0)[0].log_scale.device
    fields = {k: [] for k in Packed._fields[:13]}  # the (in, out) ones; K-major copies below
    ld_const = torch.zeros((), dtype=torch.float32, device=dev)
    for i in reversed(range(cfg.num_layers)):
        an, lin, cpl = flow.step(i)
        net = cpl.transform_net
        id_idx, tr_idx = cpl.identity_features, cpl.transform_features
        ni, nt = len(id_idx), len(tr_idx)
        w_init = net.initial_layer.weight.T.float()  # (ni + C, H)
        fields["w_in"].append(torch.zeros((dp, h), dtype=torch.float32, device=dev)
                              .index_copy(0, id_idx, w_init[:ni]))
        fields["b_in"].append(net.initial_layer.bias.float())
        for blk in net.blocks:
            for lin_k in blk.linear_layers:
                fields["big"].append(lin_k.weight.T.float())
                fields["b_big"].append(lin_k.bias.float())
        wf, bf = net.final_layer.weight.T.float(), net.final_layer.bias.float()
        zeros_hd = torch.zeros((h, dp), dtype=torch.float32, device=dev)
        zeros_d = torch.zeros(dp, dtype=torch.float32, device=dev)
        fields["w_shift"].append(zeros_hd.index_copy(1, tr_idx, wf[:, :nt]))
        fields["w_scale"].append(zeros_hd.index_copy(1, tr_idx, wf[:, nt:]))
        fields["b_shift"].append(zeros_d.index_copy(0, tr_idx, bf[:nt]))
        fields["b_scale"].append(zeros_d.index_copy(0, tr_idx, bf[nt:]))
        fields["mask_tr"].append(zeros_d.index_fill(0, tr_idx, 1.0))
        w, ld_w = glow._lu_weight(lin)
        # The inverse in f32, as JAX computes it.
        w_inv_t = torch.linalg.inv(w.float()).T
        fields["lu_inv_t"].append(F.pad(w_inv_t, (0, dp - d, 0, dp - d)))
        fields["lu_bias"].append(F.pad(lin.bias.float(), (0, dp - d)))
        fields["an_shift"].append(F.pad(an.shift.float(), (0, dp - d)))
        fields["an_scale"].append(F.pad(torch.exp(-an.log_scale.float()), (0, dp - d),
                                        value=1.0))
        ld_const = ld_const + ld_w.float() + torch.sum(an.log_scale.float())
    n_layers = cfg.num_layers
    out = {k: torch.stack(v) for k, v in fields.items()}
    out["big"] = out["big"].view(n_layers, 4, h, h)
    out["b_big"] = out["b_big"].view(n_layers, 4, h)
    out["big_t"] = out["big"].transpose(-1, -2)
    out["w_in_t"] = out["w_in"].transpose(-1, -2)
    out["w_ss_t"] = torch.cat([out["w_shift"], out["w_scale"]], dim=-1).transpose(-1, -2)
    for k in ("big", "w_in", "w_shift", "w_scale", "lu_inv_t", "big_t", "w_in_t", "w_ss_t"):
        out[k] = out[k].to(dtype)
    return Packed(**{k: v.contiguous() for k, v in out.items()}, ld_const=ld_const, dim=d)


def pack_context(flow: glow.ConditionalGlow, context: torch.Tensor) -> torch.Tensor:
    """(L, 3, B, H) per reversed layer: the initial layer's context slice
    (no bias), block 0's and block 1's gate pre-activations, in f32."""
    cache = glow._ctx_cache(flow, context)
    return torch.stack([torch.stack([cache[i]["initial"], *cache[i]["blocks"]])
                        for i in reversed(range(flow.cfg.num_layers))]).float().contiguous()


def transform(packed: Packed, z0: torch.Tensor, ctx: torch.Tensor):
    """(B, N, D) image-major base samples through every reversed layer.

    ctx: pack_context's (L, 3, B, H). Returns (x (B, N, D), the sum of log
    scale over the layers (B, N)), f32.
    """
    ext.require(z0.shape[-1] == packed.dim,
                f"glow sampler: z0 has D={z0.shape[-1]}, the flow {packed.dim}")
    return _op(z0, ctx, *(getattr(packed, name) for name in KERNEL_FIELDS))


def transform_plain(packed: Packed, z0: torch.Tensor, ctx: torch.Tensor):
    """The `glow.forward` loop on the packed weights: every product's
    operands rounded to the weights' dtype, then summed in f32, where the
    kernel rounds them."""
    b, n, d = z0.shape
    dp = packed.mask_tr.shape[1]
    wd = packed.big.dtype

    def dot(a, w):
        return a.to(wd).float() @ w.float()

    def per_image(rows, c, op):  # rows (B * N, H) op the row's image's (B, H) row
        return op(rows.view(b, n, -1), c[:, None]).view(b * n, -1)

    x = F.pad(z0.float(), (0, dp - d)).reshape(b * n, dp)
    ld = x.new_zeros(b * n)
    for l in range(packed.big.shape[0]):
        c = ctx[l].float()
        bb = packed.b_big[l]
        temps = per_image(dot(x, packed.w_in[l]) + packed.b_in[l], c[0], torch.add)
        for k in range(2):
            t = dot(torch.relu(temps), packed.big[l, 2 * k]) + bb[2 * k]
            u = dot(torch.relu(t), packed.big[l, 2 * k + 1]) + bb[2 * k + 1]
            temps = temps + per_image(u, torch.sigmoid(c[1 + k]), torch.mul)
        mask = packed.mask_tr[l]
        shift = dot(temps, packed.w_shift[l]) + packed.b_shift[l]
        sraw = dot(temps, packed.w_scale[l]) + packed.b_scale[l]
        scale = torch.where(mask > 0, torch.sigmoid(sraw + 2.0) + 1e-3, torch.ones_like(sraw))
        x = (x - shift * mask) / scale
        ld = ld + torch.log(scale).sum(-1)
        x = dot(x - packed.lu_bias[l], packed.lu_inv_t[l])
        x = (x - packed.an_shift[l]) * packed.an_scale[l]
    return x.reshape(b, n, dp)[..., :d], ld.reshape(b, n)


def check_shapes(packed: Packed, z0: torch.Tensor, ctx: torch.Tensor) -> None:
    """The kernel's shape, dtype and layout checks on its operands (the fake
    implementation's too)."""
    b, n, d = z0.shape
    n_layers, _, h, _ = packed.big_t.shape
    dp = packed.mask_tr.shape[1]
    ext.require(z0.dtype == torch.float32 and z0.is_contiguous(),
                "glow sampler: z0 must be contiguous float32 (B, N, D)")
    ext.require(d == packed.dim and dp % D_ALIGN == 0 and d <= dp <= MAX_DP,
                f"glow sampler: z0 has D={d}, the flow {packed.dim} padded to {dp} "
                f"(a multiple of {D_ALIGN}, at most {MAX_DP})")
    ext.require(h % H_ALIGN == 0,
                f"glow sampler: hidden width {h} is not a multiple of {H_ALIGN}")
    ext.require(ctx.shape == (n_layers, 3, b, h) and ctx.dtype == torch.float32
                and ctx.is_contiguous(),
                f"glow sampler: ctx must be contiguous float32 {(n_layers, 3, b, h)}, got "
                f"{tuple(ctx.shape)} {ctx.dtype}")
    for name in ("big_t", "w_in_t", "w_ss_t", "lu_inv_t"):
        t = getattr(packed, name)
        ext.require(t.dtype == torch.bfloat16 and t.is_contiguous(),
                    f"glow sampler: packed {name} must be contiguous bfloat16, not {t.dtype}")
    for name in ("b_big", "b_in", "b_shift", "b_scale", "lu_bias", "an_shift", "an_scale",
                 "mask_tr"):
        t = getattr(packed, name)
        ext.require(t.dtype == torch.float32 and t.is_contiguous(),
                    f"glow sampler: packed {name} must be contiguous float32")
    for t in (ctx, *(getattr(packed, name) for name in KERNEL_FIELDS)):
        ext.require(t.device == z0.device, "glow sampler: tensors on different devices")


def _transform_kernel(packed: Packed, z0: torch.Tensor, ctx: torch.Tensor):
    global launches
    ext.require(z0.is_cuda, f"glow sampler: unsupported device {z0.device}")
    check_shapes(packed, z0, ctx)
    b, n, d = z0.shape
    n_layers, _, h, _ = packed.big_t.shape
    dp = packed.mask_tr.shape[1]
    args = tuple(getattr(packed, name) for name in KERNEL_FIELDS)
    rows = b * n
    x = torch.empty_like(z0)
    ld = torch.empty((b, n), dtype=torch.float32, device=z0.device)
    # Scratch: the f32 state and its bf16 copy, the f32 residual stream, the
    # two bf16 operand copies of the hidden products and the blocks' gates.
    xs = torch.empty((rows, dp), dtype=torch.float32, device=z0.device)
    x16 = torch.empty((rows, dp), dtype=torch.bfloat16, device=z0.device)
    temps = torch.empty((rows, h), dtype=torch.float32, device=z0.device)
    a16 = torch.empty((rows, h), dtype=torch.bfloat16, device=z0.device)
    t16 = torch.empty((rows, h), dtype=torch.bfloat16, device=z0.device)
    gates = torch.empty((n_layers, 2, b, h), dtype=torch.float32, device=z0.device)
    lib = ext.load()
    err = lib.mhent_glow_sample(
        z0.data_ptr(), ctx.data_ptr(), *(t.data_ptr() for t in args), x.data_ptr(),
        ld.data_ptr(), xs.data_ptr(), x16.data_ptr(), temps.data_ptr(), a16.data_ptr(),
        t16.data_ptr(), gates.data_ptr(), b, n, d, dp, h, n_layers, ext.stream_of(z0))
    ext.check(err, "mhent_glow_sample")
    launches += 1
    return x, ld



# The kernel's operands: the K-major copies, the biases, the LU inverse, the
# actnorm and the mask (the op's tensors after z0 and ctx).
KERNEL_FIELDS = ("big_t", "b_big", "w_in_t", "b_in", "w_ss_t", "b_shift", "b_scale",
                 "lu_inv_t", "lu_bias", "an_shift", "an_scale", "mask_tr")


def _from_kernel_fields(z0: torch.Tensor, fields, plain: bool = False) -> Packed:
    """A Packed of the op's operands; with `plain`, also the (in, out)
    weights that `transform_plain` reads, transposed back (exactly `pack`'s:
    the same values, contiguous). `ld_const` is not among them."""
    k = dict(zip(KERNEL_FIELDS, fields))
    big = w_in = w_shift = w_scale = None
    if plain:
        dp = k["mask_tr"].shape[1]
        big = k["big_t"].transpose(-1, -2).contiguous()
        w_in = k["w_in_t"].transpose(-1, -2).contiguous()
        w_ss = k["w_ss_t"].transpose(-1, -2)
        w_shift, w_scale = w_ss[..., :dp].contiguous(), w_ss[..., dp:].contiguous()
    return Packed(big=big, w_in=w_in, w_shift=w_shift, w_scale=w_scale, **k, ld_const=None,
                  dim=z0.shape[-1])


def _transform_cpu(z0, ctx, *fields):
    x, ld = transform_plain(_from_kernel_fields(z0, fields, plain=True), z0, ctx)
    return x.contiguous(), ld


def _transform_fake(z0, ctx, *fields):
    ops.require_device(z0, "glow sampler")
    if z0.is_cuda:
        check_shapes(_from_kernel_fields(z0, fields), z0, ctx)
    return z0.new_empty(z0.shape, dtype=torch.float32), z0.new_empty(z0.shape[:2],
                                                                        dtype=torch.float32)


_op = ops.define(
    "glow_sample(Tensor z0, Tensor ctx, " + ", ".join(f"Tensor {f}" for f in KERNEL_FIELDS)
    + ") -> (Tensor, Tensor)",
    cpu=_transform_cpu,
    cuda=lambda z0, ctx, *fields: _transform_kernel(_from_kernel_fields(z0, fields), z0, ctx),
    fake=_transform_fake)

def sample_and_log_prob_fused(flow: glow.ConditionalGlow, packed: Packed,
                              context: torch.Tensor, n: int, noise: torch.Tensor):
    """The flow draw for n hypotheses of each of B images.

    context: (B, C); noise: (n * B, D) hypothesis-major base noise, already
    times temp. Returns x (n * B, D) hypothesis-major and log q (n * B,).
    """
    b = context.shape[0]
    d = flow.cfg.features
    # Inside `parallel.sharded.tensor_parallel` the gates are gathered over
    # the line (`glow._ctx_cache`); the packed weights are whole.
    ctx = pack_context(flow, context)
    z0 = noise.reshape(n, b, d).transpose(0, 1).contiguous()  # image-major
    with sharded.whole():
        x, sum_log_scale = transform(packed, z0, ctx)
    lp = std_normal_logp(z0) + sum_log_scale + packed.ld_const
    return x.transpose(0, 1).reshape(n * b, d), lp.transpose(0, 1).reshape(n * b)
