"""Post-training W8A8 quantisation of the eval / serving encoder.

Port of mhentropy_tpu/models/quant.py: `QuantSpec` :49, `_quantize`,
`_qconv_pre` and `_qconv` :96-113, `_forward` :143 (the structural eval
forward shared by calibration and int8 inference), `calibrate` :316,
`prepare` :323, `backbone_forward` :377, `resolve_q_from` :383,
`quantize_encoder` :399, `encoder_feat` :416, `sampler_supported` :430 and
`quantize_sampler_into` :443.

Scheme: symmetric per-output-channel int8 weights, symmetric per-tensor
int8 activations with static scales (max|x| / 127 at each conv input on
representative images), eval BN folded into the dequantise affine
(y = acc * s_a * s_w * alpha + beta), residuals, ReLU and pooling in the
float compute dtype. The downsample shares conv1's input and scale, so the
block input is quantised once.

Where each part runs on the card: the stem is the bf16 stem kernel
(stem_cuda); stage 1 is the int8 stage-1 kernel (stage1_int8_cuda) when
q_from == 0, else the bf16 stage-1 kernel; stages 2-4's int8 convolutions
are `torch._int_mm` library products (1x1 directly, 3x3 through an int8
im2col), as the JAX package left them to XLA outside any Pallas kernel. On
the CPU they are f64 convolutions of the integer-valued tensors, exact like
XLA's s32 accumulation. Two opt-in kernels, off by default as in the JAX
package, take their parts over where the JAX package's gates pass: with
`int8_stem` the stem is the W8A8 stem kernel (stem_int8_cuda, calibrated
per input channel), and with `pallas_mid=True` stages 2 and 3 are the
fused W8A8 stage kernel (stage2_int8_cuda). On the CPU the same dispatch
runs their plain versions. `pallas_mid` "s8" / "fused" need the int8
stage-1 kernel's s8 emits, which are not ported, and raise.

The qtree is {"float": the ResNet module (stem and stages below q_from),
"sites": {"layer{i}_{j}/{conv}": {"w8" (kh, kw, I, O) int8, "inv_sa" (),
"scale" (O,), "bias" (O,)}, "stem/conv1": {"w8" (7, 7, 3, 64), "inv_a" (3,),
"scale", "bias"} with int8_stem}, "stage1": the int8 stage-1 kernel's
operands when q_from == 0, "stem" / "stage2" / "stage3": the int8 stem's
and stage kernel's operands when the spec asks for them, "flow": the int8
sampler's FlowQTree}.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from mhentropy_tpu_torch.flows import cuda_sampler_int8
from mhentropy_tpu_torch.models import (stage1_cuda, stage1_int8_cuda, stage2_int8_cuda,
                                        stem_cuda, stem_int8_cuda)

EPS = 1e-5
_ARCH = {"resnet18": ((2, 2, 2, 2), "basic"), "resnet50": ((3, 4, 6, 3), "bottleneck")}
CALIB_HYPOTHESES = 32  # flow calibration draws per image (quantize_sampler's n)
CALIB_SEED = 17  # calibration is deterministic by design


class QuantSpec(NamedTuple):
    backbone: str = "resnet50"
    q_from: int = 1  # first stage index (0-based) to quantise
    dtype: str = "bfloat16"  # float compute dtype of the unquantised ops
    pallas_stem: bool = True  # the bf16 stem kernel on the card
    pallas_stage1: bool = True  # the stage-1 kernels on the card
    # The fused int8 stage-2/3 kernel: False (default) or True; "s8" and
    # "fused" (the stage-1 kernel's s8 emits) raise.
    pallas_mid: bool | str = False
    int8_stem: bool = False  # the int8 stem kernel (default off)
    int8_sampler: bool = False  # the int8 fused sampler draws the hypotheses


def _check(spec: QuantSpec) -> None:
    if spec.pallas_mid not in (False, True, "s8", "fused"):
        # Compared by identity below: an unrecognised value (a config layer's
        # stringified bool) would run the default path while claiming a mode.
        raise ValueError(f"QuantSpec.pallas_mid must be False/True/'s8'/'fused', got "
                         f"{spec.pallas_mid!r}")
    if spec.pallas_mid in ("s8", "fused"):
        raise NotImplementedError(
            f"QuantSpec.pallas_mid={spec.pallas_mid!r} needs the int8 stage-1 kernel's "
            "nhwc_s8 / cm_s8 emits, which ROADMAP lists under 'Not to port'")


def _bn_affine(bn):
    alpha = bn.weight.float() / torch.sqrt(bn.running_var.float() + EPS)
    return alpha, bn.bias.float() - bn.running_mean.float() * alpha


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(x, w, stride: int, pad: int, dtype):
    """NHWC x, OIHW w -> NHWC, in dtype."""
    return _nhwc(F.conv2d(_nchw(x.to(dtype)), w.to(dtype), stride=stride, padding=pad))


def _quantize(x, inv_sa) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() * inv_sa), -127, 127).to(torch.int8)


def _im2col(xq: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, k * k * C), columns in (dy, dx, c) order
    (the HWIO weight's row order)."""
    if k == 1 and pad == 0:
        return xq[:, ::stride, ::stride]
    b, h, w, _ = xq.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    return torch.cat([xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                         dx:dx + stride * (wo - 1) + 1:stride]
                      for dy in range(k) for dx in range(k)], dim=-1)


def _int_conv(xq: torch.Tensor, w8: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """int8 NHWC conv with an exact integer sum, returned as f32 NHWC."""
    if not xq.is_cuda:
        y = F.conv2d(_nchw(xq).double(), w8.permute(3, 2, 0, 1).double(),
                     stride=stride, padding=pad)
        return _nhwc(y).float()
    cols = _im2col(xq, w8.shape[0], stride, pad)
    b, ho, wo, kdim = cols.shape
    a = cols.reshape(-1, kdim)
    m = a.shape[0]
    rows = max(32, -(-m // 8) * 8)  # torch._int_mm takes m > 16, cuBLASLt a multiple of 8
    if rows != m:
        a = F.pad(a, (0, 0, 0, rows - m))
    acc = torch._int_mm(a.contiguous(), w8.reshape(kdim, -1).contiguous())[:m]
    return acc.float().reshape(b, ho, wo, -1)


def _qconv_pre(xq, site: dict, stride: int, pad: int):
    """int8 conv on an already-quantised input + dequantise epilogue."""
    return _int_conv(xq, site["w8"], stride, pad) * site["scale"] + site["bias"]


def _qconv(x, site: dict, stride: int, pad: int):
    return _qconv_pre(_quantize(x, site["inv_sa"]), site, stride, pad)


def _modules(blk, conv_name: str):
    if conv_name == "downsample_conv":
        return blk.downsample[0], blk.downsample[1]
    return getattr(blk, conv_name), getattr(blk, "bn" + conv_name[-1])


def _int8_stem_ok(spec: QuantSpec, sites: dict | None, x: torch.Tensor) -> bool:
    return (spec.int8_stem and sites is not None and "stem/conv1" in sites
            and stem_int8_cuda.supported(x, 64, False))


def _forward(spec: QuantSpec, res, sites: dict | None, x: torch.Tensor,
             collect: dict | None = None, packs: dict | None = None) -> torch.Tensor:
    """Eval-mode backbone walk on a (B, H, W, 3) NHWC image -> (B, feat) f32.

    With `collect`, records max|input| of every conv that will be
    quantised (calibration); with `sites`, runs those convs in int8.
    `res` is the port's ResNet module (its float stem and stages); `packs`
    holds the kernels' operands (the qtree's "stage1", "stem", "stage2",
    "stage3"). The int8 kernels' gates are the JAX package's.
    """
    _check(spec)
    packs = packs or {}
    dtype = getattr(torch, spec.dtype)
    sizes, kind = _ARCH[spec.backbone]
    kernels = x.is_cuda and dtype == torch.bfloat16
    if kernels and (spec.pallas_stem or spec.pallas_stage1) and res.folded is None:
        raise RuntimeError("the CUDA kernel path needs ResNet.fold_kernel_weights() first "
                           "(mhent.prepare runs it)")
    if spec.int8_stem and collect is not None:
        # Per input channel: the stem site quantises each channel alone.
        collect["stem/conv1"] = x.abs().amax(dim=tuple(range(x.dim() - 1))).float()
    if _int8_stem_ok(spec, sites, x):
        x = stem_int8_cuda.stem_forward_q(x.float().contiguous(), packs["stem"], out_dtype=dtype)
    elif kernels and spec.pallas_stem:
        x = stem_cuda.stem_forward(x.to(dtype).contiguous(), *res.folded[0])
    else:
        alpha, beta = _bn_affine(res.bn1)
        x = _conv(x, res.conv1.weight, 2, 3, dtype) * alpha.to(dtype) + beta.to(dtype)
        x = _nhwc(F.max_pool2d(_nchw(torch.relu(x)), 3, stride=2, padding=1))

    for i, n_blocks in enumerate(sizes):
        quant_stage = i >= spec.q_from
        if (i == 0 and kind == "bottleneck" and spec.pallas_stage1 and kernels
                and x.dtype == torch.bfloat16):
            if not quant_stage and res.folded[1] is not None:
                x = stage1_cuda.stage1_forward(x.contiguous(), res.folded[1])
                continue
            if quant_stage and sites is not None and "stage1" in packs:
                x = stage1_int8_cuda.stage1_forward_q(x.contiguous(), packs["stage1"]).to(dtype)
                continue
        if (i in (1, 2) and quant_stage and sites is not None and kind == "bottleneck"
                and spec.pallas_mid is True):
            stage = i + 1
            if (stage2_int8_cuda.supported(x, stage) and stage2_int8_cuda.sites_ok(sites, stage)
                    and stage2_int8_cuda.GEOMS[stage].n_blocks == n_blocks):
                x = stage2_int8_cuda.stage_forward_q(x.contiguous(), packs[f"stage{stage}"],
                                                     stage, out_dtype=dtype)
                continue
        x = walk_stage(spec, res, sites, x, i, collect)
    return x.mean(dim=(1, 2)).float()


def walk_stage(spec: QuantSpec, res, sites: dict | None, x: torch.Tensor, i: int,
               collect: dict | None = None) -> torch.Tensor:
    """Stage i (0-based) conv by conv on NHWC x: float convolutions below
    q_from, int8 ones (`torch._int_mm` on the card) from it on."""
    dtype = getattr(torch, spec.dtype)
    sizes, kind = _ARCH[spec.backbone]
    quant_stage = i >= spec.q_from
    layer = getattr(res, f"layer{i + 1}")
    for j in range(sizes[i]):
        blk = layer[j]
        stride = 2 if i > 0 and j == 0 else 1
        path = f"layer{i + 1}_{j}"

        def cv(conv_name, xin, st, pad, path=path, blk=blk):
            key = f"{path}/{conv_name}"
            if quant_stage and sites is not None:
                return _qconv(xin, sites[key], st, pad).to(dtype)
            if quant_stage and collect is not None:
                collect[key] = xin.abs().max().float()
            conv, bn = _modules(blk, conv_name)
            alpha, beta = _bn_affine(bn)
            return _conv(xin, conv.weight, st, pad, dtype) * alpha.to(dtype) + beta.to(dtype)

        r = x
        ds_key = f"{path}/downsample_conv"
        if quant_stage and sites is not None and ds_key in sites:
            # conv1 and the downsample share the block input and its
            # scale: quantise it once.
            s1 = sites[f"{path}/conv1"]
            xq = _quantize(x, s1["inv_sa"])
            c1_stride, c1_pad = (1, 0) if kind == "bottleneck" else (stride, 1)
            y = torch.relu(_qconv_pre(xq, s1, c1_stride, c1_pad).to(dtype))
            if kind == "bottleneck":
                y = torch.relu(cv("conv2", y, stride, 1))
                y = cv("conv3", y, 1, 0)
            else:
                y = cv("conv2", y, 1, 1)
            r = _qconv_pre(xq, sites[ds_key], stride, 0).to(dtype)
        elif kind == "bottleneck":
            y = torch.relu(cv("conv1", x, 1, 0))
            y = torch.relu(cv("conv2", y, stride, 1))
            y = cv("conv3", y, 1, 0)
            if r.shape != y.shape:
                r = cv("downsample_conv", x, stride, 0)
        else:
            y = torch.relu(cv("conv1", x, stride, 1))
            y = cv("conv2", y, 1, 1)
            if r.shape != y.shape:
                r = cv("downsample_conv", x, stride, 0)
        x = torch.relu(y + r)
    return x


@torch.no_grad()
def calibrate(spec: QuantSpec, res, images: torch.Tensor) -> dict:
    """The float eval forward on representative images ->
    {site: max|activation|} for every to-be-quantised conv input."""
    collect = {}
    _forward(spec, res, None, images, collect)
    return collect


@torch.no_grad()
def prepare(spec: QuantSpec, res, act_maxabs: dict) -> dict:
    """int8 weights and dequantise affines for the quantised sites; the
    module itself serves the float stem and stages below q_from."""
    _check(spec)
    sizes, kind = _ARCH[spec.backbone]
    names = ("conv1", "conv2", "conv3") if kind == "bottleneck" else ("conv1", "conv2")
    sites = {}
    if spec.int8_stem and "stem/conv1" in act_maxabs:
        sites["stem/conv1"] = stem_int8_cuda.prepare_stem_site(res.conv1.weight, res.bn1,
                                                               act_maxabs["stem/conv1"])
    for i, n_blocks in enumerate(sizes):
        if i < spec.q_from:
            continue
        layer = getattr(res, f"layer{i + 1}")
        for j in range(n_blocks):
            blk, path = layer[j], f"layer{i + 1}_{j}"
            convs = names + (("downsample_conv",) if blk.downsample is not None else ())
            for conv_name in convs:
                key = f"{path}/{conv_name}"
                conv, bn = _modules(blk, conv_name)
                w = conv.weight.float().permute(2, 3, 1, 0)  # HWIO
                s_w = w.abs().amax(dim=(0, 1, 2)) / 127.0
                s_w = torch.where(s_w > 0, s_w, torch.ones_like(s_w))
                w8 = torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8).contiguous()
                alpha, beta = _bn_affine(bn)
                # The downsample reads conv1's input: pin its scale to conv1's.
                act_key = f"{path}/conv1" if conv_name == "downsample_conv" else key
                s_a = torch.as_tensor(act_maxabs[act_key], dtype=torch.float32,
                                      device=w.device) / 127.0
                s_a = torch.where(s_a > 0, s_a, torch.ones_like(s_a))
                sites[key] = {"w8": w8, "inv_sa": 1.0 / s_a,
                              "scale": (s_a * s_w * alpha).float(), "bias": beta.float()}
    return finish({"float": res, "sites": sites}, spec)


def finish(qtree: dict, spec: QuantSpec) -> dict:
    """Adds the kernels' operands, packed once per calibration: the int8
    stage-1 kernel's when stage 1 is quantised, the int8 stem's with
    `int8_stem`, and the stage kernel's for stages 2 and 3 with
    `pallas_mid=True`, wherever their sites are there."""
    _check(spec)
    sites = qtree["sites"]
    bottleneck = _ARCH[spec.backbone][1] == "bottleneck"
    if spec.q_from == 0 and bottleneck and stage1_int8_cuda.sites_ok(sites):
        qtree["stage1"] = stage1_int8_cuda.pack(sites)
    if spec.int8_stem and "stem/conv1" in sites:
        qtree["stem"] = stem_int8_cuda.pack(sites["stem/conv1"])
    if spec.pallas_mid is True and bottleneck:
        for stage in (2, 3):
            if stage2_int8_cuda.sites_ok(sites, stage):
                qtree[f"stage{stage}"] = stage2_int8_cuda.pack(sites, stage)
    return qtree


def backbone_forward(spec: QuantSpec, qtree: dict, images: torch.Tensor) -> torch.Tensor:
    """Quantised eval-mode features: (B, H, W, 3) -> (B, feat) f32."""
    return _forward(spec, qtree["float"], qtree["sites"], images, packs=qtree)


def resolve_q_from(q_from, backbone: str, image_shape, device) -> int:
    """"auto" quantises stage 1 too (q_from = 0) exactly where the JAX
    policy does (quant.py:383): a resnet50 whose post-stem map (B, H/4, W/4,
    64) passes the int8 stage-1 kernel's geometry gate
    (`stage1_int8_cuda.supported`), with the gate's TPU clause read as "the
    device is CUDA". Explicit values pass through, "0"/"1" strings
    included."""
    if q_from != "auto":
        return int(q_from)
    if _ARCH.get(backbone, (None, None))[1] != "bottleneck" or len(image_shape) != 4:
        return 1
    b, h, w = image_shape[:3]
    return 0 if (torch.device(device).type == "cuda"
                 and stage1_int8_cuda.supported((b, h // 4, w // 4, 64))) else 1


def quantize_encoder(encoder, calib_images: torch.Tensor, q_from="auto") -> tuple:
    """One-call encoder quantisation -> (spec, qtree) for `encoder_feat`;
    the heads stay float. The kernel switches are read from the encoder's
    config where it has them, with the JAX package's defaults. The port's
    EncoderConfig has none of these fields, so today the reads give the
    defaults; they mirror the JAX package's quantize_encoder."""
    cfg = encoder.cfg
    spec = QuantSpec(backbone=cfg.backbone, dtype=cfg.dtype,
                     q_from=resolve_q_from(q_from, cfg.backbone, calib_images.shape,
                                           calib_images.device),
                     pallas_stem=getattr(cfg, "pallas_stem", True),
                     pallas_stage1=getattr(cfg, "pallas_stage1", True),
                     pallas_mid=getattr(cfg, "pallas_mid", False),
                     int8_stem=getattr(cfg, "int8_stem", False))
    act = calibrate(spec, encoder.res, calib_images)
    return spec, prepare(spec, encoder.res, act)


def encoder_feat(spec: QuantSpec, qtree: dict, encoder, images: torch.Tensor,
                 head: bool = True) -> torch.Tensor:
    """The quantised conditioning feature: int8 backbone, f32 mu head."""
    feats = backbone_forward(spec, qtree, images)
    return encoder.l1(feats) if head else feats


def sampler_supported(model_cfg) -> bool:
    """A RealNVP regressor whose flow the int8 sampler takes."""
    return model_cfg.regressor == "realnvp" and cuda_sampler_int8.shape_ok(model_cfg.flow)


def calib_noise(n_images: int, dim: int, temp: float, device) -> torch.Tensor:
    """The flow calibration's (CALIB_HYPOTHESES * n_images, dim) base noise,
    times temp, from the fixed calibration seed."""
    g = torch.Generator(device=device).manual_seed(CALIB_SEED)
    return torch.randn((CALIB_HYPOTHESES * n_images, dim), generator=g, device=device) * temp


@torch.no_grad()
def quantize_sampler_into(spec: QuantSpec, qtree: dict, net, calib_images: torch.Tensor,
                          z0_calib: torch.Tensor | None = None, temp: float = 0.8) -> tuple:
    """Extend an encoder (spec, qtree) with the int8 sampler: the flow's
    activation scales are calibrated on the QUANTISED encoder's features
    (what the sampler will see) and the tree is attached as qtree["flow"].

    temp must be >= the hottest temperature the tree will serve: the scales
    are amaxes of a temp-scaled trajectory. z0_calib is the calibration's
    base noise already times temp (`calib_noise` when None).
    """
    feat = encoder_feat(spec, qtree, net.feat_extractor, calib_images)
    if z0_calib is None:
        z0_calib = calib_noise(feat.shape[0], net.cfg.flow.dim, temp, feat.device)
    qtree = dict(qtree)
    qtree["flow"] = cuda_sampler_int8.quantize_sampler(net.q_z_giv_i, feat, z0_calib)
    return spec._replace(int8_sampler=True), qtree
