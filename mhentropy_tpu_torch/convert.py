"""JAX params -> the port's state_dict.

`from_jax` is the exact inverse of tools/convert_torch.py (`convert_resnet`
:25, `convert_linear` :74, `convert_realnvp` :78, `convert_det_head` :122,
`load_torch_checkpoint` :129): it turns the JAX package's MHEnt param pytree
and batch stats, given as numpy arrays, into the reference's `encoderRGB`
state_dict names, which are also the port's module names. The result loads
into `models.mhent.MHEnt` with `strict=True`; so does a reference
`ent_ho3d.pth`'s `encoderRGB` entry.

`glow_from_jax` turns the JAX ConditionalGlow params (flows/glow.py) into
the nkolot/nflows fork's state_dict names, which are the port's
`flows.glow.ConditionalGlow` names; `prohmr_from_jax` does the same for a
whole JAX ProHMR model (`models.prohmr.ProHMR`), and
`load_prohmr_smpl_flow` loads a released ProHMR SMPL-flow checkpoint by
name (the counterpart of tools/convert_torch.py:304).

`qtree_from_jax` and `flowq_from_jax` turn the JAX package's quantised
trees (models/quant.py's qtree, flows/pallas_sampler_int8.py's FlowQTree),
given as numpy arrays, into the port's, so that both packages compute with
the same int8 weights and scales. `opt_state_from_jax` turns the optax Adam
state of the JAX `make_optimizer` into the port's Adam moments by
parameter name, so a JAX-trained state continues in the port.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear(sd: dict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["w"]).T)
    sd[f"{key}.bias"] = _t(p["b"])


def _resnet(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    def module_name(path):
        out = []
        for part in path:
            m = re.fullmatch(r"layer(\d+)_(\d+)", part)
            if m:
                out.append(f"layer{m.group(1)}.{m.group(2)}")
            else:
                out.append({"downsample_conv": "downsample.0",
                            "downsample_bn": "downsample.1"}.get(part, part))
        return prefix + ".".join(out)

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path, k, v

    for path, leaf, v in walk(params, ()):
        name = module_name(path)
        if leaf == "kernel":  # HWIO -> OIHW
            sd[f"{name}.weight"] = _t(np.asarray(v).transpose(3, 2, 0, 1))
        elif leaf == "scale":
            sd[f"{name}.weight"] = _t(v)
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "bias":
            sd[f"{name}.bias"] = _t(v)
        else:
            raise ValueError(f"unexpected backbone leaf {path + (leaf,)}")
    for path, leaf, v in walk(stats, ()):
        key = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{module_name(path)}.{key}"] = _t(v)


def realnvp_state_dict(flow, prefix: str = "") -> dict:
    """JAX RealNVPParams (or its dict) -> RealNVP module state_dict."""
    sd: dict = {}
    p = flow._asdict() if hasattr(flow, "_asdict") else dict(flow)
    sd[f"{prefix}mask"] = _t(p["masks"])
    n_layers = np.asarray(p["masks"]).shape[0]
    for net in ("s", "t"):
        for i in range(n_layers):
            for j in range(3):
                _linear(sd, f"{prefix}{net}.{i}.l.{j}",
                        {"w": np.asarray(p[f"{net}_w{j}"])[i], "b": np.asarray(p[f"{net}_b{j}"])[i]})
            for j in range(2):
                if p.get(f"{net}_c{j}") is not None:
                    _linear(sd, f"{prefix}{net}.{i}.c.{j}",
                            {"w": np.asarray(p[f"{net}_c{j}"])[i],
                             "b": np.asarray(p[f"{net}_cb{j}"])[i]})
    return sd


def from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX MHEnt params {'encoder', 'flow', 'det_head'} + backbone batch
    stats -> state_dict for models.mhent.MHEnt."""
    sd: dict = {}
    enc = params["encoder"]
    _resnet(sd, "feat_extractor.res.", enc["backbone"], batch_stats)
    for head in ("l1", "l2"):
        _linear(sd, f"feat_extractor.{head}.0", enc[head])
    sd.update(realnvp_state_dict(params["flow"], "q_z_giv_i."))
    _linear(sd, "det_head.0", params["det_head"]["l0"])
    _linear(sd, "det_head.2", params["det_head"]["l1"])
    return sd


def opt_state_from_jax(opt_state) -> dict:
    """optax state of chain(clip_by_global_norm, adam(schedule)), given as
    numpy arrays ((EmptyState(), (ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count)))) -> {"count": updates taken, "state":
    {parameter name: {"exp_avg": mu, "exp_avg_sq": nu}}}, the names mapped
    as `from_jax` maps the params (engine.Optimizer.load_moments)."""
    def find(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                found = find(child)
                if found is not None:
                    return found
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optax state")
    mu, nu = from_jax(adam.mu, {}), from_jax(adam.nu, {})
    # The masks' moments (a buffer in the port) and the BN counters are no
    # parameters.
    names = [k for k in mu if not k.endswith(("num_batches_tracked", "q_z_giv_i.mask"))]
    return {"count": int(np.asarray(adam.count)),
            "state": {k: {"exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in names}}


def _tensor(a, dtype=None, device="cpu") -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return (t if dtype is None else t.to(dtype)).contiguous().to(device)


def qtree_from_jax(spec, qtree: dict, device="cpu") -> dict:
    """JAX quant.prepare qtree (+ optional "flow") -> the port's qtree for
    `spec` (a port QuantSpec): every site's keys as they are (int8 HWIO
    `w8`, f32 scales: `inv_sa`, or the int8 stem's per-channel `inv_a`), a
    fresh ResNet module holding the float stem and stages, and the kernels'
    operands that `quant.finish` packs for the spec."""
    from mhentropy_tpu_torch.models import quant, resnet

    sites = {key: {name: _tensor(v, torch.int8 if name == "w8" else torch.float32, device)
                   for name, v in s.items()}
             for key, s in qtree["sites"].items()}
    sd: dict = {}
    _resnet(sd, "", qtree["float"]["params"], qtree["float"]["batch_stats"])
    res = resnet.make_backbone(spec.backbone)
    unexpected = res.load_state_dict(sd, strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"unexpected float backbone keys {sorted(unexpected)[:4]}")
    res = res.to(device=device, dtype=getattr(torch, spec.dtype)).eval()
    out = quant.finish({"float": res, "sites": sites}, spec)
    if qtree.get("flow") is not None:
        out["flow"] = flowq_from_jax(qtree["flow"], device=device)
    return out


def flowq_from_jax(ftree, dim: int = 45, device="cpu"):
    """JAX FlowQTree (D padded to 128 lanes) -> the port's (D padded to a
    multiple of 32). The dropped padding holds no weights: zero rows of w0,
    zero columns of w2 and b2."""
    from mhentropy_tpu_torch.flows import cuda_sampler_int8 as q8

    f = ftree._asdict() if hasattr(ftree, "_asdict") else dict(ftree)
    dp = -(-dim // q8.D_ALIGN) * q8.D_ALIGN
    fields = {}
    for name in q8.FlowQTree._fields:
        if name == "kernel":
            continue
        a = np.asarray(f[name])
        if name.endswith("_w0"):
            extra, a = a[:, dp:], a[:, :dp]
        elif name in ("cond_scale", "cond_bias"):
            extra = np.zeros(0)
        else:
            extra, a = a[..., dp:], a[..., :dp]
        if name.endswith(("_w0", "_w2", "_b2")) and np.any(extra != 0):
            raise ValueError(f"{name}: weights on the lane padding beyond D={dim}")
        fields[name] = _tensor(a, torch.int8 if "_w" in name else torch.float32, device)
    return q8.with_kernel_layout(q8.FlowQTree(**fields))


def glow_from_jax(params: list, prefix: str = "") -> dict:
    """JAX ConditionalGlow params (a list of per-step {actnorm, linear,
    coupling} dicts) -> the fork-named state_dict of
    flows.glow.ConditionalGlow. ActNorm's `initialized` is True: the values
    are final and a later train-mode forward must not re-initialise them."""
    from mhentropy_tpu_torch.flows import glow

    d = np.asarray(params[0]["actnorm"]["log_scale"]).shape[0]
    masks = glow.coupling_masks(d, len(params))
    sd: dict = {}
    for i, layer in enumerate(params):
        base = f"{prefix}_transform._transforms."
        an, lin, cpl = layer["actnorm"], layer["linear"], layer["coupling"]
        sd[f"{base}{3 * i}.initialized"] = torch.tensor(True)
        sd[f"{base}{3 * i}.log_scale"] = _t(an["log_scale"])
        sd[f"{base}{3 * i}.shift"] = _t(an["shift"])
        for name in ("bias", "lower_entries", "upper_entries", "unconstrained_upper_diag"):
            sd[f"{base}{3 * i + 1}.{name}"] = _t(lin[name])
        c = f"{base}{3 * i + 2}"
        sd[f"{c}.identity_features"] = torch.as_tensor(masks[i][0], dtype=torch.long)
        sd[f"{c}.transform_features"] = torch.as_tensor(masks[i][1], dtype=torch.long)
        _linear(sd, f"{c}.transform_net.initial_layer", cpl["initial"])
        _linear(sd, f"{c}.transform_net.final_layer", cpl["final"])
        for k, blk in enumerate(cpl["blocks"]):
            if "bn0" in blk:
                raise NotImplementedError("Glow coupling nets with BatchNorm are not ported yet "
                                          "(ROADMAP queue 1, item 9)")
            b = f"{c}.transform_net.blocks.{k}"
            _linear(sd, f"{b}.context_layer", blk["ctx"])
            _linear(sd, f"{b}.linear_layers.0", blk["l0"])
            _linear(sd, f"{b}.linear_layers.1", blk["l1"])
    return sd


def prohmr_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX ProHMR params {'encoder', 'flow', 'betas_head', 'cam_head'} +
    backbone batch stats -> state_dict for models.prohmr.ProHMR."""
    sd: dict = {}
    enc = params["encoder"]
    _resnet(sd, "encoder.res.", enc["backbone"], batch_stats)
    for head in ("l1", "l2"):
        _linear(sd, f"encoder.{head}.0", enc[head])
    sd.update(glow_from_jax(params["flow"], "flow."))
    _linear(sd, "betas_head", params["betas_head"])
    _linear(sd, "cam_head", params["cam_head"])
    return sd


_GLOW_MARKER = "_transform._transforms.0.log_scale"


def glow_config_of(sd: dict, prefix: str = ""):
    """The GlowConfig a fork-named state_dict was built with."""
    from mhentropy_tpu_torch.flows import glow

    steps = {int(m.group(1)) for k in sd
             if (m := re.match(re.escape(prefix) + r"_transform\._transforms\.(\d+)\.", k))}
    net = f"{prefix}_transform._transforms.2.transform_net"
    blocks = {int(m.group(1)) for k in sd
              if (m := re.match(re.escape(net) + r"\.blocks\.(\d+)\.", k))}
    init_w = sd[f"{net}.initial_layer.weight"]
    ctx = sd[f"{net}.blocks.0.context_layer.weight"].shape[1]
    return glow.GlowConfig(features=sd[f"{prefix}{_GLOW_MARKER}"].shape[0],
                           hidden=init_w.shape[0], num_layers=len(steps) // 3,
                           num_blocks=len(blocks), context_features=ctx,
                           use_batch_norm=any("batch_norm_layers" in k for k in sd))


def load_prohmr_smpl_flow(path: str, cfg=None, device="cpu"):
    """A released ProHMR SMPL-flow checkpoint (or any torch file holding a
    fork ConditionalGlow) -> flows.glow.ConditionalGlow, loaded by name
    with strict=True. The key prefix (ProHMR stores the flow as `flow.`,
    standalone dumps use none) is found from the first ActNorm's key. cfg:
    the GlowConfig the caller expects; a checkpoint of another geometry
    raises with both configs."""
    from mhentropy_tpu_torch.flows import glow

    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    prefixes = sorted({k[:-len(_GLOW_MARKER)] for k in sd if k.endswith(_GLOW_MARKER)})
    if not prefixes:
        raise ValueError(f"{path}: no ConditionalGlow found; keys like {sorted(sd)[:5]}")
    prefix = prefixes[0]
    got = glow_config_of(sd, prefix)
    if cfg is not None and got != cfg._replace(dropout=got.dropout):
        raise ValueError(f"{path}: checkpoint geometry {got} does not match the configured "
                         f"flow {cfg}")
    flow = glow.ConditionalGlow(got if cfg is None else cfg)
    flow.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
                         strict=True)
    return flow.to(device).eval()
