"""JAX params -> the port's state_dict.

`from_jax` is the exact inverse of tools/convert_torch.py (`convert_resnet`
:25, `convert_linear` :74, `convert_realnvp` :78, `convert_det_head` :122,
`load_torch_checkpoint` :129): it turns the JAX package's MHEnt param pytree
and batch stats, given as numpy arrays, into the reference's `encoderRGB`
state_dict names, which are also the port's module names. The result loads
into `models.mhent.MHEnt` with `strict=True`; so does a reference
`ent_ho3d.pth`'s `encoderRGB` entry.
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
