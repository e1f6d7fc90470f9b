"""Serving export: the multi-hypothesis sampler through `torch.export`.

Port of tools/export.py: `make_sample_fn` :24, `export_sampler` :74,
`load_sampler` :93 and `main` :101. The sampler (encoder -> flow -> MANO
decode, `models/mhent.py::sample_hypotheses`) is traced by
`torch.export.export` into an `ExportedProgram` and saved with
`torch.export.save` to bytes, which a later process (one that imports only
this module) loads and calls.

Notes:
  - Export is device-specific, like the JAX package's platform-specific
    artifacts: on the card the program launches the port's CUDA kernels,
    which are operators `mhent::*` (mhentropy_tpu_torch/ops.py) that the
    trace keeps as calls; on the CPU it holds their plain versions' path.
    The artifact records its device, and `Sampler.call` refuses inputs on
    another.
  - Shapes are static (batch and n fixed at export time): the serving
    contract a batcher pads to.
  - torch cannot replay `jax.random`, so the base noise is an input (JAX's
    `raw_key`): (n * batch, 45) hypothesis-major rows, already times temp.
  - `ShardedSampler` serves one artifact data-parallel (the sharded export
    of tests/test_export.py:81): every rank loads the same bytes, exported
    for its share of the batch, and the outputs are gathered.

    python -m mhentropy_tpu_torch.export sampler.pt2 [--batch 8] [--n 100]
        [--quantize] [--pth ckpt.pth] [--mano ./mano/] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

import torch
from torch import nn

from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.flows import cuda_glow_sampler
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.parallel import mesh as mesh_lib
from mhentropy_tpu_torch.parallel import sharded

# What the artifact records beside the program (torch.export.save's extra files).
DEVICE_FILE = "device"
CONFIG_FILE = "mhent_config.json"


def _flow_fields(packed) -> tuple:
    """The packed flow's fields that the sampling path reads: the Glow
    sampler's kernel operands and its log-det constant (not the (in, out)
    copies that only `transform_plain` reads), every tensor of the
    RealNVP's."""
    if isinstance(packed, cuda_glow_sampler.Packed):
        return (*cuda_glow_sampler.KERNEL_FIELDS, "ld_const")
    return tuple(k for k, t in packed._asdict().items() if isinstance(t, torch.Tensor))


def kernel_weights(net: mhent.MHEnt) -> dict:
    """The tensors `mhent.prepare` derives from the weights for the kernels
    (the folded stem and stage 1, the packed flow), by name."""
    out = {}
    folded = net.feat_extractor.res.folded
    if folded is not None:
        out["stem_w"], out["stem_b"] = folded[0]
        for j, blk in enumerate(folded[1] or ()):
            out.update({f"stage1_{j}_{k}": t for k, t in blk._asdict().items() if t is not None})
    if net.packed_flow is not None:
        out.update({f"flow_{k}": getattr(net.packed_flow, k)
                    for k in _flow_fields(net.packed_flow)})
    return out


@contextlib.contextmanager
def _bound(net: mhent.MHEnt, weights: dict):
    """The net's kernel weights replaced by `weights` (`kernel_weights`'
    names) for the duration, so that a trace reads them as the sampler
    module's buffers."""
    res = net.feat_extractor.res
    saved = res.folded, net.packed_flow
    if res.folded is not None:
        stem, stage1 = res.folded
        if stage1 is not None:
            stage1 = [blk._replace(**{k: weights[f"stage1_{j}_{k}"]
                                      for k, t in blk._asdict().items() if t is not None})
                      for j, blk in enumerate(stage1)]
        res.folded = ((weights["stem_w"], weights["stem_b"]), stage1)
    if net.packed_flow is not None:
        net.packed_flow = net.packed_flow._replace(
            **{k: weights[f"flow_{k}"] for k in _flow_fields(net.packed_flow)})
    try:
        yield
    finally:
        res.folded, net.packed_flow = saved


class SampleFn(nn.Module):
    """The serving entry: forward(image (B, S, S, 3) f32, base_noise
    (n * B, 45) already times temp) -> {mod: out[mod] for mod in mods}.

    The net's parameters and buffers are this module's (under `net.`), and
    the kernels' weights derived from them are its buffers too (under
    `kernel.`), so a traced program takes a `load_state_dict`
    (`Sampler.load_state_dict` refreshes both). The MANO model and the
    keypoint fold bake in as constants.

    quant: optional (QuantSpec, qtree) of models/quant.py: the int8 W8A8
    encoder (and with `spec.int8_sampler` the int8 sampler). The qtree is
    closed over, so the int8 weights and scales bake into a traced program
    as constants: the fixed-checkpoint deployment shape. CAVEAT that
    follows, as in the JAX package: with quant set, the encoder BACKBONE's
    quantised stages (and with the int8 sampler the coupling nets) come from
    the baked qtree, and a later state dict feeds only the float stem and
    stages below q_from, the mu head, the flow (with the int8 sampler its
    conditioning only) and the det head. Build the qtree from the same
    checkpoint you deploy.
    """

    def __init__(self, model: mano.ManoModel, net: mhent.MHEnt, n: int, temp: float,
                 mods=("xyz", "uv"), quant=None):
        super().__init__()
        self.net = net
        self.kernel = nn.Module()
        for name, t in kernel_weights(net).items():
            self.kernel.register_buffer(name, t)
        self.model = model
        self.fold = mano.fold_keypoints(model)
        self.n, self.temp, self.mods, self.quant = n, temp, tuple(mods), quant

    def forward(self, image: torch.Tensor, base_noise: torch.Tensor) -> dict:
        weights = {name: getattr(self.kernel, name) for name, _ in self.kernel.named_buffers()}
        with _bound(self.net, weights):
            out = mhent.sample_hypotheses(self.model, self.net, image, n=self.n, temp=self.temp,
                                          mods=self.mods, base_noise=base_noise, fold=self.fold,
                                          quant=self.quant)
        return {m: out[m] for m in self.mods}


def make_sample_fn(model: mano.ManoModel, net: mhent.MHEnt, n: int, temp: float,
                   mods=("xyz", "uv"), quant=None) -> SampleFn:
    """The serving entry as a module (`SampleFn`); `net` prepared
    (`mhent.prepare`) on the device to serve on."""
    return SampleFn(model, net, n, temp, mods, quant)


def _config_json(cfg: mhent.MHEntConfig) -> str:
    def enc(v):
        if hasattr(v, "_asdict"):
            return {k: enc(x) for k, x in v._asdict().items()}
        if isinstance(v, tuple):
            return [enc(x) for x in v]
        return v

    return json.dumps(enc(cfg))


def _config_from_json(text: str) -> mhent.MHEntConfig:
    def tuples(v):
        return tuple(tuples(x) for x in v) if isinstance(v, list) else v

    def dec(cls, fields: dict):
        kw = {}
        for k, v in fields.items():
            default = cls._field_defaults.get(k)
            kw[k] = dec(type(default), v) if hasattr(default, "_asdict") else tuples(v)
        return cls(**kw)

    return dec(mhent.MHEntConfig, json.loads(text))


def export_sampler(model: mano.ManoModel, net: mhent.MHEnt, batch: int, n: int = 100,
                   temp: float = 0.8, mods=("xyz", "uv"), quant=None) -> bytes:
    """Serialise the sampler for `batch` images of the net's image size and
    its device (the prepared net's) to a `torch.export` artifact. A net
    stored split (a sharded run's, `parallel.sharded.distribute`) is
    gathered whole before the trace, on every rank (collective): the
    artifact holds the 1-process weights."""
    with sharded.whole(net):
        fn = make_sample_fn(model, net, n, temp, mods, quant=quant)
        if any(t.is_inference() for t in fn.state_dict().values()):
            raise ValueError("export_sampler: the net's weights are inference tensors; run "
                             "mhent.prepare (and load its weights) outside torch.inference_mode")
        dev = net.det_head[0].weight.device
        size = net.cfg.image_size
        args = (torch.zeros((batch, size, size, 3), device=dev),
                torch.zeros((n * batch, net.cfg.flow.dim), device=dev))
        with torch.no_grad():
            program = torch.export.export(fn, args)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={DEVICE_FILE: dev.type,
                                                 CONFIG_FILE: _config_json(net.cfg)})
    return buf.getvalue()


class Sampler:
    """A loaded artifact: `call(image, base_noise)` serves it; `module` is
    the program as a module (the sampler's parameter names under `net.`,
    the kernels' weights under `kernel.`); `device` is the device type it
    was exported for."""

    def __init__(self, program, device: str, config: str):
        self.module = program.module()
        self.device = device
        self._config = config

    def call(self, image: torch.Tensor, base_noise: torch.Tensor) -> dict:
        for name, t in (("image", image), ("base_noise", base_noise)):
            if t.device.type != self.device:
                raise ValueError(f"this artifact was exported for {self.device}; {name} is on "
                                 f"{t.device}")
        with torch.no_grad():
            return self.module(image, base_noise)

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Serve an MHEnt state dict (the reference's names, as
        `MHEnt.load_state_dict` takes): the parameters, and the kernels'
        weights derived from them as `mhent.prepare` derives them. A baked
        qtree stays as it was (`SampleFn`'s caveat)."""
        net = mhent.MHEnt(_config_from_json(self._config))
        net.load_state_dict(state_dict, strict=True)
        mhent.prepare(net, self.device)
        self.module.load_state_dict(
            {**{f"net.{k}": v for k, v in net.state_dict().items()},
             **{f"kernel.{k}": v for k, v in kernel_weights(net).items()}}, strict=True)


def load_sampler(blob: bytes) -> Sampler:
    """Deserialise an exported sampler. Importing this module registers the
    kernels' operators (through `models.mhent`), which the program calls."""
    extra = {DEVICE_FILE: "", CONFIG_FILE: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return Sampler(program, extra[DEVICE_FILE], extra[CONFIG_FILE])


class ShardedSampler:
    """A data-parallel server of one artifact (JAX's sharded export,
    tests/test_export.py:81): every rank of the mesh's 'data' axis loads
    the same artifact bytes, exported for the per-rank batch, and serves
    its rows of a global batch; `call` returns the outputs gathered over
    'data', (N, B, ...) as the unsharded call gives them. The ranks of
    the other axes serve the same rows."""

    def __init__(self, blob: bytes, mesh: mesh_lib.Mesh):
        self.sampler = load_sampler(blob)
        self.mesh = mesh

    def call(self, image: torch.Tensor, base_noise: torch.Tensor) -> dict:
        """image (B, S, S, 3) and base_noise (n * B, 45), the global batch's,
        alike on every rank."""
        b = image.shape[0]
        n = base_noise.shape[0] // b
        mine = self.sampler.call(mesh_lib.shard_batch(self.mesh, image),
                                 mesh_lib.shard_rows(self.mesh, base_noise, n, b, hypo=False))
        group = self.mesh.group(mesh_lib.DATA_AXIS)
        return {k: mesh_lib.all_gather(v, group, dim=1) for k, v in mine.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out", help="artifact path (.pt2)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--quantize", action="store_true",
                   help="bake the int8 W8A8 encoder into the artifact "
                        "(calibrates on random images here; pass real "
                        "calibration data via the library API). The "
                        "baked backbone ignores a later state dict — "
                        "combine with --pth for a deployable artifact.")
    p.add_argument("--pth", default=None,
                   help="the reference's .pth checkpoint ({'encoderRGB': state_dict}) to "
                        "export instead of fresh-init weights")
    p.add_argument("--mano", default="./mano/",
                   help="MANO asset dir; a deployable export needs the "
                        "real MANO_RIGHT.pkl (falls back to the synthetic "
                        "fixture model with a warning)")
    p.add_argument("--device", default="cuda",
                   help="the device to export for (the card by default)")
    args = p.parse_args(argv)

    from mhentropy_tpu_torch import serve
    from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
    from mhentropy_tpu_torch.models import quant
    from mhentropy_tpu_torch.models.encoder import EncoderConfig
    from mhentropy_tpu_torch.train import engine

    dev = engine.resolve_device(args.device)
    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone=args.backbone, n_latent=(512, 512)),
        flow=RealNVPConfig(dim=45, cond_dim=512, h_dim=512, num_steps=6),
        feat_dim=512,
        image_size=args.image_size,
    )
    # The MANO model bakes into the artifact as constants — a deployable
    # export must use the real assets, not the synthetic fixture.
    model = engine.load_mano_model(args.mano, device=dev)
    if not mano.find_mano_assets(args.mano):
        print(f"WARNING: no MANO assets under {args.mano} — baking the "
              "SYNTHETIC fixture model; decoded xyz/uv/verts are only "
              "meaningful against the same fixture (pass --mano)",
              file=sys.stderr)
    net = mhent.init(cfg, seed=0)
    if args.pth:
        serve.InferenceServer._restore(net, args.pth)
    net = mhent.prepare(net, dev)
    quant_arg = None
    if args.quantize:
        if not args.pth:
            print("WARNING: --quantize without --pth bakes a FRESH-INIT "
                  "int8 backbone into the artifact; a later state dict "
                  "cannot replace it (SampleFn docstring)",
                  file=sys.stderr)
        print("WARNING: --quantize calibrates activation scales on random "
              "uniform images; for a deployable artifact calibrate on real "
              "batches via quant.quantize_encoder and the library API",
              file=sys.stderr)
        g = torch.Generator(device=dev).manual_seed(3)
        calib = torch.rand((args.batch, args.image_size, args.image_size, 3), generator=g,
                           device=dev) * 2 - 1
        with torch.no_grad():
            spec, qtree = quant.quantize_encoder(net.feat_extractor, calib)
            if quant.sampler_supported(cfg):
                # As the server's int8 buckets: the int8 sampler rides the
                # same qtree.
                spec, qtree = quant.quantize_sampler_into(spec, qtree, net, calib,
                                                          temp=max(1.0, args.temp))
        quant_arg = (spec, qtree)
    blob = export_sampler(model, net, args.batch, n=args.n, temp=args.temp, quant=quant_arg)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(json.dumps({
        "path": args.out,
        "bytes": len(blob),
        "platform": dev.type,
        "batch": args.batch,
        "n": args.n,
    }))


if __name__ == "__main__":
    main()
