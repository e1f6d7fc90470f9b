"""The port's serving export (mhentropy_tpu_torch/export.py) against the live
port and against tools/export.py, and the kernels' operators.

At a small size (resnet18 at 64 px, RealNVP 2 x 32, f32, B = 2, N = 4):
the artifact after `torch.export.save` / `load` equals the live port
bitwise, float and int8, with verts; on weights carried from JAX
(`convert.from_jax`, `convert.qtree_from_jax`) and JAX's base noise
(jax.random.normal(key, (N * B, 45)) * temp) it matches JAX's live
`make_sample_fn` at tests/test_torch_slice.py's tolerances (xyz 1e-4, uv
2e-2 px) and JAX's deserialised artifact at tests/test_export.py's (rtol
1e-2, atol 0.05). A state dict loaded into the artifact serves those
weights; a fresh process that imports only the export module loads and
calls an artifact; the CLI prints tools/export.py's JSON keys. Each of the
nine operators passes `torch.library.opcheck` on the CPU, and each public
wrapper there equals its plain version exactly.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models import quant as jquant
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu_torch import export, ops
from mhentropy_tpu_torch.convert import from_jax, qtree_from_jax
from mhentropy_tpu_torch.core import lbs_cuda, mano
from mhentropy_tpu_torch.flows import cuda_glow_sampler, cuda_sampler, cuda_sampler_int8, glow
from mhentropy_tpu_torch.flows import realnvp
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import (mhent, quant, resnet, stage1_cuda, stage1_int8_cuda,
                                        stage2_int8_cuda, stem_cuda, stem_int8_cuda)
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from tools import export as jexport
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

B, N, IMG, TEMP = 2, 4, 64, 0.8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = ("xyz", "uv", "verts")


def _randomise(params, stats, seed):
    """Non-default BN statistics and an O(1) flow (tests/test_torch_slice.py)."""
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(lambda v: (rng.rand(*v.shape) * 0.5 + 0.75).astype(np.float32)
                         if v.ndim else v, stats)
    flow = params["flow"]
    fields = {}
    for name, v in flow._asdict().items():
        if hasattr(v, "shape") and name != "masks":
            fan_in = v.shape[-2] if v.ndim == 3 else v.shape[-1]
            fields[name] = (rng.uniform(-1, 1, v.shape) / np.sqrt(fan_in)).astype(np.float32)
    params = dict(params, flow=flow._replace(**fields))
    return jax.tree.map(np.asarray, params), stats


def _cfg():
    return mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(32, 32), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2),
        feat_dim=32, image_size=IMG)


@pytest.fixture(scope="module")
def setup():
    jcfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(32, 32), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2),
        feat_dim=32, image_size=IMG)
    # Jitted, the init compiles once instead of op by op (the same values).
    params, stats = jax.jit(lambda k: jmhent.init(k, jcfg))(jax.random.key(0))
    params, stats = _randomise(params, stats, 1)
    net = mhent.MHEnt(_cfg())
    net.load_state_dict(from_jax(params, stats), strict=True)
    image = np.random.RandomState(2).uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    key = jax.random.key(3)
    noise = np.array(jax.random.normal(key, (N * B, 45)) * TEMP)
    return {"jcfg": jcfg, "params": params, "stats": stats, "jmodel": jmano.synthetic_mano_model(0),
            "net": mhent.prepare(net, "cpu"), "model": mano.synthetic_mano_model(0),
            "image": image, "key": key, "noise": noise}


def _jax_quant(setup):
    """JAX's int8 encoder (q_from 1) and int8 sampler calibrated on the
    image, and the port's (spec, qtree) carried from them."""
    jcfg, params, stats, image = setup["jcfg"], setup["params"], setup["stats"], setup["image"]
    jspec = jquant.QuantSpec(backbone="resnet18", q_from=1, dtype="float32", int8_sampler=True)
    act = jquant.calibrate(jspec, params["encoder"]["backbone"], stats, jnp.asarray(image))
    jqt = jquant.prepare(jspec, params["encoder"]["backbone"], stats, act)
    jq = jquant.quantize_sampler_into(jspec, jqt, params, jcfg.flow, jnp.asarray(image),
                                      temp=TEMP)
    spec = quant.QuantSpec(backbone="resnet18", q_from=1, dtype="float32", int8_sampler=True)
    return jq, (spec, qtree_from_jax(spec, jax.tree.map(np.asarray, jq[1])))


@pytest.fixture(scope="module")
def artifacts(setup):
    """{"float" | "int8": (JAX quant or None, port quant or None, the port's
    artifact with verts, that artifact loaded)}."""
    out = {}
    for kind in ("float", "int8"):
        jq, qarg = _jax_quant(setup) if kind == "int8" else (None, None)
        blob = export.export_sampler(setup["model"], setup["net"], B, n=N, temp=TEMP, mods=MODS,
                                     quant=qarg)
        out[kind] = (jq, qarg, blob, export.load_sampler(blob))
    return out


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_artifact_roundtrip_is_the_live_port_bitwise(setup, artifacts, kind):
    net, model = setup["net"], setup["model"]
    image, noise = torch.from_numpy(setup["image"]), torch.from_numpy(setup["noise"])
    _, qarg, _, sampler = artifacts[kind]
    with torch.no_grad():
        live = export.make_sample_fn(model, net, N, TEMP, MODS, quant=qarg)(image, noise)
        ref = mhent.sample_hypotheses(model, net, image, n=N, temp=TEMP, mods=MODS,
                                      base_noise=noise, fold=mano.fold_keypoints(model),
                                      quant=qarg)
    assert sampler.device == "cpu"
    served = sampler.call(image, noise)
    assert set(served) == set(MODS)
    for m in MODS:
        assert served[m].shape == (N, B, {"xyz": 63, "uv": 42, "verts": 2334}[m])
        assert torch.equal(served[m], live[m]) and torch.equal(live[m], ref[m]), m
    with pytest.raises(ValueError, match="exported for cpu"):
        sampler.call(image.to("meta"), noise)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_served_port_matches_jax_live_and_served(setup, artifacts, kind):
    """The port's artifact on weights (and a qtree) carried from JAX, with
    the base noise JAX draws from the key, against JAX's live sampler and
    JAX's deserialised artifact."""
    jcfg, params, stats = setup["jcfg"], setup["params"], setup["stats"]
    image, key = setup["image"], setup["key"]
    jq, _, _, sampler = artifacts[kind]
    raw_key = jax.random.key_data(key).astype(jnp.uint32)
    live = jexport.make_sample_fn(setup["jmodel"], jcfg, N, TEMP, quant=jq)(
        params, stats, jnp.asarray(image), raw_key)
    jblob = jexport.export_sampler(setup["jmodel"], jcfg, params, stats, B, n=N, temp=TEMP,
                                   quant=jq)
    jserved = jexport.load_sampler(jblob).call(params, stats, jnp.asarray(image), raw_key)
    got = sampler.call(torch.from_numpy(image), torch.from_numpy(setup["noise"]))
    np.testing.assert_allclose(got["xyz"].numpy(), np.asarray(live["xyz"]), atol=1e-4)
    np.testing.assert_allclose(got["uv"].numpy(), np.asarray(live["uv"]), atol=2e-2)
    np.testing.assert_allclose(got["xyz"].numpy(), np.asarray(jserved["xyz"]), rtol=1e-2,
                               atol=0.05)


def test_load_state_dict_serves_those_weights(setup, artifacts):
    """The call-time-weights contract: another seed's state dict loaded into
    the artifact equals the live port with that seed's weights."""
    model = setup["model"]
    image, noise = torch.from_numpy(setup["image"]), torch.from_numpy(setup["noise"])
    sampler = export.load_sampler(artifacts["float"][2])
    other = mhent.init(_cfg(), seed=7)
    sampler.load_state_dict(other.state_dict())
    other = mhent.prepare(other, "cpu")
    with torch.no_grad():
        want = export.make_sample_fn(model, other, N, TEMP, MODS)(image, noise)
        before = export.make_sample_fn(model, setup["net"], N, TEMP, MODS)(image, noise)
    got = sampler.call(image, noise)
    for m in MODS:
        assert torch.equal(got[m], want[m]), m
        assert not torch.equal(got[m], before[m]), m
    program_kernel = {k[len("kernel."):]: v for k, v in sampler.module.state_dict().items()
                      if k.startswith("kernel.")}
    mine = export.kernel_weights(other)
    assert program_kernel.keys() == mine.keys()
    assert all(torch.equal(program_kernel[k], mine[k]) for k in mine)


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    """The CLI on the CPU with --quantize (the port's own int8 calibration)."""
    out = tmp_path_factory.mktemp("cli") / "cli.pt2"
    proc = subprocess.run(
        [sys.executable, "-m", "mhentropy_tpu_torch.export", str(out), "--device", "cpu",
         "--backbone", "resnet18", "--image-size", str(IMG), "--batch", str(B), "--n", str(N),
         "--quantize", "--mano", str(out.parent / "no_mano")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    return out, proc


def test_cli_prints_the_jax_keys(cli_artifact):
    out, proc = cli_artifact
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line == {"path": str(out), "bytes": out.stat().st_size, "platform": "cpu",
                    "batch": B, "n": N}
    for warning in ("SYNTHETIC", "FRESH-INIT", "random uniform images"):
        assert warning in proc.stderr


def test_a_fresh_process_loads_and_calls_an_artifact(cli_artifact):
    """An int8 artifact (the CLI's), loaded where only the export module is
    imported: the kernels' operators come with it, JAX does not."""
    path = cli_artifact[0]
    code = (
        "import sys, torch\n"
        "import mhentropy_tpu_torch.export as ex\n"
        f"s = ex.load_sampler(open({str(path)!r}, 'rb').read())\n"
        f"out = s.call(torch.zeros({B}, {IMG}, {IMG}, 3), torch.zeros({N * B}, 45))\n"
        "print(sorted((k, tuple(v.shape)) for k, v in out.items()))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mhentropy_tpu', 'tools'))\n"
        "sys.exit(1 if bad or not all(bool(v.isfinite().all()) for v in out.values()) else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"('uv', ({N}, {B}, 42)), ('xyz', ({N}, {B}, 63))" in proc.stdout


# Each operator on small CPU inputs: (wrapper call, plain call, op args).

def _rand_bn(bn, g):
    n = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
        bn.bias.copy_(0.1 * torch.randn(n, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(n, generator=g))
        bn.running_var.copy_(1.0 + 0.5 * torch.rand(n, generator=g))


def _resnet50(g):
    res = resnet.resnet50().eval()
    for m in res.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            _rand_bn(m, g)
        elif isinstance(m, torch.nn.Conv2d):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * math.sqrt(2.0 / m.weight[0].numel()))
    return res


def _int8_sites(g):
    res = _resnet50(g)
    spec = quant.QuantSpec(backbone="resnet50", q_from=0, dtype="float32")
    act = quant.calibrate(spec, res, torch.randn(1, 32, 32, 3, generator=g))
    return quant.prepare(spec, res, act)["sites"]


def _case(name):
    g = torch.Generator().manual_seed(11)
    if name == "stem":
        conv = torch.randn(64, 3, 7, 7, generator=g) * math.sqrt(2 / 147)
        bn = torch.nn.BatchNorm2d(64)
        _rand_bn(bn, g)
        w, b = stem_cuda.fold(conv, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        image = torch.randn(2, 33, 31, 3, generator=g)
        return (lambda: stem_cuda.stem_forward(image, w, b),
                lambda: stem_cuda.stem_plain(image, w, b), (image, w, b))
    if name == "stage1":
        folded = stage1_cuda.fold(_resnet50(g).layer1)
        x = torch.randn(1, 9, 17, 64, generator=g)
        return (lambda: stage1_cuda.stage1_forward(x, folded),
                lambda: stage1_cuda.stage1_plain(x, folded), (x, ops.flatten(folded)))
    if name in ("realnvp_sample", "realnvp_sample_q"):
        flow = realnvp.RealNVP(RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2))
        flow.init_params(g)
        feat = torch.randn(2, 32, generator=g)
        z0 = torch.randn(2, 3, 45, generator=g) * 0.8
        with torch.no_grad():
            if name == "realnvp_sample":
                packed = cuda_sampler.pack(flow)
                cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat)).float()
                return (lambda: cuda_sampler.transform(packed, z0, cproj),
                        lambda: cuda_sampler.transform_plain(packed, z0, cproj),
                        (z0, cproj, *packed[:7]))
            tree = cuda_sampler_int8.quantize_sampler(flow, feat, torch.randn(64, 45, generator=g))
            cq = cuda_sampler_int8.cond_q(flow, tree, feat)
        pad = torch.nn.functional.pad(z0, (0, tree.masks.shape[-1] - 45))
        return (lambda: cuda_sampler_int8.transform_q(tree, z0, cq),
                lambda: tuple(t[..., :45] if t.dim() == 3 else t
                              for t in cuda_sampler_int8.xla_forward_q(tree, pad, cq)),
                (z0, cq, *tree.kernel))
    if name == "lbs_blend":
        args = (torch.rand(10, 4, generator=g), torch.randn(3, 3, 4, 5, generator=g),
                torch.randn(3, 4, 5, generator=g), torch.randn(3, 10, 5, generator=g))
        return (lambda: lbs_cuda.lbs_blend(*args), lambda: lbs_cuda.lbs_blend_plain(*args), args)
    if name == "glow_sample":
        flow = glow.ConditionalGlow(glow.GlowConfig(features=45, hidden=64, num_layers=2,
                                                    context_features=32))
        flow.init_params(g)
        with torch.no_grad():
            packed = cuda_glow_sampler.pack(flow)
            ctx = cuda_glow_sampler.pack_context(flow, torch.randn(2, 32, generator=g))
        z0 = torch.randn(2, 3, 45, generator=g)
        return (lambda: cuda_glow_sampler.transform(packed, z0, ctx),
                lambda: cuda_glow_sampler.transform_plain(packed, z0, ctx),
                (z0, ctx, *(getattr(packed, f) for f in cuda_glow_sampler.KERNEL_FIELDS)))
    if name == "stage1_int8":
        packed = stage1_int8_cuda.pack(_int8_sites(g))
        x = torch.randn(1, 8, 8, 64, generator=g).abs()
        return (lambda: stage1_int8_cuda.stage1_forward_q(x, packed),
                lambda: stage1_int8_cuda.stage1_plain(x, packed).to(torch.bfloat16),
                (x, ops.flatten(packed)))
    if name == "stem_int8":
        conv = torch.randn(64, 3, 7, 7, generator=g) * math.sqrt(2 / 147)
        bn = torch.nn.BatchNorm2d(64)
        _rand_bn(bn, g)
        with torch.no_grad():
            bn.weight[::5] *= -1  # negative BN scales: pack's signed rows
        image = torch.randn(1, 16, 24, 3, generator=g)
        site = stem_int8_cuda.prepare_stem_site(conv, bn, image.abs().amax(dim=(0, 1, 2)))
        packed = stem_int8_cuda.pack(site)
        return (lambda: stem_int8_cuda.stem_forward_q(image, packed),
                lambda: stem_int8_cuda.stem_plain(image, site).to(torch.bfloat16),
                (image, packed["wq"], packed["inv_a"], packed["scale"], packed["bias"], True))
    if name == "stage2_int8":
        packed = stage2_int8_cuda.pack(_int8_sites(g), 2)
        x = torch.randn(1, 8, 8, 256, generator=g).abs()
        return (lambda: stage2_int8_cuda.stage_forward_q(x, packed, 2),
                lambda: stage2_int8_cuda.stage_plain(x, packed).to(torch.bfloat16),
                (x, ops.flatten(packed), 2, True))
    raise KeyError(name)


OPS = ["stem", "stage1", "realnvp_sample", "lbs_blend", "stage1_int8", "realnvp_sample_q",
       "glow_sample", "stem_int8", "stage2_int8"]


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    _, _, args = _case(name)
    torch.library.opcheck(getattr(torch.ops.mhent, name).default, args)


@pytest.mark.parametrize("name", OPS)
def test_wrapper_on_cpu_is_the_plain_version(name):
    wrapper, plain, _ = _case(name)
    got, want = wrapper(), plain()
    for a, b in zip(*((t,) if isinstance(t, torch.Tensor) else t for t in (got, want))):
        assert a.dtype == b.dtype and torch.equal(a, b)
