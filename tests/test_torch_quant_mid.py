"""The opt-in int8 encoder path, `QuantSpec(int8_stem=True, pallas_mid=True)`
at q_from = 1, against the JAX package's on a resnet50 at 256 px, B = 1,
with weights carried by `convert` (f32 compute).

The JAX side computes what it computes on its chip: the backend clause of
the `stem_int8` and `stage2_int8` gates is dropped, `stem_forward_q` is its
XLA reference (as tests/test_quant.py substitutes it; the kernel takes
about 30 s to interpret) and `stage_forward_q` runs in Pallas interpret
mode. The port runs the same dispatch on the CPU: the int8 stem's and the
stage kernel's plain versions.

* calibrate: the stem's per-channel amax exactly (the same max of the same
  image), every other amax within rel 1e-4 (f32 sums in another order).
* prepare on the JAX amaxes: the stem site's int8 weights exactly and its
  scales within rel 1e-6.
* encoder_feat on the JAX qtree carried by `convert.qtree_from_jax`: the
  integer products are exact, but stage 1 is float and sums in another
  order, so a value within an ulp of a rounding boundary may requantise to
  the neighbouring integer, and through the ten int8 bottlenecks of stages
  2 and 3 at 64 x 64 such flips spread. With both switches off the port and
  JAX differ by 3.7e-3 of the features' range on these inputs (and by
  2.6e-3 with them on), so the features are held to 1e-2 of their range
  and a cosine above 0.9999.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import encoder as jencoder
from mhentropy_tpu.models import quant as jquant
from mhentropy_tpu.models import stage2_int8 as jstage2_int8
from mhentropy_tpu.models import stem_int8 as jstem_int8
from mhentropy_tpu_torch.convert import _resnet, qtree_from_jax
from mhentropy_tpu_torch.models import quant, stage2_int8_cuda, stem_int8_cuda
from mhentropy_tpu_torch.models.encoder import Encoder, EncoderConfig
from tests import torch_dist
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

IMG = 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_backend(gate):
    def ungated(*args, **kwargs):
        with mock.patch.object(jax, "default_backend", lambda: "tpu"):
            return gate(*args, **kwargs)
    return ungated


@pytest.fixture
def jax_on_chip(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jstem_int8, "supported", _no_backend(jstem_int8.supported))
    monkeypatch.setattr(jstage2_int8, "supported", _no_backend(jstage2_int8.supported))
    used = {"stem": 0, "stage": []}

    def stem_xla(image, site, compute_dtype=jnp.bfloat16, out_dtype=jnp.bfloat16):
        used["stem"] += 1
        return jstem_int8.xla_reference(image, site, out_dtype=out_dtype)

    orig_stage = jstage2_int8.stage_forward_q

    def stage(x, sites, stage=2, **kw):
        used["stage"].append(stage)
        return orig_stage(x, sites, stage=stage, **kw)

    monkeypatch.setattr(jstem_int8, "stem_forward_q", stem_xla)
    monkeypatch.setattr(jstage2_int8, "stage_forward_q", stage)
    return used


@pytest.fixture(scope="module")
def carried():
    cfg = jencoder.EncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32")
    params, stats = jencoder.init(jax.random.key(0), cfg, image_size=IMG)
    stats = jax.tree.map(lambda v: np.asarray(v + 0.03), stats)
    params = jax.tree.map(np.asarray, params)
    x = np.array(jax.random.normal(jax.random.key(1), (1, IMG, IMG, 3)))
    enc = Encoder(EncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32"))
    sd = {}
    _resnet(sd, "", params["backbone"], stats)
    enc.res.load_state_dict(sd, strict=True)
    for head in ("l1", "l2"):
        getattr(enc, head)[0].weight.data = torch.from_numpy(params[head]["w"].T.copy())
        getattr(enc, head)[0].bias.data = torch.from_numpy(params[head]["b"].copy())
    return params, stats, x, enc.eval()


def _specs():
    kw = {"backbone": "resnet50", "q_from": 1, "dtype": "float32", "int8_stem": True,
          "pallas_mid": True}
    return jquant.QuantSpec(**kw), quant.QuantSpec(**kw)


def test_int8_stem_and_mid_kernels_match_jax(carried, jax_on_chip, monkeypatch):
    params, stats, x, enc = carried
    jspec, spec = _specs()
    act = jquant.calibrate(jspec, params["backbone"], stats, jnp.asarray(x))
    with torch.no_grad():
        got_act = quant.calibrate(spec, enc.res, torch.from_numpy(x))
    assert set(got_act) == set(act) and act["stem/conv1"].shape == (3,)
    np.testing.assert_array_equal(got_act["stem/conv1"].numpy(), np.asarray(act["stem/conv1"]))
    for k, v in act.items():
        np.testing.assert_allclose(np.asarray(got_act[k]), np.asarray(v), rtol=1e-4, err_msg=k)

    jqt = jax.tree.map(np.asarray, jquant.prepare(jspec, params["backbone"], stats, act))
    mine = quant.prepare(spec, enc.res, {k: torch.tensor(np.asarray(v)) for k, v in act.items()})
    site, jsite = mine["sites"]["stem/conv1"], jqt["sites"]["stem/conv1"]
    np.testing.assert_array_equal(site["w8"].numpy(), jsite["w8"])
    for name in ("inv_a", "scale", "bias"):
        np.testing.assert_allclose(site[name].numpy(), jsite[name], rtol=1e-6, atol=0,
                                   err_msg=name)

    ref = np.asarray(jquant.encoder_feat(jspec, jqt, params, jnp.asarray(x)))
    assert jax_on_chip == {"stem": 1, "stage": [2, 3]}

    qt = qtree_from_jax(spec, jqt)
    stem = qt["sites"]["stem/conv1"]
    assert set(stem) == {"w8", "inv_a", "scale", "bias"} and stem["w8"].dtype == torch.int8
    assert stem["inv_a"].shape == (3,) and {"stem", "stage2", "stage3"} <= set(qt)
    assert "stage1" not in qt and len(qt["stage2"]) == 4 and len(qt["stage3"]) == 6
    calls = {"stem": 0, "stage": 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(stem_int8_cuda, "stem_plain", counted("stem", stem_int8_cuda.stem_plain))
    monkeypatch.setattr(stage2_int8_cuda, "stage_plain",
                        counted("stage", stage2_int8_cuda.stage_plain))
    with torch.no_grad():
        got = quant.encoder_feat(spec, qt, enc, torch.from_numpy(x)).numpy()
    assert calls == {"stem": 1, "stage": 2}
    assert got.shape == ref.shape == (1, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    cos = float((got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.9999, cos


def test_gates_keep_the_walk_where_the_jax_package_does():
    """Off the kernels' geometry (64 px: stage 2 sees 16 x 16) the spec's
    switches change nothing: the float stem and the `_int_mm` walk run."""
    res = Encoder(EncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32")).res
    res.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32))
    spec = quant.QuantSpec(backbone="resnet50", q_from=1, dtype="float32", int8_stem=True,
                           pallas_mid=True)
    with torch.no_grad():
        qt = quant.prepare(spec, res, quant.calibrate(spec, res, x))
        plain = quant.QuantSpec(backbone="resnet50", q_from=1, dtype="float32")
        assert {"stem", "stage2", "stage3"} <= set(qt)
        torch.testing.assert_close(quant.backbone_forward(spec, qt, x),
                                   quant.backbone_forward(plain, qt, x), rtol=0, atol=0)


@pytest.mark.parametrize("mode,error", [("s8", NotImplementedError),
                                        ("fused", NotImplementedError),
                                        ("true", ValueError), ("mid", ValueError)])
def test_pallas_mid_modes_that_raise(mode, error):
    spec = quant.QuantSpec(backbone="resnet50", pallas_mid=mode)
    with pytest.raises(error, match="Not to port" if error is NotImplementedError else "got"):
        quant.prepare(spec, None, {})
    with pytest.raises(error):
        quant.finish({"sites": {}}, spec)


def test_bench_quant_runs_on_the_cpu():
    """The JAX tool's argv, at a tiny geometry: one JSON line per side."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(torch_dist.TEST_THREADS))
    proc = subprocess.run(
        [sys.executable, "-m", "mhentropy_tpu_torch.bench_quant", "4", "1", "1", "1", "mid",
         "--device", "cpu", "--tiny"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [line["metric"].split(",")[1].split()[0] for line in lines] == \
        ["bf16", "int8", "int8_mid"]
    for line in lines:
        assert line["unit"] == "hypotheses/s" and line["value"] > 0 and line["windows"] == 3
        assert line["device"] == "cpu" and len(line["ms_min_max"]) == 2
