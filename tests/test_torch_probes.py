"""The port's probe functions (stem_probe, stem_cost_attrib, stage1_probe)
against the JAX package's TPU probes, run in Pallas interpret mode on the
CPU, on the same numpy inputs.

Tolerances:

* the stem's rolls and im2col cuts sum bf16 values in the same order on both
  sides: equal;
* the gemm cut and the envelope are f32 sums in another order: within 1e-5
  of the largest output;
* the full cut rounds its pooled maxima to bf16 after f32 sums in another
  order, which can move a rounding by one bf16 ulp: within 2^-7 (two bf16
  ulps) of the largest output;
* stage 1 rounds h1, h2 and each block's output to bf16 after f32 sums in
  another order, so a value near a boundary can land one bf16 ulp away and
  move what follows: within 2^-6 of the largest output.

The JAX stem probe loops over 128 conv rows and B is fixed; it does not
interpret at any size on the CPU, so the envelope is held to the gemm cut
and to a numpy einsum of its definition instead. The JAX cost-attribution
body runs with its conv rows cut to 8 (NLANES 1024) and B = 1, and the
stage-1 variants at B = 1, through `monkeypatch`.
"""

import json

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import stem_pallas
from mhentropy_tpu_torch import stage1_probe, stem_cost_attrib, stem_probe
from tools import stage1_probe as jstage1_probe
from tools import stem_cost_attrib as jstem_cost_attrib
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

ROWS = stem_probe.ROWS


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _bf16(a):
    """numpy f32 -> (the bf16-rounded f32 array, the jnp bf16 array, the torch bf16 tensor)."""
    r = np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)
    return r.astype(np.float32), jnp.asarray(r), torch.from_numpy(r.astype(np.float32)).to(
        torch.bfloat16)


def _stem_operands(b, seed=0):
    rng = np.random.RandomState(seed)
    planes = rng.randn(b, 6, ROWS, 128).astype(np.float32)
    a = rng.randn(1, 64, 152).astype(np.float32)
    a[..., 147:] = 0
    g = (0.5 + rng.rand(1, 64, 128)).astype(np.float32)
    bb = (0.1 * rng.randn(1, 64, 128)).astype(np.float32)
    s = rng.randn(1, 64, 128).astype(np.float32)
    return planes, a, g, bb, s


def test_specs_are_the_jax_stems():
    assert stem_probe._SPECS == stem_pallas._SPECS


@pytest.mark.parametrize("phase", stem_probe.PHASES)
def test_stem_cut_matches_jax(interpret, monkeypatch, phase):
    rows = 8
    monkeypatch.setattr(jstem_cost_attrib, "B", 1)
    monkeypatch.setattr(jstem_cost_attrib, "CONV_ROWS", rows)
    monkeypatch.setattr(jstem_cost_attrib, "NLANES", rows * 128)
    planes, a, g, bb, s = _stem_operands(1, seed=1)
    _, jplanes, tplanes = _bf16(planes)
    _, ja, ta = _bf16(a)
    _, js, ts = _bf16(s)
    ref = np.asarray(jstem_cost_attrib.make_step(phase)(jplanes, ja, jnp.asarray(g),
                                                        jnp.asarray(bb), js))
    got = stem_cost_attrib.attrib_forward(tplanes, ta, torch.from_numpy(g), torch.from_numpy(bb),
                                          ts, phase, conv_rows=rows).numpy()
    assert got.shape == ref.shape == (1, 64, 128)
    tol = stem_cost_attrib.tolerance(phase, torch.from_numpy(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    if phase in ("rolls", "im2col"):
        np.testing.assert_array_equal(got, ref)
    assert np.abs(ref).max() > 0


def test_stem_envelope_matches_its_definition():
    """The envelope at its full 128 conv rows and B = 1, against a numpy
    einsum of the definition in float64, and against the gemm cut on the
    same values as bf16 planes."""
    planes, a, *_ = _stem_operands(1, seed=2)
    got = stem_probe.stem_probe(torch.from_numpy(planes), torch.from_numpy(a).to(torch.bfloat16))
    pr = planes.astype(ml_dtypes.bfloat16).astype(np.float64)
    ar = a.astype(ml_dtypes.bfloat16).astype(np.float64)
    r = np.zeros((21, ROWS, 128))
    for t, (plane, shift) in enumerate(stem_probe._SPECS):
        for j in range(128):
            if 0 <= j - shift < 128:
                r[t, :, j] = pr[0, plane, :, j - shift]
    bm = np.zeros((152, 128, 128))  # (7 t + k, i, j)
    for t in range(21):
        for k in range(7):
            bm[7 * t + k] = r[t, 1 + k:1 + k + 256:2]
    want = np.einsum("fk,kij->fj", ar[0], bm)
    assert got.shape == (1, 64, 128)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    rounded = torch.from_numpy(pr.astype(np.float32))
    cut = stem_cost_attrib.attrib_forward(rounded.to(torch.bfloat16),
                                          torch.from_numpy(a).to(torch.bfloat16), None, None,
                                          None, "gemm")
    np.testing.assert_array_equal(cut.numpy(),
                                  stem_probe.stem_probe(rounded, torch.from_numpy(a).to(
                                      torch.bfloat16)).numpy())


def test_stem_probe_refusals():
    planes, a, *_ = _stem_operands(1)
    tp, ta = torch.from_numpy(planes), torch.from_numpy(a).to(torch.bfloat16)
    with pytest.raises(ValueError, match="f32 planes"):
        stem_probe.stem_probe(tp.to(torch.bfloat16), ta)
    with pytest.raises(ValueError, match="bf16 planes"):
        stem_cost_attrib.attrib_forward(tp, ta, None, None, None, "rolls")
    with pytest.raises(ValueError, match="phase"):
        stem_probe.probe_forward(tp, ta, phase="epilogue")


@pytest.mark.parametrize("b,rows,sms", [(32, 128, 132), (32, 64, 132), (3, 48, 132),
                                         (48, 48, 132), (2, 64, 132), (1, 128, 132),
                                         (64, 128, 132), (8, 96, 16)])
def test_stem_band_plan_is_the_cheapest_wave_count(b, rows, sms):
    """The kernel's band: a multiple of 16 within the conv rows whose waves x
    (band + BAND_OVERHEAD) is least (ties: the larger band); one wave of 128
    blocks at the probe's B = 32 and 128 conv rows on the H100's 132 SMs,
    half the rows a block at half the conv rows; the card tests' band edges:
    bands of 16 at B = 2 and 3, of 32 (the second ragged) at B = 48, 48 rows."""
    band = stem_probe.plan_band(b, rows, sms)
    assert band % stem_probe.ROW_MULTIPLE == 0 and 0 < band <= rows

    def cost(x):
        return -(-b * -(-rows // x) // sms) * (x + stem_probe.BAND_OVERHEAD)

    others = range(stem_probe.ROW_MULTIPLE, rows + 1, stem_probe.ROW_MULTIPLE)
    assert all(cost(band) < cost(x) or (cost(band) == cost(x) and band >= x) for x in others)
    if (b, rows, sms) == (32, 128, 132):
        assert band == 32
    if (b, rows, sms) in ((32, 64, 132), (3, 48, 132), (2, 64, 132)):
        assert band == 16
    if (b, rows, sms) == (48, 48, 132):
        assert band == 32


def _stage1_operands(seed=3):
    rng = np.random.RandomState(seed)
    x = (rng.randn(1, 4096, 64) * 0.1).astype(np.float32)
    return x, {k: (rng.randn(*s) * 0.05).astype(np.float32)
               for k, s in stage1_probe.SHAPES.items()}


def _jax_variant(monkeypatch, make, x, ws):
    monkeypatch.setattr(jstage1_probe, "B", 1)
    step, _ = make()
    args = [_bf16(x)[1]] + [_bf16(ws[k])[1] for k in stage1_probe.NAMES]
    return np.asarray(step(*args).astype(jnp.float32))


def _within(got, ref):
    tol = stage1_probe.tolerance(torch.from_numpy(ref))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= tol, (err, tol)


def test_stage1_variant_a_matches_jax(interpret, monkeypatch):
    x, ws = _stage1_operands()
    ref = _jax_variant(monkeypatch, jstage1_probe._probe_variant_a, x, ws)
    got = stage1_probe.forward_a(_bf16(x)[2], {k: _bf16(v)[2] for k, v in ws.items()})
    assert got.shape == ref.shape == (1, 4096, 256) and got.dtype == torch.bfloat16
    _within(got, ref)


def test_stage1_variant_b_matches_jax(interpret, monkeypatch):
    x, ws = _stage1_operands(seed=4)
    xb = np.ascontiguousarray(x.transpose(0, 2, 1))
    wsb = {k: np.ascontiguousarray(np.swapaxes(v, -1, -2)) for k, v in ws.items()}
    ref = _jax_variant(monkeypatch, jstage1_probe._probe_variant_b, xb, wsb)
    got = stage1_probe.forward_b(_bf16(xb)[2], {k: _bf16(v)[2] for k, v in wsb.items()})
    assert got.shape == ref.shape == (1, 256, 4096)
    _within(got, ref)


@pytest.mark.parametrize("hw", [(64, 64), (16, 16)])
def test_stage1_variant_b_is_a_transposed(hw):
    h, w = hw
    wa = stage1_probe.weights_a(seed=5)
    xa = stage1_probe.input_a(2, seed=6, hw=h * w)
    a = stage1_probe.forward_a(xa, wa, h, w)
    b = stage1_probe.forward_b(xa.transpose(1, 2).contiguous(), stage1_probe.to_b(wa), h, w)
    assert a.shape == (2, h * w, 256) and b.shape == (2, 256, h * w)
    _within(b.transpose(1, 2), a.float().numpy())
    assert float(a.float().abs().max()) > 0


def test_stage1_probe_flops_is_the_jax_count():
    from mhentropy_tpu.models import stage1_pallas

    assert stage1_probe.flops(32) == stage1_pallas.flops(32, 64, 64)


@pytest.mark.parametrize("module,lines", [(stem_probe, 1), (stem_cost_attrib, 8),
                                          (stage1_probe, 2)])
def test_probe_cli_checks_on_the_cpu(module, lines, capsys):
    """`check` at B = 1 on the CPU: one JSON line a side, each error within
    its tolerance, no timings (they come from the card only)."""
    out = module.main(["check", "--device", "cpu", "--batch", "1"])
    printed = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert out["ok"] and len(printed) == len(out["lines"]) == lines
    for line in printed:
        assert line["device"] == "cpu" and line["max_abs_err"] <= line["tol"]
        assert "ms" not in line and "graph_ms" not in line
