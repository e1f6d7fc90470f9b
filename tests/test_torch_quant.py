"""The port's W8A8 encoder quantisation against the JAX package's
(models/quant.py), on carried weights (resnet50, 64 px, f32 compute).

* calibrate: the amaxes of two f32 float forwards through 50 layers, which
  differ in summation order only: rel 1e-4.
* prepare on the same amaxes: the int8 weights exactly, the scales within
  rel 1e-6 (the same f32 ops).
* encoder_feat with q_from = 1 on the same qtree: the int8 convolutions are
  exact, but their inputs come from f32 stages that differ in summation
  order, and a value within an ulp of a rounding boundary may land on the
  neighbouring integer. Such flips are rare and each moves one activation
  by one quantisation step: the features agree within 1e-3 of their range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.models import encoder as jencoder
from mhentropy_tpu.models import quant as jquant
from mhentropy_tpu_torch.convert import _resnet, qtree_from_jax
from mhentropy_tpu_torch.models import quant
from mhentropy_tpu_torch.models.encoder import Encoder, EncoderConfig
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

IMG = 64


@pytest.fixture(scope="module")
def carried():
    cfg = jencoder.EncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32")
    params, stats = jencoder.init(jax.random.key(0), cfg, image_size=IMG)
    stats = jax.tree.map(lambda v: np.asarray(v + 0.03), stats)
    params = jax.tree.map(np.asarray, params)
    x = np.array(jax.random.normal(jax.random.key(1), (2, IMG, IMG, 3)))
    enc = Encoder(EncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32"))
    sd = {}
    _resnet(sd, "", params["backbone"], stats)
    enc.res.load_state_dict(sd, strict=True)
    for head in ("l1", "l2"):
        getattr(enc, head)[0].weight.data = torch.from_numpy(params[head]["w"].T.copy())
        getattr(enc, head)[0].bias.data = torch.from_numpy(params[head]["b"].copy())
    return params, stats, x, enc.eval()


def test_calibrate_and_prepare_match_jax(carried):
    params, stats, x, enc = carried
    jspec = jquant.QuantSpec(backbone="resnet50", q_from=0, dtype="float32")
    act = jquant.calibrate(jspec, params["backbone"], stats, jnp.asarray(x))
    jqt = jquant.prepare(jspec, params["backbone"], stats, act)
    spec = quant.QuantSpec(backbone="resnet50", q_from=0, dtype="float32")
    with torch.no_grad():
        got = quant.calibrate(spec, enc.res, torch.from_numpy(x))
    assert set(got) == set(act) and len(got) == 3 * 16 + 4
    for k, v in act.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)

    qt = quant.prepare(spec, enc.res, {k: torch.as_tensor(np.asarray(v)) for k, v in act.items()})
    assert set(qt["sites"]) == set(jqt["sites"]) and "stage1" in qt
    for key, site in jqt["sites"].items():
        mine = qt["sites"][key]
        np.testing.assert_array_equal(mine["w8"].numpy(), np.asarray(site["w8"]), err_msg=key)
        for name in ("inv_sa", "scale", "bias"):
            np.testing.assert_allclose(mine[name].numpy(), np.asarray(site[name]),
                                       rtol=1e-6, atol=0, err_msg=f"{key}/{name}")


def test_encoder_feat_q_from_1_matches_jax(carried):
    params, stats, x, enc = carried
    jspec = jquant.QuantSpec(backbone="resnet50", q_from=1, dtype="float32")
    act = jquant.calibrate(jspec, params["backbone"], stats, jnp.asarray(x))
    jqt = jax.tree.map(np.asarray, jquant.prepare(jspec, params["backbone"], stats, act))
    ref = np.asarray(jquant.encoder_feat(jspec, jqt, params, jnp.asarray(x)))
    spec = quant.QuantSpec(backbone="resnet50", q_from=1, dtype="float32")
    qt = qtree_from_jax(spec, jqt)
    assert "stage1" not in qt and set(qt["sites"]) == set(jqt["sites"])
    with torch.no_grad():
        got = quant.encoder_feat(spec, qt, enc, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


def test_q_from_policy_and_unported_options():
    # "auto" quantises stage 1 exactly when the int8 stage-1 kernel runs: a
    # resnet50 on the card. Explicit stages pass through, strings included.
    assert quant.resolve_q_from("auto", "resnet50", (8, 256, 256, 3), "cuda") == 0
    assert quant.resolve_q_from("auto", "resnet50", (8, 256, 256, 3), "cpu") == 1
    assert quant.resolve_q_from("auto", "resnet18", (8, 256, 256, 3), "cuda") == 1
    assert quant.resolve_q_from("0", "resnet50", (8, 256, 256, 3), "cpu") == 0
    assert quant.resolve_q_from(2, "resnet50", (8, 256, 256, 3), "cuda") == 2
    # pallas_mid's s8 handoffs need the int8 stage-1 kernel's s8 emits, which
    # are not ported; True and int8_stem run (tests/test_torch_quant_mid.py).
    for mode in ("s8", "fused"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            quant.prepare(quant.QuantSpec(pallas_mid=mode), None, {})


@pytest.mark.parametrize("px", [64, 224, 256])
def test_q_from_auto_follows_the_jax_geometry_gate(monkeypatch, px):
    """"auto" resolves as the JAX policy does at each image size, the JAX
    gate's backend clause patched to the TPU's and the port's device CUDA:
    64 px (a 16 x 16 post-stem map, below hw 3136) keeps stage 1 float,
    224 and 256 px quantise it."""
    from mhentropy_tpu.models import stage1_int8 as jstage1_int8

    gate = jstage1_int8.supported

    def on_tpu(*args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(jax, "default_backend", lambda: "tpu")
            return gate(*args, **kwargs)

    monkeypatch.setattr(jstage1_int8, "supported", on_tpu)
    shape = (8, px, px, 3)
    want = jquant.resolve_q_from("auto", "resnet50", shape)
    assert want == (1 if px == 64 else 0)
    assert quant.resolve_q_from("auto", "resnet50", shape, "cuda") == want
    assert quant.resolve_q_from("auto", "resnet50", shape, "cpu") == 1


def test_int_conv_is_an_exact_integer_sum():
    """The CPU route: an f64 convolution of int8 tensors, equal to the
    integer sum (here checked against an int64 im2col product)."""
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (2, 9, 7, 16), generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (3, 3, 16, 24), generator=g, dtype=torch.int8)
    got = quant._int_conv(xq, w8, 2, 1)
    cols = quant._im2col(xq, 3, 2, 1)
    want = cols.long().reshape(-1, 144) @ w8.long().reshape(144, 24)
    assert got.shape == (2, 5, 4, 24)
    torch.testing.assert_close(got.reshape(-1, 24), want.float(), rtol=0, atol=0)
