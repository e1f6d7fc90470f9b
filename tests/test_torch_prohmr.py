"""The port's ProHMR (Humans) path against the JAX package's
(models/prohmr.py), on weights moved by `convert.prohmr_from_jax`, at the
JAX test's small geometry (tests/test_smpl_prohmr.py: resnet18 at 32 px,
a two-layer H = 64 flow, f32, the 256-vertex SMPL fixture).

* sample_hypotheses on JAX's own base noise: every output within 1e-4 of
  its range (f32 on both sides, summation order only).
* with the int8 encoder (q_from = 1, the JAX qtree moved by
  `qtree_from_jax`): the int8 convolutions are exact, but their inputs
  come from f32 stage 1 in another summation order, and a value within an
  ulp of a rounding boundary may land on the neighbouring integer; such a
  flip moves one activation by one quantisation step. The outputs agree
  within 2e-3 of their range.
* the plain version of the fused Glow sampler (bf16 weights, as the JAX
  path runs its Pallas kernel when `use_pallas_sampler` is set) against the
  Pallas kernel in interpret mode, num_blocks = 2: within 1e-3 (both round
  the same operands to bf16 and sum in another order).
* multi_hypothesis_metrics, and the eval_prohmr / bench_prohmr entry points
  on the CPU at the small geometry.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import smpl as jsmpl
from mhentropy_tpu.flows.glow import GlowConfig as JGlowConfig
from mhentropy_tpu.models import prohmr as jprohmr
from mhentropy_tpu.models import quant as jquant
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu_torch import bench_prohmr, eval_prohmr
from mhentropy_tpu_torch.convert import prohmr_from_jax, qtree_from_jax
from mhentropy_tpu_torch.core import smpl
from mhentropy_tpu_torch.flows import cuda_glow_sampler
from mhentropy_tpu_torch.flows.glow import GlowConfig
from mhentropy_tpu_torch.models import prohmr, quant
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

B, N, IMG = 2, 4, 32
KEYS = ("pose_6d", "log_q", "verts", "joints3d", "uv", "betas", "cam")


def _configs(num_blocks: int):
    jcfg = jprohmr.ProHMRConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(64, 64), dtype="float32"),
        flow=JGlowConfig(features=144, hidden=64, num_layers=2, num_blocks=num_blocks,
                         context_features=64),
        image_size=IMG)
    cfg = prohmr.ProHMRConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(64, 64), dtype="float32"),
        flow=GlowConfig(features=144, hidden=64, num_layers=2, num_blocks=num_blocks,
                        context_features=64),
        image_size=IMG)
    return jcfg, cfg


@pytest.fixture(scope="module")
def setup():
    """The JAX test's config (one residual block), its params moved to the
    port, the fixture, an image batch and JAX's noise for key 1."""
    jcfg, cfg = _configs(1)
    params, stats = jprohmr.init(jax.random.key(0), jcfg)
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    net = prohmr.ProHMR(cfg)
    net.load_state_dict(prohmr_from_jax(params, stats), strict=True)
    net = prohmr.prepare(net, "cpu")
    image = np.random.RandomState(0).randn(B, IMG, IMG, 3).astype(np.float32)
    key = jax.random.key(1)
    noise = np.array(jax.random.normal(jax.random.split(key)[1], (N * B, 144)))
    return (jcfg, params, stats, jsmpl.synthetic_smpl_model(0, n_verts=256), net,
            smpl.synthetic_smpl_model(0, n_verts=256), image, key, noise)


def _close(got: dict, want: dict, share: float) -> None:
    for k in KEYS:
        ref = np.asarray(want[k])
        assert got[k].shape == ref.shape, k
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=0,
                                   atol=share * max(1.0, np.abs(ref).max()), err_msg=k)


def test_sample_hypotheses_matches_jax(setup):
    jcfg, params, stats, jmodel, net, model, image, key, noise = setup
    ref = jprohmr.sample_hypotheses(jmodel, params, stats, jcfg, jnp.asarray(image), key, n=N)
    with torch.inference_mode():
        got = prohmr.sample_hypotheses(model, net, torch.from_numpy(image), n=N,
                                       noise=torch.from_numpy(noise))
    assert got["verts"].shape == (N, B, 256, 3)
    _close(got, ref, 1e-4)


def test_sample_hypotheses_int8_matches_jax(setup):
    jcfg, params, stats, jmodel, net, model, image, key, noise = setup
    jq = jquant.quantize_encoder(params["encoder"], stats, jcfg.encoder, jnp.asarray(image),
                                 q_from=1)
    ref = jprohmr.sample_hypotheses(jmodel, params, stats, jcfg, jnp.asarray(image), key, n=N,
                                    quant=jq)
    spec = quant.QuantSpec(backbone="resnet18", q_from=1, dtype="float32")
    q = (spec, qtree_from_jax(spec, jax.tree.map(np.asarray, jq[1])))
    with torch.inference_mode():
        got = prohmr.sample_hypotheses(model, net, torch.from_numpy(image), n=N,
                                       noise=torch.from_numpy(noise), quant=q)
        own = prohmr.sample_hypotheses(model, net, torch.from_numpy(image), n=N,
                                       noise=torch.from_numpy(noise),
                                       quant=quant.quantize_encoder(net.encoder,
                                                                    torch.from_numpy(image),
                                                                    q_from=1))
    _close(got, ref, 2e-3)
    # The port's own calibration gives the same int8 encoder.
    for k in KEYS:
        torch.testing.assert_close(own[k], got[k], rtol=0, atol=1e-5)


def test_plain_glow_sampler_on_prohmr_matches_pallas(monkeypatch):
    """num_blocks = 2, the fused sampler's architecture: JAX's
    sample_hypotheses with use_pallas_sampler (bf16 weights, interpret
    mode) against the port's packed plain sampler on the same context."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)
    jcfg, cfg = _configs(2)
    jcfg = jcfg._replace(use_pallas_sampler=True)
    params, stats = jprohmr.init(jax.random.key(2), jcfg)
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    net = prohmr.ProHMR(cfg)
    net.load_state_dict(prohmr_from_jax(params, stats), strict=True)
    net = prohmr.prepare(net, "cpu")
    image = np.random.RandomState(3).randn(B, IMG, IMG, 3).astype(np.float32)
    key = jax.random.key(4)
    ref = jprohmr.sample_hypotheses(jsmpl.synthetic_smpl_model(0, n_verts=256), params, stats,
                                    jcfg, jnp.asarray(image), key, n=N)
    noise = np.array(jax.random.normal(jax.random.split(key)[1], (N * B, 144)))
    assert net.packed_flow.big.dtype == torch.bfloat16
    with torch.inference_mode():
        feat = prohmr.context_features(net, torch.from_numpy(image))
        pose, log_q = cuda_glow_sampler.sample_and_log_prob_fused(
            net.flow, net.packed_flow, feat, N, torch.from_numpy(noise))
    np.testing.assert_allclose(pose.numpy().reshape(N, B, 144), np.asarray(ref["pose_6d"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(log_q.numpy().reshape(N, B), np.asarray(ref["log_q"]),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", [1, 5])
def test_multi_hypothesis_metrics_match_jax(n):
    rng = np.random.RandomState(5)
    samples = {"joints3d": (rng.randn(n, 3, 24, 3) * 0.3).astype(np.float32)}
    target = {"joints3d": (rng.randn(3, 24, 3) * 0.3).astype(np.float32)}
    want = jprohmr.multi_hypothesis_metrics({k: jnp.asarray(v) for k, v in samples.items()},
                                            {k: jnp.asarray(v) for k, v in target.items()})
    got = prohmr.multi_hypothesis_metrics({k: torch.from_numpy(v) for k, v in samples.items()},
                                          {k: torch.from_numpy(v) for k, v in target.items()})
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    assert bool((got["mpjpe_bh"] <= got["mpjpe_mean"] + 1e-4).all())


def test_eval_prohmr_runs_on_the_cpu_and_needs_a_card_by_default(capsys):
    out = eval_prohmr.main(["--device", "cpu", "--tiny", "--n", "4", "--batch", "2"])
    assert set(out) == {"mpjpe_bh", "mpjpe_mean", "pjd_3d"}
    assert all(np.isfinite(v) for v in out.values()) and out["mpjpe_bh"] <= out["mpjpe_mean"]
    assert "BH-MPJPE" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            eval_prohmr.main(["--tiny"])


def test_bench_prohmr_runs_every_variant_on_the_cpu():
    res = bench_prohmr.main(["all", "--device", "cpu", "--tiny", "--batch", "2", "--n", "3",
                             "--windows", "1", "--seconds", "0.01"])
    assert set(res) == {"plain", "kernel", "quant"}
    assert all(r["hypotheses_per_s"] > 0 for r in res.values())


def test_fresh_init_is_seeded_and_prohmr_shaped():
    cfg = prohmr.ProHMRConfig()
    assert (cfg.image_size, cfg.flow) == (224, GlowConfig(144, 1024, 4, 2, 2048))
    a, b = (eval_prohmr.tiny_config() for _ in range(2))
    na, nb = prohmr.init(a, seed=3), prohmr.init(b, seed=3)
    for (k, v), w in zip(na.state_dict().items(), nb.state_dict().values()):
        assert torch.equal(v, w), k
    assert float(na.betas_head.bias.detach().abs().max()) == 0.0
