"""The whole serving slice, port vs JAX, and the port's InferenceServer.

JAX `mhent.sample_hypotheses` (resnet50, 64 px, B=2, N=4, flow h=32 with 2
steps, num_latent 32, f32) against the port's with the weights carried by
`from_jax` and the base noise JAX drew (jax.random.normal(key) * temp). xyz
within 1e-4; uv within 2e-2 px, the 1e-4 bound scaled by image_size / 2 of
`orth_project`. Then the port's server on the CPU: f32 and u8 requests,
bucket padding, HTTP.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu_torch import serve
from mhentropy_tpu_torch.convert import from_jax
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.utils.config import make_cfg
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

B, N, IMG, TEMP = 2, 4, 64, 0.8


def _randomise(params, stats, seed):
    """Non-default BN stats and an O(1) flow, so neither the BN mapping nor
    the flow is compared at its near-identity init."""
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


@pytest.mark.parametrize("n_quant", [None, 2])
def test_sample_hypotheses_matches_jax(n_quant):
    """n_quant=2 keeps the 2 most likely of the 4 hypotheses per image."""
    jcfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2),
        feat_dim=32, image_size=IMG)
    params, stats = jmhent.init(jax.random.key(0), jcfg)
    params, stats = _randomise(params, stats, 1)
    jmodel = jmano.synthetic_mano_model(0)
    image = np.random.RandomState(2).randn(B, IMG, IMG, 3).astype(np.float32)
    key = jax.random.key(3)

    @jax.jit
    def run(p, s, img, k):
        out = jmhent.sample_hypotheses(jmodel, p, s, jcfg, img, k, n=N, n_quant=n_quant,
                                       temp=TEMP, mods=("xyz", "uv"))
        return out["xyz"], out["uv"]

    xyz_ref, uv_ref = run(params, stats, jnp.asarray(image), key)
    noise = np.array(jax.random.normal(key, (N * B, 45)) * TEMP)

    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet50", n_latent=(32, 32), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=2),
        feat_dim=32, image_size=IMG)
    net = mhent.MHEnt(cfg)
    net.load_state_dict(from_jax(params, stats), strict=True)
    net.eval()
    with torch.inference_mode():
        out = mhent.sample_hypotheses(mano.synthetic_mano_model(0), net,
                                      torch.from_numpy(image), n=N, n_quant=n_quant, temp=TEMP,
                                      mods=("xyz", "uv"), base_noise=torch.from_numpy(noise))
    kept = n_quant or N
    assert out["xyz"].shape == (kept, B, 63) and out["uv"].shape == (kept, B, 42)
    np.testing.assert_allclose(out["xyz"].numpy(), np.asarray(xyz_ref), atol=1e-4)
    np.testing.assert_allclose(out["uv"].numpy(), np.asarray(uv_ref), atol=2e-2)


def _tiny_cfg():
    return make_cfg({
        "dataset": {"dataset_name": "rhd", "image_size": [32, 32]},
        "network": {"enc_type": "MHEnt", "num_latent": 32, "backbone": "resnet18",
                    "h_dims": [32, 32], "num_steps": 1, "regressor": "realnvp"},
        "training": {"test_samples": 4},
        "tpu": {"compute_dtype": "float32"},
    })


@pytest.fixture(scope="module")
def server():
    s = serve.InferenceServer(_tiny_cfg(), max_batch=4, device="cpu")
    s.warmup()
    return s


def test_buckets():
    assert serve._buckets(8) == [1, 2, 4, 8]
    assert serve._buckets(6) == [1, 2, 4, 6]
    assert serve._buckets(1) == [1]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_predict_pads_to_bucket_and_drops_padding(server, dtype):
    """B=3 pads to the 4-bucket; a request row's result does not depend on
    the padding or on its neighbours (same base noise rows)."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (3, 32, 32, 3)).astype(dtype)
    noise = torch.randn(N * 4, 45, generator=torch.Generator().manual_seed(1)) * 0.8
    out = server.predict(images, base_noise=noise)
    assert out["xyz"].shape == (3, N, 21, 3) and out["uv"].shape == (3, N, 21, 2)
    assert np.isfinite(out["xyz"]).all() and np.isfinite(out["uv"]).all()
    full = server.predict(np.concatenate([images, images[:1]]), base_noise=noise)
    np.testing.assert_allclose(out["xyz"], full["xyz"][:3], atol=1e-5)


def test_u8_is_normalised_on_device(server):
    """RHD's u8 affine is x / 255: raw pixels and pre-normalised f32 frames
    give the same hypotheses under the same noise."""
    raw = np.random.RandomState(2).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    noise = torch.randn(N * 2, 45, generator=torch.Generator().manual_seed(3))
    a = server.predict(raw, base_noise=noise)
    b = server.predict(raw.astype(np.float32) / 255.0, base_noise=noise)
    np.testing.assert_allclose(a["uv"], b["uv"], atol=1e-4)


def test_predict_oversize_batch_splits(server):
    out = server.predict(np.zeros((6, 32, 32, 3), np.float32))
    assert out["xyz"].shape == (6, N, 21, 3)


def test_pth_checkpoint_loads_directly(server, tmp_path):
    path = tmp_path / "ent.pth"
    torch.save({"encoderRGB": server.net.state_dict()}, path)
    other = serve.InferenceServer(_tiny_cfg(), checkpoint=str(path), max_batch=4,
                                  device="cpu", seed=5)
    images = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    noise = torch.randn(N * 2, 45, generator=torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(other.predict(images, base_noise=noise)["xyz"],
                                  server.predict(images, base_noise=noise)["xyz"])


def test_unported_options_raise():
    """int8 serving is ported; orbax checkpoints are not."""
    with pytest.raises(NotImplementedError, match="orbax"):
        serve.InferenceServer(_tiny_cfg(), checkpoint="some/orbax/dir", device="cpu")


def test_default_device_is_the_card(monkeypatch):
    """device=None means CUDA: without a card it raises and names the fix."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.InferenceServer(_tiny_cfg(), max_batch=4)


@pytest.fixture(scope="module")
def qserver():
    s = serve.InferenceServer(_tiny_cfg(), max_batch=4, quantize=True, quantize_min_batch=2,
                              device="cpu")
    s.warmup()
    return s


def _spy_quant(monkeypatch):
    """Records, per sample_hypotheses call, whether it ran the int8 path."""
    calls = []
    orig = serve.mhent.sample_hypotheses

    def spy(*args, quant=None, **kwargs):
        calls.append(quant is not None and quant[0].int8_sampler)
        return orig(*args, quant=quant, **kwargs)

    monkeypatch.setattr(serve.mhent, "sample_hypotheses", spy)
    return calls


def test_quantized_server_serves_int8_buckets(qserver, monkeypatch):
    """Buckets >= quantize_min_batch run the int8 encoder and sampler
    (recalibrated on the first real batch); smaller ones stay float."""
    assert qserver._quant is not None and not qserver._quant_ready
    spec, qtree = qserver._quant
    assert spec.int8_sampler and spec.q_from == 1 and "flow" in qtree
    calls = _spy_quant(monkeypatch)
    images = np.random.RandomState(5).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    out = qserver.predict(images)
    assert out["xyz"].shape == (3, N, 21, 3) and out["uv"].shape == (3, N, 21, 2)
    assert np.isfinite(out["xyz"]).all() and qserver._quant_ready
    one = qserver.predict(images[:1])
    assert one["xyz"].shape == (1, N, 21, 3)
    assert calls == [True, False]


def test_quantized_server_serves_hot_requests_float(qserver, monkeypatch, capsys):
    calls = _spy_quant(monkeypatch)
    out = qserver.predict(np.zeros((2, 32, 32, 3), np.float32), temp=1.5)
    assert out["xyz"].shape == (2, N, 21, 3) and calls == [False]
    assert "exceeds the int8 calibration ceiling" in capsys.readouterr().err


def test_http_front_end(server):
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert r.status == 200 and json.loads(r.read())["n_hypo"] == N
        for b, dt in ((3, np.float32), (1, np.uint8)):
            body = np.zeros((b, 32, 32, 3), dt).tobytes()
            req = urllib.request.Request(
                base + "/predict", data=body,
                headers={"X-Batch": str(b), "X-Dtype": np.dtype(dt).name})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            assert np.asarray(out["xyz"]).shape == (b, N, 21, 3)
            assert np.asarray(out["uv"]).shape == (b, N, 21, 2)
        req = urllib.request.Request(base + "/predict", data=b"\0" * 10,
                                     headers={"X-Batch": "1"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
