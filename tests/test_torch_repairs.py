"""Two repairs of the port.

* The reference's own checkpoints load: a reference `encoderRGB` carries
  its MANO layer's `mano_dec.th_*` buffers (tests/test_released_checkpoint_
  drill.py:56-75 fabricates them at MANO's shapes, and JAX's converter
  ignores them), which `convert.load_reference_state` drops, keeping
  strict=True for every other key. Held on a full-schema file (the port's
  MHEnt state dict, those buffers and an empty `decoderPose`) through the
  server, run.py and export.py; any other unexpected key still raises.
* The `mhent::*` operators carry autograd kernels: the gradient through
  `lbs_blend` equals the plain einsums' (1e-5 of each tensor's largest
  entry: the same sums in another order), and a backward through any of
  the eight eval-only operators raises instead of leaving its inputs
  without a gradient.
"""

import numpy as np
import pytest
import torch

from mhentropy_tpu_torch import convert, export, run, serve
from mhentropy_tpu_torch.core import lbs_cuda
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.utils.config import make_cfg
from tests.test_torch_export import _case
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

TINY = {"dataset": {"dataset_name": "ho3d", "image_size": [32, 32]},
        "network": {"enc_type": "MHEnt", "num_latent": 32, "backbone": "resnet18",
                    "h_dims": [32, 32], "num_steps": 1, "regressor": "realnvp"},
        "training": {"test_samples": 2, "batch_size": 2, "seed": 1, "epochs": 0,
                     "mode": "eval"},
        "tpu": {"compute_dtype": "float32"}}


def mano_dec_buffers(rng) -> dict:
    """ManoLayer's registered buffers at MANO's shapes (the drill's,
    tests/test_released_checkpoint_drill.py:56-75)."""
    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype("f4"))

    return {"th_betas": t(1, 10), "th_shapedirs": t(778, 3, 10), "th_posedirs": t(778, 3, 135),
            "th_v_template": t(1, 778, 3), "th_J_regressor": t(16, 778),
            "th_weights": t(778, 16),
            "th_faces": torch.from_numpy(rng.integers(0, 778, (1538, 3)).astype("i8")),
            "th_hands_mean": t(1, 45), "th_comps": t(45, 45), "th_selected_comps": t(45, 45)}


def full_schema(net: mhent.MHEnt, seed: int = 13) -> dict:
    """The reference's checkpoint dict for `net`'s weights."""
    enc = {k: v.detach().clone() for k, v in net.state_dict().items()}
    enc.update({f"mano_dec.{k}": v for k, v in
                mano_dec_buffers(np.random.default_rng(seed)).items()})
    return {"decoderPose": {}, "encoderRGB": enc}


@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    cfg = make_cfg(TINY)
    net = mhent.init(engine.build_model_config(cfg), seed=7)
    path = tmp_path_factory.mktemp("ref") / "ref.pth"
    torch.save(full_schema(net), str(path))
    return str(path), net


def _same_weights(net, want):
    sd = net.state_dict()
    for k, v in want.state_dict().items():
        assert torch.equal(sd[k].float().cpu(), v.float()), k


def test_load_reference_state_drops_mano_dec_only(tiny_pth):
    path, want = tiny_pth
    ckpt = torch.load(path)
    net = mhent.MHEnt(want.cfg)
    loaded = convert.load_reference_state(net, ckpt)
    assert not any(k.startswith("mano_dec.") for k in loaded)
    _same_weights(net, want)
    ckpt["encoderRGB"]["feat_extractor.extra.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="feat_extractor.extra.weight"):
        convert.load_reference_state(mhent.MHEnt(want.cfg), ckpt)
    del ckpt["encoderRGB"]["feat_extractor.extra.weight"]
    del ckpt["encoderRGB"]["det_head.0.bias"]
    with pytest.raises(RuntimeError, match="det_head.0.bias"):
        convert.load_reference_state(mhent.MHEnt(want.cfg), ckpt)


def test_server_restores_a_reference_checkpoint(tiny_pth, tmp_path):
    path, want = tiny_pth
    server = serve.InferenceServer(make_cfg(TINY), checkpoint=path, max_batch=2, device="cpu")
    _same_weights(server.net, want)
    bad = tmp_path / "bad.pth"
    ckpt = torch.load(path)
    ckpt["encoderRGB"]["q_z_giv_i.extra"] = torch.zeros(1)
    torch.save(ckpt, str(bad))
    with pytest.raises(RuntimeError, match="q_z_giv_i.extra"):
        serve.InferenceServer(make_cfg(TINY), checkpoint=str(bad), max_batch=2, device="cpu")


def test_run_evaluates_a_reference_checkpoint(tiny_pth, tmp_path, monkeypatch):
    path, want = tiny_pth
    seen = {}
    orig = engine.Experiment.eval_loop

    def eval_loop(self, data, *args, **kwargs):
        seen["net"] = self.net
        return orig(self, data, *args, **kwargs)

    monkeypatch.setattr(engine.Experiment, "eval_loop", eval_loop)
    yaml = tmp_path / "eval.yaml"
    yaml.write_text(
        "dataset: {dataset_name: ho3d, image_size: [32, 32]}\n"
        "network: {enc_type: MHEnt, num_latent: 32, backbone: resnet18, h_dims: [32, 32],\n"
        "          num_steps: 1}\n"
        f"training: {{mode: eval, batch_size: 2, seed: 1, test_samples: 2, pth: {path}}}\n"
        f"tpu: {{compute_dtype: float32}}\nmodel_dir: {tmp_path / 'model'}/\n")
    summary = run.main(["--cfg", str(yaml), "--device", "cpu"])
    assert np.isfinite(summary["eucLoss_3d_rgb_sample"])
    _same_weights(seen["net"], want)


def test_export_restores_a_reference_checkpoint(tmp_path, monkeypatch):
    """export.py's --pth: the export's own configuration (a 12 x 512
    RealNVP) with resnet18 at 32 px; the traced export itself is
    tests/test_torch_export.py's."""
    cfg = mhent.MHEntConfig(
        encoder=mhent.EncoderConfig(backbone="resnet18", n_latent=(512, 512)),
        flow=mhent.RealNVPConfig(dim=45, cond_dim=512, h_dim=512, num_steps=6),
        feat_dim=512, image_size=32)
    want = mhent.init(cfg, seed=5)
    path = tmp_path / "ref.pth"
    torch.save(full_schema(want), str(path))
    seen = {}

    def fake_export(model, net, batch, n=100, temp=0.8, mods=("xyz", "uv"), quant=None):
        seen["net"] = net
        return b"artifact"

    monkeypatch.setattr(export, "export_sampler", fake_export)
    export.main([str(tmp_path / "s.pt2"), "--pth", str(path), "--device", "cpu",
                 "--backbone", "resnet18", "--image-size", "32", "--batch", "1", "--n", "2"])
    net = seen["net"]
    for k, v in want.state_dict().items():
        if not k.startswith("feat_extractor.res."):  # the served backbone is cast to bf16
            assert torch.equal(net.state_dict()[k].float(), v), k


def test_lbs_blend_gradient_is_the_plain_blends():
    g = torch.Generator().manual_seed(3)
    shapes = [(778, 16), (3, 3, 16, 6), (3, 16, 6), (3, 778, 6)]
    args = [torch.randn(s, generator=g) for s in shapes]
    cot = torch.randn(3, 778, 6, generator=g)
    grads = []
    for fn in (lbs_cuda.lbs_blend, lbs_cuda.lbs_blend_plain):
        leaves = [a.clone().requires_grad_() for a in args]
        (fn(*leaves) * cot).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for got, want in zip(*grads):
        assert got is not None
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name", ["stem", "stage1", "realnvp_sample", "realnvp_sample_q",
                                  "glow_sample", "stage1_int8", "stem_int8", "stage2_int8"])
def test_eval_only_operator_backward_raises(name):
    _, _, args = _case(name)
    leaf = args[0].detach().clone().requires_grad_()
    out = getattr(torch.ops.mhent, name).default(leaf, *args[1:])
    out = out[0] if isinstance(out, (tuple, list)) else out
    assert out.requires_grad
    with pytest.raises(RuntimeError, match="eval-only"):
        out.float().sum().backward()
