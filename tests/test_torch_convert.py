"""Weights carried across: JAX params -> `from_jax` -> the port's MHEnt
(strict load), and back through tools/convert_torch.py to the exact JAX
params."""

import jax
import numpy as np
import pytest

from mhentropy_tpu.models import mhent as jmhent
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu_torch.convert import from_jax
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from tools import convert_torch


def _jax_model(backbone):
    cfg = jmhent.MHEntConfig(
        encoder=JEncoderConfig(backbone=backbone, n_latent=(16, 16), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=1),
        feat_dim=16, image_size=32)
    params, stats = jmhent.init(jax.random.key(0), cfg)
    rng = np.random.RandomState(0)
    # Non-default stats, so a mean/var mix-up cannot pass.
    stats = jax.tree.map(lambda v: (rng.rand(*v.shape) + 0.5).astype(np.float32), stats)
    return jax.tree.map(np.asarray, params), stats


def _port_model(backbone):
    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone=backbone, n_latent=(16, 16), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=16, h_dim=32, num_steps=1),
        feat_dim=16, image_size=32)
    return mhent.MHEnt(cfg)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_from_jax_loads_strict_and_round_trips(backbone):
    params, stats = _jax_model(backbone)
    net = _port_model(backbone)
    net.load_state_dict(from_jax(params, stats), strict=True)
    sd = net.state_dict()

    bb_params, bb_stats = convert_torch.convert_resnet(sd, "feat_extractor.res.")
    _assert_tree_equal(bb_params, params["encoder"]["backbone"], "backbone")
    _assert_tree_equal(bb_stats, stats, "batch_stats")
    for head in ("l1", "l2"):
        _assert_tree_equal(convert_torch.convert_linear(sd, f"feat_extractor.{head}.0"),
                           params["encoder"][head], head)
    _assert_tree_equal(convert_torch.convert_det_head(sd, "det_head."), params["det_head"],
                       "det_head")
    flow = convert_torch.convert_realnvp(sd, "q_z_giv_i.", 2)
    for name, v in params["flow"]._asdict().items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(np.asarray(getattr(flow, name)), v, err_msg=name)
