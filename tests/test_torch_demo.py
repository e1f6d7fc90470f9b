"""The port of tools/train_synthetic_demo.py on the CPU at a tiny size
(resnet18 at 32 px, feature 32, a 2-layer RealNVP of H = 64, B = 8, 16
training and 16 eval items, 8 hypotheses, 2 epochs): it trains, evaluates
before and after, runs the int8 eval and the int8 sampler's, and prints
the JAX tool's lines; without a card its default device raises."""

import numpy as np
import pytest
import torch

from mhentropy_tpu_torch import train_synthetic_demo as demo
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.models.mhent import MHEntConfig


def test_demo_runs_on_the_cpu_and_needs_a_card_by_default(monkeypatch, capsys):
    for name, value in (("BATCH", 8), ("N_TRAIN", 16), ("N_EVAL", 16)):
        monkeypatch.setattr(demo, name, value)
    monkeypatch.setattr(demo, "N_HYPO", 8)
    assert demo.demo_config("resnet50", 256).flow.h_dim == 512
    tiny = MHEntConfig(encoder=EncoderConfig(backbone="resnet18", n_latent=(32, 32),
                                             dtype="float32"),
                       flow=RealNVPConfig(dim=45, cond_dim=32, h_dim=64, num_steps=1),
                       feat_dim=32, image_size=32, n_train_hypotheses=10, b_2d=0.03)
    monkeypatch.setattr(demo, "demo_config", lambda backbone, img: tiny)
    out = demo.main(epochs=2, lr=1e-3, backbone="resnet18", img=32, device="cpu")
    printed = capsys.readouterr().out
    for line in ("before: BH-MPJPE", "after: BH-MPJPE", "after-int8: BH-MPJPE",
                 "int8 BH-MPJPE delta", "after-int8+sampler: BH-MPJPE",
                 "int8+sampler BH-MPJPE delta", "epoch 0: loss", "epoch 1: loss",
                 "BH-MPJPE drop"):
        assert line in printed, line
    for k in ("before", "after", "after_int8", "after_int8_sampler"):
        assert np.isfinite(out[k]["eucLoss_3d_rgb_sample"]), k
    assert out["before"] != out["after"]
    assert out["improved"] == (out["after"]["eucLoss_3d_rgb_sample"]
                               < out["before"]["eucLoss_3d_rgb_sample"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.cli(["1"])
