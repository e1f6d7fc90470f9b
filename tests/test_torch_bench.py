"""The port's bench (mhentropy_tpu_torch/bench.py) and profile_step on the CPU
at a tiny size: the JSON line carries bench.py's fields, a section the
budget cannot afford is listed as skipped while the headline stays, the
FLOP count is the plain path's, and profile_step's summary (busy time, top
operations with categories, idle gaps) reads a trace as the JAX tool's
`summarize` does."""

import json

import pytest
import torch

from mhentropy_tpu_torch import bench, profile_step

BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "rounds", "spread_pct", "model_flops",
                "mfu", "int8_serving", "int8_speedup", "eval_shape_n200_b64",
                "int8_eval_shape_n200_b64", "train_ms_per_step", "per_call", "serve_b1_ms",
                "skipped", "compile_s", "budget_s", "device_kind")


@pytest.fixture
def tiny_sections(monkeypatch):
    monkeypatch.setattr(bench, "EVAL_SHAPE", (6, 2))
    monkeypatch.setattr(bench, "SERVE_B1", (6, 1))
    monkeypatch.setattr(bench, "TRAIN_BATCH", 2)
    monkeypatch.setattr(bench, "TRAIN_STEPS", 2)


def test_bench_line_has_bench_py_fields(tiny_sections, capsys):
    out = bench.main(["4", "2", "--device", "cpu", "--tiny", "--steps", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    for key in BENCH_FIELDS:
        assert key in line, key
    assert line["skipped"] == [] and line["device_kind"] == "cpu"
    assert len(line["rounds"]) == bench.ROUNDS and line["value"] == max(line["rounds"]) > 0
    for key in ("int8_serving", "eval_shape_n200_b64", "int8_eval_shape_n200_b64",
                "train_ms_per_step", "per_call", "serve_b1_ms"):
        assert line[key] > 0, key
    # No device number from a CPU run.
    assert line["mfu"] is None and line["profile"] is None and line["card"] is None
    assert line["model_flops"] > 0


def test_bench_budget_skips_sections_not_the_headline(tiny_sections, monkeypatch):
    monkeypatch.setenv("MHENT_BENCH_BUDGET_S", "0")
    out = bench.main(["4", "2", "--device", "cpu", "--tiny", "--steps", "1"])
    assert out["value"] > 0
    assert out["skipped"] == ["int8", "eval_shape", "train", "per_call", "int8_eval_shape",
                              "serve_b1"]
    assert out["int8_serving"] is None and out["train_ms_per_step"] is None


def test_step_flops_counts_the_plain_path():
    model, net = bench.build("cpu", tiny=True)
    step = bench.make_step(model, net, 4, 2, torch.device("cpu"))
    flops = bench.step_flops(net, step)
    # resnet50 at 64 px dominates: at least its convolutions for two images.
    assert flops > 2 * 2 * 0.3e9
    assert net.kernels  # the switch is restored
    assert bench.step_flops(net, step) == flops


def test_summarize_reads_busy_time_ops_and_gaps():
    events = [("void (anonymous namespace)::stem_kernel(x)", 0, 100_000),
              ("void cudnn::conv_fprop", 50_000, 100_000),       # overlaps the stem
              ("void at::vectorized_elementwise_kernel", 400_000, 10_000),  # 250 us gap
              ("void cudnn::conv_fprop", 420_000, 20_000)]        # 10 us gap
    s = profile_step.summarize(events, top=2)
    assert s["busy_ns"] == 150_000 + 10_000 + 20_000
    assert s["span_ns"] == 440_000 and s["total_self_ns"] == 230_000
    assert s["gaps"] == [(150_000, 250_000)]
    assert s["rows"] == [("void cudnn::conv_fprop", 120_000, 2, "convolution (cuDNN)"),
                         ("void (anonymous namespace)::stem_kernel(x)", 100_000, 1,
                          "stem kernel")]
    split = profile_step.layer_split(events, n=2)
    assert list(split) == ["convolution (cuDNN)", "stem kernel", "elementwise"]
    assert split == pytest.approx({"convolution (cuDNN)": 0.06, "stem kernel": 0.05,
                                   "elementwise": 0.005}, rel=1e-12)


@pytest.mark.parametrize("name,layer", [
    ("void (anonymous namespace)::stem_probe_kernel<3, float>", "probe kernels"),
    ("void (anonymous namespace)::bottleneck_probe_kernel<true>", "probe kernels"),
    ("void (anonymous namespace)::bottleneck_kernel(Params)", "stage-1 kernel"),
    ("void (anonymous namespace)::realnvp_sample_kernel", "flow sampler kernel"),
    ("void (anonymous namespace)::realnvp_sample_kernel<(anonymous namespace)::Bf16>"
     "((anonymous namespace)::Params)", "flow sampler kernel"),
    ("void (anonymous namespace)::realnvp_sample_kernel<(anonymous namespace)::Tf32x3>"
     "((anonymous namespace)::Params)", "flow sampler kernel"),
    ("void (anonymous namespace)::realnvp_sample_kernel<(anonymous namespace)::S8>"
     "((anonymous namespace)::Params)", "flow sampler kernel"),
    ("void (anonymous namespace)::bottleneck_q_kernel<true, false>"
     "((anonymous namespace)::Params)", "stage-1 kernel"),
    ("void (anonymous namespace)::bottleneck_q_kernel<false, true>"
     "((anonymous namespace)::Params)", "stage-1 kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul (cuBLAS)"),
    ("Memcpy DtoD (Device -> Device)", "copy / fill"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", "copy / fill"),
    ("something else", "other"),
])
def test_category(name, layer):
    assert profile_step.category(name) == layer


def test_device_events_keep_only_device_operations():
    """The trace's step annotations sit on the device timeline too; they are
    not operations, and host events are not device ones."""
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, start, dur, annotation=False):
        span = SimpleNamespace(start=start, elapsed_us=lambda: dur)
        return SimpleNamespace(name=name, device_type=dev, time_range=span,
                               is_user_annotation=annotation)

    prof = SimpleNamespace(events=lambda: [
        ev("ProfilerStep#2", cuda, 0.0, 900.0, annotation=True),
        ev("ProfilerStep#3", cuda, 900.0, 900.0),
        ev("aten::conv2d", cpu, 1.0, 50.0),
        ev("void cudnn::conv_fprop", cuda, 2.5, 40.0)])
    assert profile_step.device_events(prof) == [("void cudnn::conv_fprop", 2500, 40000)]
