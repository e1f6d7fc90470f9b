"""The port's bench (mhentropy_tpu_torch/bench.py) and profile_step on the CPU
at a tiny size: the JSON line carries bench.py's fields, a section the
budget cannot afford is listed as skipped while the headline stays, the
FLOP count is the plain path's, and profile_step's summary (busy time, top
operations with categories, idle gaps) reads a trace as the JAX tool's
`summarize` does; sampler_ab.py's Glow and LBS shapes are chip_smoke.py's,
and on the CPU it parses its arguments and refuses to time."""

import json

import pytest
import torch

from mhentropy_tpu_torch import bench, profile_step
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "rounds", "spread_pct", "model_flops",
                "mfu", "int8_serving", "int8_speedup", "eval_shape_n200_b64",
                "int8_eval_shape_n200_b64", "train_ms_per_step", "per_call", "serve_b1_ms",
                "skipped", "compile_s", "budget_s", "device_kind")


def _small_build(dev, tiny: bool = False):
    """The bench's model at the smallest geometry its sections take
    (resnet18 at 32 px, RealNVP 1 x 2 x 32): the line's fields do not depend
    on the model; test_step_flops_counts_the_plain_path keeps --tiny's."""
    cfg = mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(32, 32), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=1), feat_dim=32,
        image_size=32)
    return mano.synthetic_mano_model(0, device=dev), mhent.prepare(mhent.init(cfg, seed=0), dev)


@pytest.fixture
def tiny_sections(monkeypatch):
    monkeypatch.setattr(bench, "build", _small_build)
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


def test_sampler_ab_times_the_smokes_glow_and_lbs_shapes():
    """sampler_ab.py's Glow and LBS shapes are the ones chip_smoke.py holds
    the kernels to: both GLOW_SHAPES, MANO at the eval batch's rows and SMPL
    at the ProHMR bench's."""
    import chip_smoke
    from mhentropy_tpu_torch import sampler_ab
    from mhentropy_tpu_torch.core import smpl

    assert sampler_ab.GLOW_SHAPES == chip_smoke.GLOW_SHAPES
    assert sampler_ab.LBS_SHAPES["mano"] == {"v": 778, "j": 16,
                                             "rows": chip_smoke.N_HYPO * chip_smoke.EVAL_BATCH}
    assert sampler_ab.LBS_SHAPES["smpl"] == {
        "v": smpl.N_VERTS, "j": 24, "rows": chip_smoke.PROHMR_BENCH[0] * chip_smoke.PROHMR_BENCH[1]}
    assert set(sampler_ab.KINDS) == {"realnvp", "stage1", "glow", "lbs", "gemm_probe",
                                     "stage1_probe", "stem_probe", "stem_int8", "stage2_int8", "request"}
    assert sampler_ab.STEM_INT8_BATCHES == chip_smoke.MID_BATCHES


@pytest.mark.parametrize("argv", [["--kinds", "glow,lbs"], ["--kinds", "lbs", "--tiles"], [],
                                  ["--kinds", "gemm_probe,stage1_probe"],
                                  ["--kinds", "stem_probe"], ["--kinds", "stem_int8"],
                                  ["--kinds", "stage2_int8"]])
def test_sampler_ab_needs_a_card(argv, monkeypatch, capsys):
    """On the CPU the script parses its arguments and refuses to time: exit
    1, no line printed."""
    import sys

    from mhentropy_tpu_torch import sampler_ab

    monkeypatch.setattr(sys, "path", list(sys.path))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert sampler_ab.main(argv) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_sampler_ab_refuses_an_unknown_kind(monkeypatch):
    import sys

    from mhentropy_tpu_torch import sampler_ab

    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(SystemExit):
        sampler_ab.main(["--kinds", "glow,resnet"])


@pytest.mark.parametrize("kind", ["gemm", "stage1", "stem", "stem_int8", "stage2_int8"])
def test_kernel_variants_apply_to_the_committed_sources(kind):
    """Every variant's substitutions match the kernel source as committed,
    and each variant but the base changes it."""
    from mhentropy_tpu_torch import kernel_variants

    srcs = kernel_variants.variant_sources(kind)
    base = srcs.pop("base")
    assert srcs and all(text != base for text in srcs.values())


def test_stem_int8_split_stamps_apply_to_the_committed_source():
    """The W8A8 stem's clock64 split: every stamp's substitution matches the
    committed kernel and each of the split's cuts, and each adds code."""
    from mhentropy_tpu_torch import kernel_variants

    srcs = kernel_variants.variant_sources("stem_int8")
    for name in kernel_variants.SPLIT_VARIANTS:
        text = srcs[name]
        for sub in kernel_variants.STEM_INT8_SPLIT:
            stamped = kernel_variants._substitute(text, *sub)
            assert len(stamped) > len(text)
            text = stamped
        assert "mhent_stem_int8_stamps" in text


def test_stage2_int8_split_stamps_apply_to_the_committed_source():
    """The stage kernel's clock64 split: every stamp's substitution matches
    the committed kernel and each of the split's variants, and each adds
    code."""
    from mhentropy_tpu_torch import kernel_variants

    srcs = kernel_variants.variant_sources("stage2_int8")
    for name in kernel_variants.STAGE2_SPLIT_VARIANTS:
        text = srcs[name]
        for sub in kernel_variants.STAGE2_INT8_SPLIT:
            stamped = kernel_variants._substitute(text, *sub)
            assert len(stamped) > len(text)
            text = stamped
        assert "mhent_stage2_int8_stamps" in text


def test_build_log_names_the_sources_whose_wgmma_ptxas_serialized():
    """ext.KernelLibrary.wgmma_serialized reads the per-source build log:
    a source is named for any of C7515 / C7517 / C7518, and only then."""
    from types import SimpleNamespace

    from mhentropy_tpu_torch import ext

    logs = {"a.cu": "ptxas info    : Used 90 registers",
            "b.cu": "ptxas info    : (C7517) warpgroup.wait is injected in around line 7",
            "c.cu": "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
                    "instructions are serialized",
            "link": ""}
    assert ext.KernelLibrary.wgmma_serialized(SimpleNamespace(logs=logs)) == ["b.cu", "c.cu"]
    assert ext.KernelLibrary.wgmma_serialized(SimpleNamespace(logs={"a.cu": ""})) == []


def test_kernel_variants_needs_a_card(monkeypatch, capsys):
    from mhentropy_tpu_torch import kernel_variants

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_variants.main(["--kinds", "gemm"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        kernel_variants.main(["--kinds", "gemm,resnet"])
