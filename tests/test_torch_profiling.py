"""mhentropy_tpu_torch/utils/profiling.py: the properties of JAX's
tests/test_utils_extra.py:216-230 that carry over to eager PyTorch
(time_fn's shape and its call count, the sanitiser raising where a NaN or
Inf appears and passing finite values), and the torch.profiler trace."""

import json
import os

import pytest
import torch

from mhentropy_tpu_torch.utils import profiling
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)


def test_time_fn_returns_seconds_and_the_last_result():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    sec, out = profiling.time_fn(fn, torch.ones(3), iters=3, warmup=2)
    assert sec >= 0.0 and len(calls) == 5
    assert torch.equal(out, torch.full((3,), 2.0))


def test_time_fn_vary_makes_each_calls_arguments():
    seen = []
    profiling.time_fn(lambda x: seen.append(float(x)), torch.tensor(0.0), iters=2, warmup=1,
                      vary=lambda i, a: (a[0] + i,))
    assert seen == [-1.0, 0.0, 1.0]


def test_hypotheses_per_sec_is_positive():
    assert profiling.hypotheses_per_sec(lambda x: x + 1, torch.zeros(4), n_hypotheses=10,
                                        batch=4, iters=2) > 0


def test_nan_sanitizer_raises_on_a_module_output():
    net = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.ReLU())
    with profiling.nan_sanitizer(True, module=net):
        net(torch.ones(1, 3))  # finite: passes
        with pytest.raises(profiling.NonFiniteError, match="0"):
            net(torch.tensor([[float("nan"), 0.0, 0.0]]))
    net(torch.tensor([[float("nan"), 0.0, 0.0]]))  # the hooks are gone
    with profiling.nan_sanitizer(False, module=net) as check:
        check(torch.tensor(float("inf")))  # off: no check


def test_nan_sanitizer_check_and_anomaly_mode():
    with profiling.nan_sanitizer(True) as check:
        assert torch.is_anomaly_enabled()
        check(torch.ones(2))
        with pytest.raises(profiling.NonFiniteError):
            check({"x": torch.tensor([1.0, float("inf")])})
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    path = tmp_path / "trace.json"
    assert path.is_file()
    assert "traceEvents" in json.loads(path.read_text())
    assert any("mm" in e.key for e in prof.key_averages())
