"""Tracing, timing and the NaN / Inf sanitiser.

Port of the GPU-meaningful part of mhentropy_tpu/utils/profiling.py:
`trace` :19 (a `torch.profiler` trace into a log dir), `nan_sanitizer` :29
(torch's anomaly mode, which JAX's docstring names as what its
jax_debug_nans / jax_debug_infs replace, plus a NaN / Inf check of every
module output that raises), `time_fn` :101 (synchronised wall time) and
`hypotheses_per_sec` :123. The relay's input variation (`_default_vary`)
and the scan harness keep XLA from hoisting or pruning a jitted body and
have no meaning in eager PyTorch: `time_fn` calls `fn` on its arguments as
given (a `vary` callback may still change them per call).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str, activities=None):
    """Capture a `torch.profiler` trace of the block into logdir (a Chrome
    trace, `trace.json`; CPU and, where there is a card, CUDA activity).
    Yields the profiler, whose `key_averages()` summarise it."""
    from torch.profiler import ProfilerActivity, profile

    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class NonFiniteError(FloatingPointError):
    """A NaN or Inf in a module's output inside `nan_sanitizer`."""


def _check(name: str, out) -> None:
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() and not bool(torch.isfinite(out).all()):
            raise NonFiniteError(f"NaN or Inf in the output of {name}")
    elif isinstance(out, (tuple, list)):
        for o in out:
            _check(name, o)
    elif isinstance(out, dict):
        for o in out.values():
            _check(name, o)


@contextlib.contextmanager
def nan_sanitizer(enable: bool = True, module: torch.nn.Module | None = None):
    """Raise where a NaN or Inf is produced: torch's anomaly mode
    (`set_detect_anomaly`: a backward that produces one raises, naming the
    forward op) and, for every submodule of `module`, a check of its
    forward outputs (NonFiniteError, naming the module). Yields `check`,
    which applies the same test to any value."""
    def check(out, name: str = "value"):
        if enable:
            _check(name, out)
        return out

    if not enable:
        yield check
        return
    handles = []
    if module is not None:
        for name, sub in module.named_modules():
            handles.append(sub.register_forward_hook(
                lambda m, args, out, name=name or type(module).__name__: _check(name, out)))
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield check
    finally:
        for h in handles:
            h.remove()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 20, warmup: int = 2, vary=None):
    """Wall seconds per call of fn(*args), the card synchronised before and
    after the timed calls; vary(i, args) -> args, when given, makes each
    call's arguments.

    Returns:
        (seconds_per_call, last_result).
    """
    if vary is None:
        def vary(i, a):
            return a
    result = None
    for i in range(warmup):
        result = fn(*vary(-1 - i, args))
    _sync()
    t0 = time.perf_counter()
    for i in range(iters):
        result = fn(*vary(i, args))
    _sync()
    return (time.perf_counter() - t0) / iters, result


def hypotheses_per_sec(fn, *args, n_hypotheses: int, batch: int, iters: int = 20) -> float:
    """The throughput metric of a sampling step: n_hypotheses * batch over
    its seconds per call."""
    sec, _ = time_fn(fn, *args, iters=iters)
    return n_hypotheses * batch / sec
