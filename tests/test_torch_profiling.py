"""The port's timing utilities on the CPU (the twin of
tests/test_profiling.py): MEASURE's mean of fenced wall times, MP/s, the
chain-slope method, the fence over nested outputs, and torch.profiler
traces."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from various_image_processings_tpu_torch.utils.profiling import (  # noqa: E402
    cuda_time_ms, fence, measure, measure_chained, measure_throughput, trace)


def test_measure_returns_positive_msec():
    x = torch.ones((64, 64))
    ms = measure(lambda: x * 2.0, iters=3)
    assert ms > 0


def test_measure_discards_the_first_call():
    calls = []
    measure(lambda: calls.append(1) or torch.zeros(1), iters=4)
    assert len(calls) == 5  # N+1 calls, the first thrown away


def test_measure_throughput():
    x = torch.ones((64, 64))
    ms, mps = measure_throughput(lambda: x + 1.0, pixels=64 * 64, iters=3)
    assert ms > 0 and mps > 0
    assert mps == pytest.approx(64 * 64 / ms / 1e3)


def test_measure_chained_runs():
    ms = measure_chained(lambda x: x * 1.0001, torch.ones((128, 128)), iters=4)
    assert np.isfinite(ms)


def test_fence_handles_nested_outputs():
    fence({"a": torch.ones((4, 4)), "b": (torch.zeros(3), [torch.tensor(1.0)]), "c": 3})
    fence(torch.ones(2))
    fence(None)


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d) as log_dir:
        assert log_dir == d
        (torch.ones((128, 128)) * 3.0).sum()
    found = []
    for _, _, files in os.walk(d):
        found += files
    assert found, "no trace files written"


def test_cuda_time_ms_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_time_ms(lambda: None)
