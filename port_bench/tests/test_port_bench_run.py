"""The command itself: no result without a card or without the program,
and, on the card, one result line per run with the contract's keys."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench import core

CHECKOUT = core.BENCH_DIR.parent


def command(cwd, *args, env=None, timeout=600):
    return subprocess.run([sys.executable, "port_bench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = command(CHECKOUT, "--workload", "btf_600x900", "--seed", str(2 ** 31 + 9), "--seconds",
                  "1", "--trace", "0", env=env)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the files under paths."""
    shutil.copytree(core.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = command(tmp_path, "--workload", "btf_600x900", "--seed", "1", "--seconds", "1",
                  "--trace", "0", env=env)
    assert out.returncode != 0
    assert out.stdout == ""


def test_unknown_workload_no_result():
    out = command(CHECKOUT, "--workload", "no_such_cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_run_on_the_card(card, trace):
    out = command(CHECKOUT, "--workload", "btf_600x900", "--seed", str(2 ** 31 + 77), "--seconds",
                  "1", "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    group = spec["per_layer" if trace == "1" else "end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in group
                                    if "btf_600x900" in m.get("workloads", ["btf_600x900"])}
    if trace == "1":
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]
