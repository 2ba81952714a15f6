"""A later change adds a cell as data: a configuration, a traffic mix, an
input generator, a reference, a work count and a metric, each a new file, and entries in
BENCHMARK.json.  The harness finds and runs them with no file of it edited."""

import hashlib
import json
import shutil
import time

import torch

from port_bench import core

NEW_FILES = {
    "configs/grad_u8.json": json.dumps({
        "name": "grad_u8", "entry": "various_image_processings_tpu_torch.gradient",
        "kwargs": {}, "precision": "float32", "reference": "gradient_u8",
        "count": "gradient_u8", "max_abs_diff_limit": 0, "source": "a test", "assumed": [],
        "reduced": []}),
    "traffic/tiny_flat.json": json.dumps({
        "height": 9, "width": 14, "channels": 3, "input": "u8_flat", "pool_frames": 3,
        "loop": "closed", "in_flight": 1, "warmup_calls": 2, "check_frames": 4}),
    "inputs/u8_flat.py": (
        "import torch\n\n\n"
        "def make_pool(traffic, generator, device):\n"
        "    shape = (traffic['pool_frames'], traffic['height'], traffic['width'],\n"
        "             traffic['channels'])\n"
        "    level = torch.randint(0, 256, (shape[0], 1, 1, 1), generator=generator,\n"
        "                          dtype=torch.uint8, device=device)\n"
        "    return level.expand(shape).contiguous()\n"),
    "refs/gradient_u8.py": (
        "from port_bench.refs import _plain\n\n\n"
        "def reference(frame, dtype=None):\n"
        "    return _plain.gradient(frame)\n"),
    "counts/gradient_u8.py": (
        "def work(kwargs, height, width, channels):\n"
        "    return 19.0 * height * width, 4.0 * height * width + height * width * channels\n"),
    "metrics/calls_per_s.py": (
        "def read(record):\n"
        "    return record.window.calls / record.window.seconds\n"),
    "metrics/ops.max_host_us.py": (
        "def read(record):\n"
        "    return max(record.window.host_ns) / 1e3\n"),
}


def digest(directory):
    return {p.relative_to(directory).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(directory.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_is_found_and_run_from_new_files_alone(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.BENCH_DIR.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "port_bench")
    for rel, text in NEW_FILES.items():
        assert not (tmp_path / "port_bench" / rel).exists()
        (tmp_path / "port_bench" / rel).write_text(text)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "grad_u8", "source": "a test", "reduced": [], "why": "t",
                            "file": "port_bench/configs/grad_u8.json"})
    spec["workloads"].append({"name": "grad_tiny", "config": "grad_u8",
                              "traffic": "tiny_flat", "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["grad_tiny"]})
    spec["per_layer"].append({"name": "ops.max_host_us", "unit": "us", "better": "lower",
                              "source": "host_clock", "layer": "ops",
                              "moves": "call_p95_ms", "workloads": ["grad_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = core.Bench(tmp_path / "port_bench")
    assert bench.package != "port_bench"
    cell = bench.cell("grad_tiny")
    out = core.run_cell(bench, cell, 2 ** 31 + 5, 0.05, False, torch.device("cpu"),
                        time.perf_counter())
    assert out["correct"] and out["checks"]["calls_compared"]["value"] == 4
    assert set(out["metrics"]) == {"setup_s", "calls_per_s"}
    assert out["metrics"]["calls_per_s"]["unit"] == "1/s"
    traced = core.run_cell(bench, cell, 7, 0.05, True, torch.device("cpu"), time.perf_counter())
    assert "ops.max_host_us" in traced["metrics"]
    assert "kernels.call_roofline" not in traced["metrics"]  # the cell is not in its list
    # the cells already there keep their metrics, and no file that was there changed
    assert [n for n, _ in bench.metrics("btf_4k", False)] == [
        "mpix_per_s", "call_p95_ms", "setup_s"]
    assert [n for n, _ in bench.metrics("bf_4k", False)] == [
        "short_call_mpix_per_s", "short_call_p95_ms", "setup_s"]
    assert "calls_per_s" not in [n for n, _ in bench.metrics("btf_600x900", False)]
    after = digest(tmp_path / "port_bench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(NEW_FILES)
