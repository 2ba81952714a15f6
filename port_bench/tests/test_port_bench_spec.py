"""BENCHMARK.json against the rules its harness relies on: every name it
gives is a file of the benchmark, and the entries keep the contract's shape."""

import json
import re

import pytest

from port_bench import core

BENCH = core.Bench()
SPEC = BENCH.spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert SPEC["paths"] == ["port_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)


def test_every_name_is_a_file():
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((BENCH.checkout / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        for kind, key in (("refs", "reference"), ("counts", "count")):
            assert (BENCH.dir / kind / f"{data[key]}.py").is_file()
        assert len(data["source"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        traffic = json.loads((BENCH.dir / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH.dir / "inputs" / f"{traffic['input']}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH.dir / "metrics" / f"{m['name']}.py").is_file()
    assert {c["config"] for c in SPEC["workloads"]} == configs


def test_names_units_and_lengths():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for x in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("metric", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        got = [n for n, _ in BENCH.metrics(w["name"], False)]
        assert "setup_s" in got and len(got) >= 2
        assert BENCH.metrics(w["name"], True)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert m["moves"] in [n for n, _ in BENCH.metrics(cell, False)]
