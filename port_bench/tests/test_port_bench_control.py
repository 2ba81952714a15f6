"""``correct`` at a size a test run holds, on the CPU (the entry's plain
path): true for the program; false for the control (the reference computed
in bfloat16 in the program's place) and for each planted fault that a
filter cell can have."""

import dataclasses
import time

import pytest
import torch

from port_bench import control, core

BENCH = core.Bench()
CPU = torch.device("cpu")


def tiny(cell_name: str) -> core.Cell:
    cell = BENCH.cell(cell_name)
    return dataclasses.replace(cell, traffic=dict(
        cell.traffic, height=21, width=34, pool_frames=5, check_frames=4, warmup_calls=1))


def run(cell, seed, entry=None):
    return core.run_cell(BENCH, cell, seed, 0.0, False, CPU, time.perf_counter(),
                         entry=entry, least=6)


CELLS = ["bf_4k", "btf_600x900"]


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 2 ** 40 + 3])
def test_program_is_correct(cell_name, seed):
    out = run(tiny(cell_name), seed)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_abs_diff"]["value"] == 0
    assert out["checks"]["calls_compared"]["value"] == 4


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [3, 4, 2 ** 31 + 12])
def test_control_is_not_correct(cell_name, seed):
    cell = tiny(cell_name)
    out = run(cell, seed, entry=control.control_entry(BENCH, cell))
    assert not out["correct"]
    assert out["checks"]["max_abs_diff"]["value"] >= 1


def unchanged(entry):
    """A call that returns its input as it came."""
    return lambda frame, **kwargs: frame.clone()


def half_left_out(entry):
    """Half of the frame's rows filtered, the rest passed through."""
    def broken(frame, **kwargs):
        out = entry(frame, **kwargs)
        out[frame.shape[0] // 2:] = frame[frame.shape[0] // 2:]
        return out
    return broken


def answer_altered(entry):
    """One value of each output changed where it is produced."""
    def broken(frame, **kwargs):
        out = entry(frame, **kwargs)
        out[3, 5, 1] ^= 1
        return out
    return broken


def shape_changed(entry):
    """An output a row short."""
    return lambda frame, **kwargs: entry(frame, **kwargs)[1:]


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered, shape_changed])
def test_planted_fault_is_not_correct(cell_name, fault):
    cell = tiny(cell_name)
    out = run(cell, 5, entry=fault(core.resolve(cell.config["entry"])))
    assert not out["correct"], (fault.__name__, out["checks"])
