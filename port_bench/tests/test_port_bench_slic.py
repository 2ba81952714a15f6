"""The SLIC configuration on the CPU, at sizes a test run holds: the plain
reference against the port label for label, ``correct`` through the
harness for the program and not for the control or planted faults, the
work count against a count by hand, and the new metrics with nothing to
read."""

import dataclasses
import json
import sys
import time
import types

import numpy as np
import pytest
import torch

import various_image_processings_tpu_torch as vt
from port_bench import control, core
from various_image_processings_tpu_torch.core import colors
from various_image_processings_tpu_torch.models import slic as mslic

BENCH = core.Bench()
CPU = torch.device("cpu")
CELL = "slic_euclid_4k"
REF = BENCH.load("refs", "slic")
TRAFFIC = BENCH.cell(CELL).traffic


def photo_like(h, w, seed):
    """A frame of the cell's traffic mix at another size."""
    generator = torch.Generator().manual_seed(seed)
    traffic = dict(TRAFFIC, height=h, width=w, pool_frames=1)
    return BENCH.load("inputs", TRAFFIC["input"]).make_pool(traffic, generator, CPU)[0]


def ramp():
    ys, xs = np.mgrid[0:48, 0:64]
    return torch.from_numpy(np.stack([xs * 3, ys * 5, np.full_like(xs, 77)], -1).astype(np.uint8))


def noise():
    return torch.from_numpy(np.random.default_rng(1).integers(0, 256, (90, 130, 3),
                                                              dtype=np.uint8))


def program(frame, s, iters):
    return vt.superpixel_slic(frame, s, iters, 20.0, "euclidean", device="cpu")


@pytest.mark.parametrize("shape,s,iters,seed", [
    ((48, 64), 6, 3, 1), ((48, 64), 10, 10, 2 ** 31 + 5), ((90, 130), 6, 10, 3),
    ((90, 130), 10, 3, 4), ((61, 47), 10, 10, 2 ** 40 + 1)])
def test_reference_equals_the_program_on_photo_like_frames(shape, s, iters, seed):
    frame = photo_like(*shape, seed)
    got = REF.reference(frame, s, iters, 20.0, "euclidean")
    assert got.dtype == torch.int32 and got.shape == shape
    assert torch.equal(got, program(frame, s, iters))


def test_reference_equals_the_program_where_the_early_exit_comes_first():
    mslic.iterations = 0
    want = program(ramp(), 6, 10)
    assert mslic.iterations < 10
    assert torch.equal(REF.reference(ramp(), 6, 10, 20.0, "euclidean"), want)


def test_reference_equals_the_program_where_the_connectivity_pass_merges_fragments():
    frame = noise()
    lab = colors.bgr2lab_u8_exact(frame)
    raw = mslic.slic_device(lab, 90, 130, 10, 10, 20.0)[0]
    fragments = int(REF.components(raw.to(torch.int64)).max()) + 1
    want = program(frame, 10, 10)
    assert fragments > 10 * (int(want.max()) + 1)  # thousands of fragments, ~200 regions
    assert torch.equal(REF.reference(frame, 10, 10, 20.0, "euclidean"), want)


def test_reference_lab_and_seeds_equal_the_ports():
    for mine, theirs in zip(REF.lab_tables(), colors._lab_tables()):
        assert np.array_equal(mine, theirs)
    every = torch.arange(1 << 24, dtype=torch.int64)
    bgr = torch.stack([every & 255, every >> 8 & 255, every >> 16], -1).to(torch.uint8)
    for chunk in bgr.split(1 << 21):
        assert torch.equal(REF.bgr_to_lab(chunk).to(torch.uint8),
                           colors.bgr2lab_u8_exact(chunk))
    lab = colors.bgr2lab_u8_exact(photo_like(37, 53, 9))
    x, y, color = REF.seeds(lab.to(torch.int64), 8)
    cx, cy, want = mslic._init_centers(lab.to(torch.float32), 37, 53, 8, 5, 7)
    assert torch.equal(x.float(), cx) and torch.equal(y.float(), cy)
    assert torch.equal(color.float(), want)


def test_components_are_numbered_by_their_first_pixel():
    labels = torch.tensor([[0, 0, 1, 1], [2, 0, 1, 0], [2, 2, 0, 0]])
    assert REF.components(labels).tolist() == [[0, 0, 1, 1], [2, 0, 1, 3], [2, 2, 3, 3]]


def test_reference_takes_the_euclidean_metric_only():
    frame = photo_like(20, 20, 0)
    for metric in ("ciede2000", "ciede2000_ref"):
        with pytest.raises(ValueError, match="euclidean"):
            REF.reference(frame, 10, 3, 20.0, metric)


def test_bfloat16_reference_departs_from_float32():
    frame = photo_like(48, 64, 5)
    f32 = REF.reference(frame, 10, 10, 20.0, "euclidean")
    bf16 = REF.reference(frame, 10, 10, 20.0, "euclidean", dtype=torch.bfloat16)
    assert (f32 != bf16).any()


# ---------------------------------------------------------------------------
# correct, through the harness
# ---------------------------------------------------------------------------

def tiny() -> core.Cell:
    cell = BENCH.cell(CELL)
    return dataclasses.replace(cell, traffic=dict(
        cell.traffic, height=48, width=64, pool_frames=5, check_frames=4, warmup_calls=1))


def run(cell, seed, entry=None):
    return core.run_cell(BENCH, cell, seed, 0.0, False, CPU, time.perf_counter(),
                         entry=entry, least=6)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 2 ** 40 + 3])
def test_program_is_correct(seed):
    out = run(tiny(), seed)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_abs_diff"]["value"] == 0
    assert out["checks"]["calls_compared"]["value"] == 4


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 12])
def test_control_is_not_correct(seed):
    cell = tiny()
    out = run(cell, seed, entry=control.control_entry(BENCH, cell))
    assert not out["correct"]
    assert out["checks"]["max_abs_diff"]["value"] >= 1


def every_label_plus_one(entry):
    return lambda frame, **kwargs: entry(frame, **kwargs) + 1


def one_label_changed(entry):
    def broken(frame, **kwargs):
        out = entry(frame, **kwargs)
        out[3, 5] += 1
        return out
    return broken


def connectivity_skipped(entry):
    """The k-means labels as they come, no connectivity pass."""
    def broken(frame, **kwargs):
        pass_through = mslic.enforce_connectivity
        mslic.enforce_connectivity = lambda labels, *args, **kw: np.asarray(labels, np.int32)
        try:
            return entry(frame, **kwargs)
        finally:
            mslic.enforce_connectivity = pass_through
    return broken


def a_row_short(entry):
    return lambda frame, **kwargs: entry(frame, **kwargs)[1:]


@pytest.mark.parametrize("fault", [every_label_plus_one, one_label_changed,
                                   connectivity_skipped, a_row_short])
def test_planted_fault_is_not_correct(fault):
    cell = tiny()
    out = run(cell, 5, entry=fault(core.resolve(cell.config["entry"])))
    assert not out["correct"], (fault.__name__, out["checks"])


# ---------------------------------------------------------------------------
# the work count
# ---------------------------------------------------------------------------

def test_count_equals_a_count_by_hand():
    """20 x 20 pixels, S = 10: 2 x 2 cells, seeds at 4 and 14 on each axis.
    Every pixel has both cells of an axis within two cells (40 pairs an
    axis); |p - 4| <= 10 holds for 15 pixels and |p - 14| <= 10 for 16 (31)."""
    kwargs = {"superpixel_size": 10, "num_iteration": 3, "color_scale": 20.0,
              "metric": "euclidean"}
    association = (4 * 40 * 40 + 16 * 31 * 31, 11 * 400 + (20 + 48) * 4)
    snap_keys = (10 * 400 + 12 * 4, 7 * 400 + (68 + 8) * 4)
    update = (6 * 4, (28 + 23 + 56) * 4)
    per = [association, snap_keys, update]
    assert BENCH.load("counts", "slic").kernel_work(10, 20, 20) == {
        "association": association, "snap_keys": snap_keys, "update": update}
    ops, nbytes = BENCH.load("counts", "slic").work(kwargs, 20, 20, 3)
    assert ops == 3 * sum(o for o, _ in per) == 77544
    assert nbytes == 3 * sum(b for _, b in per) + 8 * 400 == 27812


def test_count_at_4k_is_bound_by_bytes():
    cfg = BENCH.cell(CELL).config
    ops, nbytes = BENCH.load("counts", "slic").work(cfg["kwargs"], 2160, 3840, 3)
    peaks = BENCH.peaks()
    assert nbytes / peaks["hbm_bytes_per_s"] > ops / peaks["f32_ops_per_s"]
    with pytest.raises(ValueError, match="euclidean"):
        BENCH.load("counts", "slic").work(dict(cfg["kwargs"], metric="ciede2000"), 20, 20, 3)


# ---------------------------------------------------------------------------
# the metrics
# ---------------------------------------------------------------------------

def window(calls=2):
    return core.Window(calls, 0, 10, [5] * calls, [4] * calls, [5, 10][:calls], 0)


def record(profile, ops=0.0, nbytes=3.35e9):
    return core.Record(1.0, 100, ops, nbytes, BENCH.peaks(), window(), profile)


def profile(device, calls=2):
    return core.Profile(calls, 0, 10**9, device, [], 0)


def read(name, rec):
    return BENCH.load("metrics", name).read(rec)


def test_kmeans_roofline_reads_the_slic_kernels_alone():
    rec = record(profile([("void slic_association_kernel<Euclidean>", 0, 2_000_000),
                          ("void slic_update_kernel", 2_000_000, 4_000_000),
                          ("Memcpy DtoH (Device -> Pageable)", 4_000_000, 9_000_000)]))
    # 1 ms of bytes at the HBM peak over 2 ms a call of slic_ operations
    assert read("kernels.slic_kmeans_roofline", rec) == pytest.approx(50.0)
    assert read("kernels.slic_kmeans_roofline", record(None)) is None
    assert read("kernels.slic_kmeans_roofline",
                record(profile([("bilateral_kernel", 0, 10)]))) is None


def test_copies_read_the_memcpy_operations_alone():
    rec = record(profile([("Memcpy DtoH (Device -> Pageable)", 0, 3_000_000),
                          ("Memcpy HtoD (Pageable -> Device)", 3_000_000, 4_000_000),
                          ("Memcpy DtoD (Device -> Device)", 4_000_000, 9_000_000),
                          ("void slic_update_kernel", 9_000_000, 10_000_000)]))
    assert read("copies.ms_per_call", rec) == pytest.approx(2.0)
    assert read("copies.ms_per_call", record(None)) is None
    assert read("copies.ms_per_call", record(profile([]))) is None


def test_connectivity_reads_the_programs_counters(monkeypatch):
    metric = "slic.connectivity_ms_per_call"
    name = "various_image_processings_tpu_torch.models.slic"
    monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(connectivity_ns=9_000_000,
                                                                  connectivity_calls=3))
    assert read(metric, record(None)) == pytest.approx(3.0)
    monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(connectivity_ns=0,
                                                                  connectivity_calls=0))
    assert read(metric, record(None)) is None
    monkeypatch.setitem(sys.modules, name, types.SimpleNamespace())  # the parent's module
    assert read(metric, record(None)) is None
    monkeypatch.delitem(sys.modules, name)
    assert read(metric, record(None)) is None


def test_the_cell_reports_the_host_paced_family():
    names = [n for n, _ in BENCH.metrics(CELL, False)]
    assert names == ["small_frame_mpix_per_s", "small_frame_call_p95_ms", "setup_s"]
    traced = [n for n, _ in BENCH.metrics(CELL, True)]
    assert traced == ["ops.host_us_per_call", "cuda_wrappers.launches_per_call",
                      "device.idle_pct", "kernels.slic_kmeans_roofline", "copies.ms_per_call",
                      "slic.connectivity_ms_per_call"]
    cfg = json.loads((BENCH.checkout / "port_bench/configs/slic_s10_nitr10.json").read_text())
    assert cfg["kwargs"] == {"superpixel_size": 10, "num_iteration": 10, "color_scale": 20.0,
                             "metric": "euclidean"}
    assert cfg["max_abs_diff_limit"] == 0
