"""The metric arithmetic: a rate over the whole window, a p95 over every
call, the idle share as a union of device intervals, and a stall inside a
window moving both end-to-end metrics."""

import itertools
import random
import time

import numpy as np
import pytest
import torch

from port_bench import core

BENCH = core.Bench()
PEAKS = {"f32_ops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def read(name, record):
    return BENCH.load("metrics", name).read(record)


def record(window, profile=None, ops=0.0, nbytes=0.0, pixels=100):
    return core.Record(1.5, pixels, ops, nbytes, PEAKS, window, profile)


def window(latency_ns, host_ns=None, start=1000, launches=0):
    ends = list(itertools.accumulate(latency_ns, initial=start))[1:]
    return core.Window(len(latency_ns), start, ends[-1], list(latency_ns),
                       list(host_ns or latency_ns), ends, launches)


def profile(device, start, end, spans=(), calls=1):
    busy = sum(e - s for s, e in core.union([(s, e) for _, s, e in device], start, end))
    return core.Profile(calls, start, end, list(device), sorted(spans, key=lambda s: s[1]),
                        busy)


@pytest.mark.parametrize("n", [1, 2, 7, 20, 101, 1000])
def test_percentile_is_numpys_linear(n):
    rng = random.Random(n)
    values = [rng.random() for _ in range(n)]
    for q in (0, 50, 95, 99, 100):
        assert core.percentile(values, q) == pytest.approx(np.percentile(values, q), abs=1e-15)


@pytest.mark.parametrize("name", ["mpix_per_s", "short_call_mpix_per_s",
                                  "small_frame_mpix_per_s"])
def test_rate_is_over_the_whole_window(name):
    w = window([2_000_000] * 99 + [102_000_000])  # 99 calls of 2 ms, one of 102 ms
    assert w.seconds == pytest.approx(0.3)
    assert read(name, record(w, pixels=3_000_000)) == pytest.approx(100 * 3 / 0.3)


@pytest.mark.parametrize("name", ["call_p95_ms", "short_call_p95_ms", "small_frame_call_p95_ms"])
def test_p95_is_over_every_call(name):
    lat = [1_000_000] * 90 + [5_000_000] * 10  # the slowest 10% are 5 ms
    got = read(name, record(window(lat)))
    assert got == pytest.approx(np.percentile(lat, 95) / 1e6)
    assert got == pytest.approx(5.0)


def test_tenths_count_the_calls_completed_in_each():
    w = window([1_000] * 50 + [9_000] * 10 + [1_000] * 50)  # a slow stretch in the middle
    assert core.tenths(w) == [18, 19, 13, 2, 2, 3, 2, 12, 19, 20]


def test_setup_and_host_and_launches():
    w = window([3000, 5000], host_ns=[1000, 2000], launches=24)
    w.calls = 2
    rec = record(w)
    assert read("setup_s", rec) == 1.5
    assert read("ops.host_us_per_call", rec) == pytest.approx(1.5)
    assert read("cuda_wrappers.launches_per_call", rec) == 12


def test_stall_inside_a_window_moves_both_metrics():
    """A real closed loop on the CPU: calls of ~0.5 ms, and the same with a
    stretch of 20% of the calls taking 5 ms more."""
    def run(stall):
        calls = [0]

        def entry(frame):
            calls[0] += 1
            time.sleep(0.0055 if stall and 100 <= calls[0] < 140 else 0.0005)
            return frame

        frames = [torch.zeros(4, 4, 3, dtype=torch.uint8)]
        loop = core.Loop(entry, {}, frames, torch.device("cpu"), "no_such_package",
                         core.Reservoir(1, 0))
        w = loop.window(0.0, least=200)
        return record(w)

    calm, stalled = run(False), run(True)
    assert calm.window.calls == stalled.window.calls == 200
    assert read("mpix_per_s", stalled) < 0.7 * read("mpix_per_s", calm)
    assert read("call_p95_ms", stalled) > 3 * read("call_p95_ms", calm)


def test_union_and_gaps():
    busy = core.union([(5, 10), (8, 12), (20, 25), (0, 3), (24, 40)], 2, 30)
    assert busy == [(2, 3), (5, 12), (20, 30)]
    assert core.gaps(busy, 2, 30) == [(3, 5), (12, 20)]
    assert core.gaps([], 0, 7) == [(0, 7)]


def test_idle_share_is_one_minus_the_union():
    dev = [("k1", 100, 300), ("k2", 250, 400), ("k3", 700, 800), ("k4", 950, 1200)]
    p = profile(dev, 0, 1000)
    assert p.busy_ns == 300 + 100 + 50
    assert read("device.idle_pct", record(window([1]), p)) == pytest.approx(55.0)
    assert read("device.idle_pct", record(window([1]))) is None  # nothing to read


@pytest.mark.parametrize("name", ["kernels.call_roofline", "kernels.short_call_roofline"])
def test_roofline_over_every_device_operation(name):
    dev = [("a", 0, 400), ("b", 500, 700), ("memset", 800, 900)]  # 700 ns a call, 2 calls
    p = profile(dev, 0, 1000, calls=2)
    ops = 67e12 * 175e-9  # 175 ns at the f32 peak
    rec = record(window([1]), p, ops=ops, nbytes=1.0)
    assert read(name, rec) == pytest.approx(50.0)
    rec = record(window([1]), p, ops=1.0, nbytes=3.35e12 * 35e-9)  # bound by the bytes
    assert read(name, rec) == pytest.approx(10.0)
    assert read(name, record(window([1]), profile([], 0, 10))) is None


def test_breakdown_labels_gaps_by_the_open_span():
    dev = [("bf", 100, 400), ("bf", 600, 900)]
    spans = [("entry call", 0, 90), ("synchronize", 90, 450), ("entry call", 480, 590),
             ("synchronize", 590, 920)]
    out = core.breakdown(profile(dev, 0, 1000, spans, calls=2))
    assert out["device_ops"] == [["bf", 6e-7]]
    idle = dict(out["idle_gaps"])
    # gaps 0-100 (middle 50: the entry call), 400-600 (middle 500: the entry
    # call), 900-1000 (middle 950: between calls, the harness)
    assert idle["entry call: all 2 gaps"] == pytest.approx(3e-7)
    assert idle["harness: all 1 gaps"] == pytest.approx(1e-7)
    # then the longest gaps, each at its offset into the window
    assert out["idle_gaps"][2:] == [["entry call: the gap at 0.000400 ms", 2e-7],
                                    ["entry call: the gap at 0.000000 ms", 1e-7],
                                    ["harness: the gap at 0.000900 ms", 1e-7]]
    assert len(out["idle_gaps"]) <= core.TOP


def test_a_gap_in_a_synchronize_that_touches_the_entry_call_is_the_synchronize():
    spans = [("entry call", 0, 100), ("synchronize", 95, 400)]
    starts = [s for _, s, _ in spans]
    assert core.open_span(spans, starts, 97) == "synchronize"
    assert core.open_span(spans, starts, 50) == "entry call"
    assert core.open_span(spans, starts, 450) == "harness"


def traced_window():
    """Two calls on the host clock: 1000-1300 and 1400-1700, each 100 ns in
    the entry; one launch each."""
    return core.Window(2, 1000, 1700, [300, 300], [100, 100], [1300, 1700], 2)


TRACE_OFFSET = 50_000  # the trace's clock runs this far ahead of the host's


def trace_of(win, marks=2, syncs=None, ops=None, stretch=0):
    """A trace of ``traced_window``; ``stretch``: the trace's clock counts
    that many ns more than the host's over the window."""
    o = TRACE_OFFSET
    spans = [("mark", o + 900, o + 1000), ("synchronize", o + 1100, o + 1250),
             ("synchronize", o + 1500, o + 1650), ("mark", o + 1700 + stretch, o + 1750 + stretch)]
    spans = [s for s in spans if s[0] != "mark"] + [s for s in spans if s[0] == "mark"][:marks]
    if syncs is not None:
        spans = [s for s in spans if s[0] != "synchronize"] + spans[1:1 + syncs]
    device = [("spin", o, o + 800), ("bf", o + 1120, o + 1240), ("bf", o + 1520, o + 1600)]
    return sorted(spans, key=lambda s: s[1]), device[:ops]


def test_a_whole_trace_places_the_entry_calls_by_the_marks():
    win = traced_window()
    p, line = core.complete(*trace_of(win), win)
    assert p is not None, line
    assert (p.start_ns, p.end_ns) == (TRACE_OFFSET + 1000, TRACE_OFFSET + 1700)
    assert [d[0] for d in p.device] == ["bf", "bf"]  # the spin kernel is outside
    assert p.busy_ns == 200
    entry = [s for s in p.spans if s[0] == "entry call"]
    assert entry == [("entry call", TRACE_OFFSET + 1000, TRACE_OFFSET + 1100),
                     ("entry call", TRACE_OFFSET + 1400, TRACE_OFFSET + 1500)]
    # gaps 1000-1120 (in the first entry call), 1240-1520 (between the
    # calls: middle 1380), 1600-1700 (middle 1650, in the second synchronize)
    labels = dict(core.breakdown(p)["idle_gaps"])
    assert {k: round(v * 1e9) for k, v in labels.items() if ": all " in k} == {
        "entry call: all 1 gaps": 120, "harness: all 1 gaps": 280,
        "synchronize: all 1 gaps": 100}


def test_a_clock_that_runs_fast_stretches_the_entry_calls_with_it():
    win = traced_window()
    p, line = core.complete(*trace_of(win, stretch=70), win)  # 770 ns by the trace's clock
    assert p.end_ns == TRACE_OFFSET + 1770
    entry = [s for s in p.spans if s[0] == "entry call"]
    assert entry == [("entry call", TRACE_OFFSET + 1000, TRACE_OFFSET + 1110),
                     ("entry call", TRACE_OFFSET + 1440, TRACE_OFFSET + 1550)]
    assert "0.1 us longer" in line


@pytest.mark.parametrize("lack", [{"marks": 1}, {"marks": 0}, {"syncs": 1}, {"ops": 2}])
def test_a_trace_that_lacks_part_of_the_window_gives_no_profile(lack):
    win = traced_window()
    p, line = core.complete(*trace_of(win, **lack), win)
    assert p is None
    assert "marks" in line or "synchronizes" in line


def test_reservoir_is_uniform_and_seeded():
    def sample(seed, calls=1000, size=8):
        r = core.Reservoir(size, seed)
        for n in range(calls):
            r.offer(n, n)
        return [n for n, _ in r.items()]

    assert sample(3) == sample(3) and sample(3) != sample(4)
    assert len(sample(3)) == 8 and sample(3, calls=5) == [0, 1, 2, 3, 4]
    hits = np.zeros(10)
    for seed in range(2000):
        for n in sample(seed, calls=100, size=10):
            hits[n // 10] += 1
    assert hits.min() > 0.8 * hits.mean()  # each tenth of the window is sampled alike


def test_launch_count_reads_the_wrappers_counters():
    from various_image_processings_tpu_torch.ops.cuda import bilateral, bilateral_texture
    prefix = "various_image_processings_tpu_torch.ops.cuda"
    before = core.launch_count(prefix)
    bilateral.launches += 2
    bilateral_texture.guide_launches += 1
    try:
        assert core.launch_count(prefix) == before + 3
    finally:
        bilateral.launches -= 2
        bilateral_texture.guide_launches -= 1
