"""The port's spans (``utils/profiling.py``'s ``SPANS``): the recorder on its
own, the spans each public entry records on the CPU path, and, on the card,
the kernel wrappers' spans of one BTF call against the launch counters.
Imports neither jax nor the JAX package."""

import itertools
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.utils import profiling  # noqa: E402
from various_image_processings_tpu_torch.utils.profiling import SPANS, SpanRecorder  # noqa: E402


@pytest.fixture
def ticks(monkeypatch):
    """The recorder's clock: 0, 10, 20, ... ns, one tick a reading."""
    monkeypatch.setattr(profiling, "perf_counter_ns", itertools.count(0, 10).__next__)


@pytest.fixture
def spans():
    """The port's recorder on; off and empty after the test."""
    SPANS.start(1 << 12)
    try:
        yield SPANS
    finally:
        SPANS.stop()
        SPANS.drain()


def image(h=20, w=24, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                                  dtype=np.uint8))


def hole(h=20, w=24):
    mask = np.zeros((h, w), np.uint8)
    mask[8:12, 9:14] = 255
    return mask


ENTRIES = {
    "bilateral_filter": lambda: vt.bilateral_filter(image(), 5),
    "joint_bilateral_filter": lambda: vt.joint_bilateral_filter(image(), image(seed=1), 5),
    "bilateral_texture_filter": lambda: vt.bilateral_texture_filter(image(), 3, 1),
    "adaptive_bilateral_filter": lambda: vt.adaptive_bilateral_filter(image(), 5),
    "gradient": lambda: vt.gradient(image()),
    "superpixel_slic": lambda: vt.superpixel_slic(image(), 6, 2),
    "inpainting_wexler": lambda: vt.inpainting_wexler(image(32, 32).numpy(), hole(32, 32),
                                                      multi_start=1, device="cpu"),
}


def boundary(n: int) -> None:
    """A boundary of the program's, ``n`` times."""
    for _ in range(n):
        s = SPANS.open("ops.validate") if SPANS.on else -1
        if s >= 0:
            SPANS.close(s)


def test_off_records_nothing_reads_no_clock_and_makes_no_object(monkeypatch):
    assert SpanRecorder().on is False and SPANS.on is False
    lists = (SPANS.names, SPANS.starts, SPANS.ends)

    def never(*args):
        raise AssertionError("a boundary of a recorder that is off went on")

    monkeypatch.setattr(profiling, "perf_counter_ns", never)
    monkeypatch.setattr(SpanRecorder, "open", never)
    for call in ENTRIES.values():
        call()
    assert SPANS.n == 0 and SPANS.dropped == 0
    assert (SPANS.names, SPANS.starts, SPANS.ends) == lists
    assert all(a is b for a, b in zip((SPANS.names, SPANS.starts, SPANS.ends), lists))
    boundary(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        boundary(10_000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename in (__file__, profiling.__file__) and d.size_diff > 0]
    assert grown == []


def test_nesting_parents_and_call_ids(ticks):
    r = SpanRecorder()
    r.start(16)
    root = r.open("ops.f")
    r.close(r.open("ops.validate"))
    wrapper = r.open("cuda_wrappers.k")
    r.close(r.open("enqueue.k"))
    r.close(wrapper)
    r.close(root)
    r.close(r.open("cuda_wrappers.k"))  # a launch of no entry's call: a call of its own
    r.close(r.open("ops.g"))
    r.stop()
    d = r.drain()
    assert d.names == ["ops.f", "ops.validate", "cuda_wrappers.k", "enqueue.k",
                       "cuda_wrappers.k", "ops.g"]
    assert d.parents == [-1, 0, 0, 2, -1, -1]
    assert d.calls == [0, 0, 0, 0, 1, 2]
    assert d.starts == [0, 10, 30, 40, 80, 100]
    assert d.ends == [70, 20, 60, 50, 90, 110]
    assert d.dropped == 0


def test_self_time_is_the_span_less_its_children(ticks):
    r = SpanRecorder()
    r.start(8)
    root = r.open("ops.f")
    r.close(r.open("ops.validate"))
    wrapper = r.open("cuda_wrappers.k")
    r.close(r.open("enqueue.k"))
    r.close(wrapper)
    r.close(root)
    d = r.drain()
    length = [e - s for s, e in zip(d.starts, d.ends)]
    children = [sum(length[j] for j, p in enumerate(d.parents) if p == i)
                for i in range(len(length))]
    assert length == [70, 10, 30, 10]
    assert [n - c for n, c in zip(length, children)] == [30, 10, 20, 10]


def test_spans_past_the_room_are_dropped_and_counted(ticks):
    r = SpanRecorder()
    r.start(3)
    opened = [r.open(f"s{i}") for i in range(5)]
    assert opened == [0, 1, 2, -1, -1]
    d = r.drain()
    assert d.names == ["s0", "s1", "s2"] and d.dropped == 2
    assert d.ends == [0, 0, 0]  # never closed
    r.close(r.open("t"))
    d = r.drain()
    assert d.names == ["t"] and d.dropped == 0 and d.parents == [-1]


def test_a_span_left_open_by_an_exception_is_closed_over_by_its_root(spans):
    with pytest.raises(ValueError, match="ksize"):
        vt.bilateral_filter(image(), 4)
    vt.gradient(image())
    d = spans.drain()
    assert d.names == ["ops.bilateral_filter", "ops.validate", "ops.gradient", "ops.validate"]
    assert d.parents == [-1, 0, -1, 2]
    assert d.ends[0] > 0 and d.ends[1] == 0  # the root closed, the validation did not
    assert d.calls[2] == d.calls[3] != d.calls[0]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_each_public_entry_records_its_root_and_validation(spans, entry):
    ENTRIES[entry]()
    d = spans.drain()
    assert d.names[0] == f"ops.{entry}" and d.parents[0] == -1
    assert d.names[1] == "ops.validate" and d.parents[1] == 0
    assert d.names.count(f"ops.{entry}") == 1 and d.dropped == 0
    assert not [n for n in d.names if n.startswith(("cuda_wrappers.", "enqueue."))]
    assert set(d.calls) == {d.calls[0]}  # every span of the call shares its id
    assert all(d.starts[0] <= s <= e <= d.ends[0] for s, e in zip(d.starts, d.ends))


def test_a_slic_call_records_its_host_pieces_and_counts_its_connectivity_pass(spans):
    """The download, the connectivity pass and the upload are spans inside
    ``ops.superpixel_slic``; the pass's counters rise by one call; the
    labels are those of a call with the recorder off."""
    from various_image_processings_tpu_torch.models import slic

    spans.stop()
    want = vt.superpixel_slic(image(), 6, 2)
    spans.start(1 << 12)
    calls, ns = slic.connectivity_calls, slic.connectivity_ns
    got = vt.superpixel_slic(image(), 6, 2)
    d = spans.drain()
    assert torch.equal(got, want)
    assert d.names == ["ops.superpixel_slic", "ops.validate", "models.slic.download",
                       "models.slic.connectivity", "models.slic.upload"]
    assert d.parents == [-1, 0, 0, 0, 0] and d.dropped == 0
    assert all(d.starts[0] <= s <= e <= d.ends[0] for s, e in zip(d.starts, d.ends))
    assert d.ends[2] <= d.starts[3] and d.ends[3] <= d.starts[4]  # in that order
    assert slic.connectivity_calls == calls + 1 and slic.connectivity_ns > ns


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def launch_counters() -> int:
    from various_image_processings_tpu_torch.ops.cuda import bilateral as kbf
    from various_image_processings_tpu_torch.ops.cuda import bilateral_texture as kbt
    from various_image_processings_tpu_torch.ops.cuda import gradient as kgr
    return kbf.launches + kbt.blur_rtv_launches + kbt.guide_launches + kgr.launches


@pytest.mark.cuda
def test_a_btf_call_on_the_card_records_its_launches(cuda, spans):
    """The call's 12 kernels go in through one wrapper and one ctypes call:
    ``cuda_wrappers.btf`` around ``enqueue.btf``, while the launch counters
    still rise by 12."""
    from various_image_processings_tpu_torch.ops.cuda import bilateral_texture as kbt

    img = image(600, 900).to(cuda)
    vt.bilateral_texture_filter(img, 9, 3)  # the library is built and the tables cached
    torch.cuda.synchronize()
    spans.drain()
    before, calls = launch_counters(), kbt.single_calls
    vt.bilateral_texture_filter(img, 9, 3)
    torch.cuda.synchronize()
    d = spans.drain()
    assert d.dropped == 0
    assert launch_counters() - before == 12 and kbt.single_calls == calls + 1
    assert d.names == ["ops.bilateral_texture_filter", "ops.validate", "ops.tables",
                       "cuda_wrappers.btf", "enqueue.btf"]
    assert d.parents == [-1, 0, 0, 0, 3]
    assert set(d.calls) == {d.calls[0]}
    assert all(d.starts[0] <= s <= e <= d.ends[0] for s, e in zip(d.starts, d.ends))
