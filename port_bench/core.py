"""What every cell of the port's benchmark shares.

One run of one cell: make the frame pool on the device from the seed, warm
up the cell's one shape, call the entry in a closed loop for the window,
read the metrics, check a seeded sample of the window's outputs against the
plain reference, and print one JSON line.  Everything that belongs to one
configuration, traffic mix or metric is a file of its own, found by name:

    configs/<config>.json  the entry, its keyword arguments, the names of its
                           reference and work count, its check's limit (the
                           launch counters read are those under the entry's
                           package's ``ops.cuda``)
    traffic/<mix>.json     frame size, input generator, pool, loop, sample
    inputs/<name>.py       make_pool(traffic, generator, device)
    refs/<name>.py         reference(frame, dtype=torch.float32, **kwargs)
    counts/<name>.py       work(kwargs, height, width, channels) -> (ops, bytes)
    metrics/<name>.py      read(record) -> a number, or None: nothing to read

Host times are ``time.perf_counter_ns``; device times come from
``torch.profiler``'s trace, on its own clock, in the ``--trace 1`` run only.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import json
import math
import random
import resource
import shutil
import subprocess
import sys
import time
from bisect import bisect_right
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "various_image_processings_tpu")
# the profiled window's longest length and most calls: its events are read back in Python
PROFILE_SECONDS = 5.0
PROFILE_CALLS = 20000
PROFILE_TRIES = 5
COUNTERS = "{package}.ops.cuda"  # the modules whose ``*launches`` ints are the launch counters
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict


@dataclasses.dataclass
class Window:
    """One closed-loop window, on the host clock (ns)."""
    calls: int
    start_ns: int          # the first call
    end_ns: int            # the return of the last call's synchronize
    latency_ns: list       # each call: from the call to the return of its synchronize
    host_ns: list          # each call: from the call until the entry returns
    ends_ns: list          # each call: the return of its synchronize
    launches: int          # rise of the program's launch counters

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Profile:
    """The profiled window, on the profiler's clock (ns)."""
    calls: int
    start_ns: int
    end_ns: int
    device: list           # (name, start, end) of every device operation in the window
    spans: list            # (name, start, end) of the host's spans: "entry call", "synchronize"
    busy_ns: int           # the union of the device operations

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Record:
    """What a metric's reader reads."""
    setup_s: float
    pixels_per_call: int
    ops_per_call: float
    bytes_per_call: float
    peaks: dict
    window: Window          # profiler off
    profile: Profile | None  # the --trace 1 run's profiled window


class Bench:
    """The benchmark laid out in ``directory``, with BENCHMARK.json beside it."""

    def __init__(self, directory: Path = BENCH_DIR):
        self.dir = Path(directory).resolve()
        self.checkout = self.dir.parent
        self.spec = json.loads((self.checkout / "BENCHMARK.json").read_text())
        digest = hashlib.sha1(str(self.dir).encode()).hexdigest()[:8]
        self.package = "port_bench" if self.dir == BENCH_DIR else f"port_bench_{digest}"

    def load(self, kind: str, name: str):
        """The module ``<kind>/<name>.py``, loaded once."""
        path = self.dir / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
        module_name = f"{self.package}.{kind}.{name.replace('.', '_')}"
        if module_name not in sys.modules:
            spec = importlib.util.spec_from_file_location(module_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[module_name] = module
            try:
                spec.loader.exec_module(module)
            except BaseException:
                del sys.modules[module_name]
                raise
        return sys.modules[module_name]

    def cell(self, name: str) -> Cell:
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        config = next(c for c in self.spec["configs"] if c["name"] == work[name]["config"])
        return Cell(name, int(work[name]["chips"]),
                    json.loads((self.checkout / config["file"]).read_text()),
                    json.loads((self.dir / "traffic" / f"{work[name]['traffic']}.json")
                               .read_text()))

    def metrics(self, cell: str, trace: bool) -> list[tuple[str, str]]:
        """(name, unit) of the metrics a run of ``cell`` reports."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [(m["name"], m["unit"]) for m in group if cell in m.get("workloads", [cell])]

    def peaks(self) -> dict:
        return json.loads((self.dir / "peaks.json").read_text())


def resolve(dotted: str):
    """``package.module.attr`` → the attribute."""
    module, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def forbidden_modules() -> list[str]:
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def launch_count(prefix: str) -> int:
    """The sum of the program's launch counters: every module-level int
    whose name ends in ``launches``, in the loaded modules under ``prefix``."""
    total = 0
    for name, module in list(sys.modules.items()):
        if module is None or not (name == prefix or name.startswith(prefix + ".")):
            continue
        for attr, value in vars(module).items():
            if attr.endswith("launches") and type(value) is int:
                total += value
    return total


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, interpolated between the two
    nearest ranks (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def union(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of (start, end) intervals clipped to [lo, hi], merged and in order."""
    merged: list[list[int]] = []
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def gaps(busy, lo: int, hi: int) -> list[tuple[int, int]]:
    """The parts of [lo, hi] that the merged intervals ``busy`` leave free."""
    out, at = [], lo
    for start, end in busy:
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if hi > at:
        out.append((at, hi))
    return out


class Reservoir:
    """A uniform sample of ``size`` of the window's calls, drawn from the
    seed: call n's output takes a slot with chance size / (calls so far)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.seen = 0
        self.slots: dict[int, tuple[int, object]] = {}

    def offer(self, n: int, out) -> None:
        j = self.seen if self.seen < self.size else self.rng.randrange(self.seen + 1)
        if j < self.size:
            self.slots[j] = (n, out)
        self.seen += 1

    def items(self) -> list[tuple[int, object]]:
        return sorted(self.slots.values(), key=lambda item: item[0])


class Loop:
    """One caller with one frame in flight: call the entry on the next frame
    of the pool, wait for the result, call again."""

    def __init__(self, entry, kwargs: dict, frames, device: torch.device, counters: str,
                 sample: Reservoir):
        self.entry, self.kwargs, self.frames = entry, kwargs, frames
        self.cuda = device.type == "cuda"
        self.counters = counters
        self.sample = sample
        self.n = 0  # calls made so far, warm-up included: call n takes frame n mod pool
        # the marks' events; made on the card by their first record, in the warm-up
        self.events = [torch.cuda.Event() for _ in range(2)] if self.cuda else []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def marks(self) -> tuple:
        """Two callables, each a runtime call that a trace shows
        (``cudaEventRecord``): the window's ends, since the profiler adds
        synchronizes of its own."""
        if not self.cuda:
            return (lambda: None,) * 2
        return tuple(event.record for event in self.events)

    def warm_up(self, calls: int) -> None:
        """Run the cell's shape, holding as many outputs at once as the
        sample will, so the window allocates nothing new."""
        held = []
        for _ in range(calls):
            held.append(self.entry(self.frames[self.n % len(self.frames)], **self.kwargs))
            self.sync()
            self.n += 1
        del held
        for mark in self.marks():  # a mark in a window then costs the record alone
            mark()
        self.sync()

    def window(self, seconds: float, least: int = 0, most: int | None = None) -> Window:
        """Calls started within ``seconds`` of the first, at least ``least``
        and at most ``most`` of them, each waited for.  It opens on an idle
        device."""
        entry, kwargs, frames, pool = self.entry, self.kwargs, self.frames, len(self.frames)
        sync, offer, clock = self.sync, self.sample.offer, time.perf_counter_ns
        latency, host, ends, out = [], [], [], None
        gc.collect()
        launches = launch_count(self.counters)
        opening, closing = self.marks()
        gc.disable()
        try:
            sync()
            opening()
            start = clock()
            deadline = start + int(seconds * 1e9)
            done = start
            most = math.inf if most is None else most
            while (done < deadline or len(latency) < least) and len(latency) < most:
                t_call = clock()
                out = entry(frames[self.n % pool], **kwargs)
                t_ret = clock()
                sync()
                done = clock()
                latency.append(done - t_call)
                host.append(t_ret - t_call)
                ends.append(done)
                offer(self.n, out)
                self.n += 1
            closing()
            del out
        finally:
            gc.enable()
        return Window(len(latency), start, done, latency, host, ends,
                      launch_count(self.counters) - launches)

    def profiled_window(self, seconds: float) -> tuple[Profile, Window]:
        """The window under ``torch.profiler``, tracing the device alone: its
        operations and the runtime calls that wait for them and mark the
        window.  (The profiler's host side records every torch op, which
        halves the calls a second of a host-bound cell.)  The window runs
        between the marks that open and close it.  A trace can miss its
        first events, so a spin kernel opens it, and it is taken again, up to
        PROFILE_TRIES times, until ``complete`` finds it whole; else
        ``IncompleteTrace``.  The host's entry calls are placed on the
        trace's clock by the two marks.  On the CPU nothing is traced."""
        if not self.cuda:
            win = self.window(seconds)
            return Profile(win.calls, win.start_ns, win.end_ns, [], [], 0), win
        from torch.profiler import ProfilerActivity, profile

        for tries in range(1, PROFILE_TRIES + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1 << 20)
                win = self.window(seconds, most=PROFILE_CALLS)
            traced, line = complete(*read_trace(prof), win)
            print(f"[port_bench] trace {tries}: {line}", file=sys.stderr)
            if traced is not None:
                return traced, win
        raise IncompleteTrace(f"no whole trace in {PROFILE_TRIES} tries; the last: {line}")


class IncompleteTrace(RuntimeError):
    """The profiler's trace lacks part of the window: no per-layer metric."""


def complete(spans, device, win: Window):
    """(the Profile of a trace of ``win``, a line on it) if the trace holds
    both marks, a synchronize a call and as many device operations as the
    program counted launches; else (None, what it lacks).  ``spans`` and
    ``device`` are ``read_trace``'s."""
    marks = [s for s in spans if s[0] == "mark"]
    if len(marks) != 2:
        return None, f"{len(marks)} of 2 marks"
    start, end = marks[0][2], marks[1][1]
    device = [d for d in device if start <= d[1] < end]
    syncs = [s for s in spans if s[0] == "synchronize" and s[2] > start and s[1] < end]
    if len(syncs) != win.calls or len(device) < win.launches:
        return None, (f"{len(syncs)} synchronizes for {win.calls} calls, {len(device)} "
                      f"device operations for {win.launches} launches")
    # the host took win.start_ns just after the opening mark returned, and
    # win.end_ns just before the closing mark began: the two clocks' ticks
    # are matched there, and linearly between
    scale = (end - start) / max(1, win.end_ns - win.start_ns)

    def on_trace(t: int) -> int:
        return start + round((t - win.start_ns) * scale)

    entry = [("entry call", on_trace(done - lat), on_trace(done - lat + host))
             for lat, host, done in zip(win.latency_ns, win.host_ns, win.ends_ns)]
    busy = sum(e - s for s, e in union([(s, e) for _, s, e in device], start, end))
    line = (f"{len(device)} device operations, {len(syncs)} synchronizes, {win.calls} calls; "
            f"the window is {(end - start - win.end_ns + win.start_ns) / 1e3:.1f} us longer by "
            f"the trace's clock than by the host's")
    return Profile(win.calls, start, end, device, sorted(syncs + entry, key=lambda s: s[1]),
                   busy), line


def _ns(event, what: str) -> int:
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


SYNCHRONIZE = ("cudaDeviceSynchronize", "cuCtxSynchronize")
MARK = ("cudaEventRecord", "cuEventRecord")


def read_trace(prof):
    """(host spans, device operations) of a profile, each (name, start,
    end) in order.  The host spans are the runtime calls that wait
    ("synchronize") and mark the window ("mark"); the device operations are
    the kernels, copies and sets: every event on the device but an
    annotation."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, device = [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() == cuda:
            if not getattr(e, "is_user_annotation", lambda: False)():
                device.append((name, start, end))
        elif name in SYNCHRONIZE:
            spans.append(("synchronize", start, end))
        elif name.startswith(MARK):
            spans.append(("mark", start, end))
    spans.sort(key=lambda s: s[1])
    device.sort(key=lambda d: d[1])
    return spans, device


def open_span(spans, starts, t: int) -> str:
    """The name of the host span open at ``t`` ("synchronize" before
    "entry call", where the clocks make them touch), else "harness"."""
    i = bisect_right(starts, t) - 1
    found = [spans[j][0] for j in (i, i - 1) if j >= 0 and spans[j][1] <= t <= spans[j][2]]
    return "synchronize" if "synchronize" in found else (found[0] if found else "harness")


def breakdown(profile: Profile) -> dict:
    """The device operations that took most time, by name; the device's idle
    time by what the host was doing at a gap's middle (in the entry call, in
    its synchronize, or in the harness between them), in all and its longest
    gaps."""
    by_name: dict[str, int] = {}
    for name, start, end in profile.device:
        by_name[name] = by_name.get(name, 0) + end - start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = union([(s, e) for _, s, e in profile.device], profile.start_ns, profile.end_ns)
    starts = [s for _, s, _ in profile.spans]
    labelled = [(open_span(profile.spans, starts, (lo + hi) // 2), hi - lo, lo - profile.start_ns)
                for lo, hi in gaps(busy, profile.start_ns, profile.end_ns)]
    totals: dict[str, list[int]] = {}
    for label, ns, _ in labelled:
        totals.setdefault(label, [0, 0])
        totals[label][0] += ns
        totals[label][1] += 1
    idle = [[f"{label}: all {n} gaps", ns / 1e9]
            for label, (ns, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])]
    longest = sorted(labelled, key=lambda g: -g[1])[:TOP - len(idle)]
    idle += [[f"{label}: the gap at {at / 1e6:.6f} ms", ns / 1e9] for label, ns, at in longest]
    return {"device_ops": [[name, ns / 1e9] for name, ns in ops], "idle_gaps": idle}


def check(reference, kwargs: dict, frames, sample: Reservoir):
    """(largest |output − reference| over the sampled calls, calls compared,
    calls whose output's shape or dtype differs)."""
    worst, mismatched = 0.0, 0
    items = sample.items()
    for n, out in items:
        want = reference(frames[n % len(frames)], **kwargs)
        if out.shape != want.shape or out.dtype != want.dtype:
            mismatched += 1
            continue
        worst = max(worst, float((out.double() - want.double()).abs().max()))
    return worst, len(items), mismatched


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return "not read"
    try:
        out = subprocess.run([tool, "-i", "0", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"


def tenths(window: Window) -> list[int]:
    """Calls completed in each tenth of the window."""
    counts, span = [0] * 10, max(1, window.end_ns - window.start_ns)
    for end in window.ends_ns:
        counts[min(9, (end - window.start_ns) * 10 // span)] += 1
    return counts


def run_cell(bench: Bench, cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, entry=None, least: int = 0) -> dict:
    """One run of ``cell``; the result line as a dict.  ``t_process`` is the
    host clock (``time.perf_counter``) at the process's start.  ``entry``
    replaces the configuration's entry (the control, a planted fault), and
    the window then runs ``least`` calls at the least."""
    cfg, traffic = cell.config, cell.traffic
    if traffic["loop"] != "closed" or traffic["in_flight"] != 1:
        raise ValueError(f"{cell.name}: only a closed loop with one frame in flight is "
                         f"implemented, got {traffic['loop']!r} with {traffic['in_flight']}")
    entry = entry or resolve(cfg["entry"])
    kwargs = dict(cfg["kwargs"])
    generator = torch.Generator(device=device)
    generator.manual_seed(seed % 2 ** 64)
    pool = bench.load("inputs", traffic["input"]).make_pool(traffic, generator, device)
    frames = pool.unbind(0)
    sample = Reservoir(traffic["check_frames"], seed)
    counters = COUNTERS.format(package=cfg["entry"].partition(".")[0])
    loop = Loop(entry, kwargs, frames, device, counters, sample)
    loop.warm_up(max(traffic["warmup_calls"], traffic["check_frames"] + 2))
    setup_s = time.perf_counter() - t_process

    window = loop.window(seconds, least=least)
    profile = None
    if trace:
        profile, traced = loop.profiled_window(min(seconds, PROFILE_SECONDS))
        print(f"[port_bench] tracing overhead: {traced.calls / traced.seconds:.1f} calls/s "
              f"profiled against {window.calls / window.seconds:.1f} with the profiler off",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    height, width, channels = frames[0].shape
    ops, nbytes = bench.load("counts", cfg["count"]).work(kwargs, height, width, channels)
    record = Record(setup_s, height * width, float(ops), float(nbytes), bench.peaks(),
                    window, profile)
    metrics = {}
    for name, unit in bench.metrics(cell.name, trace):
        value = bench.load("metrics", name).read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    attempted = sample.seen  # every timed call, a retaken trace's too
    print(f"[port_bench] {cell.name}: {window.calls} calls in {window.seconds:.6f} s "
          f"with the profiler off ({', '.join(map(str, tenths(window)))} in each tenth); "
          f"set-up {setup_s:.6f} s; host peak "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB", file=sys.stderr)

    del loop, window, record  # the program's state: only the sampled outputs stay
    reference = bench.load("refs", cfg["reference"]).reference
    t_check = time.perf_counter()
    worst, compared, mismatched = check(reference, kwargs, frames, sample)
    print(f"[port_bench] the reference took {time.perf_counter() - t_check:.3f} s for "
          f"{compared} calls", file=sys.stderr)
    limit, need = cfg["max_abs_diff_limit"], min(traffic["check_frames"], attempted)
    checks = {"max_abs_diff": {"value": worst, "limit": limit},
              "calls_compared": {"value": compared, "least": need},
              "shape_mismatches": {"value": mismatched, "limit": 0}}
    correct = worst <= limit and compared >= need and mismatched == 0

    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics}
    if device.type == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": 1, "memory_peak_bytes": peak,
                            "power_limit": power_limit()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": None}
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_ns / 1e9
        result["device"]["window_s"] = profile.seconds
        result["breakdown"] = breakdown(profile)
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    dev = result["device"]
    print(f"[port_bench] device: {dev['kind']}, power limit {dev.get('power_limit')}, "
          f"peak {dev['memory_peak_bytes']} bytes", file=sys.stderr)
    for name, c in result["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c else f"at least {c['least']}"
        print(f"[port_bench] check {name}: {c['value']} ({bound})", file=sys.stderr)
    print(f"[port_bench] correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
