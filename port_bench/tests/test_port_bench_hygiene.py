"""What a run leaves behind: nothing outside the checkout, no fixed paths."""

import os
import subprocess
import sys
import textwrap

from port_bench import core

RUN_TINY = textwrap.dedent("""
    import dataclasses, sys, time, torch
    sys.path.insert(0, {checkout!r})
    from port_bench import core
    bench = core.Bench()
    cell = bench.cell("btf_600x900")
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, height=12, width=16,
                                                  pool_frames=3, check_frames=2))
    for trace in (False, True):
        out = core.run_cell(bench, cell, 3, 0.05, trace, torch.device("cpu"), time.perf_counter())
        assert out["correct"], out
""")


def files_under(directory):
    return sorted(str(p.relative_to(directory)) for p in directory.rglob("*")
                  if "__pycache__" not in p.parts)


def test_a_traced_run_writes_nothing_outside_the_checkout(tmp_path):
    dirs = {name: tmp_path / name for name in ("cwd", "tmp", "home", "cache")}
    for d in dirs.values():
        d.mkdir()
    before = files_under(core.BENCH_DIR)
    env = dict(os.environ, TMPDIR=str(dirs["tmp"]), HOME=str(dirs["home"]),
               XDG_CACHE_HOME=str(dirs["cache"]))
    subprocess.run([sys.executable, "-c", RUN_TINY.format(checkout=str(core.BENCH_DIR.parent))],
                   cwd=dirs["cwd"], env=env, check=True, timeout=600, capture_output=True)
    for name in ("cwd", "home", "cache"):
        assert files_under(dirs[name]) == [], name
    # TMPDIR: at most the empty directory that importing torch.profiler makes
    assert [p for p in dirs["tmp"].rglob("*") if p.is_file()] == []
    assert files_under(core.BENCH_DIR) == before


def test_no_fixed_scratch_paths_in_the_harness():
    for path in core.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, path
