"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (BENCHMARK.json).  Without a
CUDA card, or with fewer cards than the cell asks for, it exits with code 2
and prints no result: it never falls back to the CPU.  Where the run loads
jax or the JAX package it exits with 3, and where no whole trace of the
profiled window was taken, with 4, each with no result.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(CHECKOUT)  # port_bench is imported as a package, not file by file
else:
    sys.path.insert(0, str(CHECKOUT))

import torch  # noqa: E402

from port_bench import core  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True, help="makes the frames")
    parser.add_argument("--seconds", type=float, required=True, help="the window's length")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0,
                        help="1: the per-layer metrics, from a profiled window")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = core.Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("[port_bench] no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"[port_bench] {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    try:
        result = core.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), T_PROCESS)
    except core.IncompleteTrace as e:
        print(f"[port_bench] {e}: no result", file=sys.stderr)
        return 4
    found = core.forbidden_modules()
    if found:
        print(f"[port_bench] the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    core.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
