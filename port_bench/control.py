"""The readings that the limits of ``correct`` are set from.  The
benchmark's own runs do not run this.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 7,8,9 --seconds 2

For each seed of ``--seeds``, one run of the cell as the benchmark makes it,
with a short window; for each of ``--control-seeds``, one run with the plain
reference in the program's place, computed in the precision below the one
that the configuration states (bfloat16 for float32), through the same
window and the same check.  One JSON line a run, with the numbers compared.
All in one process, on the card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(CHECKOUT)
else:
    sys.path.insert(0, str(CHECKOUT))

import torch  # noqa: E402

from port_bench import core  # noqa: E402

LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


def control_entry(bench: core.Bench, cell: core.Cell):
    """The configuration's reference in the precision below its own."""
    reference = bench.load("refs", cell.config["reference"]).reference
    dtype = LOWER[cell.config["precision"]]

    def entry(frame, **kwargs):
        return reference(frame, dtype=dtype, **kwargs)
    return entry


def readings(bench: core.Bench, cell: core.Cell, seeds, control_seeds, seconds: float,
             device: torch.device):
    """Yield (side, seed, result) for the program's seeds, then the control's."""
    for seed in seeds:
        yield "program", seed, core.run_cell(bench, cell, seed, seconds, False, device,
                                             time.perf_counter())
    entry = control_entry(bench, cell)
    for seed in control_seeds:
        yield "control", seed, core.run_cell(bench, cell, seed, seconds, False, device,
                                             time.perf_counter(), entry=entry,
                                             least=cell.traffic["check_frames"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="", help="comma-separated")
    parser.add_argument("--control-seeds", default="", help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("[port_bench] no CUDA device", file=sys.stderr)
        return 2
    bench = core.Bench()
    cell = bench.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    device = torch.device("cuda", 0)
    for side, seed, result in readings(bench, cell, seeds, control_seeds, args.seconds,
                                       device):
        print(json.dumps({"workload": cell.name, "side": side, "seed": seed,
                          "correct": result["correct"], "checks": result["checks"],
                          "attempted": result["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
