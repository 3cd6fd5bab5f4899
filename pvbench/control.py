"""The control of `correct`, and the planted faults, at a cell's own size.

    python3 -m pvbench.control --workload <cell> --seeds <n> [<n> ...] --seconds <s>
        [--fault stale_state|half_lanes|altered] [--float32]

puts the plain reference in the program's place (pvbench/reference/
programs.py): by default computed one precision below the configuration's
float32 (the correlation's operands rounded to TF32), which the check must
find not correct; with --float32 at the configuration's own precision, which
it must find correct; with --fault, the reference with that fault planted,
which it must find not correct.  Each seed runs the cell's own set-up, a
short window at the cell's own load and the cell's own check, and prints one
JSON line: the seed, `correct` and the numbers compared with their limits.
Not part of a benchmark run.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from pvbench import harness  # noqa: E402
from pvbench.reference import programs  # noqa: E402


def reference_program(cell, device, tf32: bool, fault=None):
    """The reference in the place of the cell's program: its driver's own."""
    drv = harness.load_module("drivers", cell.mix["driver"])
    return drv.reference_program(cell, device, tf32, fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m pvbench.control", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=programs.FAULTS, default=None)
    ap.add_argument("--float32", action="store_true",
                    help="the reference at the configuration's precision (a sound run)")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("pvbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(args.workload, bench)
    for seed in args.seeds:
        prog = reference_program(cell, device, tf32=not args.float32, fault=args.fault)
        t = time.perf_counter()
        r = harness.run_cell(cell, bench, seed, args.seconds, False, device, t, program=prog,
                             out=lambda s: print(s, flush=True))
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "precision": "float32" if args.float32 else "tf32",
                          "correct": r["correct"], "attempted": r["attempted"],
                          "seconds": time.perf_counter() - t, "checks": r["checks"]}),
              flush=True)
        del prog
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
