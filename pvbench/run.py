"""Run one cell of the benchmark once and print its result line.

    python3 -m pvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It sets up the cell's inputs from the seed,
warms up every shape, measures for --seconds, checks the outputs against
the plain reference and prints, as the last line of standard output, one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
breakdown, and last the numbers compared with their limits (also the last
lines of standard error).  Without a CUDA device, or with fewer than the
cell asks for, it exits 2 and prints no result; when the process holds a
JAX module once the window has closed, it exits 3.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    kernel library builds into build/pvot_torch/ on its own)."""
    cache = ROOT / "build" / "pvbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m pvbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    import torch

    from pvbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(args.workload, bench)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"pvbench: the cell needs {chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, bench, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0, out=lambda s: print(s, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"pvbench: the process holds {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
