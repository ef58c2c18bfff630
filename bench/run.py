"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: BENCHMARK.json there names the cell's
configuration and traffic mix, the files under bench/ hold the rest
(bench/lib/spec.py), and the program is the PyTorch port under src/.  The
run makes its data and weights from the seed, warms up, measures for
`--seconds` (whole epochs or scan groups, until that much has passed),
compares the first steps with the plain reference, and prints as its last
line of standard output one JSON object: correct, attempted, failed,
metrics (the end-to-end metrics, or with --trace 1 the per-layer ones),
device, with --trace 1 the breakdown, and last the numbers compared with
their limits, which also end standard error.  It exits non-zero, printing
no result, without as many CUDA devices as the cell asks for, or when a
module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The module names (default: those loaded) whose top-level part is one
    of FORBIDDEN, compared whole: `repro_torch` is not `repro`."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from bench.lib import harness, spec
    cell = spec.load_cell(args.workload)
    chips = {w["name"]: w["chips"]
             for w in spec.load_benchmark()["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                            traced=bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
