"""The readings that a cell's correctness limits are set from, on the chip
at the cell's own size.

    python3 bench/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        [--extra-seeds 3]

For each seed, in one process: the cell's set-up (the program's first
three steps through the timed call and feed, as bench/run.py drives them;
no window), then the plain reference, and the numbers compared between
them: the program's readings, which set a limit's lower end.  On the
first --extra-seeds seeds also the control, the reference one precision
below the one the configuration states (TF32 for the paper's fp32, fp8
for bf16; see bench/reference/lowp.py) against the fp32 reference, and the
fault that leaves out half of the batch, planted in the reference.  Their
readings set the upper end (steps 2-4 of the rules in PERF.md).  A state
left unchanged reads 1 on the change and needs no run.  One JSON line a
seed and kind; the harness never runs this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

LOWER = {"float32": "tf32", "fp32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--extra-seeds", type=int, default=3,
                    help="run the control and the fault on the first N seeds")
    args = ap.parse_args(argv)
    import torch
    from bench.lib import compare, spec
    cell = spec.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = cell.config["program"]
    low = LOWER[prog.get("dtype", prog.get("compute_dtype"))]
    for i, seed in enumerate(args.seeds):
        extra = i < args.extra_seeds
        t = time.perf_counter()
        drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, "cuda")
        drv.setup()
        drv.release()
        ref = drv.reference()
        runs = [("program", drv.program)]
        if extra:
            runs += [(f"control_{low}", drv.reference(prec=low)),
                     ("half_batch", drv.reference(half=True))]
        for kind, got in runs:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind,
                              "numbers": compare.numbers(got, ref),
                              "losses": got["losses"],
                              "ref_losses": ref["losses"]}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr)
        del drv, ref, runs
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
