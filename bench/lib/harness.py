"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

    drv = Driver(cell, seed, device); drv.setup()     set-up ends here
    out = drv.window(seconds, traced)                 the measured window
    peak memory read; drv.release()                   the program's state freed
    drv.reference()                                   the reference's steps

The end-to-end metrics come from the host clock and the allocator; the
per-layer metrics from bench/metrics/<name>.py over the traced segment
(`--trace 1`).  `correct` is the comparison of bench/lib/compare.py
against the cell's limits.
"""
from __future__ import annotations

import sys
import time

import torch

from bench.lib import compare, spec
from bench.lib import trace as trace_lib

GIB = float(1 << 30)


def device_info(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": device.type, "kind": device.type, "count": 1,
            "memory_peak_bytes": peak}


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float = None) -> dict:
    """The result line's object for one run of `cell`.  t_start: the host
    clock at the process's start (perf_counter), where set-up begins."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    # fp32 products in fp32, the references' and the paper configuration's
    # precision (cuDNN's default is TF32); bf16 products are unaffected
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    out = drv.window(seconds, traced)
    print("window: host seconds of each epoch or scan group: "
          + " ".join(f"{s:.4f}" for s in out["unit_s"]), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    drv.release()
    verdict = compare.judge(compare.numbers(drv.program, drv.reference()),
                            cell.limits["limits"])

    metrics, dev = {}, device_info(device, peak)
    line = {"correct": verdict["correct"], "attempted": out["attempted"],
            "failed": out["failed"]}
    if traced:
        tr = out["trace"]
        ctx = {"trace": tr, "info": out["info"], "cell": cell}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print(f"traced segment: {tr.window_s:.4f} s on the device's clock, "
              f"{len(tr.device)} device events; after it "
              f"{out['info'].get('mfu_units')} units in "
              f"{out['info'].get('mfu_seconds', 0):.4f} s", file=sys.stderr)
        dev["busy_s"] = trace_lib.busy_s(tr)
        dev["window_s"] = tr.window_s
        line["breakdown"] = trace_lib.breakdown(tr)
    else:
        values = dict(out["end_to_end"], setup_s=setup_s,
                      peak_mem_gib=peak / GIB)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line["metrics"], line["device"] = metrics, dev
    line["checks"] = verdict["checks"]
    return line
