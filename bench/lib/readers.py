"""What the per-layer metrics read from a traced segment.  Each
bench/metrics/<name>.py calls one of these with the run's context:

    ctx["trace"]  the segment's `trace.Trace`
    ctx["info"]   the driver's account of the window and the segment:
                  "mfu_units" and "mfu_seconds" (the rounds or steps run
                  after the segment and their host time), "unit_flops"
                  (model FLOPs of one), "flops_peak", "cut_launches" ({kernel: [(rows, d, bytes
                  an activation, mode, launches)]}), "flash_launches",
                  "flash_bound_s" (one launch's least time), "data_wait_s"

A reader that finds nothing to read returns None, and the metric is left
out of the line.  A share of a roofline or a peak is never clipped: one
above 100 means the FLOPs or bytes are counted too high or the time leaves
out part of the work.
"""
from __future__ import annotations

from bench import roofline
from bench.lib import trace as trace_lib


def device_idle(ctx):
    """% of the traced window in which no kernel, copy or set ran."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace_lib.busy_s(tr) / tr.window_s)


def step_mfu(ctx):
    """% of the peak: the model FLOPs of the window's rounds or steps after
    the traced segment, over their time on the host clock (the profiler
    slows an eager step at S=4096 twofold, so the traced window would halve
    it)."""
    info = ctx["info"]
    if not info.get("mfu_units") or info.get("mfu_seconds", 0) <= 0:
        return None
    flops = info["mfu_units"] * info["unit_flops"]
    return 100.0 * flops / info["mfu_seconds"] / info["flops_peak"]


def cutlayer_roofline(ctx):
    """% of the bytes bound: the traced cut_fwd and cut_bwd launches' least
    time at the HBM's bandwidth over their device time, when the trace
    holds as many launches as the segment ran."""
    tr, info = ctx["trace"], ctx["info"]
    plan = info.get("cut_launches") if tr is not None else None
    if not plan:
        return None
    n, seconds = trace_lib.kernel_time(tr, *plan)
    nbytes, want = 0, 0
    for kernel, launches in plan.items():
        count = roofline.cut_fwd_bytes if "fwd" in kernel \
            else roofline.cut_bwd_bytes
        for rows, d, act, mode, k in launches:
            nbytes += k * count(rows, d, act, mode)
            want += k
    if n != want or seconds <= 0:
        return None
    bound = nbytes / roofline.PEAKS["h100"]["hbm_bytes_per_s"]
    return 100.0 * bound / seconds


def flash_fwd_roofline(ctx):
    """% of the roofline: the traced flash_attn_fwd launches' least time
    (each the larger of its FLOPs at the bf16 peak and its bytes at the
    HBM's bandwidth) over their device time."""
    tr, info = ctx["trace"], ctx["info"]
    if tr is None or not info.get("flash_launches"):
        return None
    n, seconds = trace_lib.kernel_time(tr, "flash_fwd_mma_kernel",
                                       "flash_fwd_kernel")
    if n != info["flash_launches"] or seconds <= 0:
        return None
    return 100.0 * n * info["flash_bound_s"] / seconds


def data_wait_ms(ctx):
    """Host ms a step that the loop waited in next() on the prefetch
    iterator, over the whole window."""
    wait = ctx["info"].get("data_wait_s")
    return None if wait is None else 1e3 * wait
