"""ssd_scan_roofline.llm: the grouped `ssd_scan` launches' share of their
roofline: the calls' least time (each the larger of its FLOPs at the bf16
peak and its bytes at the HBM's bandwidth, bench/roofline/zamba2.py) over
the device time of their four kernels in the traced segment, read only
when the trace holds as many launches as the segment ran."""
from bench.lib import trace as trace_lib


def read(ctx):
    tr, plan = ctx["trace"], ctx["info"].get("ssd_launches")
    if tr is None or not plan:
        return None
    n, seconds = trace_lib.kernel_time(tr, *plan["kernels"])
    if n != plan["calls"] * plan["launches_a_call"] or seconds <= 0:
        return None
    return 100.0 * plan["calls"] * plan["bound_s"] / seconds
