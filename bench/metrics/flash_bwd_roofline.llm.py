"""flash_bwd_roofline.llm: the attention backward's share of its bound:
each `flash_attn_bwd` call's least time, 2.5 x 4 Dh FLOPs a kept (query,
key) pair and head at the bf16 peak (bench/roofline/zamba2.py), over the
device time of the `flash_bwd_*` kernels in the traced segment, read only
when the trace holds as many launches as the segment ran."""
from bench.lib import trace as trace_lib


def read(ctx):
    tr, plan = ctx["trace"], ctx["info"].get("flash_bwd_launches")
    if tr is None or not plan:
        return None
    n, seconds = trace_lib.kernel_time(tr, "flash_bwd_")
    if n != plan["calls"] * plan["launches_a_call"] or seconds <= 0:
        return None
    return 100.0 * plan["calls"] * plan["bound_s"] / seconds
