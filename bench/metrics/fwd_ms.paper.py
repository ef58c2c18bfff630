"""fwd_ms.paper: the median device ms of `forward` a graphed round,
over the units no profiler recorded (bench/lib/marks.py)."""
from bench.lib.marks import phase_ms

read = phase_ms("forward", "graph")
