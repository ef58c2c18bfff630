"""optim_ms.paper: the median device ms of `optimizer` a graphed round,
over the units no profiler recorded (bench/lib/marks.py)."""
from bench.lib.marks import phase_ms

read = phase_ms("optimizer", "graph")
