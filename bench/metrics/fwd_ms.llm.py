"""fwd_ms.llm: the median device ms of `forward` an eager step,
over the units no profiler recorded (bench/lib/marks.py)."""
from bench.lib.marks import phase_ms

read = phase_ms("forward", "eager")
