"""alloc_retries.llm: the allocator's retries an eager step, the mean over
the steps no profiler recorded (bench/lib/marks.py)."""
from bench.lib.marks import alloc_retries as read  # noqa: F401
