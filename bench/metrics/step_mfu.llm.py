"""step_mfu.llm: model FLOPs of the traced rounds or steps over the traced
window, as a share of the peak (bench/lib/readers.py)."""
from bench.lib.readers import step_mfu as read  # noqa: F401
