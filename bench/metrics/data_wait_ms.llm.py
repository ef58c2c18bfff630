"""data_wait_ms.llm: host ms a step spent waiting on the prefetch
iterator (bench/lib/readers.py)."""
from bench.lib.readers import data_wait_ms as read  # noqa: F401
