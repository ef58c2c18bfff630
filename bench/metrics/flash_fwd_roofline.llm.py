"""flash_fwd_roofline.llm: flash_attn_fwd's share of its roofline
(bench/lib/readers.py)."""
from bench.lib.readers import flash_fwd_roofline as read  # noqa: F401
