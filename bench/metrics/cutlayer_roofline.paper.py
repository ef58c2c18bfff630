"""cutlayer_roofline.paper: the cut-layer kernels' share of their bytes bound
(bench/lib/readers.py)."""
from bench.lib.readers import cutlayer_roofline as read  # noqa: F401
