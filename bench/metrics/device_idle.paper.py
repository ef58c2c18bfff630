"""device_idle.paper: the share of the traced window in which the device ran
nothing (bench/lib/readers.py)."""
from bench.lib.readers import device_idle as read  # noqa: F401
