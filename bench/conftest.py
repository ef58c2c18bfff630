"""pytest settings for the benchmark's own tests (bench/tests): the `card`
marker, and the checkout's root and src/ on the path.

    python -m pytest -q bench/tests               # on the CPU
    python -m pytest -q -m card bench/tests       # the card's tests, on the chip
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
