"""What the per-layer metrics of the program's own phase marks read: the
samples `repro_torch.tracing` keeps, one a unit (an eager step, or one
replay of a graphed round), left out those a profiler recorded.

    phase_ms(phase, kind)   the median device ms of `phase` ("forward",
                            "backward", "optimizer") a unit of `kind`
                            ("graph": the paper cells' rounds, "eager":
                            the LLM cells' steps)
    alloc_retries(ctx)      the mean allocator retries an eager step

Each reads after the window, when nothing else runs, and returns None with
fewer than MIN_SAMPLES samples: a program without the marks (the module is
absent) has none.
"""
from __future__ import annotations

import importlib
import statistics

MIN_SAMPLES = 3


def unprofiled(kind: str) -> list:
    """The program's samples of `kind` that no profiler recorded."""
    try:
        tracing = importlib.import_module("repro_torch.tracing")
    except ImportError:
        return []
    return [s for s in tracing.samples()
            if s.kind == kind and not s.profiled]


def phase_ms(phase: str, kind: str):
    def read(ctx):
        got = [s.ms[phase] for s in unprofiled(kind)]
        return statistics.median(got) if len(got) >= MIN_SAMPLES else None
    read.__doc__ = (f"Median device ms of `{phase}` a unit of kind "
                    f"{kind!r}, over the unprofiled units.")
    return read


def alloc_retries(ctx):
    """Mean allocator retries an unprofiled eager step."""
    got = [s.alloc_retries for s in unprofiled("eager")
           if s.alloc_retries is not None]
    return statistics.fmean(got) if len(got) >= MIN_SAMPLES else None
