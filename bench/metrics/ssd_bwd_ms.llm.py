"""ssd_bwd_ms.llm: the median device ms a step of the SSD backward
recompute, the program's sub-mark "ssd_backward" summed over an eager
step, over the steps no profiler recorded (bench/lib/marks.py).  A
program without the sub-mark has no such samples: None."""
import statistics

from bench.lib.marks import MIN_SAMPLES, unprofiled


def read(ctx):
    got = [s.ms["ssd_backward"] for s in unprofiled("eager")
           if "ssd_backward" in s.ms]
    return statistics.median(got) if len(got) >= MIN_SAMPLES else None
