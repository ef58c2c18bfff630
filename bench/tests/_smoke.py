"""The cells at sizes a CPU test run can hold: every width cut, the same
code paths, the same limits files."""
from __future__ import annotations

from bench.lib import spec

PAPER = dict(conv_channels=[8, 16], d_bottleneck=16, dense_units=[64],
             dataset_size=512)
LLM = dict(d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
           vocab_size=512, vocab_size_padded=512)


def cell(name: str, **program) -> spec.Cell:
    c = spec.load_cell(name)
    prog = dict(c.config["program"])
    if c.traffic["driver"] == "paper_scheme":
        prog.update(PAPER, **program)
        traffic = dict(c.traffic, batch=16, eval_n=64)
    else:
        prog.update(LLM, inl=dict(prog["inl"], d_bottleneck=32), **program)
        traffic = dict(c.traffic, batch=2, seq=64, scan_steps=2)
    return c._replace(config=dict(c.config, program=prog), traffic=traffic)
