"""The plain references against the port at smoke sizes on the CPU, both
in fp32: the first three steps of every cell through its driver (the
timed call and feed), compared by the numbers that decide `correct`.
The references import nothing of the port; these tests may."""
import ast
from pathlib import Path

import pytest
import torch

from bench.lib import compare, spec
from bench.tests import _smoke

# fp32 against fp32, the same operations in another order: round-off, and
# Adam's first steps amplify it in elements whose gradient is near nought
BARS = {"loss": 1e-5, "grad": 1e-4, "change": 1e-2}


def _readings(name, seed, **program):
    cell = _smoke.cell(name, **program)
    drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, "cpu")
    drv.setup()
    drv.release()
    return drv, compare.numbers(drv.program, drv.reference())


@pytest.mark.parametrize("name", ["paper-inl.inl-b64", "paper-inl.fl-b64"])
@pytest.mark.parametrize("seed", [7, 2 ** 33 + 1])
def test_paper_reference_matches_port(name, seed):
    torch.set_num_threads(2)
    _, got = _readings(name, seed)
    for k, bar in BARS.items():
        assert got[k] < bar, (k, got)


@pytest.mark.parametrize("name", ["inl-starcoder2-3b.train-4k",
                                  "inl-starcoder2-3b.train-512"])
def test_llm_reference_matches_port_fp32(name):
    torch.set_num_threads(2)
    _, got = _readings(name, 2 ** 31 + 3, dtype="float32")
    for k, bar in BARS.items():
        assert got[k] < bar, (k, got)


def test_llm_reference_bf16_program_is_close():
    """The cell's own bf16 program against the fp32 reference: within bf16's
    reach, far from a wrong step."""
    torch.set_num_threads(2)
    _, got = _readings("inl-starcoder2-3b.train-4k", 5)
    assert got["loss"] < 1e-2 and got["grad"] < 5e-2 and got["change"] < 0.1


def test_references_import_nothing_of_the_program():
    for path in (spec.BENCH / "reference").glob("*.py"):
        tree = ast.parse(Path(path).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "jaxlib", "flax"), (path, n)
