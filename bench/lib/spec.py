"""What a cell is, read from data: BENCHMARK.json at the checkout's root
names each cell's configuration and traffic mix; the files beside this
package hold the rest, found by those names.

    bench/configs/<config>.json     the configuration as it is run
    bench/traffic/<traffic>.json    the traffic mix: its driver and sizes
    bench/workloads/<cell>.json     the cell's correctness limits and the
                                    readings they were set from
    bench/metrics/<metric>.py       one reader per per-layer metric
    bench/drivers/<driver>.py       one module per kind of timed entry
    bench/reference/<module>.py     the plain reference a config names

A later cell or metric adds files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files; KeyError if the
    benchmark has no such cell."""
    bench = load_benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(w['name'] for w in bench['workloads'])}")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(
        name=name,
        config=_read_json(root / config["file"]),
        traffic=_read_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=_read_json(BENCH / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def driver(name: str):
    """bench/drivers/<name>.py as a module."""
    return importlib.import_module(f"bench.drivers.{name}")


def reference(name: str):
    """bench/reference/<name>.py as a module."""
    return importlib.import_module(f"bench.reference.{name}")


def metric_reader(name: str):
    """The `read(ctx)` function of bench/metrics/<name>.py.  Metric names
    hold dots, so the file is loaded by its path, not imported."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
