"""BENCHMARK.json against the rules it is held to, the files its names
lead to, and a cell added with new files only."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from bench.lib import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head|expan|experts_per|d_model|d_ff|bottleneck")


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word.split("/")
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (spec.ROOT / p).is_dir()


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = spec.ROOT / cfg["file"]
    assert path.parts[len(spec.ROOT.parts)] in BENCH["paths"]
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
        assert key in data.get("published", {})
    assert (spec.BENCH / "reference" / f"{data['reference']}.py").exists()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_metrics_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads")
            assert reports is None or w in reports


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_load(w):
    cell = spec.load_cell(w["name"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert set(cell.limits["limits"]) == {"loss", "grad", "change"}
    spec.driver(cell.traffic["driver"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_a_new_cell_takes_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix, its limits and
    a per-layer metric as new files plus BENCHMARK.json entries; its
    loader finds them all and no file it had is edited."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "paper-inl.inl-b32",
                               "config": "paper-inl", "traffic": "inl-b32",
                               "chips": 1, "why": "a smaller batch"})
    bench["per_layer"].append({
        "name": "rounds_traced.paper", "unit": "rounds", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "train_images_per_s", "workloads": ["paper-inl.inl-b32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((spec.BENCH / "traffic" / "inl-b64.json")
                         .read_text())
    (tmp_path / "bench/traffic/inl-b32.json").write_text(
        json.dumps(dict(traffic, batch=32)))
    shutil.copy(spec.BENCH / "workloads" / "paper-inl.inl-b64.json",
                tmp_path / "bench/workloads/paper-inl.inl-b32.json")
    (tmp_path / "bench/metrics/rounds_traced.paper.py").write_text(
        "def read(ctx):\n    return ctx['info'].get('units')\n")
    probe = (
        "import sys; sys.path.insert(0, '.')\n"
        "from bench.lib import spec\n"
        "c = spec.load_cell('paper-inl.inl-b32')\n"
        "assert c.traffic['batch'] == 32, c.traffic\n"
        "names = [m['name'] for m in c.per_layer]\n"
        "assert names == ['rounds_traced.paper'], names\n"
        "print(spec.metric_reader(names[0])({'info': {'units': 7}}))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7"
    helped = subprocess.run([sys.executable, "bench/run.py", "--help"],
                            cwd=tmp_path, capture_output=True, text=True,
                            timeout=120)
    assert helped.returncode == 0 and "--workload" in helped.stdout
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """No CUDA device here: the run exits non-zero and prints no line; in a
    directory of BENCHMARK.json and bench/ alone it does so too."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (spec.ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "bench/run.py", "--workload",
             "paper-inl.inl-b64", "--seed", str(2 ** 31 + 11),
             "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
