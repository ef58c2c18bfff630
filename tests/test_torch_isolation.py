"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless asked for the CPU.

  * importing every repro_torch module in a fresh process leaves no jax*
    and no repro / repro.* module in sys.modules;
  * no source file under src/repro_torch imports jax or repro;
  * device=None means "cuda": without a card the entry points raise
    (the search's driver too);
  * a cluster worker (`python -m repro_torch.cluster.worker`) starts and
    registers without importing torch or jax, and the channel layer,
    the policies, the cluster protocol and the membership ladder import
    with neither in sys.modules (a respawn costs a process start, not a
    torch import).
"""
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import convert, search  # noqa: E402
from repro_torch.configs.paper_inl import SMOKE  # noqa: E402
from repro_torch.core import inl, schemes  # noqa: E402
from repro_torch.core.schemes import runner  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

SRC = Path(repro_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(SRC)], prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for m in ("repro_torch.kernels.inl_bottleneck",
              "repro_torch.serving.engine", "repro_torch.optim",
              "repro_torch.core.linkmodel",
              "repro_torch.core.schemes.runner", "repro_torch.core.wirefmt",
              "repro_torch.core.sl", "repro_torch.core.fl",
              "repro_torch.core.schemes.sl", "repro_torch.core.schemes.fl",
              "repro_torch.core.schemes.splitfed",
              "repro_torch.core.schemes.hybrid",
              "repro_torch.configs.base", "repro_torch.configs.zamba2_2_7b",
              "repro_torch.data.tokens", "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.ssm_scan", "repro_torch.models.attention",
              "repro_torch.models.ssm", "repro_torch.models.transformer",
              "repro_torch.models.zoo", "repro_torch.launch.steps",
              "repro_torch.launch.serve", "repro_torch.checkpoint",
              "repro_torch.search", "repro_torch.search.space",
              "repro_torch.search.pricing", "repro_torch.search.pareto",
              "repro_torch.search.driver", "repro_torch.transport.network",
              "repro_torch.transport.adaptive", "repro_torch.chaos",
              "repro_torch.cluster.supervisor",
              "repro_torch.cluster.transport", "repro_torch.serving.loadgen"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib')) or n == 'repro' or "
        "n.startswith('repro.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC.parent)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)\b",
                         re.MULTILINE)
    offenders = [str(p.relative_to(SRC)) for p in SRC.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert len(list(SRC.rglob("*.py"))) >= 20


def test_device_none_means_cuda_and_raises_without_a_card(monkeypatch):
    params, state = inl.init(SMOKE, 0, device="cpu")
    scheme = schemes.get("inl")
    st = {"params": params, "state": state}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    views = torch.zeros((SMOKE.num_clients, 1) + SMOKE.image_shape)
    calls = [
        lambda: inl.init(SMOKE, 0),
        lambda: inl.predict(params, state, views),
        lambda: scheme.init(SMOKE, 0),
        lambda: scheme.predict(st, views),
        lambda: scheme.predict_batched(st, views),
        lambda: ServingEngine(scheme, st, SMOKE),
        lambda: convert.inl_from_jax(params, {"encoders": {"bns": []}},
                                     SMOKE),
        lambda: runner.run_scheme("inl", views, torch.zeros(1), SMOKE,
                                  epochs=1),
        lambda: search.run_search([search.ConfigPoint("inl", "star(5)")],
                                  SMOKE, epochs=1, batch_size=1,
                                  log=lambda *a: None),
    ]
    for name in ("splitfed", "hybrid"):
        hyb = schemes.get(name)
        hst = hyb.init(SMOKE, 0, device="cpu")
        calls += [
            lambda h=hyb: h.init(SMOKE, 0),
            lambda h=hyb, s=hst: h.predict(s, views),
            lambda h=hyb, s=hst: h.predict_batched(s, views),
            lambda n=name: runner.run_scheme(n, views, torch.zeros(1), SMOKE,
                                             epochs=1),
        ]
    from repro_torch.launch import serve
    from repro_torch.transport import NetworkTransport
    tr = NetworkTransport(None, SMOKE)
    calls += [
        lambda: runner.run_scheme("inl", views, torch.zeros(1), SMOKE,
                                  epochs=1, transport=tr),
        lambda: ServingEngine(scheme, st, SMOKE, transport=tr,
                              speculative=True),
        lambda: serve.main(["--arch", "paper-inl", "--smoke"]),
    ]
    calls.append(lambda: convert.splitfed_from_jax(
        {"encoders": {"convs": [], "bns": []}}, {"encoders": {"bns": []}},
        SMOKE))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    tr.close()
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC.parent))


def test_channel_layer_imports_without_torch_or_jax():
    code = (
        "import sys\n"
        "import repro_torch.transport.channel, repro_torch.transport.policy\n"
        "import repro_torch.cluster.proto, repro_torch.cluster.membership\n"
        "from repro_torch.transport import TcpListener, RetryPolicy\n"
        "from repro_torch.cluster import HeartbeatMonitor, pack_msg\n"
        "print(repr(sorted(n for n in sys.modules if n.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'repro'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_worker_registers_without_importing_torch_or_jax():
    """The worker as the supervisor spawns it, under -X importtime: it
    prints its registration line, and no torch or jax module was
    imported on the way."""
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "repro_torch.cluster.worker", "--node", "m0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())
    try:
        info = json.loads(proc.stdout.readline())
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=30)
    assert info["node"] == "m0" and info["pid"] == proc.pid
    assert info["port"] > 0
    imported = [line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
                if line.startswith("import time:")]
    assert "repro_torch.cluster.worker" in imported or \
        "repro_torch.transport.channel" in imported, err[-2000:]
    heavy = [m for m in imported
             if m.split(".")[0] in ("torch", "jax", "jaxlib")]
    assert heavy == []
