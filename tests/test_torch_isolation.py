"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless asked for the CPU.

  * importing every repro_torch module in a fresh process leaves no jax*
    and no repro / repro.* module in sys.modules;
  * no source file under src/repro_torch imports jax or repro;
  * device=None means "cuda": without a card the entry points raise
    (the search's driver too).
"""
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
              "repro_torch.search.driver"):
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
    calls.append(lambda: convert.splitfed_from_jax(
        {"encoders": {"convs": [], "bns": []}}, {"encoders": {"bns": []}},
        SMOKE))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
