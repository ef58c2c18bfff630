"""A run with the timed path broken underneath comes out `correct` false,
against each cell's own limits: the harness driven on the CPU at smoke
size (its look for a chip skipped), once for each fault a training cell
can have on one chip: a step that returns its state unchanged, and half of
the batch left out with the mean taken over the rest.  The control (the
plain reference one precision below the configuration's) fails the
limits too."""
import pytest
import torch

from bench.lib import compare, harness, spec
from bench.tests import _smoke

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _run(name):
    torch.set_num_threads(2)
    return harness.run_cell(_smoke.cell(name), seed=2 ** 32 + 9,
                            seconds=0.1, traced=False, device="cpu")


@pytest.fixture
def unchanged_state(monkeypatch):
    from repro_torch import optim
    adamw = optim.adamw

    def frozen(*args, **kw):
        opt = adamw(*args, **kw)
        return optim.Optimizer(opt.init,
                               lambda grads, state, params, **_: (params,
                                                                  state))
    monkeypatch.setattr(optim, "adamw", frozen)


@pytest.fixture
def half_batch(monkeypatch):
    from repro_torch.core import inl_llm, losses
    inl_loss, xent, ce = losses.inl_loss, losses.xent, inl_llm._chunked_inl_ce

    def half_inl(joint, branch, labels, mus, logvars, us, **kw):
        h = labels.shape[0] // 2
        kw["rates"] = [r[:h] for r in kw["rates"]]
        return inl_loss(joint[:h], [b[:h] for b in branch], labels[:h],
                        [m[:h] for m in mus], [v[:h] for v in logvars],
                        [u[:h] for u in us], **kw)

    def half_xent(logits, labels):
        h = labels.shape[0] // 2
        return xent(logits[:h], labels[:h])

    def half_ce(params, cfg, h, u, labels, chunk=512):
        lab = labels.clone().reshape(-1)
        lab[lab.numel() // 2:] = -1
        return ce(params, cfg, h, u, lab.reshape(labels.shape), chunk)
    monkeypatch.setattr(losses, "inl_loss", half_inl)
    monkeypatch.setattr(losses, "xent", half_xent)
    monkeypatch.setattr(inl_llm, "_chunked_inl_ce", half_ce)


@pytest.mark.parametrize("name", CELLS)
def test_unchanged_state_is_not_correct(name, unchanged_state):
    line = _run(name)
    assert line["correct"] is False
    assert line["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_is_not_correct(name, half_batch):
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_line(name):
    line = _run(name)
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"loss", "grad", "change"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in
                                    spec.load_cell(name).end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    torch.set_num_threads(2)
    cell = _smoke.cell(name)
    drv = spec.driver(cell.traffic["driver"]).Driver(cell, 2 ** 31 + 5,
                                                     "cpu")
    drv.setup()
    drv.release()
    prog = cell.config["program"]
    low = "fp8" if prog.get("dtype") == "bfloat16" else "tf32"
    got = compare.numbers(drv.reference(prec=low), drv.reference())
    assert compare.judge(got, cell.limits["limits"])["correct"] is False
