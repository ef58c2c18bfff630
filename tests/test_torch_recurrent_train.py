"""The recurrent blocks' train mode in the port against the JAX package, on
the CPU: Mamba2 (Zamba2, through the SSD scan's autograd Function) and
xLSTM's mLSTM and sLSTM (through `ssm._scan_chunked_remat`).

The Zamba2 smoke config at num_layers=4 (two periods, the shared
attention block called twice) and the xLSTM smoke config, both fp32, at
B=2, S=64 with the SSM chunk cut to 32 in both packages, so that the SSD
scan runs two chunks and the xLSTM scans run two checkpointed chunks;
weights from the reference's `zoo.init_params` through
`convert.zoo_from_jax` (`_torch_common.zoo_weights`).  Bars:
  * `loss_and_metrics`' loss within rtol 1e-5 and every gradient leaf
    within GRAD_TOL = 2e-5 of the leaf's largest |gradient| of
    `jax.value_and_grad(zoo.loss_and_metrics)`, the attention blocks' bar
    (tests/test_torch_llm_train.py).  xLSTM keeps it: with XLA's fused
    mLSTM update (ROADMAP queue 3) its leaves part by at most 1.97e-6 of
    their largest here, Zamba2's by 4.3e-6 (measured), so the bar needs
    no widening;
  * the reference's `test_train_step_no_nan` for both;
  * remat on == off, bit for bit;
  * `_scan_chunked_remat` == the plain step loop bit for bit, forward and
    backward, in the chunked branch and in its fallbacks (a chunk that
    does not divide S, that equals S, that exceeds S); inside the stack's
    period checkpoint each level recomputes once (3 S cell calls a layer
    for a forward and backward, 2 S without the period checkpoint).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import flat, zoo_weights  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import optim, tree_leaves, tree_map  # noqa: E402
from repro_torch import value_and_grad  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import ssm, zoo  # noqa: E402

ARCHS = ("zamba2-2.7b", "xlstm-125m")
LAYERS = {"zamba2-2.7b": 4, "xlstm-125m": 2}
GRAD_TOL = 2e-5
B, S, CHUNK = 2, 64, 32


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(get, arch):
    cfg = get(arch)
    return dataclasses.replace(
        cfg, dtype="float32", num_layers=LAYERS[arch],
        ssm=dataclasses.replace(cfg.ssm, chunk_size=CHUNK))


def cfgs(arch):
    return smoke(jax_get_smoke, arch), smoke(get_smoke_config, arch)


@functools.lru_cache(maxsize=None)
def weights(arch):
    return zoo_weights(*cfgs(arch))


def np_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    return {"tokens": toks, "labels": labels}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, cfg = cfgs(arch)
    jp, tp = weights(arch)
    batch = np_batch(cfg)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_and_metrics(p, jcfg, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = value_and_grad(
        lambda p: zoo.loss_and_metrics(p, cfg, to_torch(batch)), tp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flat(jax.tree.map(np.asarray, jg))
    got = flat(tree_map(lambda t: t.numpy(), grads))
    assert want.keys() == got.keys()
    for path, w in want.items():
        err = np.abs(got[path] - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (arch, path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_no_nan(arch):
    """The port's counterpart of the reference's test_train_step_no_nan:
    one AdamW step, loss and grad_norm finite, the parameters moved."""
    _, cfg = cfgs(arch)
    _, tp = weights(arch)
    opt = optim.adamw(1e-3)
    new, _, metrics = steps.make_train_step(cfg, opt)(
        tp, opt.init(tp), to_torch(np_batch(cfg, seed=1)))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(tp), tree_leaves(new)))
    assert moved > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_gradients(arch):
    _, cfg = cfgs(arch)
    _, tp = weights(arch)
    batch = to_torch(np_batch(cfg, seed=2))
    got = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, grads = value_and_grad(
            lambda p: zoo.loss_and_metrics(p, c, batch), tp)
        got.append((loss, tree_leaves(grads)))
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))


def _toy_cell(carry, inp):
    """A nonlinear recurrence of the mLSTM's shape of call."""
    c, n = carry
    x, g = inp
    c = torch.sigmoid(g)[..., None] * c + torch.tanh(x)
    n = n + c.square().mean(dim=-1)
    return (c, n), c * torch.rsqrt(1.0 + n)[..., None]


@pytest.mark.parametrize("steps_n,chunk", [(12, 4), (12, 5), (12, 12),
                                           (12, 40)],
                         ids=["chunked", "ragged", "whole", "longer"])
def test_scan_chunked_remat_equals_the_plain_loop(steps_n, chunk):
    gen = torch.Generator().manual_seed(steps_n + chunk)
    x = torch.randn(3, steps_n, 5, generator=gen, requires_grad=True)
    g = torch.randn(3, steps_n, generator=gen, requires_grad=True)
    init = (torch.zeros(3, 5), torch.zeros(3))
    gy = torch.randn(3, steps_n, 5, generator=gen)
    outs = []
    for scan in (lambda: ssm._scan_steps(_toy_cell, init, (x, g)),
                 lambda: ssm._scan_chunked_remat(_toy_cell, init, (x, g),
                                                 steps_n, chunk)):
        (c, n), ys = scan()
        grads = torch.autograd.grad((ys, n), (x, g), (gy, torch.ones(3)))
        outs.append([c, n, ys, *grads])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat,calls", [(True, 3), (False, 2)])
def test_nested_checkpoints_recompute_once_a_level(monkeypatch, remat,
                                                   calls):
    """xLSTM's forward and backward: the cells run S times in the forward,
    S again in the period's recompute (remat on) and S again in the
    chunks' recompute."""
    _, cfg = cfgs("xlstm-125m")
    _, tp = weights("xlstm-125m")
    n = {"mlstm": 0, "slstm": 0}
    cells = {"mlstm": ssm._mlstm_cell, "slstm": ssm._slstm_cell}

    def counted(kind):
        def cell(*args):
            n[kind] += 1
            return cells[kind](*args)
        return cell
    monkeypatch.setattr(ssm, "_mlstm_cell", counted("mlstm"))
    monkeypatch.setattr(ssm, "_slstm_cell", counted("slstm"))
    c = dataclasses.replace(cfg, remat=remat)
    value_and_grad(lambda p: zoo.loss_and_metrics(
        p, c, to_torch(np_batch(cfg, seed=3))), tp)
    assert n == {"mlstm": calls * S, "slstm": calls * S}


def test_prefill_keeps_its_plain_loop():
    """The prefill's outputs and states are the train forward's values:
    one recurrence, two scans that agree bit for bit."""
    _, cfg = cfgs("xlstm-125m")
    _, tp = weights("xlstm-125m")
    bm = tree_map(lambda t: t[0], tp["stack"]["pattern"][0]["mlstm"])
    bs = tree_map(lambda t: t[0], tp["stack"]["pattern"][1]["slstm"])
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for apply, p in ((ssm.mlstm_apply, bm), (ssm.slstm_apply, bs)):
            y_pre, state = apply(p, cfg, x, mode="prefill")
            y_train, none = apply(p, cfg, x, mode="train")
            assert none is None and state is not None
            assert torch.equal(y_pre, y_train)
