"""LLM training in the port against the JAX package, on the CPU: the loss
(`zoo.softmax_xent`, `chunked_xent`, `loss_and_metrics`), the stack's
train mode (aux sums, remat), the train steps (`launch/steps`:
`make_train_step` with microbatches, `make_scan_train_step`,
`default_optimizer`, `grouped_batches`, `stack_batches`).

The eight attention-block smoke configs in fp32, their weights from the
reference's `zoo.init_params` through `convert.zoo_from_jax`
(`_torch_common.zoo_weights`).  Bars:
  * the cross entropies within rtol 1e-6 (fp32 log-softmax, other sum
    orders);
  * `loss_and_metrics`' loss within rtol 1e-5 and every gradient leaf
    within GRAD_TOL = 2e-5 of the leaf's largest |gradient| of
    `jax.value_and_grad(zoo.loss_and_metrics)` (measured: the loss within
    5e-7, the leaves within 2.9e-6: fp32 GEMMs, softmaxes and the MoE's
    scatters in other orders);
  * remat on and off give the same gradients bit for bit (the recompute
    repeats the forward exactly on the CPU);
  * the reference's `test_train_step_no_nan` per architecture and
    `test_microbatched_step_matches_full` (its < 2e-5);
  * `make_scan_train_step` over K = 3 == three `make_train_step` calls bit
    for bit;
  * three `default_optimizer` steps against the reference's: the losses,
    cross entropies and gradient norms (and DeepSeek's aux losses) at rtol
    1e-4.
The recurrent blocks' train mode (mamba2, mLSTM, sLSTM) and the scheme
"inl" of `make_scan_train_step` run here; their parity with the reference
is in tests/test_torch_recurrent_train.py and tests/test_torch_inl_llm.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import flat, zoo_weights  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import optim, tree_leaves, tree_map  # noqa: E402
from repro_torch import value_and_grad  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

ARCHS = ("llama3.2-1b", "qwen1.5-4b", "starcoder2-3b", "codeqwen1.5-7b",
         "arctic-480b", "deepseek-v2-236b", "musicgen-medium",
         "internvl2-2b")
GRAD_TOL = 2e-5
XENT_TOL = dict(rtol=1e-6, atol=0)
B, S, PATCHES = 2, 32, 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch):
    return (dataclasses.replace(jax_get_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def np_batch(cfg, batch=B, seq=S, seed=0):
    """A train batch of cfg's modality as numpy arrays: next-token labels
    of a token stream (-1 at the last position); an audio model's K
    codebooks; the VLM's seeded N(0, 1) patches before the text, their
    labels ignored."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio_tokens":
        shape = (batch, seq + 1, cfg.num_codebooks)
        toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
        return {"tokens_mc": toks[:, :-1], "labels": toks[:, 1:]}
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(
        np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)],
                            axis=1)
    if cfg.modality == "vlm":
        pe = rng.normal(size=(batch, PATCHES, cfg.d_model)).astype(np.float32)
        labels = np.concatenate([np.full((batch, PATCHES), -1, np.int32),
                                 labels[:, :seq - PATCHES]], axis=1)
        return {"patch_embeds": pe, "tokens": toks[:, :seq - PATCHES],
                "labels": labels}
    return {"tokens": toks, "labels": labels}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def weights(arch):
    """(numpy params, port params) of arch's fp32 smoke config, made once a
    module: every step here is functional, so no test changes them."""
    return zoo_weights(*cfgs(arch))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, jax cfg, port cfg, numpy params, port params), fp32 smoke."""
    return (request.param, *cfgs(request.param), *weights(request.param))


# ---------------------------------------------------------------------------
# The cross entropies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 9, 37), (2, 9, 4, 37)],
                         ids=["text", "audio"])
def test_softmax_xent_matches_reference(shape):
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=shape)).astype(np.float32)
    labels = rng.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    labels[0, :3] = -1                              # ignored
    want = jzoo.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = zoo.softmax_xent(torch.from_numpy(logits),
                           torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(got), float(want), **XENT_TOL)
    none = np.full(shape[:-1], -1, np.int32)        # nothing counted: 0
    assert float(zoo.softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("arch,chunk", [("llama3.2-1b", 7),
                                        ("llama3.2-1b", 512),
                                        ("musicgen-medium", 6),
                                        ("starcoder2-3b", 5)])
def test_chunked_xent_matches_reference(arch, chunk):
    """The value and its gradient with respect to h, at a chunk that does
    not divide S (7, 6, 5 of 20) and one that holds S whole; tied
    embeddings (Llama), an untied unembedding (StarCoder2), MusicGen's K
    heads with (B, S, K) labels."""
    jcfg, cfg = cfgs(arch)
    jp, tp = weights(arch)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    lab_shape = (2, 20) + ((cfg.num_codebooks,)
                           if cfg.modality == "audio_tokens" else ())
    labels = rng.integers(0, cfg.vocab_size, size=lab_shape).astype(np.int32)
    labels[1, 4:9] = -1
    want, jgrad = jax.value_and_grad(
        lambda h: jzoo.chunked_xent(jp, jcfg, h, jnp.asarray(labels),
                                    chunk=chunk))(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    got = zoo.chunked_xent(tp, cfg, th, torch.from_numpy(labels).long(),
                           chunk=chunk)
    (tgrad,) = torch.autograd.grad(got, th)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jg = np.asarray(jgrad)
    assert np.abs(tgrad.numpy() - jg).max() <= GRAD_TOL * np.abs(jg).max()
    # the same loss whole, as softmax_xent of the full logits
    with torch.no_grad():
        full = zoo._project_out(tp, cfg, th)
        np.testing.assert_allclose(
            float(zoo.softmax_xent(full, torch.from_numpy(labels).long())),
            float(got.detach()), rtol=1e-5)


# ---------------------------------------------------------------------------
# The loss and its gradients, each architecture
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_reference(model):
    arch, jcfg, cfg, jp, tp = model
    batch = np_batch(cfg)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_and_metrics(p, jcfg, b), has_aux=True))(
        jp, to_jax(batch))
    loss, metrics, grads = value_and_grad(
        lambda p: zoo.loss_and_metrics(p, cfg, to_torch(batch)), tp)
    assert metrics.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flat(jax.tree.map(np.asarray, jg))
    got = flat(tree_map(lambda t: t.numpy(), grads))
    assert want.keys() == got.keys()
    for path, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[path] - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (arch, path, err)


def test_forward_returns_the_aux_sum(model):
    """zoo.forward's third value is the blocks' aux sum, the one the loss
    reads; train mode builds no cache."""
    arch, jcfg, cfg, jp, tp = model
    batch = np_batch(cfg)
    jaux = jax.jit(lambda p, b: jzoo.forward(p, jcfg, b, mode="train")[2])(
        jp, to_jax(batch))
    with torch.no_grad():
        logits, cache, aux = zoo.forward(tp, cfg, to_torch(batch),
                                         mode="train")
    assert cache is None and aux.keys() == jaux.keys()
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert (float(aux["lb_loss"]) > 0) == cfg.is_moe


def test_train_step_no_nan(model):
    """The port's counterpart of the reference's test_train_step_no_nan:
    one AdamW step, loss and grad_norm finite, the parameters moved."""
    arch, jcfg, cfg, jp, tp = model
    opt = optim.adamw(1e-3)
    new, _, metrics = steps.make_train_step(cfg, opt)(
        tp, opt.init(tp), to_torch(np_batch(cfg, seed=1)))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(tp), tree_leaves(new)))
    assert moved > 0.0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    _, cfg = cfgs(arch)
    params = zoo.init_params(cfg, 0, device="cpu")
    batch = to_torch(np_batch(cfg, seed=2))
    got = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, grads = value_and_grad(
            lambda p: zoo.loss_and_metrics(p, c, batch), params)
        got.append((loss, tree_leaves(grads)))
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))


# ---------------------------------------------------------------------------
# The train steps
# ---------------------------------------------------------------------------

def test_microbatched_step_matches_full():
    """The reference's test_microbatched_step_matches_full: SGD, two
    microbatches of two against the batch of four, < 2e-5."""
    _, cfg = cfgs("llama3.2-1b")
    params = zoo.init_params(cfg, 0, device="cpu")
    opt = optim.sgd(1e-2)
    batch = to_torch(np_batch(cfg, batch=4, seq=32, seed=3))
    p1, _, m1 = steps.make_train_step(cfg, opt)(params, opt.init(params),
                                                batch)
    p2, _, m2 = steps.make_train_step(cfg, opt, microbatches=2)(
        params, opt.init(params), batch)
    diff = max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert diff < 2e-5
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(cfg, opt, microbatches=3)(
            params, opt.init(params), batch)


def test_scan_train_step_equals_single_steps():
    """K = 3 steps in one make_scan_train_step call == three
    make_train_step calls, bit for bit (params, AdamW state, metrics);
    the batches stacked on the host by grouped_batches / stack_batches."""
    _, cfg = cfgs("llama3.2-1b")
    params = zoo.init_params(cfg, 1, device="cpu")
    opt = steps.default_optimizer(cfg, total_steps=3)
    stream = [np_batch(cfg, seed=10 + i) for i in range(4)]
    groups = list(steps.grouped_batches(stream, 3))
    assert [len(g) for g in groups] == [3, 1]
    stacked = steps.stack_batches(groups[0])
    assert stacked["tokens"].shape == (3, B, S)
    p_scan, o_scan, m_scan = steps.make_scan_train_step(cfg, opt)(
        params, opt.init(params), to_torch(stacked))
    step = steps.make_train_step(cfg, opt)
    p, o, ms = params, opt.init(params), []
    for b in groups[0]:
        p, o, m = step(p, o, to_torch(b))
        ms.append(m)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves((p_scan, o_scan)), tree_leaves((p, o))))
    for k in m_scan:
        assert torch.equal(m_scan[k], torch.stack([m[k] for m in ms])), k
    # params and state the caller passed in are left as they were on the
    # CPU (the reference donates only on accelerators)
    assert all(t.numel() for t in tree_leaves(params))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b"])
def test_default_optimizer_trajectory_matches_reference(arch):
    jcfg, cfg = cfgs(arch)
    jp, tp = weights(arch)
    batches = [np_batch(cfg, seed=20 + i) for i in range(3)]
    jopt = jsteps.default_optimizer(jcfg, total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt))
    js, jm = jopt.init(jp), []
    for b in batches:
        jp, js, m = jstep(jp, js, to_jax(b))
        jm.append(m)
    opt = steps.default_optimizer(cfg, total_steps=3)
    step = steps.make_train_step(cfg, opt)
    ts, tm = opt.init(tp), []
    for b in batches:
        tp, ts, m = step(tp, ts, to_torch(b))
        tm.append(m)
    assert int(ts["step"]) == int(js["step"]) == 3
    for t, j in zip(tm, jm):
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-4,
                                       err_msg=k)
    assert isinstance(joptim.global_norm(jp), jax.Array)


# ---------------------------------------------------------------------------
# The recurrent blocks and the inl scheme
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_recurrent_blocks_train_with_finite_gradients(arch):
    """mamba2 (and the shared attention block), mLSTM and sLSTM in train
    mode: a finite loss, no cache, and a finite, non-zero gradient on
    every leaf of the recurrent blocks."""
    _, cfg = cfgs(arch)
    params = zoo.init_params(cfg, 0, device="cpu")
    batch = to_torch(np_batch(cfg, seq=8))
    with torch.no_grad():
        _, cache, _ = zoo.forward(params, cfg, batch, mode="train")
    assert cache is None
    loss, _, grads = value_and_grad(
        lambda p: zoo.loss_and_metrics(p, cfg, batch), params)
    assert bool(torch.isfinite(loss))
    for kind, tree in zip(cfg.block_pattern, grads["stack"]["pattern"]):
        block = tree["mamba" if "mamba" in kind else kind]
        for g in tree_leaves(block):
            assert bool(torch.isfinite(g).all()), kind
            assert float(g.abs().max()) > 0.0, kind


def test_inl_scheme_scan_step_equals_single_inl_steps():
    """make_scan_train_step(scheme="inl") over K = 2 with a generator ==
    two make_inl_train_step calls drawing from a generator of the same
    seed, bit for bit (params, AdamW state, metrics); the standard scheme
    refuses draws."""
    from repro_torch.core import inl_llm
    _, cfg = cfgs("llama3.2-1b")
    cfg = dataclasses.replace(cfg, num_layers=2)
    params = inl_llm.init(cfg, 0, device="cpu")
    opt = optim.adamw(1e-3)
    stacked = steps.stack_batches([np_batch(cfg, seq=16, seed=30 + i)
                                   for i in range(2)])
    p_scan, o_scan, m_scan = steps.make_scan_train_step(
        cfg, opt, scheme="inl")(params, opt.init(params), to_torch(stacked),
                                torch.Generator().manual_seed(5))
    step = steps.make_inl_train_step(cfg, opt)
    gen = torch.Generator().manual_seed(5)
    p, o, ms = params, opt.init(params), []
    for i in range(2):
        p, o, m = step(p, o, to_torch({k: v[i] for k, v in stacked.items()}),
                       gen)
        ms.append(m)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves((p_scan, o_scan)), tree_leaves((p, o))))
    for k in m_scan:
        assert torch.equal(m_scan[k], torch.stack([m[k] for m in ms])), k
    assert bool(torch.isfinite(m_scan["loss"]).all())
    with pytest.raises(ValueError, match="draws nothing"):
        steps.make_scan_train_step(cfg, opt)(
            params, opt.init(params), to_torch(stacked),
            torch.Generator().manual_seed(5))
