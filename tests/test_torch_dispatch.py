"""One dispatch per round, per bucket and per token (repro_torch/graphs.py).

  * `run_scheme(dispatch="scan")` (the default) equals
    `dispatch="per_round"` for all six schemes, on the clean star and at
    erasure 0.3 an edge: the curve and both ledgers exactly, and
    `make_epoch` K rounds equal to K `make_round` calls bit for bit (the
    state and every round's loss), the counterpart of the reference's
    `test_epoch_scan_matches_per_round`;
  * the host part of each round names its CUDA-graph signature;
  * decode with `cache_len` as a 0-dim int64 tensor against the JAX decode
    step on the Zamba2 smoke model (num_layers=4), at the bars of
    tests/test_torch_zamba2.py (logits rtol 1e-4, atol 1e-5; caches 1e-5);
    `trace_log` stays empty on the CPU;
  * `splitfed.fedavg` (n computed on the device), `wirefmt.dyn_quantize`
    and `ref.quantize_value` (constants filled on the device) equal the
    host-constant formulas they replace, bit for bit;
  * the engine's `trace_counts` is keyed by its buckets, 0 on the CPU;
  * on the card only (skipped here): one INL round, one serving bucket and
    one decode step graphed against eager, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import cuda_device, flat, zamba2_weights  # noqa: E402,F401
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.configs.paper_inl import PaperExperimentConfig  # noqa: E402
from repro_torch.core import bandwidth, fl, linkfault, schemes  # noqa: E402
from repro_torch.core import topology, wirefmt  # noqa: E402
from repro_torch.core.schemes import runner, splitfed  # noqa: E402
from repro_torch.data import multiview  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

CFG = PaperExperimentConfig(conv_channels=(4,), d_bottleneck=8,
                            dense_units=(32,), image_shape=(16, 16, 3),
                            dataset_size=128)
BATCH, N = 8, 160           # 20 minibatches: 2 FL rounds of 10
SCHEMES = (("inl", CFG), ("inl+learned_prior",
                          dataclasses.replace(CFG, learned_prior=True)),
           ("sl", CFG), ("fl", CFG), ("splitfed", CFG), ("hybrid", CFG))
ERASURE = 0.3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs: the workers of a parallel
    test run share the machine's cores (both dispatches of a comparison
    run under the same setting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=N):
    imgs, labels = multiview.make_base_dataset(
        n, image_shape=CFG.image_shape, seed=0)
    return multiview.make_views(imgs, CFG.noise_stds), labels


def _lossy():
    return linkfault.with_links(topology.star(CFG.num_clients),
                                linkfault.LinkModel(erasure=ERASURE))


def _scheme_name(label):
    return label.split("+")[0]


@pytest.mark.parametrize("lossy", [False, True], ids=["clean", "erasure"])
@pytest.mark.parametrize("label, cfg", SCHEMES, ids=[s for s, _ in SCHEMES])
def test_run_scheme_scan_equals_per_round(label, cfg, lossy):
    name = _scheme_name(label)
    # two epochs of one FL round (10 minibatches), of three other rounds
    views, labels = _data(80 if name == "fl" else 24)
    topo = _lossy() if lossy else None
    curves, meters = {}, {}
    for dispatch in ("scan", "per_round"):
        meters[dispatch] = bandwidth.BandwidthMeter()
        curves[dispatch] = runner.run_scheme(
            name, views, labels, cfg, epochs=2,
            batch_size=BATCH, eval_n=24, topology=topo, dispatch=dispatch,
            meter=meters[dispatch], device="cpu", seed=3)
    assert curves["scan"] == curves["per_round"]
    assert len(curves["scan"]) == 2 and curves["scan"][-1].gbits > 0
    a, b = meters["scan"], meters["per_round"]
    assert (a.edge_bits, a.edge_measured_bytes, a.edge_delivered_bits) == \
        (b.edge_bits, b.edge_measured_bytes, b.edge_delivered_bits)
    assert a.delivery_ratio == b.delivery_ratio
    assert (a.delivery_ratio < 1.0) == lossy


def _epoch_inputs(name, cfg, views, labels, K):
    """(K, R, J, B, ...) views and (K, R, B) labels of K rounds."""
    R = schemes.get(name).batches_per_round(cfg)
    J = cfg.num_clients
    v = torch.from_numpy(views[:, :K * R * BATCH]).reshape(
        J, K, R, BATCH, *cfg.image_shape).permute(1, 2, 0, 3, 4, 5, 6)
    lab = torch.from_numpy(labels[:K * R * BATCH]).long().reshape(
        K, R, BATCH)
    return v, lab


@pytest.mark.parametrize("lossy", [False, True], ids=["clean", "erasure"])
@pytest.mark.parametrize("label, cfg", SCHEMES, ids=[s for s, _ in SCHEMES])
def test_epoch_fn_equals_round_calls_bit_for_bit(label, cfg, lossy):
    """make_epoch's K rounds (the graphed loop's CPU twin) against K
    make_round calls: every state leaf and every round's loss identical,
    each round's host signature from its fault draw."""
    name = _scheme_name(label)
    scheme = schemes.get(name)
    views, labels = _data()
    K = 2 if name == "fl" else 4
    topo = _lossy() if lossy else None
    v, lab = _epoch_inputs(name, cfg, views, labels, K)
    keys = [linkfault.round_key(11, g) for g in range(K)] if lossy else None
    init = scheme.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    epoch_fn = scheme.make_epoch(cfg, topology=topo)
    st_e, metrics = epoch_fn(init, v, lab, torch.Generator().manual_seed(1),
                             round_keys=keys)
    assert metrics["loss"].shape == (K,)
    assert epoch_fn.captures == {}             # no graph on the CPU
    round_fn = scheme.make_round(cfg, topology=topo)
    g = torch.Generator().manual_seed(1)
    st_r, losses = init, []
    for k in range(K):
        st_r, m = round_fn(st_r, v[k], lab[k], g,
                           round_key=None if keys is None else keys[k])
        losses.append(m["loss"])
    assert torch.equal(metrics["loss"], torch.stack(losses))
    for a, b in zip(tree_leaves(st_e), tree_leaves(st_r)):
        assert torch.equal(a, b)
    plan, _ = scheme.make_round_parts(cfg, topology=topo)
    sigs = {plan(None if keys is None else keys[k], BATCH)[0]
            for k in range(K)}
    clean = {"sl": {"keep"}, "fl": {"all"}}.get(name, {"clean"})
    if not lossy:
        assert sigs == clean
    elif name not in ("sl", "fl"):
        assert sigs == {"masked"}


def test_host_signatures_name_each_variant():
    """FL's average is decided on the host (all / none / partial n), SL's
    keep or skip; a lossy round without its key raises, as before."""
    assert fl.average_plan(np.ones(5, bool)) == "all"
    assert fl.average_plan(np.zeros(5, bool)) == "none"
    assert fl.average_plan(np.array([1, 0, 1, 1, 0], bool)) == ("partial", 3)
    topo = _lossy()
    sigs = {schemes.get("sl").make_round_parts(CFG, topology=topo).plan(
        linkfault.round_key(0, g), BATCH)[0] for g in range(300)}
    assert sigs == {"keep", "skip"}            # 0.3^3: a few skipped rounds
    for name, match in (("inl", "round_key"), ("sl", "retries"),
                        ("fl", "client delivery mask"),
                        ("splitfed", "round_key"), ("hybrid", "round_key")):
        with pytest.raises(ValueError, match=match):
            schemes.get(name).make_round_parts(CFG, topology=topo).plan(
                None, BATCH)


def test_capture_safe_constants_keep_their_bits():
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(5, 7, 3))
                                  .astype(np.float32))}
    for mask in ([1, 1, 1, 1, 1], [1, 0, 1, 1, 0], [0, 0, 0, 0, 0]):
        mask = np.array(mask, bool)
        w = torch.from_numpy(mask).to(torch.float32)
        n = torch.tensor(float(max(int(mask.sum()), 1)))       # the old n
        x = tree["w"]
        a = torch.sum(x * w.reshape(5, 1, 1), dim=0) / n
        want = torch.where(w.reshape(5, 1, 1) > 0, a.expand(x.shape), x)
        for m in (mask, torch.from_numpy(mask)):
            assert torch.equal(splitfed.fedavg(tree, m)["w"], want)
    g = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    for bits in (1, 2, 4, 8):
        gf = g.to(torch.float32)
        m = torch.amax(torch.abs(gf), dim=-1, keepdim=True)
        levels = torch.tensor(float((1 << bits) - 1))           # the old one
        scale = levels / (2.0 * torch.clamp_min(m, 1e-12))
        want = torch.round((torch.clamp(gf, -m, m) + m) * scale) / scale - m
        assert torch.equal(wirefmt.dyn_quantize(g, bits), want)
        u = 3 * g
        idx = torch.round((torch.clamp(u, -4.0, 4.0) + 4.0)
                          * (((1 << bits) - 1) / 8.0))
        want = idx / torch.tensor(((1 << bits) - 1) / 8.0) - 4.0
        assert torch.equal(ref.quantize_value(u, bits), want)


def test_engine_trace_counts_are_keyed_by_its_buckets():
    scheme = schemes.get("inl")
    state = scheme.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    engine = ServingEngine(scheme, state, CFG, device="cpu")
    assert engine.trace_counts == {1: 0, 4: 0, 16: 0, 64: 0}
    views, _ = _data()
    engine.warmup()
    probs, served = engine.serve(views[:, :5])
    assert probs.shape == (5, CFG.num_classes)
    assert engine.trace_counts == {1: 0, 4: 0, 16: 0, 64: 0}
    engine = ServingEngine(scheme, state, CFG, buckets=(2, 8), device="cpu")
    assert engine.trace_counts == {2: 0, 8: 0}


# ---------------------------------------------------------------------------
# Zamba2 decode with cache_len on the device
# ---------------------------------------------------------------------------

ARCH = "zamba2-2.7b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = 64


def _smoke(get):
    return dataclasses.replace(get(ARCH), dtype="float32", num_layers=4)


ZCFG, ZJCFG = _smoke(get_smoke_config), _smoke(jax_get_smoke)


@pytest.fixture(scope="module")
def zamba2():
    return zamba2_weights(ZJCFG, ZCFG)


def test_decode_with_a_tensor_cache_len_matches_jax(zamba2):
    jp, tp = zamba2
    toks = np.random.default_rng(7).integers(
        0, ZCFG.vocab_size, size=(2, PROMPT)).astype(np.int32)
    jl, jc = jax.jit(jsteps.make_prefill_step(ZJCFG))(
        jp, {"tokens": jnp.asarray(toks)})
    _, tc = steps.make_prefill_step(ZCFG)(
        tp, {"tokens": torch.from_numpy(toks).long()})
    jc, tc = jzoo.pad_cache(jc, 3), zoo.pad_cache(tc, 3)
    jdec = jax.jit(jsteps.make_decode_step(ZJCFG))
    log = []
    tdec = steps.make_decode_step(ZCFG, trace_log=log)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for t in range(3):
        jlog, jc = jdec(jp, {"tokens": jnp.asarray(tok),
                             "cache_len": jnp.asarray(PROMPT + t, jnp.int32)},
                        jc)
        tlog, tc = tdec(tp, {"tokens": torch.from_numpy(tok).long(),
                             "cache_len": torch.tensor(PROMPT + t)}, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    got = flat(tc)
    for path, leaf in flat(jc).items():
        np.testing.assert_allclose(got[path], leaf, err_msg=path,
                                   **CACHE_TOL)
    assert log == []                           # no capture on the CPU
    # the int and the tensor cache_len run one code path: the same bits
    _, tc2 = steps.make_prefill_step(ZCFG)(
        tp, {"tokens": torch.from_numpy(toks).long()})
    tc2 = zoo.pad_cache(tc2, 1)
    a, _ = steps.make_decode_step(ZCFG)(
        tp, {"tokens": torch.from_numpy(tok).long(), "cache_len": PROMPT},
        tree_map(torch.clone, tc2))
    b, _ = steps.make_decode_step(ZCFG)(
        tp, {"tokens": torch.from_numpy(tok).long(),
             "cache_len": torch.tensor(PROMPT)}, tc2)
    assert torch.equal(a, b)
    gen_log = []
    gen = serve.serve_batch(ZCFG, tp, torch.from_numpy(toks).long(), 4,
                            trace_log=gen_log)
    assert gen.shape == (2, 4) and gen_log == []


# ---------------------------------------------------------------------------
# On the card: graphed == eager (skipped without one)
# ---------------------------------------------------------------------------

def test_graphed_inl_round_equals_eager_on_cuda(cuda_device):
    views, labels = _data()
    scheme = schemes.get("inl")
    v, lab = _epoch_inputs("inl", CFG, views, labels, 4)
    v, lab = v.to(cuda_device), lab.to(cuda_device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        def init():
            return scheme.init(CFG, torch.Generator(
                device=cuda_device).manual_seed(0), device=cuda_device)
        epoch_fn = scheme.make_epoch(CFG)
        st_g, m_g = epoch_fn(init(), v, lab, torch.Generator(
            device=cuda_device).manual_seed(1))
        round_fn = scheme.make_round(CFG)
        g = torch.Generator(device=cuda_device).manual_seed(1)
        st_e, losses = init(), []
        for k in range(4):
            st_e, m = round_fn(st_e, v[k], lab[k], g)
            losses.append(m["loss"])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert epoch_fn.captures == {"clean": 1}
    assert torch.equal(m_g["loss"], torch.stack(losses))
    for a, b in zip(tree_leaves(st_g), tree_leaves(st_e)):
        assert torch.equal(a, b)


def test_graphed_bucket_equals_eager_predict_on_cuda(cuda_device):
    views, _ = _data()
    scheme = schemes.get("inl")
    state = scheme.init(CFG, torch.Generator(device=cuda_device)
                        .manual_seed(0), device=cuda_device)
    engine = ServingEngine(scheme, state, CFG, buckets=(4,),
                           device=cuda_device)
    engine.warmup()
    for _ in range(3):
        probs, _ = engine.serve(views[:, :4])
    assert engine.trace_counts == {4: 1}
    want = scheme.predict_batched(state, views[:, :4], cfg=CFG,
                                  device=cuda_device).cpu().numpy()
    np.testing.assert_array_equal(probs, want)
    engine.state = tree_map(torch.clone, state)  # new tensors: recaptured
    engine.serve(views[:, :4])
    assert engine.trace_counts == {4: 2}


def test_graphed_decode_step_equals_eager_on_cuda(cuda_device, zamba2):
    _, tp = zamba2
    tp = tree_map(lambda t: t.to(cuda_device), tp)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, ZCFG.vocab_size, size=(2, PROMPT))).long().to(cuda_device)
    log = []
    got = serve.serve_batch(ZCFG, tp, toks, 6, trace_log=log)
    _, cache = steps.make_prefill_step(ZCFG)(tp, {"tokens": toks})
    cache = zoo.pad_cache(cache, 6)
    tok = torch.argmax(steps.make_prefill_step(ZCFG)(
        tp, {"tokens": toks})[0], dim=-1)
    want = [tok]
    for t in range(5):
        tok, cache = zoo_decode(tp, tok, PROMPT + t, cache)
        want.append(tok)
    assert len(log) == 1
    assert torch.equal(got, torch.stack(want, dim=1))


def zoo_decode(params, tok, cache_len, cache):
    """One eager greedy decode step, never captured."""
    with torch.no_grad():
        logits, cache = zoo.forward(params, ZCFG,
                                    {"tokens": tok[:, None],
                                     "cache_len": cache_len},
                                    mode="decode", cache=cache)
    return torch.argmax(logits[:, -1], dim=-1), cache
