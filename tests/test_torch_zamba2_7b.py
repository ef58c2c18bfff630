"""Zamba2-7B (`configs/zamba2_7b.py`) on the port's standard train path
against the benchmark's plain reference (bench/reference/zamba2.py), on
the CPU, with no JAX.

The smoke config (two periods of five Mamba2 layers and a hybrid, two
groups of B and C, two shared blocks, tiny widths) in fp32 through
`steps.make_scan_train_step(scheme="standard")` and
`common.value_and_grad` over `zoo.loss_and_metrics`, on the weights the
reference draws from a seed (A_log, D, dt_bias, the conv biases and both
adapter matrices drawn, not constant; the norm scales 1 + 0.1 N(0, 1)
here), so that a swapped, mis-broadcast or unused leaf cannot pass.

Bars, fp32 against fp32 (the same operations in another order):
  loss     relative gap 1e-6 (measured 0; the bf16 program: 1.1e-4)
  grads    every leaf within 1e-4 of the leaf's largest |value|
           (measured 1e-5; bf16: 0.29)
  weights  after three AdamW steps, each leaf's change within 2e-3 of
           the larger of the norm of the reference's change and the
           median leaf's, by the norm of the gap (the benchmark's
           `change`: Adam moves an element whose gradient is near eps by
           up to the learning rate on round-off alone, so an element's
           own gap would not do, and an fp32 norm scale near 1 that moved
           1e-4 holds 1e-3 of its move in its own last bit; measured
           5.5e-4; bf16: 170)
Each bar is held against the bf16 program too, which must fail it.

Besides: the grouped plain SSD against the token-by-token recurrence at
G = 2; one group given as (B, S, 1, N) is the shared form bit for bit; the
benchmark's 12-layer cut counts 1,757,853,120 parameters; each shared
block's weights take a gradient from exactly its own invocations (period
p runs block p mod 2).
"""
import dataclasses
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.lib import weights as W  # noqa: E402
from bench.reference import adamw as ref_adamw  # noqa: E402
from bench.reference import zamba2 as Z  # noqa: E402
from repro_torch import optim, tree_leaves, value_and_grad  # noqa: E402
from repro_torch.configs.base import (get_config, get_smoke_config,  # noqa
                                      list_archs)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers, transformer, zoo  # noqa: E402

ARCH = "zamba2-7b"
SEED = 2 ** 33 + 11
LOSS_BAR, GRAD_BAR, CHANGE_BAR = 1e-6, 1e-4, 2e-3
LR, WARMUP, TOTAL = 3e-4, 100, 1000


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def smoke(dtype="float32", **change):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **change)


def mdict(cfg):
    """The configuration as the reference reads it."""
    s = cfg.ssm
    return dict(num_layers=cfg.num_layers, d_model=cfg.d_model,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                vocab_size=cfg.vocab_size,
                vocab_size_padded=layers.pad_vocab(cfg.vocab_size),
                rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                dtype="float32", num_mem_blocks=cfg.num_mem_blocks,
                adapter_rank=cfg.adapter_rank,
                ssm=dict(state_dim=s.state_dim, conv_width=s.conv_width,
                         expand=s.expand, head_dim=s.head_dim,
                         chunk_size=s.chunk_size, ngroups=s.ngroups))


def draws(m, seed=SEED):
    """The reference's weights, the norm scales 1 + 0.1 N(0, 1)."""
    out = {}
    for name, shape in Z.shapes(m).items():
        w = Z.make_weight(m, name, shape, seed, "cpu")
        if name.endswith("scale"):
            w = 1 + 0.1 * W.draw(name + "#noise", shape, ("normal", 1.0),
                                 seed=seed, device="cpu")
        out[name] = w
    return out


def program(cfg, ws):
    p = zoo.init_params(cfg, 0, device="cpu")
    W.fill(p, lambda name, shape: ws[name])
    return p


def batches(cfg, k=3, B=2, S=64):
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (k, B, S + 1), generator=g)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def first_step(dtype):
    cfg = smoke(dtype)
    m = mdict(cfg)
    ws = draws(m)
    b = {k: v[0] for k, v in batches(cfg).items()}
    loss, _, grads = value_and_grad(
        lambda q: zoo.loss_and_metrics(q, cfg, b), program(cfg, ws))
    want_loss, want = Z._grads(m, ws, b["tokens"], b["labels"])
    loss_gap = abs(float(loss) - want_loss) / abs(want_loss)
    grad_gap = max(float((g.float() - want[n]).abs().max()
                         / want[n].abs().max())
                   for n, g in W.named_leaves(grads))
    return loss_gap, grad_gap, set(want) == {n for n, _ in
                                            W.named_leaves(grads)}


def three_steps(dtype):
    cfg = smoke(dtype)
    m = mdict(cfg)
    ws = draws(m)
    xs = batches(cfg)
    opt = optim.adamw(optim.warmup_cosine_schedule(LR, WARMUP, TOTAL),
                      weight_decay=0.1, clip_norm=1.0)
    epoch = steps.make_scan_train_step(cfg, opt, scheme="standard")
    params = program(cfg, ws)
    params, state, metrics = epoch(params, opt.init(params), xs)
    master = state.get("master", params)
    ropt = ref_adamw.AdamW(ws, ref_adamw.warmup_cosine(LR, WARMUP, TOTAL),
                           weight_decay=0.1, clip=1.0)
    rw, losses = dict(ws), []
    for i in range(3):
        value, g = Z._grads(m, rw, xs["tokens"][i], xs["labels"][i])
        rw = ropt.update(rw, g)
        losses.append(value)
    loss_gap = max(abs(float(a) - b) / abs(b)
                   for a, b in zip(metrics["loss"], losses))
    moved = {n: float(torch.linalg.vector_norm(rw[n] - ws[n])) for n in ws}
    median = statistics.median(moved.values())
    change_gap = max(float(torch.linalg.vector_norm(
        (p.float() - ws[n]) - (rw[n] - ws[n]))) / max(moved[n], median)
        for n, p in W.named_leaves(master))
    return loss_gap, change_gap


def test_registered_at_published_widths():
    cfg = get_config(ARCH)
    assert ARCH not in list_archs()
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff) == \
        (81, 3584, 32000, 14336)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 32, 224)
    s = cfg.ssm
    assert (s.expand, s.head_dim, s.state_dim, s.ngroups, s.conv_width,
            s.chunk_size) == (2, 64, 64, 2, 4, 256)
    assert s.num_heads(cfg.d_model) == 112
    assert (cfg.num_mem_blocks, cfg.adapter_rank) == (2, 128)
    assert cfg.attn_scale == (224 / 2) ** -0.5
    assert cfg.act == "gelu_exact" and cfg.tie_embeddings
    with pytest.raises(ValueError, match="not divisible"):
        transformer.num_periods(cfg)


def test_the_benchmark_cut_counts_its_parameters():
    cut = dataclasses.replace(get_config(ARCH), num_layers=12)
    assert zoo.param_count(cut) == 1_757_853_120 == (
        12 * 78_437_456 + 2 * 333_982_208 + 2 * 16_973_824 + 114_688_000
        + 3584)
    cfg = smoke()
    assert zoo.param_count(cfg) == sum(
        t.numel() for t in tree_leaves(zoo.init_params(cfg, 0, "cpu")))
    assert zoo.param_count(cfg) == sum(
        int(np.prod(s)) for s in Z.shapes(mdict(cfg)).values())


def test_first_step_matches_the_reference():
    loss_gap, grad_gap, same_leaves = first_step("float32")
    assert same_leaves
    assert loss_gap <= LOSS_BAR and grad_gap <= GRAD_BAR, (loss_gap,
                                                           grad_gap)


def test_three_adamw_steps_match_the_reference():
    loss_gap, change_gap = three_steps("float32")
    assert loss_gap <= LOSS_BAR and change_gap <= CHANGE_BAR, (loss_gap,
                                                               change_gap)


def test_a_bf16_program_fails_the_bars():
    loss_gap, grad_gap, _ = first_step("bfloat16")
    assert loss_gap > LOSS_BAR and grad_gap > GRAD_BAR, (loss_gap, grad_gap)
    _, change_gap = three_steps("bfloat16")
    assert change_gap > CHANGE_BAR, change_gap


def test_grouped_plain_scan_is_the_recurrence():
    rng = np.random.default_rng(5)
    B, S, H, P, N, G = 2, 48, 6, 8, 5, 2
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, bm, cm = f(B, S, H, P), f(B, S, G, N), f(B, S, G, N)
    dt = torch.nn.functional.softplus(f(B, S, H))
    a, d = -torch.exp(0.2 * f(H)), 1 + 0.2 * f(H)
    y, state = ref.ssd_chunked_ref(x, dt, a, bm, cm, d, chunk=16)
    y_seq, state_seq = ref.ssd_scan_ref(x, dt, a, bm, cm, d)
    # head h reads group h // 3: the recurrence with each head's B, C
    y_h, _ = ref.ssd_scan_ref(x[:, :, 4:5], dt[:, :, 4:5], a[4:5],
                              bm[:, :, 1], cm[:, :, 1], d[4:5])
    top = float(y_seq.abs().max())
    assert float((y - y_seq).abs().max()) <= 1e-5 * top
    assert float((state - state_seq).abs().max()) <= 1e-5 * float(
        state_seq.abs().max())
    assert float((y_seq[:, :, 4:5] - y_h).abs().max()) <= 1e-6 * top


def test_one_group_is_the_shared_form_bit_for_bit():
    rng = np.random.default_rng(6)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, bm, cm = f(1, 32, 4, 8), f(1, 32, 1, 5), f(1, 32, 1, 5)
    dt, a, d = torch.nn.functional.softplus(f(1, 32, 4)), -torch.exp(f(4)), \
        f(4)
    for fn in (lambda *t: ref.ssd_chunked_ref(*t, chunk=8),
               ref.ssd_scan_ref):
        got = fn(x, dt, a, bm, cm, d)
        want = fn(x, dt, a, bm[:, :, 0], cm[:, :, 0], d)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    p = {"scale": f(16)}
    h = f(3, 16)
    assert torch.equal(layers.group_rmsnorm(p, h, 1), layers.rmsnorm(p, h))


@pytest.mark.parametrize("periods", [1, 2, 3])
def test_each_shared_block_learns_from_its_own_invocations(periods):
    """Period p runs block p mod 2: with one period block 1 takes no
    gradient; with two or three, each block one; a block's gradient is the
    sum of its invocations', each taken with the other invocations' copies
    of it held fixed."""
    cfg = smoke(num_layers=6 * periods)
    m = mdict(cfg)
    ws = draws(m)
    b = {k: v[0] for k, v in batches(cfg, S=32).items()}
    _, _, grads = value_and_grad(
        lambda q: zoo.loss_and_metrics(q, cfg, b), program(cfg, ws))
    blocks = grads["stack"]["mem_blocks"]
    for blk in range(2):
        leaves = tree_leaves(blocks[blk])
        used = blk < periods
        assert all(bool(g.abs().max() > 0) == used for g in leaves), blk
    # the reference with each invocation's own copy of its block
    copies = {}
    for per in range(periods):
        for n, w in ws.items():
            pre = f"stack.mem_blocks.{per % 2}."
            if n.startswith(pre):
                copies[(per, n[len(pre):])] = w.clone().requires_grad_(True)

    mem_of = Z.hybrid_layer

    def hybrid(mm, prec, h, e, w, shared, remat=True):
        per = hybrid.calls
        hybrid.calls += 1
        own = {k: copies[(per, k)] for k in shared}
        return mem_of(mm, prec, h, e, w, own, remat)
    hybrid.calls = 0
    Z.hybrid_layer = hybrid
    try:
        value = Z.loss(m, ws, b["tokens"], b["labels"], remat=False)
    finally:
        Z.hybrid_layer = mem_of
    keys = sorted(copies)
    got = dict(zip(keys, torch.autograd.grad(value, [copies[k]
                                                     for k in keys])))
    for blk in range(min(periods, 2)):
        pre = f"stack.mem_blocks.{blk}."
        for name, g in W.named_leaves(blocks[blk], pre[:-1]):
            k = name[len(pre):]
            want = sum(got[(per, k)] for per in range(periods)
                       if per % 2 == blk)
            assert float((g - want).abs().max()) <= GRAD_BAR * float(
                want.abs().max()), name


def test_one_backward_recompute_a_mixer_a_step():
    """`models/ssm.LAUNCHES["ssd_scan_bwd"]` counts the SSD backward's
    recomputes: one a Mamba2 mixer (ten mamba layers and two hybrids) a
    step, the remat's second forward notwithstanding."""
    from repro_torch.models import ssm
    cfg = smoke()
    b = {k: v[0] for k, v in batches(cfg, S=32).items()}
    before = ssm.LAUNCHES["ssd_scan_bwd"]
    value_and_grad(lambda q: zoo.loss_and_metrics(q, cfg, b),
                   program(cfg, draws(mdict(cfg))))
    assert ssm.LAUNCHES["ssd_scan_bwd"] - before == 12
