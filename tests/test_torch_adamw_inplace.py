"""AdamW in place (`optim.adamw(...).update_`, `kernels/ops.grad_norm` and
`kernels/ops.adamw_`, csrc/adamw.cu), with no JAX.

On the CPU: the plain in-place version equals the functional `update`
bit for bit in params, m, v, the master and the step, over three steps of
mixed bf16/fp32 trees and an `INLLLMParams`, with and without a master,
weight decay 0 and 0.1, the clip engaged and not; the norm it returns is
`global_norm` of the unclipped gradients, bit for bit; the update is the
step's "optimizer" phase; `make_scan_train_step` in place (donated) gives
the functional run's params, state and metrics in both schemes; the chunk
table; the kernel source's constants; the wrapper refuses a strided leaf
and two leaves over one memory before it looks at the device.

On the card (skipped here): given the kernel's clip scale, the kernel
equals the plain version bit for bit (both are the same rounded fp32
operations); its norm sums in fp64 in another order than `global_norm`'s
fp32 sums, so it agrees to 1e-6 of the norm; two launches from one state
give the same bits; one norm and one update launch a step; a strided
leaf and two leaves over one memory are refused, nothing launched.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_common import cuda_device  # noqa: E402,F401
from repro_torch import optim, tracing, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core import inl_llm  # noqa: E402
from repro_torch.kernels import adamw as adamw_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

CSRC = Path(adamw_kernel.__file__).resolve().parent / "csrc" / "adamw.cu"
STEPS = 3
B, S, K = 2, 16, 3


def mixed_tree(device="cpu"):
    """bf16 and fp32 leaves, a ragged size, a nested dict."""
    g = torch.Generator().manual_seed(0)
    return tree_map(lambda t: t.to(device), {
        "a": torch.randn(37, 5, generator=g).to(torch.bfloat16),
        "b": torch.randn(64, generator=g),
        "c": {"d": torch.randn(8, 16, generator=g).to(torch.bfloat16),
              "e": torch.randn(3, generator=g)}})


def inl_tree(device="cpu"):
    return inl_llm.init(get_smoke_config("llama3.2-1b"), 0, device=device)


TREES = {"mixed": mixed_tree, "inl_llm": inl_tree}


def grads_like(params, seed, size):
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda p: (size * torch.randn(p.shape, generator=g))
                    .to(p.dtype).to(p.device), params)


def clone(tree):
    return tree_map(torch.clone, tree)


def same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def optimizer(master, wd):
    return optim.adamw(optim.warmup_cosine_schedule(1e-2, 2, 10), b2=0.95,
                       weight_decay=wd, clip_norm=1.0, keep_master=master)


@pytest.mark.parametrize("clip", ["engaged", "not engaged"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("master", [True, False], ids=["master", "no master"])
@pytest.mark.parametrize("tree", list(TREES))
def test_inplace_equals_functional(tree, master, wd, clip):
    params = TREES[tree]()
    opt = optimizer(master, wd)
    state = opt.init(params)
    assert ("master" in state) == master
    p_f, s_f = params, state
    p_i, s_i = clone(params), clone(state)
    leaves_i = tree_leaves((p_i, s_i))
    size = 10.0 if clip == "engaged" else 1e-4
    for t in range(STEPS):
        grads = grads_like(params, 10 + t, size)
        norm_want = optim.global_norm(grads)
        assert (float(norm_want) > 1.0) == (clip == "engaged")
        p_f, s_f = opt.update(grads, s_f, p_f)
        norm = opt.update_(grads, s_i, p_i)
        assert torch.equal(norm, norm_want)
        assert same(p_i, p_f) and same(s_i, s_f), t
    assert int(s_i["step"]) == STEPS
    # every leaf the caller passed is the one updated
    assert all(a is b for a, b in zip(leaves_i, tree_leaves((p_i, s_i))))


def test_update_is_the_optimizer_phase(monkeypatch):
    seen = []
    phase = tracing.phase

    def recorded(name, device):
        seen.append((name, device.type))
        return phase(name, device)
    monkeypatch.setattr(tracing, "phase", recorded)
    params = mixed_tree()
    opt = optimizer(True, 0.1)
    state = opt.init(params)
    opt.update_(grads_like(params, 1, 1.0), state, params)
    assert seen == [("optimizer", "cpu")]


def test_sgd_has_no_inplace_update():
    assert optim.sgd(0.1).update_ is None
    assert optim.adam(1e-3).update_ is not None


def _scan_inputs(scheme):
    cfg = get_smoke_config("llama3.2-1b")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (K, B, S), generator=g)
    labels = torch.cat([tokens[:, :, 1:], torch.full((K, B, 1), -1)], -1)
    if scheme == "inl":
        params = inl_llm.init(cfg, 0, device="cpu")
    else:
        from repro_torch.models import zoo
        params = zoo.init_params(cfg, 0, device="cpu")
    return cfg, params, {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("scheme", ["standard", "inl"])
def test_scan_step_in_place_equals_functional(scheme):
    """donate=True on the CPU runs every step in place, donate=False the
    first functionally and the rest in place: the same params, state and
    metrics bit for bit; the donated call updated the caller's tensors,
    the other left them as they were."""
    cfg, params, batches = _scan_inputs(scheme)
    opt = steps.default_optimizer(cfg, total_steps=10)
    runs = {}
    for donate in (False, True):
        p0, s0 = clone(params), opt.init(clone(params))
        before = clone((p0, s0))
        args = (torch.Generator().manual_seed(7),) if scheme == "inl" else ()
        out = steps.make_scan_train_step(cfg, opt, scheme=scheme,
                                         donate=donate)(p0, s0, batches,
                                                        *args)
        runs[donate] = out
        in_place = all(a is b for a, b in zip(tree_leaves((p0, s0)),
                                              tree_leaves(out[:2])))
        assert in_place == donate
        assert same((p0, s0), before) != donate
    (pf, sf, mf), (pi, si, mi) = runs[False], runs[True]
    assert same(pf, pi) and same(sf, si)
    assert mf.keys() == mi.keys() and "grad_norm" in mi
    assert all(torch.equal(mf[k], mi[k]) for k in mf)
    assert int(si["step"]) == K


def test_scan_step_without_inplace_update_frees_donated_buffers():
    """An optimizer without `update_` (SGD) stays functional: donated
    buffers are freed after the first step, as before."""
    cfg, params, batches = _scan_inputs("standard")
    opt = optim.sgd(1e-2)
    p0, s0 = clone(params), opt.init(params)
    p, _, ms = steps.make_scan_train_step(cfg, opt, donate=True)(
        p0, s0, batches)
    assert not any(t.numel() and t.untyped_storage().size()
                   for t in tree_leaves(p0))
    assert all(t.untyped_storage().size() for t in tree_leaves(p))
    assert ms["grad_norm"].shape == (K,)


def test_meta_tensors_take_the_plain_version():
    params = tree_map(lambda t: t.to("meta"), mixed_tree())
    grads = tree_map(lambda t: t.to("meta"), grads_like(mixed_tree(), 1, 1.0))
    opt = optimizer(True, 0.1)
    state = opt.init(params)
    before = dict(adamw_kernel.LAUNCHES)
    norm = opt.update_(grads, state, params)
    assert norm.device.type == "meta" and norm.shape == ()
    assert adamw_kernel.LAUNCHES == before


def test_ops_on_cpu_leave_the_kernel_counter_alone():
    params = mixed_tree()
    grads = tree_leaves(grads_like(params, 2, 1.0))
    before = dict(adamw_kernel.LAUNCHES)
    norm, scale = ops.grad_norm(grads, 0.5)
    want = optim.global_norm(grads)
    assert torch.equal(norm, want)
    assert torch.equal(scale, torch.clamp(0.5 / want, max=1.0))
    assert float(ops.grad_norm(grads, None)[1]) == 1.0
    assert adamw_kernel.LAUNCHES == before


@pytest.mark.parametrize("numels", [(0,), (1,), (65536,), (65545, 3),
                                    (3 * 65536, 0, 7)])
def test_chunk_rows(numels):
    rows = adamw_kernel.chunk_rows(numels)
    start, leaf, length = rows[:, 0], rows[:, 1] & 0xffffffff, rows[:, 1] >> 32
    assert rows.dtype.name == "int64"
    for i, n in enumerate(numels):
        mine = leaf == i
        assert length[mine].sum() == n
        assert (start[mine] % adamw_kernel.CHUNK == 0).all()
        assert (length[mine] <= adamw_kernel.CHUNK).all()
        assert (length[mine] > 0).all()


def test_kernel_source_constants():
    src = CSRC.read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == \
        adamw_kernel.CHUNK
    for name, value in (("kBf16", adamw_kernel.BF16),
                        ("kMaster", adamw_kernel.MASTER),
                        ("kAligned", adamw_kernel.ALIGNED)):
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == value
    # no atomics: the norm is the same bits every run
    assert "atomic" not in src.split("#include")[-1]
    assert "Replaces: no TPU kernel" in src


# a leaf the kernel cannot write in place, and the refusal's words
LAYOUT_FAULTS = {"transposed": "contiguous", "aliased": "share memory"}


def _refuses_layout(fault, device):
    """`adamw_kernel.adamw_update` over two fp32 leaves of 24 elements, one
    m a transposed (strided) view or the two weights over one storage:
    refused with a ValueError, and nothing launched."""
    m = [torch.zeros(4, 6, device=device), torch.zeros(24, device=device)]
    v = [torch.zeros_like(t) for t in m]
    params = [torch.zeros_like(t) for t in m]
    if fault == "transposed":
        m[0] = torch.zeros(6, 4, device=device).t()
    else:
        buf = torch.zeros(40, device=device)
        params = [buf[:24].view(4, 6), buf[16:]]
    grads = [torch.ones_like(t) for t in params]
    one = torch.ones((), device=device)
    before = dict(adamw_kernel.LAUNCHES)
    with pytest.raises(ValueError, match=LAYOUT_FAULTS[fault]):
        adamw_kernel.adamw_update(grads, m, v, None, params, one, one, one,
                                  one, b1=0.9, b2=0.95, eps=1e-8,
                                  weight_decay=0.0)
    assert adamw_kernel.LAUNCHES == before


@pytest.mark.parametrize("fault", list(LAYOUT_FAULTS))
def test_wrapper_refuses_strided_or_shared_leaves(fault):
    """The layout is refused before the device check, so on the CPU too."""
    _refuses_layout(fault, "cpu")


def test_wrapper_takes_a_master_that_is_its_weight():
    """`init` keeps an fp32 leaf's master as the weight itself: that one
    memory passes the layout checks, and CPU tensors are then refused
    only for their device."""
    params = mixed_tree()
    state = optimizer(True, 0.1).init(params)
    master = tree_leaves(state["master"])
    assert any(a is b for a, b in zip(master, tree_leaves(params)))
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        adamw_kernel.adamw_update(
            tree_leaves(grads_like(params, 1, 1.0)), tree_leaves(state["m"]),
            tree_leaves(state["v"]), master, tree_leaves(params), one, one,
            one, one, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)


def test_wrapper_refuses_cpu_tensors():
    grads = tree_leaves(grads_like(mixed_tree(), 1, 1.0))
    with pytest.raises(ValueError, match="CUDA"):
        adamw_kernel.grad_norm(grads, 1.0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_tree(device):
    """Leaves of the cell's kinds and edge cases: bf16 matrices, an fp32
    vector, sizes below a vector, ragged and above a chunk."""
    g = torch.Generator().manual_seed(5)
    return {"w": torch.randn(300, 257, generator=g).to(torch.bfloat16)
            .to(device),
            "norm": torch.randn(3072, generator=g).to(device),
            "tiny": torch.randn(5, generator=g).to(torch.bfloat16).to(device),
            "big": torch.randn(2, 70000, generator=g).to(device)
            .to(torch.bfloat16),
            "offset": torch.randn(3 * 65536 + 77, generator=g)
            .to(torch.bfloat16).to(device)}


def _offset(t):
    """`t`'s values one element into a larger storage: not 16-byte
    aligned, so the kernel takes the element-by-element path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("clip", ["engaged", "not engaged"])
@pytest.mark.parametrize("master", [True, False], ids=["master", "no master"])
def test_kernel_matches_plain_on_cuda(cuda_device, master, clip):
    params = _card_tree(cuda_device)
    opt = optimizer(master, 0.1)
    state = opt.init(params)
    p_k, s_k = clone(params), clone(state)
    p_r, s_r = clone(params), clone(state)
    size = 10.0 if clip == "engaged" else 1e-4
    p_k["offset"] = _offset(p_k["offset"])
    for t in range(STEPS):
        grads = grads_like(params, 20 + t, size)
        grads["offset"] = _offset(grads["offset"])
        grads = tree_leaves(grads)
        assert sum(g.data_ptr() % 16 != 0 for g in grads) == 1
        norm, scale = adamw_kernel.grad_norm(grads, 1.0)
        want = optim.global_norm(grads)
        assert abs(float(norm) - float(want)) <= 1e-6 * float(want)
        ref_norm, _ = ref.grad_norm_ref(grads, 1.0)
        assert torch.equal(ref_norm, want)
        step = s_k["step"].add_(1)
        s_r["step"].add_(1)
        lr = torch.full((), 1e-2, device=cuda_device)
        bc1, bc2 = 1 - 0.9 ** step.float(), 1 - 0.95 ** step.float()
        kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
        args = (tree_leaves(s_k["m"]), tree_leaves(s_k["v"]),
                tree_leaves(s_k["master"]) if master else None,
                tree_leaves(p_k))
        adamw_kernel.adamw_update(grads, *args, scale, lr, bc1, bc2, **kw)
        ref.adamw_update_ref_(
            grads, tree_leaves(s_r["m"]), tree_leaves(s_r["v"]),
            tree_leaves(s_r["master"]) if master else None,
            tree_leaves(p_r), scale, lr, bc1, bc2, **kw)
        assert same(p_k, p_r) and same(s_k, s_r), t


def test_kernel_is_deterministic_and_counted_on_cuda(cuda_device):
    params = _card_tree(cuda_device)
    opt = optimizer(True, 0.1)
    state = opt.init(params)
    runs = []
    for _ in range(2):
        p, s = clone(params), clone(state)
        before = dict(adamw_kernel.LAUNCHES)
        norms = [opt.update_(grads_like(params, 30 + t, 10.0), s, p)
                 for t in range(STEPS)]
        assert {k: adamw_kernel.LAUNCHES[k] - before[k] for k in before} \
            == {"adamw_norm": STEPS, "adamw_update": STEPS}
        runs.append((p, s, torch.stack(norms)))
    assert same(runs[0], runs[1])


@pytest.mark.parametrize("fault", list(LAYOUT_FAULTS))
def test_kernel_refuses_strided_or_shared_leaves_on_cuda(cuda_device, fault):
    _refuses_layout(fault, cuda_device)


def test_kernel_refuses_on_cuda(cuda_device):
    params = _card_tree(cuda_device)
    state = optimizer(True, 0.1).init(params)
    grads = [g.to(torch.float16) for g in
             tree_leaves(grads_like(params, 1, 1.0))]
    with pytest.raises(TypeError, match="bf16 or fp32"):
        adamw_kernel.grad_norm(grads, 1.0)
    one = torch.ones((), device=cuda_device)
    with pytest.raises(TypeError, match="fp32 scalars"):
        adamw_kernel.adamw_update(
            tree_leaves(grads_like(params, 1, 1.0)), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(state["master"]),
            tree_leaves(params), one.double(), one, one, one, b1=0.9,
            b2=0.95, eps=1e-8, weight_decay=0.0)
