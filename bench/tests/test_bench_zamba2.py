"""The Zamba2-7B cell (`zamba2-7b.lm-2x4096`): its files load, its
reference imports nothing of the program and matches the port through the
cell's own driver at smoke size on the CPU, its FLOP forms are what
`FlopCounterMode` counts over the reference, and its per-layer readers
read their plans and return None where the program has nothing to read."""
import ast
import statistics
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import roofline
from bench.lib import compare, spec
from bench.lib.trace import Trace
from bench.reference import zamba2 as Z
from bench.roofline import zamba2 as zr

CELL = "zamba2-7b.lm-2x4096"
NEW = ("ssd_scan_roofline.llm", "flash_bwd_roofline.llm", "ssd_bwd_ms.llm")
SMOKE = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=32,
             attn_scale=16 ** -0.5, d_ff=96, vocab_size=256,
             vocab_size_padded=256, adapter_rank=8,
             ssm=dict(state_dim=16, conv_width=4, expand=2, head_dim=16,
                      chunk_size=16, ngroups=2))


def smoke_cell(**program):
    c = spec.load_cell(CELL)
    prog = dict(c.config["program"], **SMOKE)
    prog.update(program)
    return c._replace(config=dict(c.config, program=prog),
                      traffic=dict(c.traffic, batch=2, seq=64, scan_steps=2))


def test_the_cell_loads():
    c = spec.load_cell(CELL)
    assert c.traffic["driver"] == "llm_train"
    assert (c.traffic["batch"], c.traffic["seq"]) == (2, 4096)
    assert c.config["reference"] == "zamba2"
    assert c.config["reduced"] == ["num_layers"]
    assert c.config["num_hidden_layers"] == c.config["published"][
        "num_layers"] == 81
    assert c.config["program"]["num_layers"] == 12
    names = {m["name"] for m in c.per_layer}
    assert set(NEW) <= names and "cutlayer_roofline.llm" not in names
    assert {m["name"] for m in c.end_to_end} == {
        "setup_s", "train_tokens_per_s", "peak_mem_gib"}
    spec.driver("llm_train").Driver(c, 1, "cpu")


def test_the_reference_imports_nothing_of_the_program():
    path = spec.BENCH / "reference" / "zamba2.py"
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("repro_torch", "repro", "jax",
                                           "jaxlib", "flax"), n


def _readings(seed, **program):
    cell = smoke_cell(**program)
    drv = spec.driver("llm_train").Driver(cell, seed, "cpu")
    drv.setup()
    drv.release()
    return compare.numbers(drv.program, drv.reference())


def test_the_driver_matches_the_reference_fp32():
    torch.set_num_threads(2)
    got = _readings(2 ** 31 + 7, dtype="float32")
    # fp32 against fp32: round-off, which Adam's first steps amplify
    assert got["loss"] < 1e-5 and got["grad"] < 1e-4 \
        and got["change"] < 1e-2, got


def test_the_bf16_driver_is_close():
    """The cell's own bf16 program against the fp32 reference at smoke
    widths: within bf16's reach (measured grad 0.08), far from a step that
    leaves out half the batch (0.5 on the LLM cells)."""
    torch.set_num_threads(2)
    got = _readings(5)
    assert got["loss"] < 1e-2 and got["grad"] < 0.2 \
        and got["change"] < 0.3, got


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_step_flops_counted():
    m = dict(spec.load_cell(CELL).config["program"], **SMOKE)
    B, S = 2, 48
    w = Z.make_weights(m, 3, "cpu", torch.float32)
    leaves = {k: v.requires_grad_(True) for k, v in w.items()}
    tokens = torch.randint(0, m["vocab_size"], (B, S))

    def run():
        loss = Z.loss(m, leaves, tokens, tokens, remat=False)
        torch.autograd.grad(loss, list(leaves.values()))
    assert _counted(run) == zr.step_flops(m, B, S, causal=False)


def test_step_flops_full_size():
    m = spec.load_cell(CELL).config["program"]
    f = zr.step_flops(m, 2, 4096)
    params = 1_757_853_120 - 32000 * 3584 - 3584 - 12 * (3584 + 5 * 112
                                                         + 4 * 7424 + 7168)
    dense = 3 * 2 * (params - 2 * 2 * 7168 - 2 * 3584) * 2 * 4096
    # roughly 6 N tokens of the products plus the head, attention and SSD
    assert dense < f < 2 * dense
    assert 90e12 < f < 130e12


def test_kernel_forms_by_hand():
    # one group: chip_smoke.py's row-9 form
    B, S, H, P, N, L = 4, 2048, 80, 64, 64, 256
    nc, pairs = S // L, L * (L + 1) // 2
    assert zr.ssd_scan_flops(B, S, H, P, N, 1, L) == \
        2 * B * nc * (pairs * N + H * (pairs * P + 2 * L * N * P))
    assert zr.ssd_scan_bytes(B, S, H, P, N, 1) == \
        2 * B * S * (2 * H * P + 2 * N) + 4 * B * S * H + 8 * H \
        + 4 * B * H * N * P
    # two groups: C B^T twice, the per-head terms unchanged
    assert zr.ssd_scan_flops(B, S, H, P, N, 2, L) - \
        zr.ssd_scan_flops(B, S, H, P, N, 1, L) == 2 * B * nc * pairs * N
    assert zr.flash_bwd_flops(2, 4096, 32, 224) == \
        5 * roofline.flash_fwd_flops(2, 4096, 32, 224) // 2


def _trace(kernels):
    dev = [(name, 1000 * i, 1000 * i + 500) for i, name in
           enumerate(kernels)]
    return Trace(0, 1000 * len(kernels), dev, [])


def test_readers_read_their_plans():
    read = {n: spec.metric_reader(n) for n in NEW}
    plan = {"ssd_launches": {"kernels": ("ssd_cb_kernel", "ssd_out_kernel"),
                             "calls": 2, "launches_a_call": 2,
                             "bound_s": 250e-9},
            "flash_bwd_launches": {"calls": 1, "launches_a_call": 4,
                                   "bound_s": 1e-6}}
    tr = _trace(["ssd_cb_kernel", "ssd_out_kernel"] * 2
                + ["flash_bwd_dq_mma_kernel"]
                + ["flash_bwd_dkdv_mma_kernel"] * 2
                + ["flash_bwd_sum_kernel", "flash_fwd_mma_kernel"])
    ctx = {"trace": tr, "info": plan}
    assert read["ssd_scan_roofline.llm"](ctx) == pytest.approx(25.0)
    assert read["flash_bwd_roofline.llm"](ctx) == pytest.approx(50.0)
    short = {"trace": _trace(["ssd_cb_kernel"]), "info": plan}
    assert read["ssd_scan_roofline.llm"](short) is None
    assert read["flash_bwd_roofline.llm"](short) is None
    for name in NEW:
        assert read[name]({"trace": None, "info": {}}) is None


def test_ssd_bwd_ms_reads_the_sub_mark(monkeypatch):
    from bench.lib import marks
    s = lambda ms, **kw: SimpleNamespace(kind="eager", profiled=False,
                                         ms=ms, **kw)
    got = [s({"backward": 5.0, "ssd_backward": v}) for v in (3.0, 1.0, 2.0)]
    monkeypatch.setattr(marks, "unprofiled", lambda kind: got)
    read = spec.metric_reader("ssd_bwd_ms.llm")
    assert read({}) == statistics.median([3.0, 1.0, 2.0])
    monkeypatch.setattr(marks, "unprofiled",
                        lambda kind: [s({"backward": 5.0})] * 4)
    assert spec.metric_reader("ssd_bwd_ms.llm")({}) is None


# The faults of bench/tests/test_bench_faults.py, for this cell (its
# `_smoke.cell` sizes only the cells that split an LLM for INL)

def _run():
    from bench.lib import harness
    torch.set_num_threads(2)
    return harness.run_cell(smoke_cell(), seed=2 ** 32 + 9, seconds=0.1,
                            traced=False, device="cpu")


def test_sound_run_line():
    line = _run()
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"loss", "grad", "change"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in
                                    spec.load_cell(CELL).end_to_end}


def test_unchanged_state_is_not_correct(monkeypatch):
    from repro_torch import optim
    adamw = optim.adamw

    def frozen(*args, **kw):
        opt = adamw(*args, **kw)
        return optim.Optimizer(opt.init,
                               lambda grads, state, params, **_: (params,
                                                                  state))
    monkeypatch.setattr(optim, "adamw", frozen)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct(monkeypatch):
    from repro_torch.models import zoo
    xent = zoo.chunked_xent

    def half(params, cfg, h, labels, chunk=512):
        lab = labels.clone().reshape(-1)
        lab[lab.numel() // 2:] = -1
        return xent(params, cfg, h, lab.reshape(labels.shape), chunk=chunk)
    monkeypatch.setattr(zoo, "chunked_xent", half)
    assert _run()["correct"] is False


def test_control_is_not_correct():
    torch.set_num_threads(2)
    cell = smoke_cell()
    drv = spec.driver("llm_train").Driver(cell, 2 ** 31 + 5, "cpu")
    drv.setup()
    drv.release()
    got = compare.numbers(drv.reference(prec="fp8"), drv.reference())
    assert compare.judge(got, cell.limits["limits"])["correct"] is False
