"""The dry-run (`repro_torch.launch.dryrun`) and the H100 roofline
(`repro_torch.roofline.analysis`).

  * twins of `tests/test_substrate.py`'s `test_roofline_terms_dominance`
    and `test_model_flops_modes`, with the H100's data-sheet constants;
  * `model_flops` equal to the reference's for the ten architectures at
    the four input shapes, and `roofline_terms` and `analyze` equal to the
    reference's with its `Hardware` given the H100's constants;
  * the dense smoke Llama's prefill FLOPs counted on `meta` tensors equal
    the closed form within 1%: 2 x the matmul parameters x the tokens,
    plus the attention term as the plain version computes it (every
    (query, key) product, the causal mask applied after, as the
    reference's cost oracle counts it), plus the tied unembedding of the
    last position;
  * the 1- and 2-period compensation on a 3-period smoke model equals its
    direct count (FLOPs and bytes, a whole train step);
  * a kernel's plain version on meta tensors counts as the kernel: its
    inputs and outputs once;
  * the per-rank argument bytes on a 1-rank mesh equal the bytes of the
    same params, AdamW state and batch made on the CPU;
  * `--arch all --shape all --mesh single` at smoke size: 40 records,
    each `ok`.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import arch_for_shape as j_arch_for_shape  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.roofline import analysis as j_roofline  # noqa: E402
from repro_torch import tree_leaves  # noqa: E402
from repro_torch.configs.base import (INPUT_SHAPES, ShapeConfig,  # noqa: E402
                                      arch_for_shape, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, zoo  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs (the xdist workers share the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_h100_constants():
    hw = roofline.HW
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 80e9)
    assert "H100" in hw.name and "700 W" in hw.name


def test_roofline_terms_dominance():
    """Twin of tests/test_substrate.py::test_roofline_terms_dominance."""
    t = roofline.roofline_terms(1e15, 1e12, 1e9, 256)
    assert t["dominant"] == "compute"
    t = roofline.roofline_terms(1e12, 1e15, 1e9, 256)
    assert t["dominant"] == "memory"
    t = roofline.roofline_terms(1e10, 1e10, 1e13, 256)
    assert t["dominant"] == "collective"
    t = roofline.roofline_terms(989e12 * 256, 3.35e12 * 256, 450e9 * 256,
                                256)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0


def test_model_flops_modes():
    """Twin of tests/test_substrate.py::test_model_flops_modes."""
    cfg = get_config("llama3.2-1b")
    n = cfg.param_count()
    f_train = roofline.model_flops(cfg, INPUT_SHAPES["train_4k"])
    f_prefill = roofline.model_flops(cfg, INPUT_SHAPES["prefill_32k"])
    f_decode = roofline.model_flops(cfg, INPUT_SHAPES["decode_32k"])
    assert f_train == 6 * n * 256 * 4096
    assert f_prefill == 2 * n * 32 * 32768
    assert f_decode == 2 * n * 128
    ds = get_config("deepseek-v2-236b")
    assert roofline.model_flops(ds, INPUT_SHAPES["train_4k"]) \
        < 6 * ds.param_count() * 256 * 4096


# the reference's Hardware with the H100's constants in place of v5e's
J_H100 = j_roofline.Hardware(name=roofline.HW.name,
                             peak_flops=roofline.HW.peak_flops,
                             hbm_bw=roofline.HW.hbm_bw,
                             ici_bw=roofline.HW.link_bw,
                             hbm_bytes=roofline.HW.hbm_bytes)
# (flops, hbm bytes, collective bytes, chips): each term dominant once,
# a tie, a zero term, one chip and the 512-chip mesh
RECORDS = [(1e15, 1e12, 1e9, 256), (1e12, 1e15, 1e9, 256),
           (1e10, 1e10, 1e13, 256), (989e12, 3.35e12, 450e9, 1),
           (7.274e13, 1.37e12, 0.0, 1), (3.1e18, 2.2e16, 4.4e15, 512)]


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference(arch, shape_name):
    """6ND / 2ND / 2NB over the active parameters (a MoE's routed
    experts counted k of E) as the reference counts them, on each arch's
    config as `arch_for_shape` makes it for the shape."""
    shape, j_shape = INPUT_SHAPES[shape_name], J_SHAPES[shape_name]
    got = roofline.model_flops(arch_for_shape(get_config(arch), shape),
                               shape)
    want = j_roofline.model_flops(
        j_arch_for_shape(j_get_config(arch), j_shape), j_shape)
    assert got == want > 0


@pytest.mark.parametrize("record", RECORDS)
def test_roofline_terms_equal_the_reference(record):
    assert roofline.roofline_terms(*record) == \
        j_roofline.roofline_terms(*record, hw=J_H100)


@pytest.mark.parametrize("arch", list_archs())
def test_analyze_equals_the_reference(arch):
    """`analyze` on one record a term dominates: the reference's terms,
    model FLOPs and useful ratio (its `hlo_flops` is `counted_flops`
    here), the port's own suggestion and hardware name."""
    shape, j_shape = INPUT_SHAPES["train_4k"], J_SHAPES["train_4k"]
    cfg = arch_for_shape(get_config(arch), shape)
    j_cfg = j_arch_for_shape(j_get_config(arch), j_shape)
    for flops, hbm, coll, chips in RECORDS[:3]:
        rec = {"flops": flops, "hbm_bytes": hbm, "coll_bytes": coll}
        got = roofline.analyze(rec, cfg, shape, chips)
        want = j_roofline.analyze(rec, j_cfg, j_shape, chips, hw=J_H100)
        want["counted_flops"] = want.pop("hlo_flops")
        del want["suggestion"]
        assert got.pop("suggestion") == roofline._SUGGESTIONS[got["dominant"]]
        assert got.pop("hardware") == roofline.HW.name
        assert got == want


def test_prefill_flops_closed_form():
    cfg = get_smoke_config("llama3.2-1b")
    assert cfg.tie_embeddings and not cfg.is_moe
    B, S = 2, 64
    shape = ShapeConfig("p", S, B, "prefill")
    flops, _ = dryrun.count(cfg, shape)
    params = zoo.init_params(cfg, 0, device="meta")
    # the stack's matmul weights: every leaf named "w" (dense layers)
    n_mm = []
    from repro_torch.launch import sharding
    sharding.map_with_path(
        lambda path, t: n_mm.append(t.numel())
        if path[0] == "stack" and path[-1] == "w" else None, params)
    attn = 4 * B * cfg.num_heads * S * S * cfg.head_dim * cfg.num_layers
    unembed = 2 * B * layers.pad_vocab(cfg.vocab_size) * cfg.d_model
    want = 2 * sum(n_mm) * B * S + attn + unembed
    assert abs(flops - want) <= 0.01 * want, (flops, want)
    assert flops == want          # the counter counts the matmuls only


def test_period_compensation_equals_direct_count():
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), num_layers=3)
    shape = ShapeConfig("t", 32, 2, "train")
    (f1, b1), (f2, b2), (f3, b3) = (
        dryrun.count(dryrun._variant(cfg, k, cost_oracle=True), shape)
        for k in (1, 2, 3))
    assert f1 < f2 < f3
    assert f1 + 2 * (f2 - f1) == f3
    assert b1 + 2 * (b2 - b1) == b3
    rec = dryrun.run_record("llama3.2-1b", cfg, shape,
                            mesh_lib.AbstractMesh((1, 1), ("data", "model")),
                            "one")
    assert rec["compensation"]["periods"] == 3
    assert rec["cost"]["flops"] == f3


def test_kernel_counts_as_itself_on_meta():
    q = torch.empty((2, 128, 4, 32), device="meta")
    kv = torch.empty((2, 128, 2, 32), device="meta")
    plain = ops.attention
    with dryrun.counting() as (_, counter):
        o = ops.attention(q, kv, kv)
    assert o.shape == q.shape and o.device.type == "meta"
    assert counter.bytes == 4 * (2 * q.numel() + 2 * kv.numel())
    assert counter.inside == 0 and ops.attention is plain
    counter = dryrun._ByteCounter()
    with counter:                      # the plain ops, one by one
        ops.ref.attention_ref(q, kv, kv)
    assert counter.bytes > 8 * (2 * q.numel() + 2 * kv.numel())


def test_backward_kernel_counts_as_itself_on_meta():
    """The attention backward (flash_attn_bwd on the card) counts its six
    inputs and three outputs once, none of its plain version's tiles."""
    q = torch.empty((2, 128, 4, 32), device="meta")
    kv = torch.empty((2, 128, 2, 32), device="meta")
    lse = torch.empty((2, 128, 4), device="meta")
    plain = ops.attention_bwd
    with dryrun.counting() as (_, counter):
        grads = ops.attention_bwd(q, kv, kv, q, lse, q)
    assert [g.shape for g in grads] == [q.shape, kv.shape, kv.shape]
    assert counter.bytes == 4 * (4 * q.numel() + 4 * kv.numel()
                                 + lse.numel())
    assert counter.inside == 0 and ops.attention_bwd is plain


def test_argument_bytes_equal_real_tensors():
    cfg = get_smoke_config("llama3.2-1b")
    shape = ShapeConfig("t", 16, 2, "train")
    mesh = mesh_lib.AbstractMesh((1, 1), ("data", "model"))
    exact, allocated = dryrun.argument_bytes(cfg, shape, mesh)
    params = zoo.init_params(cfg, 0, device="cpu")
    opt = steps.default_optimizer(cfg).init(params)
    batch = zoo.dummy_batch(cfg, shape, 0, device="cpu")
    real = {k: sum(t.numel() * t.element_size() for t in tree_leaves(v))
            for k, v in (("params", params), ("opt_state", opt),
                         ("batch", batch))}
    assert exact == real
    assert all(allocated[k] >= exact[k] and allocated[k] % 512 == 0
               for k in exact)
    # the pod mesh's rank holds a 256th of the FSDP/TP-sharded leaves
    pod = dryrun.argument_bytes(get_config("llama3.2-1b"),
                                INPUT_SHAPES["train_4k"],
                                mesh_lib.make_production_mesh())[0]
    full = dryrun.argument_bytes(get_config("llama3.2-1b"),
                                 INPUT_SHAPES["train_4k"], mesh)[0]
    assert full["params"] / 256 <= pod["params"] < full["params"] / 200


def test_all_records_at_smoke_size(tmp_path):
    out = str(tmp_path / "dr")
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--smoke", "--arch", "all", "--shape", "all",
                     "--mesh", "single", "--no-compensation", "--out", out])
    assert done.value.code == 0
    files = sorted(os.listdir(out))
    assert len(files) == len(list_archs()) * len(INPUT_SHAPES) == 40
    for fn in files:
        with open(os.path.join(out, fn)) as f:
            rec = json.load(f)
        assert rec["status"] == "ok", (fn, rec.get("error"))
        assert rec["chips"] == 256 and rec["memory"]["fits_hbm"]
        r = rec["roofline"]
        assert r["dominant"] in ("compute", "memory", "collective")
        assert rec["cost"]["flops"] > 0 and rec["cost"]["hbm_bytes"] > 0
        if rec["arch"] == "xlstm-125m" and rec["shape"] in ("train_4k",
                                                             "prefill_32k"):
            assert rec["seq_extrapolated"]["from"] == list(dryrun.XLSTM_SEQS)
