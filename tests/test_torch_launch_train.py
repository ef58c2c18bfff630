"""The LLM training launcher and what it reads, against the reference.

  * `data/tokens.lm_batches` equal to the reference's bit for bit, for
    text, audio (K codebooks offset by 7 i) and VLM (patch embeddings,
    labels -1 over the prefix); the twin of
    `tests/test_substrate.py::test_token_stream_learnable`;
  * `data/prefetch.prefetch_to_device` on the CPU: twins of the four
    prefetch tests of `tests/test_sharded_parity.py`;
  * `configs.base.arch_for_shape`, `zoo.input_specs` and
    `zoo.cache_specs` against the reference's for every arch and shape
    (ids int64 in the port, int32 in the reference);
  * `launch/train.main` in-process at smoke size on the CPU, standard and
    inl (with learned priors): the reference's metric lines, `--prefetch
    1` == `--prefetch 2` bit for bit;
  * `chaos.crash_resume_check` on the CPU, in subprocesses: a real
    `python -m repro_torch.launch.train` SIGKILLed and resumed, its lines
    and final checkpoint equal to the uninterrupted run's bit for bit.
"""
import argparse
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import arch_for_shape as j_arch_for_shape  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.data import tokens as j_tokens  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch import chaos  # noqa: E402
from repro_torch.configs.base import (INPUT_SHAPES, LONG_CONTEXT_WINDOW,  # noqa
                                      arch_for_shape, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.data import prefetch, tokens  # noqa: E402
from repro_torch.launch import sharding, train  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

ARCHS = list_archs()


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs (the xdist workers share the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# token batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "musicgen-medium",
                                  "internvl2-2b"])
def test_lm_batches_equal_the_reference(arch):
    cfg, jcfg = get_smoke_config(arch), j_get_smoke(arch)
    got = list(tokens.lm_batches(cfg, 3, 17, steps=4, seed=5))
    want = list(j_tokens.lm_batches(jcfg, 3, 17, steps=4, seed=5))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
    if cfg.modality == "vlm":
        assert (got[0]["labels"][:, :cfg.num_prefix_tokens] == -1).all()
    if cfg.modality == "audio_tokens":
        mc = got[0]["tokens_mc"]
        np.testing.assert_array_equal(mc[..., 1],
                                      (mc[..., 0] + 7) % cfg.vocab_size)


def test_token_stream_learnable():
    """Twin of tests/test_substrate.py::test_token_stream_learnable."""
    toks = tokens.markov_stream(64, 4000, seed=1, noise=0.1)
    from collections import Counter, defaultdict
    nxt = defaultdict(Counter)
    for a, b in zip(toks[:-1], toks[1:]):
        nxt[a][b] += 1
    hit = sum(c.most_common(1)[0][1] for c in nxt.values())
    assert hit / (len(toks) - 1) > 0.5


# ---------------------------------------------------------------------------
# prefetch (twins of tests/test_sharded_parity.py's four)
# ---------------------------------------------------------------------------

def test_prefetch_preserves_order_and_values():
    items = [{"a": np.full((3,), i), "b": np.int32(i)} for i in range(5)]
    out = list(prefetch.prefetch_to_device(iter(items), size=2,
                                           device="cpu"))
    assert len(out) == 5
    for i, it in enumerate(out):
        assert isinstance(it["a"], torch.Tensor)
        np.testing.assert_array_equal(it["a"].numpy(), items[i]["a"])
        assert int(it["b"]) == i and it["b"].dtype == torch.int32


def test_prefetch_reraises_producer_exception():
    def flaky():
        yield np.zeros((2,))
        yield np.ones((2,))
        raise RuntimeError("disk fell over")

    it = prefetch.prefetch_to_device(flaky(), size=2, device="cpu")
    np.testing.assert_array_equal(next(it).numpy(), np.zeros((2,)))
    np.testing.assert_array_equal(next(it).numpy(), np.ones((2,)))
    with pytest.raises(RuntimeError, match="disk fell over"):
        next(it)


def test_prefetch_reraises_immediate_exception():
    def dead():
        raise ValueError("bad shard spec")
        yield  # pragma: no cover

    with pytest.raises(ValueError, match="bad shard spec"):
        next(prefetch.prefetch_to_device(dead(), device="cpu"))


def test_prefetch_consumer_can_stop_early():
    items = [np.full((2,), i) for i in range(100)]
    it = prefetch.prefetch_to_device(iter(items), size=2, device="cpu")
    assert int(next(it)[0]) == 0
    it.close()
    with pytest.raises(ValueError, match=">= 1"):
        next(prefetch.prefetch_to_device(iter(items), size=0,
                                         device="cpu"))


# ---------------------------------------------------------------------------
# shapes and specs
# ---------------------------------------------------------------------------

def _j_cache_shapes(arch, shape_name):
    """{path: (shape, dtype name)} of the reference's cache specs, the
    path as the port writes it (dict keys, list indices)."""
    jcfg = j_arch_for_shape(j_get_config(arch), J_SHAPES[shape_name])
    tree = j_zoo.cache_specs(jcfg, J_SHAPES[shape_name])
    return {tuple(getattr(q, "key", getattr(q, "idx", None)) for q in p):
            (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch):
    assert LONG_CONTEXT_WINDOW == 8192
    for name, shape in INPUT_SHAPES.items():
        jshape = J_SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.mode) == (
            jshape.seq_len, jshape.global_batch, jshape.mode)
        cfg = arch_for_shape(get_config(arch), shape)
        jcfg = j_arch_for_shape(j_get_config(arch), jshape)
        assert cfg.sliding_window == jcfg.sliding_window
        got = zoo.input_specs(cfg, shape)
        want = j_zoo.input_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k, (shp, dtype) in got.items():
            assert tuple(shp) == tuple(want[k].shape), (name, k)
            want_dtype = torch.int64 if str(want[k].dtype) == "int32" \
                else getattr(torch, str(want[k].dtype))
            assert dtype == want_dtype, (name, k)
        if shape.mode == "decode":
            got_c = {}
            sharding.map_with_path(
                lambda p, t: got_c.__setitem__(p, t),
                zoo.cache_specs(cfg, shape))
            assert all(t.device.type == "meta" for t in got_c.values())
            assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                    for p, t in got_c.items()} == _j_cache_shapes(arch, name)


def test_dummy_batch():
    cfg = get_smoke_config("internvl2-2b")
    shape = dataclass_shape("train", cfg.num_prefix_tokens + 8, 2)
    b = zoo.dummy_batch(cfg, shape, 3, device="cpu")
    specs = zoo.input_specs(cfg, shape)
    assert list(b) == list(specs)
    for k, (shp, dtype) in specs.items():
        assert tuple(b[k].shape) == tuple(shp) and b[k].dtype == dtype
    assert int(b["tokens"].max()) < cfg.vocab_size
    again = zoo.dummy_batch(cfg, shape, 3, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    d = zoo.dummy_batch(cfg, dataclass_shape("decode", 9, 2), device="cpu")
    assert int(d["cache_len"]) == 8 and d["tokens"].shape == (2, 1)


def dataclass_shape(mode, S, B):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"t_{mode}", S, B, mode)


# ---------------------------------------------------------------------------
# the CLI in-process
# ---------------------------------------------------------------------------

CLI = ["--arch", "llama3.2-1b", "--smoke", "--steps", "4", "--batch", "2",
       "--seq", "16", "--scan-steps", "2", "--device", "cpu"]


def test_train_cli_standard(capsys):
    hist = train.main(CLI)
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(x) for x in out if x.startswith("{")]
    assert [m["step"] for m in hist] == [1, 3] == [m["step"] for m in lines]
    for m, line in zip(hist, lines):
        assert set(m) == set(line) == {"ce", "loss", "grad_norm", "step",
                                       "wall_s"}
        assert all(math.isfinite(m[k]) for k in ("ce", "loss", "grad_norm"))
        assert line["loss"] == round(m["loss"], 4)
    assert out[0].startswith("arch=llama3.2-1b scheme=standard params=")
    assert out[-3].startswith(f"loss {hist[0]['loss']:.4f} -> "
                              f"{hist[-1]['loss']:.4f} (4 steps")
    assert out[-2] == "step split: not measured on cpu"   # no device marks
    assert out[-1] == "kernel launches: {}"       # no kernel on the CPU
    again = train.main(CLI + ["--prefetch", "1"])
    assert [m["loss"] for m in again] == [m["loss"] for m in hist]
    assert [m["grad_norm"] for m in again] == [m["grad_norm"] for m in hist]


def test_train_cli_inl_learned_prior(capsys):
    args = train.parse_args(CLI + ["--scheme", "inl", "--learned-prior"])
    cfg = train.model_config(args)
    assert cfg.num_layers == cfg.inl.encoder_layers + 1
    assert cfg.inl.learned_prior and cfg.dtype == "float32"
    hist = train.main(CLI + ["--scheme", "inl", "--learned-prior"])
    assert len(hist) == 2
    for m in hist:
        assert {"ce_joint", "rate_mean", "loss", "step"} <= set(m)
        assert all(math.isfinite(v) for v in m.values())
    out = capsys.readouterr().out.splitlines()
    assert out[-3].startswith("loss ")
    assert out[-2].startswith("step split: ")


def test_crash_resume_check_on_the_cpu(tmp_path, monkeypatch):
    """The reference's own assertion: SIGKILL once step 3's line is out,
    resume from the newest checkpoint (step 4's, or step 2's when the
    kill lands before the group's save), the resumed lines and the final
    checkpoint (params, AdamW state, the inl generator) bit for bit the
    golden run's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = argparse.Namespace(
        arch="llama3.2-1b", scheme="inl", steps=6, batch=2, seq=16,
        scan_steps=2, ckpt_every=2, kill_after_step=3, seed=0,
        workdir=str(tmp_path), device="cpu", learned_prior=True)
    rec = chaos.crash_resume_check(args)
    assert rec["bitwise_identical"] and rec["final_step"] == 6
    r = rec["resume_from_step"]
    assert r in (2, 4) and rec["metric_lines_compared"] == (6 - r) // 2
    assert rec["tensors_compared"] > 50
    assert rec["kernel_launches"] == {"golden": {}, "resumed": {}}
    argv = chaos._train_argv(args, "d", resume=True)
    assert argv[1:3] == ["-m", "repro_torch.launch.train"]
    assert {"--learned-prior", "--resume"} <= set(argv)
