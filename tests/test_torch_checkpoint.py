"""The port's checkpoints (repro_torch/checkpoint) against the reference's
contracts and files.

Twins of tests/test_checkpoint.py over torch trees:
  * a round trip keeps structure, values and dtypes, bf16 bit for bit
    (stored as fp32, recorded as "bfloat16");
  * `latest_step` orders numerically and counts only complete checkpoints
    (npz and sidecar);
  * a template of another structure, shape or dtype raises, with the
    reference's messages; a sidecar without dtypes still restores;
  * a save leaves no temporary file.
And across the packages:
  * a directory that `repro.checkpoint.save` wrote from a JAX INL state
    restores through the port into a numpy tree, and through
    `convert.inl_from_jax` predicts what the JAX state predicts (the bar of
    tests/test_torch_inl_predict.py);
  * a directory the port wrote restores through `repro.checkpoint`, and
    NamedTuple fields key the leaves as the reference's paths do;
  * leaves land on the template's dtype and device.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_common import jax_inl, views_np  # noqa: E402
from repro import checkpoint as jcheckpoint  # noqa: E402
from repro.configs.paper_inl import SMOKE  # noqa: E402
from repro.core import inl as jinl  # noqa: E402
from repro_torch import checkpoint, convert, tree_leaves  # noqa: E402
from repro_torch.core import inl as tinl  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones(4)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.full((2,), 0.5)],
    }


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def test_roundtrip_preserves_values_and_structure(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    checkpoint.save(d, 3, tree, extra={"note": "hi"})
    got, step = checkpoint.restore(d, tree)
    assert step == 3
    assert list(got) == list(tree) and list(got["params"]) == ["w", "b"]
    assert isinstance(got["nested"], list)
    assert _same(got, tree)
    meta = checkpoint.load_meta(d)
    assert meta["note"] == "hi" and meta["num_tensors"] == 4
    assert meta["total_params"] == 12 + 4 + 1 + 2
    assert meta["dtypes"] == {"params/w": "float32", "params/b": "float32",
                              "step": "int32", "nested/0": "float32"}


def test_bf16_roundtrip_is_bitwise_lossless(tmp_path):
    d = str(tmp_path)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(257)
                         * 1e3).to(torch.bfloat16)
    tree = {"w": x}
    checkpoint.save(d, 1, tree)
    got, _ = checkpoint.restore(d, tree)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
    # the sidecar remembers the original dtype, not the storage dtype
    assert checkpoint.load_meta(d)["dtypes"]["w"] == "bfloat16"
    with np.load(os.path.join(d, "ckpt_00000001.npz")) as data:
        assert data["w"].dtype == np.float32


def test_latest_step_numeric_ordering(tmp_path):
    d = str(tmp_path)
    assert checkpoint.latest_step(d) is None
    for s in (2, 10, 9):                       # lexicographic would say 9
        checkpoint.save(d, s, {"x": torch.full((1,), float(s))})
    assert checkpoint.latest_step(d) == 10
    got, step = checkpoint.restore(d, {"x": torch.zeros(1)})
    assert step == 10 and float(got["x"]) == 10.0


def test_latest_step_ignores_sidecarless_npz(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"x": torch.zeros(1)})
    # a crash between the npz's replace and the sidecar's: incomplete, so
    # invisible to resume
    with open(os.path.join(d, "ckpt_00000009.npz"), "wb") as f:
        f.write(b"torn")
    assert checkpoint.latest_step(d) == 1
    assert checkpoint.restore(d, {"x": torch.zeros(1)})[1] == 1


def test_no_tmp_files_left_behind(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 4, _tree())
    assert sorted(os.listdir(d)) == ["ckpt_00000004.json",
                                     "ckpt_00000004.npz"]


def test_structure_mismatch_is_loud(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="missing|extra"):
        checkpoint.restore(d, {"b": torch.zeros(2)})


def test_shape_mismatch_is_loud(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"a": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match=r"a: shape \(2, 3\) != \(3, 2\)"):
        checkpoint.restore(d, {"a": torch.zeros((3, 2))})


def test_dtype_mismatch_refuses_silent_cast(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"a": torch.zeros(4, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="refusing the silent cast"):
        checkpoint.restore(d, {"a": torch.zeros(4)})


def test_predtype_checkpoints_still_restore(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"a": torch.zeros(4)})
    meta_path = os.path.join(d, "ckpt_00000001.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["dtypes"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    got, _ = checkpoint.restore(d, {"a": torch.zeros(4)})
    assert torch.equal(got["a"], torch.zeros(4))


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path), {"a": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        checkpoint.load_meta(str(tmp_path))


def test_leaves_take_the_template_dtype_and_device(tmp_path):
    d = str(tmp_path)
    tree = {"m": torch.tensor([True, False]),
            "i": torch.arange(3, dtype=torch.int64),
            "h": torch.ones(2, dtype=torch.bfloat16)}
    checkpoint.save(d, 1, tree)
    got, _ = checkpoint.restore(d, tree)
    assert _same(got, tree)
    assert all(t.device == torch.device("cpu") for t in tree_leaves(got))
    # a numpy template restores into numpy leaves of its dtypes
    checkpoint.save(d, 2, {"m": tree["m"], "i": tree["i"]})
    arrays, _ = checkpoint.restore(d, {"m": np.zeros(2, bool),
                                       "i": np.zeros(3, np.int64)})
    assert arrays["m"].dtype == bool and arrays["i"].dtype == np.int64
    np.testing.assert_array_equal(arrays["i"], [0, 1, 2])


def test_a_jax_written_directory_restores_through_the_port(tmp_path):
    """repro.checkpoint.save of a JAX INL state -> the port's latest_step,
    load_meta and restore (into a numpy tree of the reference's
    structure) -> convert.inl_from_jax -> the same predictions."""
    d = str(tmp_path)
    jp, js = jax_inl(SMOKE)
    jcheckpoint.save(d, 5, {"params": jp, "state": js},
                     extra={"scheme": "inl"})
    assert checkpoint.latest_step(d) == 5
    meta = checkpoint.load_meta(d)
    assert meta["scheme"] == "inl" and meta["step"] == 5
    template = jax.tree.map(np.zeros_like, {"params": jp, "state": js})
    restored, step = checkpoint.restore(d, template)
    assert step == 5
    assert isinstance(restored["params"], jinl.INLParams)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(
            {"params": jp, "state": js})):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tp, ts = convert.inl_from_jax(restored["params"], restored["state"],
                                  SMOKE, device="cpu")
    views = views_np(SMOKE, 6)
    want = np.asarray(jax.jit(jinl.predict)(jp, js, jnp.asarray(views)))
    got = tinl.predict(tp, ts, views, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 1e-4
    assert np.array_equal(np.argmax(got, -1)[decided],
                          np.argmax(want, -1)[decided])


def test_a_port_written_directory_restores_through_the_reference(tmp_path):
    d = str(tmp_path)
    params, _ = tinl.init(SMOKE, 0, device="cpu")
    tree = {"params": params, "h": torch.ones(3, dtype=torch.bfloat16)}
    checkpoint.save(d, 2, tree)
    with np.load(os.path.join(d, "ckpt_00000002.npz")) as data:
        keys = set(data.files)
    # NamedTuple fields key the leaves, as the reference's GetAttrKey does
    assert "params/encoders/convs/0/w" in keys
    assert any(k.startswith("params/decoder/") for k in keys)
    template = {"params": tinl.INLParams(*(
        {k: jax.tree.map(lambda t: np.zeros(t.shape, np.float32), v)
         for k, v in part.items()} for part in params)),
        "h": jnp.zeros(3, jnp.bfloat16)}
    got, step = jcheckpoint.restore(d, template)
    assert step == 2 and got["h"].dtype == jnp.bfloat16
    flat_port = {"/".join(p): t for p, t in _paths(tree)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = "/".join(jcheckpoint._path_part(p) for p in path)
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      flat_port[key].float().numpy())


def _paths(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _paths(v, path + (f,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (str(i),))
