"""The LLM sharding rules (`repro_torch.launch.sharding`) against the
reference's (`repro.launch.sharding`), leaf by leaf.

For every one of the ten architectures' FULL configs, on the single pod
`AbstractMesh((16, 16), ("data", "model"))`, the (2, 16, 16) multi-pod
mesh and `make_inl_mesh(4)`'s (client, data, model) shape: `param_spec`
of every parameter, `opt_state_shardings` (ZeRO-1) of every leaf of
`default_optimizer`'s state, `cache_spec` of every cache leaf at
`decode_32k` and `long_500k`, and `batch_spec` of every input at the four
shapes equal the reference's.  The reference's trees are `jax.eval_shape`
trees and the port's `meta` trees: nothing is compiled or allocated.  The
per-rank bytes of params, optimizer state and caches equal the same
arithmetic on the reference's specs.  Plus the twin of
`tests/test_substrate.py::test_param_specs_divisibility_guard`, the pod
meshes' shapes, and a fact of the reference the port keeps: its
`client_axis` rule never fires on an `INLLLMParams` tree.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import arch_for_shape as j_arch_for_shape  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.core import inl_llm as j_inl_llm  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.launch import sharding as j_sharding  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch.configs.base import (INPUT_SHAPES, arch_for_shape,  # noqa
                                      get_config, get_smoke_config,
                                      list_archs)
from repro_torch.core import inl_llm  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding, steps  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

ARCHS = list_archs()
META = torch.device("meta")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs (the xdist workers share the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes():
    """(name, the port's mesh, the reference's) for the three layouts."""
    inl = mesh_lib.make_inl_mesh(4)
    c = j_mesh._client_axis_size(4, 256 // 16)
    assert tuple(inl.shape.values()) == (c, 256 // (16 * c), 16)
    out = []
    for name, m in (("single", mesh_lib.make_production_mesh()),
                    ("multi", mesh_lib.make_production_mesh(multi_pod=True)),
                    ("inl", inl)):
        out.append((name, m, JaxAbstractMesh(tuple(m.shape.values()),
                                             tuple(m.axis_names))))
    return out


def _norm(spec) -> tuple:
    """A spec as a plain tuple, one-name tuples as the name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _port_path(jpath) -> tuple:
    out = []
    for p in jpath:
        if hasattr(p, "key"):
            out.append(p.key)
        elif hasattr(p, "idx"):
            out.append(p.idx)
        else:
            out.append(sharding.Field(p.name))
    return tuple(out)


def _leaves_with_paths(jtree):
    return [(_port_path(path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jtree)[0]]


def _port_leaves(tree):
    out = {}
    sharding.map_with_path(lambda p, leaf: out.__setitem__(p, leaf), tree)
    return out


def _get(tree, path):
    for p in path:
        tree = getattr(tree, p) if isinstance(p, sharding.Field) else tree[p]
    return tree


def _bytes_on(jleaf, jspec, jmesh) -> int:
    """What a rank holds of a reference leaf under the reference's spec."""
    n = int(np.prod(jleaf.shape, dtype=np.int64))
    for e in tuple(jspec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            n //= jmesh.shape[a]
    return n * jnp.dtype(jleaf.dtype).itemsize


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference params, opt state, the port's) of the full config."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jp = jax.eval_shape(functools.partial(j_zoo.init_params, jcfg),
                        jax.random.PRNGKey(0))
    jo = jax.eval_shape(j_steps.default_optimizer(jcfg).init, jp)
    p = zoo.init_params(cfg, 0, device=META)
    o = steps.default_optimizer(cfg).init(p)
    return jp, jo, p, o


def _check_tree(jtree, tree, jspec_of, spec_tree, jmesh, mesh, what):
    """Every leaf's spec equal, and the per-rank bytes equal."""
    port = _port_leaves(tree)
    jleaves = _leaves_with_paths(jtree)
    assert sorted(map(str, port)) == sorted(str(p) for p, _ in jleaves), what
    want_bytes = 0
    for path, jleaf in jleaves:
        jspec = jspec_of(path, jleaf)
        got = _get(spec_tree, path)
        assert tuple(port[path].shape) == tuple(jleaf.shape), (what, path)
        assert _norm(got) == _norm(jspec), (what, path, got, jspec)
        want_bytes += _bytes_on(jleaf, jspec, jmesh)
    got_bytes = sum(sharding.leaf_shard_bytes(tree, spec_tree, mesh))
    assert got_bytes == want_bytes, (what, got_bytes, want_bytes)


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_the_reference(arch):
    jp, jo, p, o = _trees(arch)
    for name, mesh, jmesh in _meshes():
        what = f"{arch} on {name}"
        p_specs = sharding.param_shardings(p, mesh)
        _check_tree(jp, p, lambda path, leaf: j_sharding.param_spec(
            [_JKey(k) for k in path], leaf, jmesh), p_specs, jmesh, mesh,
            f"{what} params")
        o_specs = sharding.opt_state_shardings(o, p_specs, mesh)
        jo_specs = jax.tree_util.tree_map_with_path(
            lambda path, leaf: _OneSpec(path, leaf, jmesh), jo)
        _check_tree(jo, o, lambda path, leaf: _get_j(jo_specs, path),
                    o_specs, jmesh, mesh, f"{what} opt state")
        for shape_name in ("decode_32k", "long_500k"):
            jcfg = j_arch_for_shape(j_get_config(arch), J_SHAPES[shape_name])
            cfg = arch_for_shape(get_config(arch), INPUT_SHAPES[shape_name])
            jc = j_zoo.cache_specs(jcfg, J_SHAPES[shape_name])
            c = zoo.cache_specs(cfg, INPUT_SHAPES[shape_name])
            _check_tree(jc, c, lambda path, leaf: j_sharding.cache_spec(
                [_JKey(k) for k in path], leaf, jmesh),
                sharding.cache_shardings(c, mesh), jmesh, mesh,
                f"{what} cache {shape_name}")
        for shape_name, shape in INPUT_SHAPES.items():
            cfg = arch_for_shape(get_config(arch), shape)
            jcfg = j_arch_for_shape(j_get_config(arch), J_SHAPES[shape_name])
            specs = zoo.input_specs(cfg, shape)
            jspecs = j_zoo.input_specs(jcfg, J_SHAPES[shape_name])
            got = sharding.batch_shardings(specs, mesh)
            assert list(got) == list(jspecs)
            for k, leaf in jspecs.items():
                assert _norm(got[k]) == _norm(
                    j_sharding.batch_spec(k, leaf, jmesh)), (what, k)


class _JKey:
    """A path entry the reference's rules read (a `DictKey` for a str,
    an index otherwise)."""

    def __init__(self, k):
        if isinstance(k, str) and not isinstance(k, sharding.Field):
            self.key = k
        else:
            self.idx = k


class _OneSpec:
    """The reference's ZeRO-1 spec of one optimizer-state leaf (its
    `opt_state_shardings` wraps each in a NamedSharding, which needs a
    concrete mesh; its `one` rule is applied here to the abstract one)."""

    def __init__(self, path, leaf, jmesh):
        names = [p.key for p in path if hasattr(p, "key")]
        if leaf.ndim == 0 or (names and names[0] == "step"):
            self.spec = jax.sharding.PartitionSpec()
            return
        spec = list(j_sharding.param_spec(path[1:], leaf, jmesh))
        dp = j_sharding._dp(jmesh)
        used = {a for s in spec if s is not None
                for a in (s if isinstance(s, tuple) else (s,))}
        free = tuple(a for a in dp if a not in used)
        total = int(np.prod([j_sharding._axis_size(jmesh, a)
                             for a in free])) if free else 1
        if total > 1:
            for ax in range(leaf.ndim):
                if spec[ax] is None and leaf.shape[ax] % total == 0:
                    spec[ax] = free if len(free) > 1 else free[0]
                    break
        self.spec = jax.sharding.PartitionSpec(*spec)


def _get_j(tree, path):
    for p in path:
        tree = tree[p] if not isinstance(p, sharding.Field) \
            else getattr(tree, p)
    return tree.spec


def test_reference_opt_rule_is_the_one_mirrored():
    """The `_OneSpec` stand-in above is the reference's own rule: on a
    concrete one-device mesh its NamedShardings give the same specs."""
    jcfg = j_get_smoke("deepseek-v2-236b")
    jp = jax.eval_shape(functools.partial(j_zoo.init_params, jcfg),
                        jax.random.PRNGKey(0))
    jo = jax.eval_shape(j_steps.default_optimizer(jcfg).init, jp)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jmesh = JaxAbstractMesh((1, 1), ("data", "model"))
    real = j_sharding.opt_state_shardings(
        jo, j_sharding.param_shardings(jp, mesh), mesh)
    mine = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _OneSpec(path, leaf, jmesh), jo)
    for (path, r), m in zip(
            jax.tree_util.tree_flatten_with_path(real)[0],
            jax.tree_util.tree_leaves(
                mine, is_leaf=lambda x: isinstance(x, _OneSpec))):
        assert _norm(r.spec) == _norm(m.spec), path


def test_param_specs_divisibility_guard():
    """Twin of tests/test_substrate.py::test_param_specs_divisibility_guard."""
    mesh = mesh_lib.AbstractMesh((16, 16), ("data", "model"))
    P = sharding.PartitionSpec
    bf16 = torch.bfloat16
    spec = sharding.param_spec(("attn", "wq", "w"), ((2048, 4096), bf16),
                               mesh)
    assert spec == P("data", "model")
    # non-divisible output dim stays replicated on model
    spec2 = sharding.param_spec(("attn", "wq", "w"), ((2048, 20), bf16),
                                mesh)
    assert spec2 == P("data", None)
    # moe experts on model, fsdp on d
    spec3 = sharding.param_spec(("moe", "wi"), ((4, 128, 2048, 64), bf16),
                                mesh)
    assert spec3 == P(None, "model", "data", None)
    # norms replicated
    spec4 = sharding.param_spec(("attn_norm", "scale"), ((2048,), bf16),
                                mesh)
    assert spec4 == P(None)


def test_pod_meshes():
    """The production and INL meshes: the reference's shapes and axis
    names, 256 and 512 chips; J with no common divisor falls back to a
    replicated client axis with the reference's warning."""
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    for J in (1, 2, 4, 5, 16):
        for pod in (False, True):
            m = mesh_lib.make_inl_mesh(J, multi_pod=pod)
            slots = (512 if pod else 256) // 16
            c = j_mesh._client_axis_size(J, slots) if J != 5 else 1
            assert m.axis_names == ("client", "data", "model")
            assert m.shape["client"] == c and m.size == slots * 16
    with pytest.warns(UserWarning, match="replicated client"):
        mesh_lib.make_inl_mesh(5)
    P = sharding.PartitionSpec
    assert sharding.wire_specs(mesh_lib.make_inl_mesh(4)) == (
        P(None, ("data",), None, None), P("client", ("data",), None, None))
    assert sharding.wire_specs(single) == (None, None)


def test_inl_client_axis_never_fires_in_the_reference():
    """`param_spec(client_axis=True)` gives a leaf 'client' only when its
    path's first dict key is "encoders"; an `INLLLMParams` tree's first
    path entry is the NamedTuple field (a `GetAttrKey`), which the
    reference's rules skip, so no encoder leaf gets 'client' there
    (ROADMAP queue 3).  The port keeps the reference's rule."""
    jcfg, cfg = j_get_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    mesh = mesh_lib.make_inl_mesh(jcfg.inl.num_nodes)
    jmesh = JaxAbstractMesh(tuple(mesh.shape.values()),
                            tuple(mesh.axis_names))
    jp = jax.eval_shape(functools.partial(j_inl_llm.init, jcfg),
                        jax.random.PRNGKey(0))
    p = inl_llm.init(cfg, 0, device=META)
    specs = sharding.param_shardings(p, mesh, client_axis=True)
    seen = 0
    for path, jleaf in _leaves_with_paths(jp):
        jspec = j_sharding.param_spec(
            [_JKey(k) if not isinstance(k, sharding.Field) else _Attr(k)
             for k in path], jleaf, jmesh, client_axis=True)
        got = _get(specs, path)
        assert _norm(got) == _norm(jspec), path
        assert "client" not in _norm(jspec)
        seen += 1
    assert seen == len(_port_leaves(p))


class _Attr:
    def __init__(self, name):
        self.name = name
