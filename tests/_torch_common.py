"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

JAX weights come from `repro.core.inl.init` and reach the port through
`repro_torch.convert.inl_from_jax`, so the tests never depend on either
framework's random streams.  The BatchNorm statistics, BatchNorm affine
parameters and biases that init leaves at 0/1 are overwritten with seeded
numpy noise, so every weight is non-trivial and non-symmetric: a wrong
flatten order or a transposed kernel cannot pass.
"""
from __future__ import annotations

import functools
import multiprocessing
import os
import queue
import time

import numpy as np
import pytest

import jax

import _torch_ranks
from repro.core import inl as jinl
from repro_torch import convert
from repro_torch.kernels import ref


def _noisy(tree, rng, *, around=0.0, spread=0.1, positive=False):
    """Seeded noise of `tree`'s shapes: around + spread * N(0, 1), with
    |N(0, 1)| where `positive` (a variance stays above `around`)."""
    def one(x):
        noise = rng.normal(size=np.shape(x))
        if positive:
            noise = np.abs(noise)
        return (around + spread * noise).astype(np.asarray(x).dtype)
    return jax.tree.map(one, tree)


@functools.lru_cache(maxsize=None)
def jax_inl(cfg, seed: int = 0):
    """(numpy params, numpy state) of the reference INL at `cfg`, with
    non-trivial BatchNorm and bias values."""
    # jitted: one compile instead of an eager compile per random op
    params, state = jax.jit(jinl.init, static_argnums=0)(
        cfg, jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed + 100)
    enc = dict(params.encoders)
    enc["bns"] = [{"scale": _noisy(b["scale"], rng, around=1.0, spread=0.2),
                   "bias": _noisy(b["bias"], rng)} for b in enc["bns"]]
    enc["convs"] = [{"w": c["w"], "b": _noisy(c["b"], rng)}
                    for c in enc["convs"]]
    dec = dict(params.decoder)
    dec["dense"] = [{"w": d["w"], "b": _noisy(d["b"], rng)}
                    for d in dec["dense"]]
    params = params._replace(encoders=enc, decoder=dec)
    state = {"encoders": {"bns": [
        {"mean": _noisy(s["mean"], rng),
         "var": _noisy(s["var"], rng, around=1.0, spread=0.2,
                       positive=True)}
        for s in state["encoders"]["bns"]]}}
    return params, state


# leaf name (and its parent's) -> (around, spread) of the seeded noise
_ZOO_NOISE = {"A_log": (0.0, 0.5), "D": (1.0, 0.2), "dt_bias": (-2.0, 0.5),
              "scale": (1.0, 0.2)}


def flat(tree, prefix=""):
    """{"/path/to/leaf": numpy array} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k2: v2 for k in tree
                for k2, v2 in flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def zoo_weights(jcfg, cfg):
    """(numpy params of the reference's zoo at `jcfg`, the port's params at
    `cfg` on the CPU).  The leaves init leaves constant (A_log, D, dt_bias,
    the norm scales, q_norm's and kv_norm's among them, every bias: the
    conv biases and the QKV biases) get seeded numpy noise, and Zamba2's
    per-layer adapters are drawn N(0, 1/d_model) in place of init's 1e-4
    scale, so the shared attention block moves the logits."""
    from repro.models import zoo as jzoo
    params = jax.jit(lambda k: jzoo.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(100)

    def noisy(path, x):
        x = np.asarray(x, np.float32)
        keys = [getattr(p, "key", None) for p in path]
        name = keys[-1]
        if name == "b":
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if name == "w" and keys[-2] == "adapter":
            return (rng.normal(size=x.shape) / np.sqrt(jcfg.d_model)) \
                .astype(np.float32)
        if name in _ZOO_NOISE:
            around, spread = _ZOO_NOISE[name]
            return (around + spread * rng.normal(size=x.shape)) \
                .astype(np.float32)
        return x
    params = jax.tree_util.tree_map_with_path(noisy, params)
    return params, convert.zoo_from_jax(params, cfg, device="cpu")


def torch_inl(cfg, seed: int = 0, device="cpu"):
    """The port's (params, state) holding the same weights as jax_inl."""
    return convert.inl_from_jax(*jax_inl(cfg, seed), cfg, device=device)


def views_np(cfg, n: int, seed: int = 0) -> np.ndarray:
    """(J, n, H, W, C) views from the reference's data generator."""
    from repro.data import multiview
    imgs, _ = multiview.make_base_dataset(n, image_shape=cfg.image_shape,
                                          seed=seed)
    return multiview.make_views(imgs, cfg.noise_stds)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import, so
    every xdist worker collects the same tests."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the H100 (see "
                    "README)")
    return torch.device("cuda")


def cut_inputs(shape, seed=0):
    """Seeded (mu, logvar, eps) fp32 numpy arrays of the cut layer."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(scale=2.0, size=shape).astype(np.float32)
    lv = rng.uniform(-3.0, 3.0, size=shape).astype(np.float32)
    eps = rng.normal(size=shape).astype(np.float32)
    return mu, lv, eps


def near_midpoint(mu, lv, eps, bits, tol=1e-6):
    """Entries whose pre-quantization value lies within `tol` of a rounding
    midpoint of the `bits`-bit grid (computed in float64)."""
    pre = mu.astype(np.float64) + np.exp(0.5 * lv.astype(np.float64)) \
        * eps.astype(np.float64)
    r = ref.QUANT_RANGE
    scale = ((1 << bits) - 1) / (2.0 * r)
    t = (np.clip(pre, -r, r) + r) * scale
    return np.abs(t - np.floor(t) - 0.5) / scale < tol


class SpawnedRanks:
    """`world` spawned processes, each a rank of a gloo process group over
    a FileStore in `tmp_path` (no TCP port), running
    fn(rank, world, *args) with one intra-op thread
    (`_torch_ranks.rank_entry`).  fn must live in a module without JAX
    (tests/_torch_ranks.py), so that a rank starts in seconds.  The ranks
    start at once; `results()` waits for them (at most `timeout` seconds
    from the start) and returns their results in rank order, or raises
    with the traceback of a rank that failed.  Every process is joined,
    and killed if it outlives the deadline or a rank failed."""

    def __init__(self, fn, world: int, tmp_path, *args, timeout: float):
        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._deadline = time.monotonic() + timeout
        store = os.path.join(str(tmp_path), "store")
        self._procs = [ctx.Process(target=_torch_ranks.rank_entry,
                                   args=(fn, r, world, store, args,
                                         self._queue))
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._results = None

    def results(self) -> list:
        if self._results is not None:
            return self._results
        got, failed = {}, None
        try:
            # drain the queue before joining (a rank blocks on a full pipe)
            while len(got) < len(self._procs) and failed is None:
                left = self._deadline - time.monotonic()
                try:
                    rank, ok, value = self._queue.get(timeout=max(left, 0.1))
                except queue.Empty:
                    failed = (f"{len(self._procs) - len(got)} rank(s) gave "
                              f"no result within the deadline")
                    break
                if ok:
                    got[rank] = value
                else:
                    failed = f"rank {rank} failed:\n{value}"
        finally:
            self._close(kill=failed is not None)
        if failed is not None:
            raise RuntimeError(failed)
        self._results = [got[r] for r in range(len(self._procs))]
        return self._results

    def close(self) -> None:
        """Stop the ranks whose results were never read (a run of a
        subset of the tests): they would block on the queue, and the
        interpreter would wait for them at exit."""
        self._close(kill=True)

    def _close(self, *, kill: bool) -> None:
        for p in self._procs:
            if not kill:
                p.join(timeout=max(self._deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        alive = [p.pid for p in self._procs if p.is_alive()]
        if alive:
            raise RuntimeError(f"ranks {alive} could not be stopped")
