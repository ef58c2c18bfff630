"""The sharded rounds' arithmetic in float64: a witness that a mesh round
differs from the single-device round by rounding alone.

Run as a script with a float64 copy of repro_torch (every `torch.float32`
of the package read as `torch.float64`, `float64_copy` below) first on
PYTHONPATH:

    python tests/_torch_f64_witness.py OUT.json

It spawns two worlds of two gloo ranks (a FileStore next to OUT.json, one
intra-op thread a rank): (client=1, data=2) on J=5 runs three INL, SL and
FL rounds, (client=2, data=1) on J=2 three INL, INL with learned priors
and FL rounds, each round from the single-device round's state and
generator state; every rank holds its slice of the new state against its
slice of the single-device round's.  OUT.json gets, a world and case, the
largest relative 2-norm deviation of a leaf over the rounds and the ranks
(the conv biases and BatchNorm's running means apart: their exact
gradient is zero, so they carry rounding alone) and its path.  In float32
the same deviations are 1e-7 to 1e-5 (tests/test_torch_sharded.py); a
wrong transpose or a missing mean parts them by O(1).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import multiprocessing
import os
import re
import shutil
import sys
import traceback
import warnings

NOISE_LEAF = re.compile(r"/convs/\d+/b$|/bns/\d+/mean$")
ROUNDS = 3
BATCH = 16


def float64_copy(src_pkg: str, dst_root: str) -> str:
    """A copy of the package directory `src_pkg` under `dst_root` with
    every `torch.float32` read as `torch.float64`; returns `dst_root`."""
    dst = os.path.join(dst_root, os.path.basename(src_pkg.rstrip(os.sep)))
    shutil.copytree(src_pkg, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.cu", "*.cuh"))
    for root, _, files in os.walk(dst):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    text = fh.read()
                with open(path, "w") as fh:
                    fh.write(text.replace("torch.float32", "torch.float64"))
    return dst_root


def _leaves(tree, prefix=""):
    import torch
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [x for k, v in items for x in _leaves(v, f"{prefix}/{k}")]


def _case(mesh, key, cfg):
    import torch
    from repro_torch.core import schemes
    from repro_torch.data import multiview
    from repro_torch.launch import sharding

    name = key.split("+")[0]
    if key.endswith("+learned_prior"):
        cfg = dataclasses.replace(cfg, learned_prior=True)
    scheme = schemes.get(name)
    R = scheme.batches_per_round(cfg)
    imgs, labels = multiview.make_base_dataset(
        R * BATCH, image_shape=cfg.image_shape, seed=0)
    views = torch.from_numpy(multiview.make_views(imgs, cfg.noise_stds))
    views = views.to(torch.float64).reshape(
        (views.shape[0], R, BATCH) + tuple(views.shape[2:])).transpose(0, 1)
    labels = torch.from_numpy(labels).long().reshape(R, BATCH)
    state = scheme.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    single = scheme.make_round(cfg)
    sharded = scheme.make_sharded_round(cfg, mesh)
    specs = scheme.state_shardings(cfg, state, mesh)
    gen = torch.Generator().manual_seed(1)
    worst = (0.0, None)
    for _ in range(ROUNDS):
        gen_mesh = torch.Generator()
        gen_mesh.set_state(gen.get_state())
        got, _ = sharded(sharding.shard_state(state, specs, mesh), views,
                         labels, gen_mesh)
        state, _ = single(state, views, labels, gen)
        want = sharding.shard_state(state, specs, mesh)
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            if not b.is_floating_point() or NOISE_LEAF.search(path):
                continue
            dev = float((a - b).norm() / b.norm().clamp_min(1e-300))
            if dev > worst[0]:
                worst = (dev, path)
    return worst


def _rank(rank, world, store, num_clients, keys, queue):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)      # the parameters' init
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        from repro_torch.configs.paper_inl import PaperExperimentConfig
        from repro_torch.core import paper_model
        from repro_torch.launch import mesh as mesh_lib
        cfg = PaperExperimentConfig(
            conv_channels=(4, 8), d_bottleneck=8, dense_units=(32,),
            image_shape=(16, 16, 3), num_clients=num_clients,
            noise_stds=(0.4, 1.0, 2.0, 3.0, 4.0)[:num_clients])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            mesh = mesh_lib.make_inl_host_mesh(num_clients, device="cpu")
        out = {"shape": dict(mesh.shape),
               "dtype": str(paper_model.COMPUTE_DTYPES["fp32"])}
        out.update({key: _case(mesh, key, cfg) for key in keys})
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


WORLDS = {"data": (5, ("inl", "sl", "fl")),
          "client": (2, ("inl", "inl+learned_prior", "fl"))}


def main(out_path: str, timeout: float = 240.0) -> int:
    ctx = multiprocessing.get_context("spawn")
    results = {}
    for world_name, (J, keys) in WORLDS.items():
        store = f"{out_path}.{world_name}.store"
        if os.path.exists(store):
            os.unlink(store)
        queue = ctx.Queue()
        procs = [ctx.Process(target=_rank, args=(r, 2, store, J, keys,
                                                 queue))
                 for r in range(2)]
        for p in procs:
            p.start()
        got = []
        try:
            for _ in procs:
                rank, ok, value = queue.get(timeout=timeout)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got.append(value)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        results[world_name] = {
            "shape": got[0]["shape"], "dtype": got[0]["dtype"],
            **{key: max((g[key] for g in got), key=lambda d: d[0])
               for key in keys}}
    with open(out_path, "w") as fh:
        json.dump(results, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
