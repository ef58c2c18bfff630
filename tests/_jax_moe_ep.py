"""The reference's expert-parallel MoE on a forced multi-device CPU mesh,
for tests/test_torch_moe_ep.py.

Run as a script with XLA_FLAGS=--xla_force_host_platform_device_count=4
(jax fixes its device count when it first starts, so this runs in a
process of its own, as the reference's dry-run gets its devices):

    python tests/_jax_moe_ep.py IN.pkl OUT.pkl

IN holds a list of cases {cfg, mesh: (data, model), params, x, ct_y,
c_lb, c_z} (numpy leaves); OUT gets, per case, the reference's y, aux and
the VJP of (y, lb_loss, z_loss) with cotangents (ct_y, c_lb, c_z) with
respect to x and every parameter, all numpy.
"""
import pickle
import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.models import moe


def run(case):
    data, model = case["mesh"]
    mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    cfg = case["cfg"]
    params = jax.tree.map(jnp.asarray, case["params"])
    x = jnp.asarray(case["x"])
    jax.sharding.set_mesh(mesh)

    def f(p, x):
        y, aux = moe.moe_apply_ep(p, cfg, x)
        return y, aux["lb_loss"], aux["z_loss"], aux["expert_load"]

    @jax.jit
    def value_and_vjp(p, x, ct_y, c_lb, c_z):
        (y, lb, z, load), vjp = jax.vjp(f, p, x)
        return (y, lb, z, load), vjp((ct_y, c_lb, c_z, jnp.zeros_like(load)))

    (y, lb, z, load), (dp, dx) = value_and_vjp(
        params, x, jnp.asarray(case["ct_y"]), jnp.float32(case["c_lb"]),
        jnp.float32(case["c_z"]))
    return {"y": np.asarray(y), "lb_loss": float(lb), "z_loss": float(z),
            "expert_load": np.asarray(load), "dx": np.asarray(dx),
            "dparams": jax.tree.map(np.asarray, dp)}


def main():
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    assert len(jax.devices()) >= 4, jax.devices()
    out = [run(c) for c in cases]
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
