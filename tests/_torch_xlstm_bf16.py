"""How far xLSTM-125M in bf16 parts from itself in fp32, in the JAX package
and in the port, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_xlstm_bf16.py

For the full-width config (d_model 768) at 4 layers over a prompt of 64
and at its 12 layers over 128: the reference's weights drawn in bf16, the
same bf16 values in both packages and in fp32, one prompt.  Prints the
largest |difference| of the prefill's last logits between the reference's
bf16 and fp32 models, the port's, the two fp32 models and the two bf16
models, beside the largest logit.  The recurrence carries its inputs' bf16
roundings through every step, so the bf16 models part from their fp32
twins by a tenth of the largest logit at full depth, in both packages
(ROADMAP queue 3).  Imports both packages, as the tests do; the port
itself imports no JAX.
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.launch import steps

ARCH = "xlstm-125m"


def last_logits(num_layers: int, prompt: int) -> dict:
    """{name: (1, V) fp32 numpy logits} of the four models."""
    j16 = dataclasses.replace(jax_get_config(ARCH), num_layers=num_layers,
                              dtype="bfloat16")
    j32 = dataclasses.replace(j16, dtype="float32")
    jp = jax.jit(lambda k: jzoo.init_params(j16, k))(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, j16.vocab_size, size=(1, prompt)).astype(np.int32)
    out = {}
    for name, cfg, p in (("ref bf16", j16, jp), ("ref fp32", j32, jax.tree.map(
            lambda x: x.astype(jnp.float32), jp))):
        logits, _ = jax.jit(jsteps.make_prefill_step(cfg))(
            p, {"tokens": jnp.asarray(toks)})
        out[name] = np.asarray(logits.astype(jnp.float32))
    np32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    for name, dtype in (("port bf16", "bfloat16"), ("port fp32", "float32")):
        cfg = dataclasses.replace(get_config(ARCH), num_layers=num_layers,
                                  dtype=dtype)
        params = convert.zoo_from_jax(np32, cfg, device="cpu")
        logits, _ = steps.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(toks).long()})
        out[name] = logits.float().numpy()
    return out


def main():
    torch.set_num_threads(4)
    for num_layers, prompt in ((4, 64), (12, 128)):
        lg = last_logits(num_layers, prompt)
        top = np.abs(lg["ref fp32"]).max()
        print(f"xLSTM-125M, {num_layers} layers, prompt {prompt}: largest "
              f"logit {top:.4g}; max |diff| of the last logits:")
        for a, b in (("ref bf16", "ref fp32"), ("port bf16", "port fp32"),
                     ("port fp32", "ref fp32"), ("port bf16", "ref bf16")):
            print(f"  {a} vs {b}: {np.abs(lg[a] - lg[b]).max():.4g}")


if __name__ == "__main__":
    main()
