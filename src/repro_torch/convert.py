"""Parameters of the JAX package, in the port's layout.

`inl_from_jax` takes the reference's `repro.core.inl.INLParams` and state as
numpy trees (for example `jax.tree.map(np.asarray, params)`) and returns the
port's, so both packages compute the same function.  It reads plain
attributes and dict keys only; the port imports nothing of JAX or `repro`.

    conv weights   HWIO (J, 3, 3, I, O) -> OIHW (J, O, I, 3, 3)
    dense weights  (d_in, d_out), unchanged: the port stores them so
    head weights   unchanged: the port flattens NHWC as the reference does
    BatchNorm      scale/bias and running mean/var copied
    priors         the learned (J, d) prior mean/log-variance copied ({}
                   for the standard normal)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.inl import INLParams


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def inl_from_jax(params_np, state_np, cfg, device=None):
    """(reference INLParams of numpy leaves, {"encoders": ...} state) ->
    the port's (INLParams, state) on `device` (None: cuda)."""
    device = resolve_device(device)
    enc = params_np.encoders
    if len(enc["convs"]) != len(cfg.conv_channels):
        raise ValueError(f"{len(enc['convs'])} conv layers in the "
                         f"parameters, cfg has {len(cfg.conv_channels)}")
    convs = [{"w": _tensor(np.transpose(c["w"], (0, 4, 3, 1, 2)), device),
              "b": _tensor(c["b"], device)} for c in enc["convs"]]
    bns = [{k: _tensor(b[k], device) for k in ("scale", "bias")}
           for b in enc["bns"]]
    head = {k: {"w": _tensor(enc["head"][k]["w"], device),
                "b": _tensor(enc["head"][k]["b"], device)}
            for k in ("mu", "logvar")}
    dec = params_np.decoder
    decoder = {"dense": [{"w": _tensor(p["w"], device),
                          "b": _tensor(p["b"], device)}
                         for p in dec["dense"]],
               "branch_heads": {k: _tensor(dec["branch_heads"][k], device)
                                for k in ("w", "b")}}
    state = {"encoders": {"bns": [
        {k: _tensor(s[k], device) for k in ("mean", "var")}
        for s in state_np["encoders"]["bns"]]}}
    priors = {k: _tensor(params_np.priors[k], device)
              for k in ("mu", "logvar")} if params_np.priors else {}
    params = INLParams({"convs": convs, "bns": bns, "head": head}, decoder,
                       priors)
    return params, state
