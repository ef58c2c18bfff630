"""Parameters of the JAX package, in the port's layout.

`inl_from_jax`, `inl_heterogeneous_from_jax`, `sl_from_jax`,
`fl_from_jax`, `splitfed_from_jax` and `hybrid_from_jax` take the
reference's parameters and state as numpy trees (for example
`jax.tree.map(np.asarray, params)`) and return the port's, so both
packages compute the same function.  They read plain attributes and dict
keys only; the port imports nothing of JAX or `repro`.

    conv weights   HWIO (..., 3, 3, I, O) -> OIHW (..., O, I, 3, 3), any
                   leading axes (INL's stacked J nodes, FL's J clients)
    dense weights  (d_in, d_out), unchanged: the port stores them so
    head weights   unchanged: the port flattens NHWC as the reference does
    BatchNorm      scale/bias and running mean/var copied
    priors         the learned (J, d) prior mean/log-variance copied ({}
                   for the standard normal)

INL, SplitFed and the hybrid stack their J encoders along a leading axis
(the hybrids' at the client-side trunk, `client_cfg`; INL's
heterogeneous-encoder variant keeps a list of J encoders of differing
architectures, `inl_heterogeneous_from_jax`); SL and FL keep a list of J
per-branch encoders, as the reference does, and FL stacks the J client
copies of everything along a leading axis.

`zoo_from_jax` maps the reference's `models.zoo.init_params` tree onto the
port's (`repro_torch.models.zoo`): the trees have one structure, dense
(d_in, d_out) and conv1d (width, C) weights and the stacked (nper, ...)
period leaves copy unchanged, and every leaf takes the model's dtype but
A_log, D and dt_bias, which stay fp32 as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.inl import INLParams


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _encoder(enc, cfg, device) -> dict:
    """One encoder tree (leaves with any leading axes) in the port's
    layout."""
    if len(enc["convs"]) != len(cfg.conv_channels):
        raise ValueError(f"{len(enc['convs'])} conv layers in the "
                         f"parameters, cfg has {len(cfg.conv_channels)}")

    def oihw(w):
        n = np.ndim(w)
        lead = tuple(range(n - 4))
        return np.transpose(w, lead + (n - 1, n - 2, n - 4, n - 3))
    convs = [{"w": _tensor(oihw(c["w"]), device), "b": _tensor(c["b"], device)}
             for c in enc["convs"]]
    bns = [{k: _tensor(b[k], device) for k in ("scale", "bias")}
           for b in enc["bns"]]
    head = {k: {"w": _tensor(enc["head"][k]["w"], device),
                "b": _tensor(enc["head"][k]["b"], device)}
            for k in ("mu", "logvar")}
    return {"convs": convs, "bns": bns, "head": head}


def _encoder_state(st, device) -> dict:
    return {"bns": [{k: _tensor(s[k], device) for k in ("mean", "var")}
                    for s in st["bns"]]}


def _decoder(dec, device) -> dict:
    return {"dense": [{"w": _tensor(p["w"], device),
                       "b": _tensor(p["b"], device)} for p in dec["dense"]],
            "branch_heads": {k: _tensor(dec["branch_heads"][k], device)
                             for k in ("w", "b")}}


def inl_from_jax(params_np, state_np, cfg, device=None):
    """(reference INLParams of numpy leaves, {"encoders": ...} state) ->
    the port's (INLParams, state) on `device` (None: cuda)."""
    device = resolve_device(device)
    priors = {k: _tensor(params_np.priors[k], device)
              for k in ("mu", "logvar")} if params_np.priors else {}
    params = INLParams(_encoder(params_np.encoders, cfg, device),
                       _decoder(params_np.decoder, device), priors)
    return params, {"encoders": _encoder_state(state_np["encoders"], device)}


def inl_heterogeneous_from_jax(params_np, state_np, cfgs, device=None):
    """The reference's heterogeneous INL (`init_heterogeneous`: params
    {"encoders": [J], "decoder"}, state {"encoders": [J]}, each encoder at
    its own cfgs[j]) -> the port's list-based trees, on `device` (None:
    cuda)."""
    device = resolve_device(device)
    if len(params_np["encoders"]) != len(cfgs):
        raise ValueError(f"{len(params_np['encoders'])} encoders in the "
                         f"parameters, {len(cfgs)} configs")
    params = {"encoders": [_encoder(e, c, device)
                           for e, c in zip(params_np["encoders"], cfgs)],
              "decoder": _decoder(params_np["decoder"], device)}
    state = {"encoders": [_encoder_state(s, device)
                          for s in state_np["encoders"]]}
    return params, state


def sl_from_jax(client_np, server_np, state_np, cfg, device=None):
    """The reference SL's (client {"encoders": [J]}, server {"decoder"},
    state {"encoders": [J]}) -> the port's, on `device` (None: cuda)."""
    device = resolve_device(device)
    client = {"encoders": [_encoder(e, cfg, device)
                           for e in client_np["encoders"]]}
    server = {"decoder": _decoder(server_np["decoder"], device)}
    state = {"encoders": [_encoder_state(s, device)
                          for s in state_np["encoders"]]}
    return client, server, state


def fl_from_jax(params_np, state_np, cfg, device=None):
    """The reference FL's stacked client copies (params {"encoders": [J],
    "decoder"}, state {"encoders": [J]}, every leaf with a leading client
    axis) -> the port's, on `device` (None: cuda)."""
    device = resolve_device(device)
    params = {"encoders": [_encoder(e, cfg, device)
                           for e in params_np["encoders"]],
              "decoder": _decoder(params_np["decoder"], device)}
    state = {"encoders": [_encoder_state(s, device)
                          for s in state_np["encoders"]]}
    return params, state


def splitfed_from_jax(params_np, state_np, cfg, device=None):
    """The reference SplitFed's (params {"encoders": stacked over J,
    "decoder"}, state {"encoders": stacked}) -> the port's, on `device`
    (None: cuda).  The encoders are converted at `client_cfg(cfg)`, the
    trunk `cut_depth` keeps client-side."""
    from repro_torch.core.schemes.splitfed import client_cfg
    device = resolve_device(device)
    params = {"encoders": _encoder(params_np["encoders"], client_cfg(cfg),
                                   device),
              "decoder": _decoder(params_np["decoder"], device)}
    return params, {"encoders": _encoder_state(state_np["encoders"],
                                               device)}


def hybrid_from_jax(params_np, state_np, modes_np, cfg, device=None):
    """The reference hybrid's params and state (SplitFed's layout) and its
    (J,) `modes` -> the port's (params, state, modes), on `device` (None:
    cuda)."""
    params, state = splitfed_from_jax(params_np, state_np, cfg, device)
    device = resolve_device(device)
    return params, state, torch.tensor(np.asarray(modes_np, bool),
                                       device=device)


FP32_LEAVES = ("A_log", "D", "dt_bias")


def zoo_from_jax(params_np, cfg, *, device=None, dtype=None):
    """The reference LLM's params (nested dicts and lists of numpy leaves,
    any float type: a bf16 leaf is read through float32) -> the port's, on
    `device` (None: cuda) in `dtype` (None: cfg.dtype)."""
    from repro_torch.models import zoo
    device = resolve_device(device)
    dtype = dtype if dtype is not None else zoo.model_dtype(cfg)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        t = _tensor(tree, device)
        return t if name in FP32_LEAVES else t.to(dtype)
    return walk(params_np)
