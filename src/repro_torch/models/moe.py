"""Mixture of experts: a top-k router with capacity-based scatter dispatch,
shared experts (DeepSeek-V2) and, in the block, Arctic's dense residual.

Reference: src/repro/models/moe.py (`expert_capacity`, `moe_init`,
`moe_param_count`, `moe_active_param_count`, `moe_apply`, `moe_apply_ep`,
`moe_decode_apply`).  `moe_apply_ep` takes the mesh as an argument
(`mesh=`), where the reference reads its ambient abstract mesh.

Each (token, choice) pair takes a slot in its expert's buffer of C slots,
ranked token-major inside the expert; pairs ranked C or later are dropped.
The router runs in fp32 (its weight stays fp32 in a bf16 model), the
renormalised top-k weights are cast to the activations' dtype for the
combine, and the combine adds a token's k contributions one after another
in that dtype, the order of the reference's scatter-add: a fixed order on
every device, where a CUDA `index_add_` would add in no fixed order.
Decode contracts over k in one product (one rounding), as the reference's
`moe_decode_apply` does; the two paths round differently there too.

Aux values (the load-balance and z losses, the expert load, which, as
the reference's `stop_gradient` makes it, carries no gradient) are
returned as the reference returns them; the blocks sum them over the
layers for the training loss (`zoo.loss_and_metrics`).  Under autograd
the dispatch's gather `xf[tok_id]`, its scatter `buf[rows] = gathered`
and the combine's gather `out[slot]` take the reference's gradients
(take / scatter-add / gather); on the card their backward adds with
atomics, so runs compared bit for bit there take
`torch.use_deterministic_algorithms(True)`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def expert_capacity(num_tokens: int, cfg_moe) -> int:
    """Per-expert buffer slots, from static shapes."""
    k, E = cfg_moe.experts_per_token, cfg_moe.num_experts
    cap = int(math.ceil(num_tokens * k / E * cfg_moe.capacity_factor))
    return max(cap, k)


def _stacked(generator, n, d_in, d_out, dtype, device):
    """(n, d_in, d_out) N(0, 1/d_in) in `dtype`, drawn in fp32 one expert at
    a time (a single fp32 draw of Arctic's (128, 7168, 4864) would take
    17.8 GB before the cast)."""
    w = torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    if w.device.type == "meta":         # shapes only: nothing to draw
        return w
    for e in range(n):
        w[e] = torch.randn((d_in, d_out), generator=generator,
                           device=device) / math.sqrt(d_in)
    return w


def moe_init(generator, cfg, dtype, device=None):
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    p = {
        # the router stays fp32 whatever the model's dtype
        "router": layers.dense_init(generator, d, m.num_experts,
                                    dtype=torch.float32, device=device),
        "wi": _stacked(generator, m.num_experts, d, f, dtype, device),
        "wg": _stacked(generator, m.num_experts, d, f, dtype, device),
        "wo": _stacked(generator, m.num_experts, f, d, dtype, device),
    }
    if m.num_shared_experts:
        p["shared"] = layers.mlp_init(generator, d, f * m.num_shared_experts,
                                      act="silu", dtype=dtype, device=device)
    return p


def moe_param_count(cfg) -> int:
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    n = d * m.num_experts + 3 * m.num_experts * d * f
    if m.num_shared_experts:
        n += 3 * d * f * m.num_shared_experts
    return n


def moe_active_param_count(cfg) -> int:
    """Params touched per token (for 6·N_active·D roofline accounting)."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    n = d * m.num_experts + 3 * m.experts_per_token * d * f
    if m.num_shared_experts:
        n += 3 * d * f * m.num_shared_experts
    return n


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    broken towards the lower index, as `lax.top_k` breaks them (a stable
    descending sort; `torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, m, xf):
    """(router logits fp32, probs, renormalised top-k weights fp32, top-k
    experts) of the tokens xf (T, d)."""
    logits = layers.dense(p["router"], xf.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, m.experts_per_token)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_w, top_e


def moe_apply(p, cfg, x):
    """x: (B, S, d) -> (y, aux), aux = {"lb_loss", "z_loss",
    "expert_load"}."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.num_experts, m.experts_per_token
    C = expert_capacity(T, m)

    xf = x.reshape(T, d)
    logits, probs, top_w, top_e = _route(p, m, xf)

    # slot assignment: rank of each (token, choice) inside its expert,
    # token-major
    flat_e = top_e.reshape(T * k)
    onehot = F.one_hot(flat_e, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, torch.zeros_like(pos))

    tok_id = torch.arange(T, device=x.device).repeat_interleave(k)
    gathered = xf[tok_id] * keep[:, None].to(xf.dtype)
    # the kept pairs own their slots; every dropped pair adds zeros, so it
    # writes its zeros to one spare row past the buffer
    rows = torch.where(keep, slot, torch.full_like(slot, E * C))
    buf = xf.new_zeros((E * C + 1, d))
    buf[rows] = gathered
    buf = buf[:E * C].reshape(E, C, d)

    # the expert FFN over the stacked expert weights
    h = layers.silu(torch.bmm(buf, p["wi"])) * torch.bmm(buf, p["wg"])
    out = torch.bmm(h, p["wo"]).reshape(E * C, d)

    # combine: a token's k contributions added one after another
    slots_out = out[slot]
    w = (top_w.reshape(T * k) * keep).to(xf.dtype)
    contrib = (slots_out * w[:, None]).reshape(T, k, d)
    y = xf.new_zeros((T, d))
    for j in range(k):
        y = y + contrib[:, j]

    if m.num_shared_experts:
        y = y + layers.mlp(p["shared"], xf, act="silu")

    # aux losses (fp32)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e, E).float().sum(dim=(0, 1)) / (T * k)
    aux = {"lb_loss": E * torch.sum(me * ce),
           "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
           "expert_load": ce.detach()}
    return y.reshape(B, S, d), aux


def moe_apply_ep(p, cfg, x, *, mesh=None):
    """The expert-parallel MoE over the 'model' axis of `mesh` (a
    `launch/mesh.Mesh` of torch.distributed ranks), the reference's
    shard_map dispatch.  Without a mesh, or on a mesh with no 'model' axis,
    it is `moe_apply`, as the reference is with no mesh active.

    On the mesh, x (B, S, d) is this rank's batch shard, the same on every
    rank of its 'model' group, and p holds the router and shared experts
    whole and this rank's block of E/m experts ("wi", "wg" (E/m, d, f),
    "wo" (E/m, f, d); block r of the model axis holds experts r E/m ..
    (r + 1) E/m - 1).  Each rank routes its own tokens over all E experts,
    keeps the (token, choice) pairs of its own experts with the capacity
    of its LOCAL token count, runs them, scatters them into a (T_loc, d)
    partial, and one `Axis.psum` over 'model' adds the k contributions of
    every token.  The aux values are each rank's, averaged over the batch
    shards (pmean over 'pod' and 'data'), as the reference averages its
    per-shard values outside the shard_map.

    Gradients: the psum and the pmean are autograd Functions whose
    backward is again a psum (a pmean), JAX's transpose under
    check_rep=False.  That is sum semantics: the backward of a value that
    is the same on several ranks must be seeded on each with its share of
    the cotangent (1/m of it on a 'model' group), and a leaf held whole by
    several ranks (the router, the shared experts, x over 'model') has
    the sum over them as its gradient."""
    if mesh is None or "model" not in mesh.axis_names:
        return moe_apply(p, cfg, x)
    if not hasattr(mesh, "axis"):
        raise ValueError("moe_apply_ep runs on a Mesh of torch.distributed "
                         "ranks; an AbstractMesh has no process groups")
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.experts_per_token
    axis = mesh.axis("model")
    if E % axis.size:
        raise ValueError(f"{E} experts do not split over a 'model' axis of "
                         f"{axis.size}")
    e_loc = E // axis.size
    if p["wi"].shape[0] != e_loc:
        raise ValueError(f"this rank holds {p['wi'].shape[0]} experts; a "
                         f"'model' axis of {axis.size} gives it {e_loc}")
    T = B * S
    C = expert_capacity(T, m)
    xf = x.reshape(T, d)
    logits, probs, top_w, top_e = _route(p, m, xf)

    # this rank's (token, choice) pairs, ranked token-major in their expert
    flat_e = top_e.reshape(T * k)
    mine = torch.div(flat_e, e_loc, rounding_mode="floor") == axis.index
    loc_e = torch.where(mine, flat_e % e_loc, torch.zeros_like(flat_e))
    onehot = F.one_hot(loc_e, e_loc) * mine[:, None]
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = mine & (pos >= 0) & (pos < C)
    slot = torch.where(keep, loc_e * C + pos, torch.zeros_like(pos))

    tok_id = torch.arange(T, device=x.device).repeat_interleave(k)
    gathered = xf[tok_id] * keep[:, None].to(xf.dtype)
    rows = torch.where(keep, slot, torch.full_like(slot, e_loc * C))
    buf = xf.new_zeros((e_loc * C + 1, d))
    buf[rows] = gathered
    buf = buf[:e_loc * C].reshape(e_loc, C, d)

    h = layers.silu(torch.bmm(buf, p["wi"])) * torch.bmm(buf, p["wg"])
    out = torch.bmm(h, p["wo"]).reshape(e_loc * C, d)

    slots_out = out[slot]
    w = (top_w.reshape(T * k) * keep).to(xf.dtype)
    contrib = (slots_out * w[:, None]).reshape(T, k, d)
    y = xf.new_zeros((T, d))
    for j in range(k):
        y = y + contrib[:, j]
    y = axis.psum(y)                          # the k experts of a token

    if m.num_shared_experts:
        y = y + layers.mlp(p["shared"], xf, act="silu")

    me = probs.mean(dim=0)
    ce = F.one_hot(top_e, E).float().sum(dim=(0, 1)) / (T * k)
    aux = {"lb_loss": E * torch.sum(me * ce),
           "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
           "expert_load": ce.detach()}
    for name in ("pod", "data"):
        if name in mesh.axis_names and mesh.shape[name] > 1:
            dp = mesh.axis(name)
            aux = {key: (dp.pmean(v) if key != "expert_load"
                         else dp.mean_tree([v])[0])
                   for key, v in aux.items()}
    return y.reshape(B, S, d), aux


def moe_decode_apply(p, cfg, x):
    """Decode: one token per sequence, no buffers; a gather of the k chosen
    experts' weights per token (k small).  Returns (y, zero aux)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    _, _, top_w, top_e = _route(p, m, xf)

    wi, wg, wo = p["wi"][top_e], p["wg"][top_e], p["wo"][top_e]  # (T,k,..)
    xk = xf[:, None, None, :]                                   # (T,1,1,d)
    h = layers.silu(torch.matmul(xk, wi)) * torch.matmul(xk, wg)  # (T,k,1,f)
    out = torch.matmul(h, wo)[:, :, 0]                          # (T,k,d)
    # one contraction over k, accumulated in fp32 and rounded once
    w = top_w.to(out.dtype)
    y = torch.einsum("tkd,tk->td", out.float(), w.float()).to(out.dtype)
    if m.num_shared_experts:
        y = y + layers.mlp(p["shared"], xf, act="silu")
    aux = {"lb_loss": x.new_zeros((), dtype=torch.float32),
           "z_loss": x.new_zeros((), dtype=torch.float32),
           "expert_load": x.new_zeros((m.num_experts,),
                                      dtype=torch.float32)}
    return y.reshape(B, S, d), aux
