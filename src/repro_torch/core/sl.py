"""Split learning (Gupta & Raskar 2018), the paper's second baseline.

Reference: src/repro/core/sl.py (`init`, `forward_client`, `loss_fn`,
`make_train_step`, `predict`; its `epoch_bits` is
`core/bandwidth.sl_epoch_bits`, which the scheme's ledgers call).  Per
§IV-A the client holds ALL J conv branches (the full Fig.-4 network
minus node (J+1)'s dense part) and the server holds the dense part.  A step: the client's cut-layer
activations cross the link (`wirefmt.ship`: dense values or bit-packed
codewords), the server computes the loss, and the error vector comes back
through the same fused cut kernel's backward, straight through its
quantizer.  Each side keeps its own optimizer.

SL's activations are DETERMINISTIC: the fused cut kernel runs in its
no-noise "none" mode (eps == 0, rate == 0, u = quantize(mu)), one launch
over the stacked (J, B, d) latents.  Randomness — the server decoder's
dropout masks — comes in as `drop_masks=`, which is how the parity tests
feed the reference's draws.

Bandwidth per epoch (§III-C): (2 p q + eta N J) s bits.
"""
from __future__ import annotations

import torch

from repro_torch import tree_map, value_and_grad
from repro_torch.core import losses, paper_model, wirefmt


def init(cfg, generator, *, device=None):
    """Returns ((client, server), state): the client side is all J conv
    branches with their bottleneck heads, the server side the dense
    decoder."""
    params, state = paper_model.fl_model_init(generator, cfg, device=device)
    return ({"encoders": params["encoders"]},
            {"decoder": params["decoder"]}), state


def forward_client(client, state, views, *, train: bool,
                   link_bits: int = 32, compute_dtype: str = "fp32"):
    """The client's cut-layer activations u (J, B, d) and its new state.
    compute_dtype "bf16" runs the conv trunks in half precision (the
    gradients and parameters stay fp32 at the caller)."""
    dt = paper_model.COMPUTE_DTYPES[compute_dtype]
    return paper_model.branch_latents(paper_model.cast_compute(client, dt),
                                      state, views.to(dt), train=train,
                                      link_bits=link_bits)


def loss_fn(client, server, state, views, labels, *, drop_masks=None,
            train: bool = True, link_bits: int = 32, wire: str = "dense",
            compute_dtype: str = "fp32"):
    """Returns (loss, (metrics, new_state)); new_state detached."""
    u, new_state = forward_client(client, state, views, train=train,
                                  link_bits=link_bits,
                                  compute_dtype=compute_dtype)
    # the client -> server link: dense values or bit-packed codewords
    u_w = wirefmt.ship(u, link_bits=link_bits, wire=wire)
    server = paper_model.cast_compute(
        server, paper_model.COMPUTE_DTYPES[compute_dtype])
    logits = paper_model.decoder_apply(
        server["decoder"], paper_model.concat_latents(u_w), train=train,
        drop_masks=drop_masks)
    loss = losses.xent(logits, labels)
    metrics = {"loss": loss, "accuracy": losses.accuracy(logits, labels)}
    return loss, (metrics, tree_map(torch.Tensor.detach, new_state))


def make_train_step(optimizer_client, optimizer_server, *,
                    link_bits: int = 32, wire: str = "dense",
                    compute_dtype: str = "fp32"):
    """One SL step:

        step(client, server, state, opt_c, opt_s, views, labels, drop_masks)
            -> (client, server, state, opt_c, opt_s, metrics)

    The server computes the loss and backpropagates the cut-layer error to
    the client (the fused kernel's backward, straight through the link
    quantizer); each side updates with its own optimizer."""
    wirefmt.resolve_wire(wire, link_bits)

    def _loss(params, state, views, labels, drop_masks):
        client, server = params
        return loss_fn(client, server, state, views, labels,
                       drop_masks=drop_masks, link_bits=link_bits, wire=wire,
                       compute_dtype=compute_dtype)

    def step(client, server, state, opt_c, opt_s, views, labels,
             drop_masks):
        _, (metrics, new_state), (g_client, g_server) = value_and_grad(
            _loss, (client, server), state, views, labels, drop_masks)
        new_client, new_opt_c = optimizer_client.update(g_client, opt_c,
                                                        client)
        new_server, new_opt_s = optimizer_server.update(g_server, opt_s,
                                                        server)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (new_client, new_server, new_state, new_opt_c, new_opt_s,
                metrics)
    return step


def predict(client, server, state, views):
    """Central inference at full precision: (B, C) class probabilities."""
    u, _ = forward_client(client, state, views, train=False)
    logits = paper_model.decoder_apply(
        server["decoder"], paper_model.concat_latents(u), train=False)
    return torch.softmax(logits, dim=-1)
