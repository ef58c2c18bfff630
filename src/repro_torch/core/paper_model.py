"""The paper's §IV network (Fig. 4): per-client VGG-style conv encoders over
32x32x3 noisy views, and two dense layers at node (J+1).

Reference: src/repro/core/paper_model.py (`compute_dtype`, `cast_compute`,
the encoder, the decoder, `decoder_dropout_masks`, the parameter counts and
the FL/SL full model `fl_model_init` / `fl_model_apply`).  The public functions
keep the reference's layout: an encoder takes views (B, H, W, C), and its
flatten before the head is in NHWC order, so converted JAX head weights
apply unchanged.  Inside, the trunk runs NCHW for F.conv2d; `conv`,
`bn_apply` and `maxpool2` take NCHW tensors.  Conv weights are stored
OIHW.

`stacked_encoder_apply` runs J encoders stacked along a leading axis (INL's
nodes, the hybrids' clients) one after another.

BatchNorm is written by hand, not nn.BatchNorm2d: training statistics use
the two-pass biased variance, and BN_MOMENTUM = 0.9 weighs the OLD running
statistic, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree_map, tree_stack
from repro_torch.core import bottleneck
from repro_torch.models import layers

BN_MOMENTUM = 0.9

COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def compute_dtype(cfg):
    """The hot-path matmul/conv dtype from cfg.compute_dtype ("fp32"
    default, "bf16" for the mixed-precision policy)."""
    name = getattr(cfg, "compute_dtype", "fp32") or "fp32"
    try:
        return COMPUTE_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {name!r}; "
                         f"known: {sorted(COMPUTE_DTYPES)}") from None


def cast_compute(tree, dtype):
    """Cast the fp32 leaves of a parameter tree to the compute dtype.

    Applied INSIDE the loss function, so autograd casts the gradients back
    to fp32 and the optimizer keeps full-precision parameters (the
    mixed-precision split).  The identity for fp32."""
    if dtype == torch.float32:
        return tree
    return tree_map(
        lambda x: x.to(dtype) if x.dtype == torch.float32 else x, tree)


# ---------------------------------------------------------------------------
# Primitives (NCHW)
# ---------------------------------------------------------------------------

def conv_init(generator: torch.Generator, c_in: int, c_out: int,
              ksize: int = 3, *, device=None):
    fan_in = c_in * ksize * ksize
    w = torch.randn((c_out, c_in, ksize, ksize), generator=generator,
                    device=device) * math.sqrt(2.0 / fan_in)
    return {"w": w, "b": torch.zeros((c_out,), device=device)}


def conv(p, x):
    """3x3, stride 1, SAME padding (padding=1) on NCHW x."""
    return F.conv2d(x, p["w"], p["b"], stride=1, padding=1)


def bn_init(c: int, *, device=None):
    return ({"scale": torch.ones((c,), device=device),
             "bias": torch.zeros((c,), device=device)},
            {"mean": torch.zeros((c,), device=device),
             "var": torch.ones((c,), device=device)})


def bn_apply(p, st, x, *, train: bool, axis_name=None):
    """BatchNorm over NCHW x.  Statistics and arithmetic in fp32; the output
    drops back to x.dtype.

    axis_name — the mesh Axis (launch/mesh.py) the batch is sharded over:
    the statistics become global, `pmean` of the per-shard mean, then
    `pmean` of the mean of (x - mean)^2 around it (the two-pass form).  On
    an axis of one rank the result is the unsharded one bit for bit."""
    xf = x.to(torch.float32)
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        if axis_name is not None:
            mean = axis_name.pmean(mean)
        var = torch.square(xf - mean[None, :, None, None]).mean(
            dim=(0, 2, 3))
        if axis_name is not None:
            var = axis_name.pmean(var)
        new_st = {"mean": BN_MOMENTUM * st["mean"] + (1 - BN_MOMENTUM) * mean,
                  "var": BN_MOMENTUM * st["var"] + (1 - BN_MOMENTUM) * var}
    else:
        mean, var = st["mean"], st["var"]
        new_st = st

    def per_channel(v):
        return v.to(torch.float32)[None, :, None, None]

    y = (xf - per_channel(mean)) * torch.rsqrt(per_channel(var) + 1e-5) \
        * per_channel(p["scale"]) + per_channel(p["bias"])
    return y.to(x.dtype), new_st


def maxpool2(x):
    """2x2 max-pool, stride 2, VALID, on NCHW x."""
    return F.max_pool2d(x, 2, 2)


# ---------------------------------------------------------------------------
# Conv encoder trunk (one client branch)
# ---------------------------------------------------------------------------

def encoder_feat_dim(cfg) -> int:
    h = cfg.image_shape[0] // (2 ** len(cfg.conv_channels))
    return h * h * cfg.conv_channels[-1]


def encoder_param_count(cfg) -> int:
    chans = (cfg.image_shape[-1],) + tuple(cfg.conv_channels)
    n = 0
    for i in range(len(cfg.conv_channels)):
        n += 9 * chans[i] * chans[i + 1] + chans[i + 1]   # conv w+b
        n += 2 * chans[i + 1]                              # bn scale+bias
    n += 2 * (encoder_feat_dim(cfg) * cfg.d_bottleneck + cfg.d_bottleneck)
    return n


def encoder_init(generator: torch.Generator, cfg, *, device=None):
    """cfg: PaperExperimentConfig.  Returns (params, state) of one node."""
    chans = (cfg.image_shape[-1],) + tuple(cfg.conv_channels)
    params, state = {"convs": [], "bns": []}, {"bns": []}
    for i in range(len(cfg.conv_channels)):
        params["convs"].append(conv_init(generator, chans[i], chans[i + 1],
                                         device=device))
        bp, bs = bn_init(chans[i + 1], device=device)
        params["bns"].append(bp)
        state["bns"].append(bs)
    params["head"] = bottleneck.head_init(generator, encoder_feat_dim(cfg),
                                          cfg.d_bottleneck, device=device)
    return params, state


def encoder_apply(params, state, x, *, train: bool, axis_name=None):
    """x: (B, H, W, C) -> ((mu, logvar) (B, d), new_state).  axis_name: the
    mesh Axis the batch is sharded over (global BatchNorm statistics, see
    `bn_apply`)."""
    new_bns = []
    h = x.permute(0, 3, 1, 2)                               # NHWC -> NCHW
    for cp, bp, bs in zip(params["convs"], params["bns"], state["bns"]):
        h = conv(cp, h)
        h, nbs = bn_apply(bp, bs, h, train=train, axis_name=axis_name)
        h = torch.relu(h)
        h = maxpool2(h)
        new_bns.append(nbs)
    # the reference flattens NHWC: permute back before the flatten
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    mu, logvar = bottleneck.head_apply(params["head"], h)
    return (mu, logvar), {"bns": new_bns}


def stacked_encoder_apply(params, state, views, *, train: bool,
                          axis_name=None):
    """J encoders whose parameter and state leaves stack along a leading J
    axis, one after another: views (J, B, H, W, C) -> ((mu, logvar) (J, B,
    d), new stacked state).  axis_name as in `encoder_apply`."""
    mus, lvs, new_states = [], [], []
    for j in range(views.shape[0]):
        (mu, lv), ns = encoder_apply(tree_map(lambda t: t[j], params),
                                     tree_map(lambda t: t[j], state),
                                     views[j], train=train,
                                     axis_name=axis_name)
        mus.append(mu)
        lvs.append(lv)
        new_states.append(ns)
    return (torch.stack(mus), torch.stack(lvs)), tree_stack(new_states)


# ---------------------------------------------------------------------------
# Central node (J+1): fusion decoder + per-branch decoders (Remark 1)
# ---------------------------------------------------------------------------

def decoder_init(generator: torch.Generator, cfg, *, device=None):
    J = cfg.num_clients
    dims = (J * cfg.d_bottleneck,) + tuple(cfg.dense_units) \
        + (cfg.num_classes,)
    dense = [layers.dense_init(generator, dims[i], dims[i + 1], bias=True,
                               device=device)
             for i in range(len(dims) - 1)]
    heads = [layers.dense_init(generator, cfg.d_bottleneck, cfg.num_classes,
                               bias=True, device=device) for _ in range(J)]
    bh = {k: torch.stack([h[k] for h in heads]) for k in ("w", "b")}
    return {"dense": dense, "branch_heads": bh}    # stacked (J, d_b, C) / (J, C)


def decoder_apply(p, u_cat, *, train: bool, drop: float = 0.3,
                  drop_masks=None):
    """u_cat: (B, J*d_bottleneck) -> logits (B, classes).

    drop_masks — pre-drawn keep masks, one (B, units) bool tensor per hidden
    layer; in training they apply inverted dropout.  Without them there is
    no dropout (the reference's rng=None)."""
    h = u_cat
    for i, dp in enumerate(p["dense"][:-1]):
        h = torch.relu(layers.dense(dp, h))
        if train and drop_masks is not None:
            h = torch.where(drop_masks[i], h / (1.0 - drop),
                            torch.zeros((), dtype=h.dtype, device=h.device))
    return layers.dense(p["dense"][-1], h)


def decoder_dropout_masks(generator: torch.Generator, dense_units,
                          batch: int, drop: float = 0.3, *, device=None):
    """Keep masks for `decoder_apply(drop_masks=)`: one (batch, units) bool
    tensor per hidden layer, each entry kept with probability 1 - drop,
    drawn from `generator` (on `device`) layer after layer."""
    return [torch.rand((batch, units), generator=generator,
                       device=device) < (1.0 - drop)
            for units in dense_units]


def branch_heads_apply(p, us):
    """us: (J, B, d_b) -> per-branch logits (J, B, classes)."""
    bh = p["branch_heads"]
    return torch.bmm(us, bh["w"]) + bh["b"][:, None, :]


def decoder_param_count(cfg) -> int:
    J = cfg.num_clients
    dims = (J * cfg.d_bottleneck,) + tuple(cfg.dense_units) \
        + (cfg.num_classes,)
    n = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    n += J * (cfg.d_bottleneck * cfg.num_classes + cfg.num_classes)
    return n


# ---------------------------------------------------------------------------
# The FL full model (Fig. 4's entire network on each client) and SL's split
# ---------------------------------------------------------------------------

def fl_model_init(generator: torch.Generator, cfg, *, device=None):
    """The whole Fig.-4 network, one copy: J conv branches and the fusion
    decoder.  Returns (params {"encoders": [J per-branch trees], "decoder"},
    state {"encoders": [J]}), as the reference lays them out."""
    encs = [encoder_init(generator, cfg, device=device)
            for _ in range(cfg.num_clients)]
    params = {"encoders": [p for p, _ in encs],
              "decoder": decoder_init(generator, cfg, device=device)}
    return params, {"encoders": [s for _, s in encs]}


def branch_latents(params, state, views, *, train: bool,
                   link_bits: int = 32, axis_name=None):
    """The J branches of the full model: views (J, B, H, W, C) ->
    (u (J, B, d), new state).  The latents cross the in-model cut through
    the fused cut kernel in its deterministic mode (eps == 0, rate 0:
    u = quantize(mu), one launch for all J branches), the substrate the
    three schemes share.  axis_name: the mesh Axis the batch is sharded
    over (`bn_apply`)."""
    mus, lvs, new_states = [], [], []
    for ep, es, v in zip(params["encoders"], state["encoders"], views):
        (mu, lv), ns = encoder_apply(ep, es, v, train=train,
                                     axis_name=axis_name)
        mus.append(mu)
        lvs.append(lv)
        new_states.append(ns)
    u, _ = bottleneck.fused_sample_rate(
        None, torch.stack(mus), torch.stack(lvs), link_bits=link_bits,
        rate_estimator="none")
    return u, {"encoders": new_states}


def concat_latents(u):
    """(J, B, d) -> (B, J*d), the eq.-(5) concatenation."""
    J, B, d = u.shape
    return u.permute(1, 0, 2).reshape(B, J * d)


def fl_model_apply(params, state, views, *, train: bool, drop_masks=None):
    """views (J, B, H, W, C) — all J views of the same images, or one image
    broadcast to the J branch inputs (FL's Exp-2 inference) -> (logits
    (B, classes), new state).  The cut is full precision (link_bits 32,
    u == mu); drop_masks as in `decoder_apply`."""
    u, new_state = branch_latents(params, state, views, train=train)
    logits = decoder_apply(params["decoder"], concat_latents(u), train=train,
                           drop_masks=drop_masks)
    return logits, new_state


def fl_param_count(cfg) -> int:
    return cfg.num_clients * encoder_param_count(cfg) \
        + decoder_param_count(cfg)
