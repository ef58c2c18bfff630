"""Model zoo: full-model init and forward for every LLM architecture.

Reference: src/repro/models/zoo.py (`init_params`, `param_count`,
`_embed_inputs`, `_project_out`, `forward`, `make_cache`, `pad_cache`,
`softmax_xent`, `CE_CHUNK`, `chunked_xent`, `loss_and_metrics`,
`input_specs`, `cache_specs`, `dummy_batch`).

    init_params(cfg, generator, device=None)      -> params tree
    forward(params, cfg, batch, mode, cache)      -> (logits, new_cache, aux)
    make_cache(cfg, batch_size, max_len, device)  -> cache tree
    pad_cache(cache, extra)                       -> cache, k/v grown
    loss_and_metrics(params, cfg, batch)          -> (loss, metrics)
    param_count(cfg, active_only=False)           -> analytic N
    input_specs(cfg, shape_cfg)                   -> {name: (shape, dtype)}
    cache_specs(cfg, shape_cfg)                   -> cache tree on `meta`
    dummy_batch(cfg, shape_cfg, generator)        -> batch of random values

Batch dict keys (each optional but what the modality reads):
  tokens        (B, S) ids       text / code tokens; the VLM's text
  tokens_mc     (B, S, K) ids    audio: K parallel codebook streams
  input_embeds  (B, S, d)        audio: the stub EnCodec front end's frames
  patch_embeds  (B, P, d)        VLM: the stub vision encoder's patches,
                                 prepended to the text embeddings
  labels        (B, S) or        train: next-token targets over every
                (B, S, K) ids    position (the VLM's patches too), -1 =
                                 ignore; an audio model's per codebook
  cache_len     () int64         decode: the count of valid cache entries
`cache_len` is a 0-dim int64 tensor on the device (a Python int is moved
there), as the reference's is a traced value, so one decode step serves
every position and a CUDA graph of it can be replayed with the position
in a static buffer.  An audio model's logits are (B, S, K, V), one row a
codebook.  The training loss projects and reduces the logits a chunk of
positions at a time, each chunk under `torch.utils.checkpoint`, so only
one (B, chunk, V) fp32 tile of logits lives at a time (the reference's
`jax.checkpoint` per chunk of its scan).  `forward` and
`loss_and_metrics` take `mesh=`, the ranks a MoE's experts are dispatched
over (transformer.stack_apply); the reference reads its ambient mesh.

The specs are (shape, dtype) pairs, ids int64 as everywhere in the port;
`cache_specs` builds the cache on the `meta` device, so its leaves carry
shapes and dtypes and allocate nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import as_generator, resolve_device
from repro_torch.models import layers, moe, transformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(cfg, generator, device=None):
    """Random weights from `generator` (a torch.Generator on `device`'s
    type, or an int seed), in cfg.dtype on `device` (None: cuda)."""
    device = resolve_device(device)
    gen = as_generator(generator, device)
    dtype = model_dtype(cfg)
    p = {"stack": transformer.stack_init(gen, cfg, dtype, device),
         "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, device)}
    if cfg.modality == "audio_tokens":
        # K codebook embedding tables, stored as one (K Vpad, d) table,
        # and K output heads as one dense layer
        kv = cfg.num_codebooks * layers.pad_vocab(cfg.vocab_size)
        w = torch.randn((kv, cfg.d_model), generator=gen, device=device)
        p["embed"] = {"w": (w * 0.02).to(dtype)}
        p["heads"] = layers.dense_init(gen, cfg.d_model, kv, dtype=dtype,
                                       device=device)
        return p
    p["embed"] = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                   device)
    if not cfg.tie_embeddings:
        p["unembed"] = layers.dense_init(
            gen, cfg.d_model, layers.pad_vocab(cfg.vocab_size), dtype=dtype,
            device=device)
    return p


def param_count(cfg, active_only: bool = False) -> int:
    """Analytic parameter count (equal to init_params' leaves); with
    active_only, a MoE model counts the experts a token touches."""
    n = transformer.stack_param_count(cfg) + cfg.d_model
    if active_only and cfg.is_moe:
        pat = transformer.block_pattern(cfg)
        n_moe_layers = transformer.num_periods(cfg) * sum(
            1 for k in pat if k == "attn")
        n -= n_moe_layers * (moe.moe_param_count(cfg)
                             - moe.moe_active_param_count(cfg))
    vpad = layers.pad_vocab(cfg.vocab_size)
    if cfg.modality == "audio_tokens":
        return n + 2 * cfg.num_codebooks * vpad * cfg.d_model
    n += vpad * cfg.d_model
    if not cfg.tie_embeddings:
        n += vpad * cfg.d_model
    return n


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_inputs(p, cfg, batch):
    """Returns (h, positions): the text, audio or VLM inputs embedded, and
    positions 0..S-1 over the whole (prefix and text) sequence, or from
    cache_len on in decode."""
    dtype = model_dtype(cfg)
    if cfg.modality == "audio_tokens":
        if "input_embeds" in batch:           # the stub EnCodec front end
            h = batch["input_embeds"].to(dtype)
        else:
            toks = batch["tokens_mc"]         # (B, S, K)
            offs = torch.arange(cfg.num_codebooks, device=toks.device) \
                * layers.pad_vocab(cfg.vocab_size)
            h = layers.embed(p["embed"], toks + offs).sum(dim=2)
    elif cfg.modality == "vlm" and "patch_embeds" in batch:
        txt = layers.embed(p["embed"], batch["tokens"])
        h = torch.cat([batch["patch_embeds"].to(dtype), txt], dim=1)
    else:
        h = layers.embed(p["embed"], batch["tokens"])
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, device=h.device)
    start = cache_len_tensor(batch, h.device)
    if start is not None:
        positions = start + positions
    return h, positions.expand(B, S)


def cache_len_tensor(batch, device):
    """The batch's `cache_len` as a 0-dim int64 tensor on `device` (None
    when the batch has none)."""
    start = batch.get("cache_len")
    if start is None:
        return None
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int64)
    # a fill on the device, not a copy from the host (which would wait)
    return torch.full((), int(start), dtype=torch.int64, device=device)


def _project_out(p, cfg, h):
    if cfg.modality == "audio_tokens":
        B, S = h.shape[0], h.shape[1]
        logits = layers.dense(p["heads"], h).reshape(
            B, S, cfg.num_codebooks, layers.pad_vocab(cfg.vocab_size))
        return logits[..., :cfg.vocab_size]
    if cfg.tie_embeddings:
        return layers.unembed(p["embed"], h, cfg.vocab_size)
    return layers.dense(p["unembed"], h)[..., :cfg.vocab_size]


def forward(params, cfg, batch, *, mode: str = "train", cache=None,
            logits_positions: str = "all", mesh=None):
    """Returns (logits, new_cache, aux), aux the MoE's aux values summed
    over the blocks.  mode 'train' builds no cache (None); 'prefill' fills
    a cache for the prompt; 'decode' runs one token per sequence against
    `cache` (updated in place).  logits_positions='last' projects only the
    final position."""
    h, positions = _embed_inputs(params, cfg, batch)
    h, new_cache, aux = transformer.stack_apply(
        params["stack"], cfg, h, positions, mode=mode, cache=cache,
        cache_len=cache_len_tensor(batch, h.device), mesh=mesh)
    h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if logits_positions == "last":
        h = h[:, -1:]
    return _project_out(params, cfg, h), new_cache, aux


def make_cache(cfg, batch_size: int, max_len: int, device=None):
    return transformer.stack_make_cache(cfg, batch_size, max_len,
                                        model_dtype(cfg),
                                        resolve_device(device))


# MLA's compressed cache (c_kv, k_rope) grows too: without it a decode
# step would write at slot P of a cache of P slots
_CACHE_TIME_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}


def pad_cache(cache, extra: int):
    """Grow every attention cache's time axis by `extra` zero slots (after
    prefill, to make room for generated tokens).  SSM states are untouched:
    the new cache holds the same tensors, which decode then updates in
    place."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        ax = _CACHE_TIME_AXIS.get(name)
        if ax is None:
            return tree
        shape = list(tree.shape)
        shape[ax] = extra
        return torch.cat([tree, tree.new_zeros(shape)], dim=ax)
    return walk(cache)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _label_nll(logits, labels, ignore: int = -1):
    """(sum of the log-likelihoods of the non-ignored labels, their count),
    fp32.  labels: logits' shape without the vocab axis."""
    mask = (labels != ignore).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return (ll * mask).sum(), mask.sum()


def softmax_xent(logits, labels, ignore: int = -1):
    """Mean cross entropy over the non-ignored labels, fp32."""
    ll, n = _label_nll(logits, labels, ignore)
    return -ll / torch.clamp(n, min=1.0)


CE_CHUNK = 512


def chunked_xent(params, cfg, h, labels, *, chunk: int = CE_CHUNK):
    """The projection and cross entropy a chunk of positions at a time: the
    (B, S, vocab) fp32 logits are never whole.  Each chunk runs in
    `torch.utils.checkpoint`, which keeps its inputs only, so under
    autograd its logits are projected again in the backward.  A ragged last chunk is
    padded with ignored labels, as the reference pads it."""
    S = h.shape[1]
    chunk = min(chunk, S)
    nch = -(-S // chunk)
    pad = nch * chunk - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        widths = (0, 0) * (labels.ndim - 2) + (0, pad)
        labels = F.pad(labels, widths, value=-1)

    def body(h_c, lab_c):
        return _label_nll(_project_out(params, cfg, h_c), lab_c)

    nll = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for c in range(nch):
        h_c = h[:, c * chunk:(c + 1) * chunk]
        lab_c = labels[:, c * chunk:(c + 1) * chunk]
        ll, n = torch.utils.checkpoint.checkpoint(body, h_c, lab_c,
                                                  use_reentrant=False)
        nll, cnt = nll - ll, cnt + n
    return nll / torch.clamp(cnt, min=1.0)


def loss_and_metrics(params, cfg, batch, *, mode: str = "train",
                     mesh=None):
    """(loss, {"ce", "loss"} and, for a MoE config, "lb_loss" and
    "z_loss"): the chunked cross entropy plus router_aux_weight · lb_loss
    + router_z_weight · z_loss for a MoE."""
    labels = batch["labels"]
    h, positions = _embed_inputs(params, cfg, batch)
    h, _, aux = transformer.stack_apply(
        params["stack"], cfg, h, positions, mode=mode, cache=None,
        cache_len=cache_len_tensor(batch, h.device), mesh=mesh)
    h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    ce = chunked_xent(params, cfg, h, labels,
                      chunk=cfg.ce_chunk or CE_CHUNK)
    loss = ce
    metrics = {"ce": ce}
    if cfg.is_moe:
        loss = loss + cfg.moe.router_aux_weight * aux["lb_loss"] \
            + cfg.moe.router_z_weight * aux["z_loss"]
        metrics.update(lb_loss=aux["lb_loss"], z_loss=aux["z_loss"])
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Input specs: (shape, dtype) stand-ins, nothing allocated
# ---------------------------------------------------------------------------

def input_specs(cfg, shape_cfg):
    """{name: (shape, dtype)} of a batch for (cfg, shape).  Decode shapes
    describe ONE new token; the cache comes from cache_specs()."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    ids = torch.int64
    dt = model_dtype(cfg)
    if shape_cfg.mode in ("train", "prefill"):
        if cfg.modality == "audio_tokens":
            return {"input_embeds": ((B, S, cfg.d_model), dt),
                    "labels": ((B, S, cfg.num_codebooks), ids)}
        if cfg.modality == "vlm":
            P = cfg.num_prefix_tokens
            return {"patch_embeds": ((B, P, cfg.d_model), dt),
                    "tokens": ((B, S - P), ids),
                    "labels": ((B, S), ids)}
        return {"tokens": ((B, S), ids), "labels": ((B, S), ids)}
    # decode: one token against a cache of S entries
    if cfg.modality == "audio_tokens":
        return {"tokens_mc": ((B, 1, cfg.num_codebooks), ids),
                "cache_len": ((), ids)}
    return {"tokens": ((B, 1), ids), "cache_len": ((), ids)}


def cache_specs(cfg, shape_cfg):
    """The decode cache of (cfg, shape) built on the `meta` device: every
    leaf's shape and dtype, no storage."""
    return make_cache(cfg, shape_cfg.global_batch, shape_cfg.seq_len,
                      device="meta")


def dummy_batch(cfg, shape_cfg, generator=None, device=None):
    """A batch of `input_specs`' shapes with random values from
    `generator` (a torch.Generator on `device`'s type, or an int seed;
    None: 0) on `device` (None: cuda), for small configs: ids uniform in
    [0, vocab), cache_len = seq_len - 1, floats N(0, 1) drawn in fp32 and
    cast."""
    device = resolve_device(device)
    gen = as_generator(0 if generator is None else generator, device)
    out = {}
    for name, (shape, dtype) in input_specs(cfg, shape_cfg).items():
        if name == "cache_len":
            out[name] = torch.full((), shape_cfg.seq_len - 1, dtype=dtype,
                                   device=device)
        elif dtype == torch.int64:
            out[name] = torch.randint(0, cfg.vocab_size, shape, dtype=dtype,
                                      generator=gen, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen,
                                    device=device).to(dtype)
    return out
