"""The yardstick's arithmetic: the H100's published peaks, the bytes and
FLOPs of the hand-written kernels a launch, and each configuration's model
FLOPs a training round or step.

Model FLOPs count the matrix products and convolutions that a training
step needs (the forward, and in the backward each product's gradient with
respect to its weights and, where the input needs one, its input), and no
recomputation.  That is what `torch.utils.flop_counter.FlopCounterMode`
counts over the plain references, which the tests check.  Bytes count each
input byte read once and each output byte written once.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def bound_s(flops: float, nbytes: float, flops_peak: float,
            chip: str = "h100") -> float:
    """The least time the chip could take: the larger of the FLOPs over
    the given peak and the bytes over the memory bandwidth."""
    return max(flops / flops_peak,
               nbytes / PEAKS[chip]["hbm_bytes_per_s"])


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def cut_fwd_bytes(R: int, d: int, act: int, mode: str = "sample") -> int:
    """cut_fwd on (R, d) rows: mu, logvar (act bytes), eps (fp32) read, u
    (act bytes) and the rate (fp32, R) written.  fp32: 16 R d + 4 R."""
    return R * d * (3 * act + 4) + 4 * R


def cut_bwd_bytes(R: int, d: int, act: int, mode: str = "sample") -> int:
    """cut_bwd: mu, logvar, gu (act) and eps (fp32) read, the rate's
    cotangent (fp32, R) read unless the mode is "none"; dmu, dlv (act) and
    deps (fp32) written.  fp32: 28 R d + 4 R."""
    return R * d * (5 * act + 8) + (0 if mode == "none" else 4 * R)


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def flash_fwd_flops(B, S, H, Dh, causal=True) -> int:
    """4 Dh a (query, key) pair and head: q.k and p.v."""
    pairs = causal_pairs(S) if causal else S * S
    return 4 * Dh * H * B * pairs


def flash_fwd_bytes(B, S, H, KV, Dh, act=2, lse=True) -> int:
    """q and o (B, S, H, Dh), k and v (B, S, KV, Dh), once each; the fp32
    logsumexp (B, S, H) when it is written."""
    return act * B * S * Dh * (2 * H + 2 * KV) + (4 * B * S * H if lse else 0)


# ---------------------------------------------------------------------------
# The paper's network (Fig. 4)
# ---------------------------------------------------------------------------

def _encoder_flops(cfg, *, logvar_backward: bool):
    """(forward, backward) FLOPs of one encoder on one image; its input
    (the view) takes no gradient."""
    H, Wd, C = cfg["image_shape"]
    chans = (C,) + tuple(cfg["conv_channels"])
    fwd = bwd = 0
    for i in range(len(cfg["conv_channels"])):
        hw = (H // 2 ** i) * (Wd // 2 ** i)
        f = 2 * 9 * chans[i] * chans[i + 1] * hw
        fwd += f
        bwd += f if i == 0 else 2 * f
    side = H // 2 ** len(cfg["conv_channels"])
    head = 2 * side * side * cfg["conv_channels"][-1] * cfg["d_bottleneck"]
    fwd += 2 * head
    bwd += 2 * head + (2 * head if logvar_backward else 0)
    return fwd, bwd


def _dense_flops(cfg):
    J, d = cfg["num_clients"], cfg["d_bottleneck"]
    dims = (J * d,) + tuple(cfg["dense_units"]) + (cfg["num_classes"],)
    return sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def paper_round_flops(cfg, scheme: str, batch: int,
                      local_steps: int = 2) -> int:
    """Model FLOPs of one training round: INL's one step over J views of a
    batch; FL's J * local_steps steps of the whole network, each on one
    view broadcast to the J branches (its cut is u = mu, so the log-variance
    head takes no gradient)."""
    J = cfg["num_clients"]
    if scheme == "inl":
        ef, eb = _encoder_flops(cfg, logvar_backward=True)
        heads = 2 * cfg["d_bottleneck"] * cfg["num_classes"] * J
        return batch * (J * (ef + eb) + 3 * _dense_flops(cfg) + 3 * heads)
    if scheme == "fl":
        ef, eb = _encoder_flops(cfg, logvar_backward=False)
        step = batch * (J * (ef + eb) + 3 * _dense_flops(cfg))
        return J * local_steps * step
    raise ValueError(f"no FLOP count for scheme {scheme!r}")


# ---------------------------------------------------------------------------
# INL over an attention-block LLM
# ---------------------------------------------------------------------------

def _layer_matmul_flops(m) -> int:
    """A pre-norm attention block's products a token, forward: q, k, v, o
    and the two-matrix MLP."""
    d, H, KV, Dh, F = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["d_ff"])
    return 2 * (d * H * Dh + 2 * d * KV * Dh + H * Dh * d + 2 * d * F)


def inl_llm_step_flops(m, batch: int, seq: int, causal: bool = True) -> int:
    """Model FLOPs of one INL training step over the LLM: J encoders of
    `encoder_layers` blocks and their (mu, logvar) heads, the in-projection
    of the J d_b concatenated latents, the decoder's blocks, the
    unembedding and the J branch heads, forward and backward (3x the
    forward: every product's input takes a gradient, the embeddings are
    gathers), plus attention, 12 Dh a (query, key) pair and head."""
    inl = m["inl"]
    J, e, d_b = inl["num_nodes"], inl["encoder_layers"], inl["d_bottleneck"]
    d, V = m["d_model"], m["vocab_size_padded"]
    layers = J * e + (m["num_layers"] - e)
    per_token = (layers * _layer_matmul_flops(m) + J * 2 * 2 * d * d_b
                 + 2 * J * d_b * d + 2 * d * V + J * 2 * d_b * V)
    pairs = causal_pairs(seq) if causal else seq * seq
    attn = layers * 12 * m["head_dim"] * m["num_heads"] * batch * pairs
    return 3 * per_token * batch * seq + attn
