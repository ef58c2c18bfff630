"""The yardstick's arithmetic for Zamba2-7B's stage (bench/configs/
zamba2-7b.json): the model FLOPs of a training step, and the FLOPs and
bytes of the kernels its cell reads (the grouped `ssd_scan`, and the
attention backward `flash_attn_bwd`).

Model FLOPs are what `torch.utils.flop_counter.FlopCounterMode` counts
over the plain reference (bench/reference/zamba2.py) without its
recomputation, which the tests check: each matrix product forward and,
every product's inputs taking a gradient, twice more backward; the
attention's two products over the kept (query, key) pairs; the SSD's
chunked quadratic form as the reference writes it (C_i . B_j per head
over a chunk's L x L pairs, the product with x, and from the second
chunk on the inter-chunk term and the state carried).
"""
from __future__ import annotations

from bench.roofline import causal_pairs, flash_fwd_flops


def _dims(m):
    s = m["ssm"]
    d = m["d_model"]
    d_in = s["expand"] * d
    H = d_in // s["head_dim"]
    return d, d_in, H, s["ngroups"], s["state_dim"], s["head_dim"]


def mamba_matmul_flops(m) -> int:
    """A Mamba2 mixer's dense products a token, forward: in and out."""
    d, d_in, H, G, N, _ = _dims(m)
    return 2 * d * (2 * d_in + 2 * G * N + H) + 2 * d_in * d


def hybrid_matmul_flops(m) -> int:
    """A hybrid layer's products a token beyond its mixer's, forward: the
    shared block's q, k, v from 2 d and o, the gated MLP, the adapter and
    the invocation's linear."""
    d, F, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    HD = m["num_heads"] * m["head_dim"]
    return 2 * (3 * 2 * d * HD + HD * d + d * 2 * F + d * r + r * 2 * F
                + F * d + d * d)


def ssd_model_flops(m, batch: int, seq: int) -> int:
    """The reference's SSD products of one mixer, forward and backward."""
    _, _, H, _, N, P = _dims(m)
    L = min(m["ssm"]["chunk_size"], seq)
    nc = seq // L
    quad = 2 * batch * H * L * L * (N + P)       # C B^T and its product with x
    carry = 2 * 2 * batch * H * L * N * P        # inter-chunk term and state
    return 3 * (nc * quad + (nc - 1) * carry)


def step_flops(m, batch: int, seq: int, causal: bool = True) -> int:
    """Model FLOPs of one training step of the stage: its mixers, hybrids
    and tied head, forward and backward (3x the forward: every product's
    input takes a gradient, the embedding is a gather), plus the shared
    attention, 12 Dh a (query, key) pair and head, and the SSD."""
    n_layers = m["num_layers"]
    hybrids = n_layers // 6
    per_token = (n_layers * mamba_matmul_flops(m)
                 + hybrids * hybrid_matmul_flops(m)
                 + 2 * m["d_model"] * m["vocab_size_padded"])
    pairs = causal_pairs(seq) if causal else seq * seq
    attn = hybrids * 12 * m["head_dim"] * m["num_heads"] * batch * pairs
    return (3 * per_token * batch * seq + attn
            + n_layers * ssd_model_flops(m, batch, seq))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def ssd_scan_flops(B, S, H, P, N, G, L) -> int:
    """One `ssd_scan` call (PERF.md's row 9, B and C in G groups): C B^T
    once per (b, chunk, group) over the causal pairs, then per head G x,
    the inter-chunk term and the state update."""
    nc, pairs = S // L, L * (L + 1) // 2
    return 2 * B * nc * (G * pairs * N + H * (pairs * P + 2 * L * N * P))


def ssd_scan_bytes(B, S, H, P, N, G, act=2) -> int:
    """x, B, C (act bytes) and dt, a, D (fp32) read once; y (act) and the
    fp32 final state written once."""
    return (act * B * S * (2 * H * P + 2 * G * N) + 4 * B * S * H + 8 * H
            + 4 * B * H * N * P)


def flash_bwd_flops(B, S, H, Dh, causal=True) -> int:
    """One `flash_attn_bwd` call (PERF.md's row 10): 2.5 x the forward's
    4 Dh a kept (query, key) pair and head (S, dP, dv, dk, dq)."""
    return 5 * flash_fwd_flops(B, S, H, Dh, causal) // 2
