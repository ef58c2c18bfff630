"""Zamba2-7B [arXiv:2411.15242] at its published widths: Mamba2 layers with
two groups of B and C, and two alternating shared attention blocks.

Source: https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json
(d_model 3,584, 81 layers, vocab 32,000, context 4,096; Mamba2 expand 2,
112 heads of 64, state 64, ngroups 2, conv 4, chunk 256; shared attention
over [h, e] (attention_hidden_size 7,168 = 2 d), 32 heads of
attention_head_dim 224, RoPE theta 10,000; a gated GELU MLP of 14,336;
num_mem_blocks 2; adapter_rank 128 on the shared MLP, none on attention;
a tied head).  Registered by the port alone (the JAX package holds only
the repository's Zamba2-2.7B, whose shared block differs).

The published `layers_block_type`, 81 entries, with "hybrid" at
`hybrid_layer_ids` 6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77:

    mamba x6, hybrid, mamba x4, hybrid, then (mamba x5, hybrid) x11,
    mamba x3

A hybrid layer is invocation i of the shared blocks (i counted from layer
6) and runs block i % 2.  The registered config is periods of
("mamba",) * 5 + ("hybrid",) from published layer 12 on: 12 layers are
layers 12-23, invocations 2 and 3, so period p's hybrid runs block p % 2,
each block once; the benchmark's cell runs that 12-layer stage
(`dataclasses.replace(get_config("zamba2-7b"), num_layers=12)`).  The
registered `num_layers` is the published 81, which is no whole number of
such periods (the first 12 layers hold 10 Mamba2 layers and 2 hybrids,
the last 3 are Mamba2 layers), so the stack refuses it whole, as it
refuses any depth that is not: a stage of whole periods is what runs.

The layer equations (e the stack's input embedding, h the residual), from
`transformers`' modeling_zamba2.py where config.json fixes none:

    hybrid   c = RMSNorm_2d([h, e]);  a = o_b(Attn(q_b c, k_b c, v_b c)),
             causal, RoPE on q and k, softmax scale (224 / 2)^-1/2;
             [g, u] = gate_up_b(n) + B_i A_i n, n = RMSNorm_d(a);
             t = down_b(gelu(g) u) with the exact (erf) GELU;
             T = L_i t;  h <- h + Mamba2(RMSNorm_d(h + T))
    mamba    h <- h + Mamba2(RMSNorm_d(h))
    head     a final RMSNorm, a head tied to the embedding
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

_PATTERN = ("mamba",) * 5 + ("hybrid",)

CONFIG = register(
    ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14_336,
        vocab_size=32_000,
        head_dim=224,
        rope_theta=10_000.0,
        block_pattern=_PATTERN,
        ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64,
                      chunk_size=256, ngroups=2),
        num_mem_blocks=2,
        adapter_rank=128,
        attn_scale=(224 / 2) ** -0.5,
        act="gelu_exact",
        norm_eps=1e-5,
        tie_embeddings=True,
        source="[arXiv:2411.15242]",
    ),
    smoke=ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=12,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        head_dim=32,
        rope_theta=10_000.0,
        block_pattern=_PATTERN,
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, head_dim=16,
                      chunk_size=16, ngroups=2),
        num_mem_blocks=2,
        adapter_rank=8,
        attn_scale=(32 / 2) ** -0.5,
        act="gelu_exact",
        norm_eps=1e-5,
        tie_embeddings=True,
        source="[arXiv:2411.15242]",
    ),
    port_only=True,
)
