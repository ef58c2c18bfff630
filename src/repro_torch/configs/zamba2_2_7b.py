"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks.

54 Mamba2 layers d2560 (ssm_state=64) with a parameter-SHARED attention+MLP
block (32H, d_ff 10240) applied every 6th layer on concat([h, h_embed])
projected back to d_model — Zamba2's global-shared-attention design.

Reference: src/repro/configs/zamba2_2_7b.py, copied.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, INLConfig, register

# Repeating 6-layer period: 5 pure mamba2 blocks then mamba2 + shared attention.
_PATTERN = ("mamba",) * 5 + ("mamba+shared_attn",)

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10_240,
        vocab_size=32_000,
        head_dim=80,
        block_pattern=_PATTERN,
        ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64,
                      chunk_size=256),
        inl=INLConfig(num_nodes=4, encoder_layers=2, d_bottleneck=640),
        source="[arXiv:2411.15242]",
    ),
    smoke=ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        block_pattern=("mamba", "mamba+shared_attn"),
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, head_dim=32,
                      chunk_size=64),
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[arXiv:2411.15242]",
    ),
)
