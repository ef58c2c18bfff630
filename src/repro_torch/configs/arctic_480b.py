"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — dense-MoE hybrid.

35L d7168 56H (GQA kv=8) dense-residual d_ff 4864 alongside a 128-expert
top-2 MoE on every layer (Arctic's signature dense+MoE parallel residual).

Reference: src/repro/configs/arctic_480b.py, copied.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, INLConfig, register

CONFIG = register(
    ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32_000,
        rope_theta=1e6,
        moe=MoEConfig(num_experts=128, experts_per_token=2,
                      d_ff_expert=4864, dense_residual=True),
        inl=INLConfig(num_nodes=8, encoder_layers=2, d_bottleneck=896),
        source="[hf:Snowflake/snowflake-arctic-base]",
    ),
    smoke=ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, experts_per_token=2,
                      d_ff_expert=128, dense_residual=True),
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[hf:Snowflake/snowflake-arctic-base]",
    ),
)
