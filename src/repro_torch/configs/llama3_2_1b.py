"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] — small llama3 dense.

16L d2048 32H (GQA kv=8) d_ff 8192, vocab 128256, tied embeddings.

Reference: src/repro/configs/llama3_2_1b.py, copied.
"""
from repro_torch.configs.base import ModelConfig, INLConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3.2-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128_256,
        rope_theta=500_000.0,
        tie_embeddings=True,
        inl=INLConfig(num_nodes=4, encoder_layers=2, d_bottleneck=512),
        source="[hf:meta-llama/Llama-3.2-1B]",
    ),
    smoke=ModelConfig(
        name="llama3.2-1b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=True,
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[hf:meta-llama/Llama-3.2-1B]",
    ),
)
