"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B arch family] — dense, QKV bias.

40L d2560 20H (GQA kv=20 == MHA) d_ff 6912, vocab 151936.

Reference: src/repro/configs/qwen1_5_4b.py, copied.
"""
from repro_torch.configs.base import ModelConfig, INLConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        d_ff=6912,
        vocab_size=151_936,
        qkv_bias=True,
        rope_theta=1e6,
        inl=INLConfig(num_nodes=4, encoder_layers=2, d_bottleneck=640),
        source="[hf:Qwen/Qwen1.5-0.5B]",
    ),
    smoke=ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[hf:Qwen/Qwen1.5-0.5B]",
    ),
)
