"""StarCoder2-3B [arXiv:2402.19173] — dense, near-MQA GQA, RoPE.

30L d3072 24H (GQA kv=2) d_ff 12288, vocab 49152. StarCoder2 natively uses a
4k sliding window; we keep full attention for the standard shapes (faithful
to the assignment header) and the sliding-window variant for long_500k.

Reference: src/repro/configs/starcoder2_3b.py, copied.
"""
from repro_torch.configs.base import ModelConfig, INLConfig, register

CONFIG = register(
    ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12_288,
        vocab_size=49_152,
        qkv_bias=True,
        rope_theta=1e5,
        act="gelu",
        inl=INLConfig(num_nodes=4, encoder_layers=2, d_bottleneck=768),
        source="[arXiv:2402.19173]",
    ),
    smoke=ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        act="gelu",
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[arXiv:2402.19173]",
    ),
)
