"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 arch at 7B.

32L d4096 32H (MHA) d_ff 13440, vocab 92416, QKV bias.

Reference: src/repro/configs/codeqwen1_5_7b.py, copied.
"""
from repro_torch.configs.base import ModelConfig, INLConfig, register

CONFIG = register(
    ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13_440,
        vocab_size=92_416,
        qkv_bias=True,
        rope_theta=1e6,
        inl=INLConfig(num_nodes=8, encoder_layers=2, d_bottleneck=512),
        source="[hf:Qwen/CodeQwen1.5-7B]",
    ),
    smoke=ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[hf:Qwen/CodeQwen1.5-7B]",
    ),
)
