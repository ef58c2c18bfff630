"""InternVL2-2B [arXiv:2404.16821] — InternViT + InternLM2 (backbone only).

24L d2048 16H (GQA kv=8) d_ff 8192, vocab 92553. The InternViT vision encoder
and MLP projector are a STUB: input_specs() provides 256 precomputed patch
embeddings (B, 256, d_model) that are prepended to the text-token embeddings.

Reference: src/repro/configs/internvl2_2b.py, copied.
"""
from repro_torch.configs.base import ModelConfig, INLConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92_553,
        rope_theta=1e6,
        modality="vlm",
        num_prefix_tokens=256,
        inl=INLConfig(num_nodes=4, encoder_layers=2, d_bottleneck=512),
        source="[arXiv:2404.16821]",
    ),
    smoke=ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        modality="vlm",
        num_prefix_tokens=16,
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[arXiv:2404.16821]",
    ),
)
