"""MusicGen-medium [arXiv:2306.05284] — decoder-only LM over EnCodec tokens.

48L d1536 24H (MHA) d_ff 6144, vocab 2048 per codebook, 4 codebooks.
The EnCodec conv codec frontend is a STUB: input_specs() provides precomputed
frame embeddings (B, S, d_model); the decoder predicts the 4 codebook token
streams with 4 parallel LM heads (delay-pattern interleave handled by the
data pipeline, not the backbone).

Reference: src/repro/configs/musicgen_medium.py, copied.
"""
from repro_torch.configs.base import ModelConfig, INLConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        modality="audio_tokens",
        num_codebooks=4,
        act="gelu",
        inl=INLConfig(num_nodes=4, encoder_layers=2, d_bottleneck=384),
        source="[arXiv:2306.05284]",
    ),
    smoke=ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=256,
        modality="audio_tokens",
        num_codebooks=4,
        act="gelu",
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[arXiv:2306.05284]",
    ),
)
