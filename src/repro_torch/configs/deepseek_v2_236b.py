"""DeepSeek-V2 236B [arXiv:2405.04434] — MLA + fine-grained MoE.

60L d5120 128H, MLA kv_lora_rank=512 (qk 128 nope + 64 rope, v 128),
MoE: 2 shared + 160 routed experts top-6, d_ff_expert 1536, vocab 102400.
Layer 0 is dense (d_ff = 8 * 1536 = 12288, the standard DSv2 ratio of the
dense FFN to the expert FFN).

MLA is the arch most aligned with the paper's idea: the KV cache stores the
*compressed* latent c_kv (rank 512) + shared rope key — a learned bottleneck
representation, exactly the kind of compressed feature INL ships over links.

Reference: src/repro/configs/deepseek_v2_236b.py, copied.
"""
from repro_torch.configs.base import (ModelConfig, MoEConfig, MLAConfig, INLConfig,
                                register)

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=12_288,                      # dense layer-0 FFN width
        vocab_size=102_400,
        head_dim=192,                     # qk head dim (128 nope + 64 rope)
        use_mla=True,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_rope_head_dim=64, qk_nope_head_dim=128,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=160, experts_per_token=6,
                      num_shared_experts=2, d_ff_expert=1536,
                      first_dense_layers=1),
        inl=INLConfig(num_nodes=8, encoder_layers=2, d_bottleneck=640),
        source="[arXiv:2405.04434]",
    ),
    smoke=ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        head_dim=48,
        use_mla=True,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      qk_rope_head_dim=16, qk_nope_head_dim=32,
                      v_head_dim=32),
        moe=MoEConfig(num_experts=4, experts_per_token=2,
                      num_shared_experts=1, d_ff_expert=64,
                      first_dense_layers=1),
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[arXiv:2405.04434]",
    ),
)
