"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks, 12L d768 4H.

Block pattern follows the xLSTM[7:1]-style interleave: one sLSTM block per
four-block period, the rest mLSTM (matrix-memory, linear-attention-like).
d_ff=0 in the assignment: xLSTM blocks carry their own up/down projections
instead of a separate FFN sublayer.

Reference: src/repro/configs/xlstm_125m.py, copied.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, INLConfig, register

_PATTERN = ("mlstm", "mlstm", "mlstm", "slstm")

CONFIG = register(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        head_dim=192,
        block_pattern=_PATTERN,
        ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=384,
                      chunk_size=256),
        inl=INLConfig(num_nodes=4, encoder_layers=2, d_bottleneck=192),
        source="[arXiv:2405.04517]",
    ),
    smoke=ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=2,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        head_dim=64,
        block_pattern=("mlstm", "slstm"),
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, head_dim=64,
                      chunk_size=64),
        inl=INLConfig(num_nodes=2, encoder_layers=1, d_bottleneck=32),
        source="[arXiv:2405.04517]",
    ),
)
