"""Config system: model configs, input-shape configs, and the arch registry.

Reference: src/repro/configs/base.py, copied field for field (the port
imports nothing of the JAX package).  Only the architectures the port runs
are registered: each registers its full config and a reduced smoke config,
which the CPU tests instantiate.  The assigned input shapes and
`arch_for_shape` come with the dry-run's slice (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    experts_per_token: int = 0      # top-k
    num_shared_experts: int = 0     # always-on experts (deepseek-v2)
    d_ff_expert: int = 0            # per-expert hidden dim
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    first_dense_layers: int = 0     # deepseek-v2: leading dense layers
    capacity_factor: float = 1.25   # expert-parallel dispatch capacity
    router_aux_weight: float = 1e-2  # load-balance auxiliary loss weight
    router_z_weight: float = 1e-3    # router z-loss weight

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = full-rank q projection
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_rope_head_dim + self.qk_nope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / xLSTM state-space parameters."""
    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64              # mamba2 SSD head dim
    chunk_size: int = 256           # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class INLConfig:
    """In-network-learning vertical split (the paper's technique).

    The model is split into J encoder branches (each `encoder_layers` blocks of
    the arch's own family, width `d_encoder`) terminated by a stochastic
    Gaussian bottleneck of width `d_bottleneck` per node, plus the remaining
    stack as the fusion decoder at node J+1.  Eq. (5): J * d_bottleneck must
    equal the decoder input width.
    """
    num_nodes: int = 5              # J
    encoder_layers: int = 2
    d_bottleneck: int = 64          # latent dim per node (u_j)
    s: float = 1e-2                 # Lagrange multiplier of eq. (6)
    link_bits: int = 16             # bits per activation value on the link (s in §III-C)
    learned_prior: bool = False     # Q_psi(u_j): standard normal vs learned marginal


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    head_dim: int = 0               # 0 = d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0         # 0 = full attention; >0 = window size
    use_mla: bool = False
    mla: MLAConfig = field(default_factory=MLAConfig)
    # --- MoE ---
    moe: MoEConfig = field(default_factory=MoEConfig)
    # --- SSM / hybrid ---
    ssm: SSMConfig = field(default_factory=SSMConfig)
    block_pattern: Tuple[str, ...] = ()   # e.g. ('mamba',)*5 + ('mamba+shared_attn',)
    # xlstm: which block types in the repeating pattern ('mlstm' / 'slstm')
    # --- modality ---
    modality: str = "text"          # text | audio_tokens | vlm
    num_prefix_tokens: int = 0      # vlm: patch tokens prepended
    num_codebooks: int = 1          # audio: parallel codebooks (output heads)
    # --- misc ---
    norm_eps: float = 1e-5
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True              # activation checkpointing on scanned blocks
    scan_layers: bool = True        # lax.scan over layer stack (False = unroll)
    # flash-attention tile sizes and CE sequence-chunk (0 = library default).
    # The dry-run's cost-oracle variants set these to the full sequence so no
    # FLOPs hide inside scan bodies (never executed, only cost-analysed).
    attn_block_q: int = 0
    attn_block_k: int = 0
    ce_chunk: int = 0
    # MoE dispatch: "ep" = shard_map expert-parallel (local dispatch + one
    # psum; §Perf iteration 5), "gspmd" = partitioner-chosen scatter (the
    # frozen baseline).  "ep" falls back to "gspmd" when no mesh is active.
    moe_impl: str = "ep"
    # --- the paper's technique ---
    inl: INLConfig = field(default_factory=INLConfig)
    source: str = ""                # citation bracket from the assignment

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: num_heads={self.num_heads} not divisible by "
            f"num_kv_heads={self.num_kv_heads}")

    # ---- derived quantities -------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.moe.enabled

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return replace(self, sliding_window=window)

    def param_count(self) -> int:
        """Analytic parameter count N (used for FL bandwidth + roofline 6ND)."""
        from repro_torch.models import zoo
        return zoo.param_count(self)


# ---------------------------------------------------------------------------
# Input-shape configs (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# the ported architectures; the reference's other configs (llama3.2-1b,
# qwen1.5-4b, starcoder2-3b, codeqwen1.5-7b, arctic-480b, deepseek-v2-236b,
# xlstm-125m, musicgen-medium, internvl2-2b) come with the LLM stack's later
# slices (ROADMAP queue 1, item 6)
_ARCH_MODULES = ["zamba2_2_7b"]

_REGISTRY: dict = {}
_SMOKE_REGISTRY: dict = {}


def register(config: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[config.name] = config
    _SMOKE_REGISTRY[config.name] = smoke
    return config


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    key = name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    key = name.replace("_", "-")
    return _SMOKE_REGISTRY[key]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)

