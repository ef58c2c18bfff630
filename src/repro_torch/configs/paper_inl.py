"""The paper's own experiment setup (§IV): CIFAR-10, J=5 clients observing
Gaussian-noise-corrupted views (sigma = 0.4, 1, 2, 3, 4), VGG-style conv
encoders per client, two dense layers at node J+1.

Reference: src/repro/configs/paper_inl.py, copied field for field (the
port imports nothing of the JAX package).  Driven by repro_torch.core.inl
with the conv model in repro_torch.core.paper_model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PaperExperimentConfig:
    num_clients: int = 5                         # J
    noise_stds: Tuple[float, ...] = (0.4, 1.0, 2.0, 3.0, 4.0)
    num_classes: int = 10
    image_shape: Tuple[int, int, int] = (32, 32, 3)
    # VGG-style encoder at each client (Fig. 4 "Conv" column, reduced widths
    # are configurable for CPU-sized runs)
    conv_channels: Tuple[int, ...] = (32, 64, 128)
    d_bottleneck: int = 64                       # u_j width -> p = J * 64
    # node (J+1): two dense layers (Fig. 4)
    dense_units: Tuple[int, ...] = (512, 256)
    s: float = 1e-2                              # eq. (6) Lagrange multiplier
    # mixed-precision policy: "fp32" (default) or "bf16" — encoder/decoder
    # convs and denses run at this dtype; master params, optimizer state,
    # BatchNorm stats and the kernels' rate/KL accumulation stay fp32
    # (core/paper_model.compute_dtype / cast_compute)
    compute_dtype: str = "fp32"
    link_bits: int = 32                          # bits per activation value
    # Q_psi_j(u_j): standard normal (False) or learned per-node Gaussian
    # marginals (True, trained jointly via the fused kernel's prior path)
    learned_prior: bool = False
    # the inference graph (a core/topology.Topology: star/chain/tree, or
    # any validated single-sink DAG with per-edge link_bits/wire/dtype).
    # None — or an all-default star — keeps every code path bit-identical
    # to the pre-topology star; explicit `topology=` arguments to the
    # Scheme API override this field per call.
    topology: object = None
    # unreliable-network training (core/linkfault.py): per-round
    # probability that each view node's transmission is dropped during
    # TRAINING on top of any per-edge LinkModel erasures — the node-dropout
    # curriculum that teaches the fusion center to degrade gracefully.
    # 0.0 (default) keeps every code path bit-identical to the pre-fault
    # graph unless an edge carries a LinkModel.
    edge_dropout: float = 0.0
    # straggler deadline: when set (milliseconds) and edges carry latency/
    # bandwidth models, the fusion center fuses whatever arrived within
    # the deadline and masks the rest (fuse-what-arrived semantics).
    fusion_deadline_ms: object = None
    # hybrid-scheme knobs (core/schemes/splitfed.py, hybrid.py).  cut_depth
    # truncates the CLIENT-side conv trunk to its first k blocks (None keeps
    # the full trunk — the classic SL boundary right before the bottleneck
    # head); hybrid_fl_clients names the clients that participate FL-style
    # (full local model + weight exchange) instead of shipping cut-layer
    # activations.  Both are ignored by the pure inl/fl/sl schemes, so the
    # defaults keep every existing trajectory bit-identical.
    cut_depth: object = None
    hybrid_fl_clients: Tuple[int, ...] = (0,)
    # experiment 1 partitions data per scheme; experiment 2 shares it
    experiment: int = 1
    dataset_size: int = 50_000
    seed: int = 0


SMOKE = PaperExperimentConfig(
    conv_channels=(8, 16), d_bottleneck=16, dense_units=(64,),
    dataset_size=512)
