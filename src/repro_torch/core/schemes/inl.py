"""In-network learning behind the unified Scheme API (wraps core/inl.py).

Reference: src/repro/core/schemes/inl.py (`INLScheme.init`, `predict`,
`predict_batched`).  The state holds the parameters and the BatchNorm
statistics; the optimizer state joins it with the training slice.
"""
from __future__ import annotations

from repro_torch.core import inl
from repro_torch.core import schemes as _schemes
from repro_torch.core.schemes import base


@_schemes.register
class INLScheme(base.Scheme):
    name = "inl"

    def init(self, cfg, generator, *, device=None):
        params, state = inl.init(cfg, generator, device=device)
        return {"params": params, "state": state}

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None):
        return inl.predict(state["params"], state["state"], views, cfg=cfg,
                           topology=topology, device=device)

    def predict_batched(self, state, views, *, delivery=None, topology=None,
                        cfg=None, wire: str = "dense", device=None):
        # delivery=None reproduces `predict` bit for bit — the engine's
        # bucket-padding parity contract
        return inl.predict(state["params"], state["state"], views, cfg=cfg,
                           topology=topology, delivery=delivery, wire=wire,
                           device=device)
