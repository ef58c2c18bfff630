"""The `Scheme` interface registered schemes implement.

Reference: src/repro/core/schemes/base.py (`Scheme.serve_buckets`,
`predict`, `predict_batched`).  A scheme's `state` is an opaque dict of
tensors bundling its parameters and model state; only the scheme looks
inside.  The training half of the interface (`make_round`, the bandwidth
ledgers) comes with the training slice of the port.
"""
from __future__ import annotations

from typing import Any, Tuple


class Scheme:
    """Base class: override `init` and `predict`."""

    name: str = ""

    # serving bucket sizes (repro_torch/serving): in-flight requests are
    # padded to the smallest bucket, so the engine runs at most one batch
    # shape per bucket size
    serve_buckets: Tuple[int, ...] = (1, 4, 16, 64)

    def init(self, cfg, generator, *, device=None) -> Any:
        """Build the state for `cfg` (PaperExperimentConfig) on `device`
        (None: cuda), deterministic in `generator`."""
        raise NotImplementedError

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None) -> Any:
        """views (J, B, ...) -> class probabilities (B, C); rows sum to 1."""
        raise NotImplementedError

    def predict_batched(self, state, views, *, delivery=None, topology=None,
                        cfg=None, wire: str = "dense", device=None) -> Any:
        """The serving plane's batched inference entry: `predict` plus the
        per-request delivery mask (which comes with the link-fault slice)
        and the serving wire format.  delivery=None MUST equal `predict` bit
        for bit."""
        if delivery is not None:
            raise NotImplementedError("delivery masks come with the "
                                      "link-fault slice of the port")
        return self.predict(state, views, topology=topology, cfg=cfg,
                            device=device)

    def __repr__(self):
        return f"<Scheme {self.name!r}>"
