"""The search space: hashable configuration points and their validity.

Reference: src/repro/search/space.py, copied; the topologies parse through
the port's core/topology.

A `ConfigPoint` is one placement decision — which scheme runs, how deep
the client-side cut sits, what graph the exchange routes over, how wide
and in which wire format the links run.  Points carry the topology as its
`core/topology.from_name` spec string so a whole space is hashable and
JSON-able; `resolve()` turns a point into the (cfg, topology) pair the
runner consumes, adapting `num_clients`/`noise_stds` to the graph's view
count (extra views cycle the paper's noise ladder).

`SearchSpace.points()` enumerates the VALID product only; the rules that
exclude a combination are structural, not heuristic:

  * packed wire formats need 1 <= link_bits <= 16 (uint32 codeword lanes);
  * FL and SL are star-only by construction (`topology.require_star` —
    weight broadcast / the single client->server boundary have no
    multi-hop reading);
  * FL moves fp32 weights whatever cfg.link_bits says, so only the
    (link_bits=32, wire="dense") spelling prices truthfully — narrower
    points would charge a quantized exchange the wire never implements;
  * SL is width-limited the same way: the paper's Table-I closed form
    (2pq + eta*N*J)*s charges the per-epoch weight hand-offs at the link
    width s, but the wire ships the fp32 client masters — only s=32
    makes the charge and the shipment the same number;
  * cut_depth parameterises the hybrid schemes only (splitfed/hybrid);
    for the pure schemes the knob does not exist.

`excluded()` returns the rejected combinations with their reasons, so the
bench artifact records what the grid did NOT cover.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core import topology as topology_lib

HYBRID_SCHEMES = ("splitfed", "hybrid")
PACKED_WIRES = ("packed", "packed_duplex")


@dataclass(frozen=True)
class ConfigPoint:
    scheme: str
    topology: str                 # a from_name spec: "star(5)", "tree(2,2)"
    link_bits: int = 32
    wire: str = "dense"
    cut_depth: Optional[int] = None

    @property
    def key(self) -> str:
        depth = "full" if self.cut_depth is None else str(self.cut_depth)
        return (f"{self.scheme}/{self.topology}/q{self.link_bits}/"
                f"{self.wire}/d{depth}")

    def resolve(self, base_cfg):
        """(cfg, topology-or-None) for the runner: the base experiment
        re-shaped to this point.  None topology = the default star (the
        legacy bit-identical fast path)."""
        topo = topology_lib.from_name(self.topology)
        J = topo.num_views()
        noise = tuple(base_cfg.noise_stds[j % len(base_cfg.noise_stds)]
                      for j in range(J))
        fl_idx = tuple(j for j in getattr(base_cfg, "hybrid_fl_clients",
                                          (0,)) if j < J) or (0,)
        cfg = dataclasses.replace(
            base_cfg, num_clients=J, noise_stds=noise,
            link_bits=self.link_bits, cut_depth=self.cut_depth,
            hybrid_fl_clients=fl_idx, topology=None)
        return cfg, (None if topo.is_default_star() else topo)


@dataclass(frozen=True)
class SearchSpace:
    """A product grid.  Combine several spaces (e.g. a graph sweep for INL
    plus a cut-depth sweep for the hybrids) by concatenating `points()`."""
    schemes: Tuple[str, ...]
    topologies: Tuple[str, ...]
    link_bits: Tuple[int, ...] = (32,)
    wires: Tuple[str, ...] = ("dense",)
    cut_depths: Tuple[Optional[int], ...] = (None,)

    def _enumerate(self):
        for s in self.schemes:
            depths = self.cut_depths if s in HYBRID_SCHEMES else (None,)
            for t in self.topologies:
                for q in self.link_bits:
                    for w in self.wires:
                        for d in depths:
                            yield ConfigPoint(s, t, q, w, d)

    def _reject(self, p: ConfigPoint) -> Optional[str]:
        if p.wire in PACKED_WIRES and not 1 <= p.link_bits <= 16:
            return "packed wires need 1 <= link_bits <= 16"
        star_only = p.scheme in ("fl", "sl")
        if star_only and not p.topology.startswith("star("):
            return f"scheme {p.scheme} requires a star topology"
        if p.scheme == "fl" and (p.link_bits != 32 or p.wire != "dense"):
            return ("fl exchanges fp32 weights; only (q32, dense) prices "
                    "truthfully")
        if p.scheme == "sl" and p.link_bits != 32:
            return ("sl's Table-I form charges weight hand-offs at the "
                    "link width but the wire ships fp32 masters; only "
                    "q32 prices truthfully")
        return None

    def points(self):
        out, seen = [], set()
        for p in self._enumerate():
            if p.key in seen or self._reject(p):
                continue
            seen.add(p.key)
            out.append(p)
        return out

    def excluded(self):
        out, seen = [], set()
        for p in self._enumerate():
            reason = self._reject(p)
            if reason and p.key not in seen:
                seen.add(p.key)
                out.append((p, reason))
        return out


def merge_points(*spaces) -> list:
    """Concatenate several spaces' valid points, first spelling wins."""
    out, seen = [], set()
    for sp in spaces:
        for p in sp.points():
            if p.key not in seen:
                seen.add(p.key)
                out.append(p)
    return out
