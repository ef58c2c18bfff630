"""Per-edge link models and graceful degradation under unreliable networks.

Reference: src/repro/core/linkfault.py (`LinkModel`, `forced_erasure`,
`with_links`, `has_link_models`, `deadline_ms`, `edge_dropout`, `active`,
`fault_key`, `_edge_tx_ms`, `_edge_draws`, `_route`, `delivery_mask`,
`round_delivery_mask`, `sample_delivery_mask`, `request_delivery_mask`,
`partial_fuse`, `uplink_model`, `client_delivery_mask`,
`attempt_successes`, `round_success`, `request_survival`, `degrade_probs`,
`round_fault_charges`).  A `LinkModel` on a `topology.Edge` gives that
link an erasure probability, a latency distribution (latency_ms +
jitter_ms * Exp(1) a draw) and a bandwidth cap (transmission time =
payload bits / bandwidth_bps), judged against a fusion deadline.

Activation rule, as in the reference: attaching ANY LinkModel to an edge
switches the schemes onto the fault-aware paths.  A default `LinkModel()`
is a modelled PERFECT link: its masks are all ones, `partial_fuse`
multiplies by exactly 1.0, the masked FedAvg of an all-ones mask takes the
clean average, and SL's bounded retry always succeeds, so attaching it
moves no trajectory by a bit.  A topology with no LinkModel (and
cfg.edge_dropout == 0) takes the fault-free paths untouched.

Scheme semantics: INL fuses what arrived (`partial_fuse`: the missing
latent chunks masked out of the eq.-(5) concatenation, the survivors
scaled by J / n_delivered; backward, autograd sends each eq.-(10) error
chunk back only over a surviving route); FL averages the client uploads
that arrived (all lost: the previous global model stays); SL retries its
single client -> server uplink `max_link_retries` times and otherwise
skips the round, its state carried through unchanged.

The fault stream.  JAX's threefry `fold_in` cannot be reproduced in
torch; what carries over is the reference's contract: every fault draw is
a pure function of (round key, edge index, salt); it never touches the
round's own randomness (eps and dropout masks come from the run's
torch.Generator, which no fault draw reads), so attaching `LinkModel()`
moves no trajectory; the bandwidth meter replays a round's draws on the
host; serving draws are keyed by request id.  The port's keys are uint64
numpy arrays and its draws a counter-based hash (splitmix64's output
function) evaluated on the HOST: `key(seed)` is a run's base key,
`round_key(seed, index)` the key of training round `index` (the runner
folds the run seed with the global round index), `fold_in` derives a
child key from a key and an integer, and a key's uniforms are the top 53
bits of the hash of (key, counter), in float64; the latency jitter is
-log1p(-u) in float64, rounded to fp32.  The masks are small boolean
numpy arrays, (J,) or (J, n): identical on the CPU and on the card, known
on the host without a device sync (SL's skip, FL's all-lost round), and
moved to the device in one small copy where a fusion reads them.  The
latency arithmetic is the reference's fp32 (per-edge time, then the
store-and-forward sum along the route, then the deadline), so a mask with
no random draw (erasure 0, jitter 0) equals the reference's bit for bit.

Delivered-vs-offered: `round_fault_charges` splits one round's bandwidth
between what the schedule put on the links (offered; SL's retries charge
per attempt) and what the consumer used (delivered);
`fault_charges_from_mask` is its arithmetic on a given mask.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import topology as topology_lib

# Distinct salts, so the erasure/latency, edge-dropout and SL-retry draws
# of one round never share a stream (the reference's values)
_SALT_FAULTS = 0x11_4bed      # per-edge erasure / latency draws
_SALT_DROPOUT = 0x22_4bed     # cfg.edge_dropout training curriculum
_SALT_RETRY = 0x33_4bed       # SL bounded-retry attempt draws

FORCE_ERASURE_ENV = "REPRO_FORCE_ERASURE"

# the schemes whose delivered share is the per-edge payload fraction
_FUSING_SCHEMES = ("inl", "splitfed", "hybrid")


@dataclass(frozen=True)
class LinkModel:
    """Unreliability of one directed link.  Hashable (rides inside the
    frozen `topology.Edge`).

    erasure        P(the whole (round, edge) payload is lost in flight)
    latency_ms     mean propagation latency per traversal
    jitter_ms      scale of the exponential latency tail (stragglers)
    bandwidth_bps  serialisation cap: tx time = payload bits / cap
                   (None = infinitely fast link, latency only)
    """
    erasure: float = 0.0
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    bandwidth_bps: Optional[float] = None

    def __post_init__(self):
        if not 0.0 <= self.erasure < 1.0:
            raise ValueError(f"erasure must be in [0, 1), got {self.erasure}")
        if self.latency_ms < 0 or self.jitter_ms < 0:
            raise ValueError("latency_ms/jitter_ms must be >= 0, got "
                             f"({self.latency_ms}, {self.jitter_ms})")
        if self.bandwidth_bps is not None and self.bandwidth_bps <= 0:
            raise ValueError(f"bandwidth_bps must be > 0, got "
                             f"{self.bandwidth_bps}")


def forced_erasure(default: float = 0.0) -> float:
    """The REPRO_FORCE_ERASURE override (CI's forced-erasure smoke leg).
    Unset or empty (matrix legs export it blank) means `default`."""
    raw = os.environ.get(FORCE_ERASURE_ENV, "")
    return float(raw) if raw else default


def with_links(topo, link) -> "topology_lib.Topology":
    """A copy of `topo` with LinkModels attached: `link` is one LinkModel
    for every edge, or a {edge_key: LinkModel} dict (missing keys keep the
    edge's current model)."""
    if isinstance(link, LinkModel):
        link = {e.key: link for e in topo.edges}
    unknown = set(link) - {e.key for e in topo.edges}
    if unknown:
        raise ValueError(f"with_links got models for unknown edge(s) "
                         f"{sorted(unknown)}; edges: "
                         f"{[e.key for e in topo.edges]}")
    edges = tuple(replace(e, link=link.get(e.key, e.link))
                  for e in topo.edges)
    return type(topo)(topo.nodes, edges)


# ---------------------------------------------------------------------------
# Activation: which cfg/topology combinations take the fault-aware paths
# ---------------------------------------------------------------------------

def has_link_models(topo) -> bool:
    """True when ANY edge carries a LinkModel, even a perfect one."""
    return any(e.link is not None for e in topo.edges)


def deadline_ms(cfg) -> Optional[float]:
    return getattr(cfg, "fusion_deadline_ms", None)


def edge_dropout(cfg) -> float:
    return float(getattr(cfg, "edge_dropout", 0.0) or 0.0)


def active(topo, cfg, *, train: bool) -> bool:
    """Whether a round on (topo, cfg) must run the fault-aware path.  False
    keeps the caller on the fault-free code bit for bit."""
    if has_link_models(topo):
        return True
    return train and edge_dropout(cfg) > 0.0


# ---------------------------------------------------------------------------
# Keys and the counter-based hash (host numpy, uint64)
# ---------------------------------------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix(z) -> np.ndarray:
    """splitmix64's output function on uint64 arrays (arithmetic mod 2^64)."""
    z = np.asarray(z, np.uint64)
    with np.errstate(over="ignore"):
        z = z + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def key(seed: int) -> np.ndarray:
    """A run's base key (a 0-d uint64 array) from an integer seed."""
    return _mix(np.asarray(int(seed) & 0xFFFF_FFFF_FFFF_FFFF, np.uint64))


def fold_in(k, data) -> np.ndarray:
    """A child key of `k` (a uint64 array of any shape) and the integer(s)
    `data`, broadcasting: a pure function of both."""
    d = np.asarray(data, np.int64).astype(np.uint64)
    return _mix(np.asarray(k, np.uint64) ^ _mix(d))


def round_key(seed: int, index: int) -> np.ndarray:
    """The key of training round `index` (the global round count from 0)
    of a run seeded `seed`: what the runner hands every faulty round and
    the meter replays."""
    return fold_in(key(seed), index)


def fault_key(rng) -> np.ndarray:
    """The per-round fault stream of round key `rng`."""
    return fold_in(rng, _SALT_FAULTS)


def _uniform(k, shape) -> np.ndarray:
    """Uniforms in [0, 1) of shape k.shape + shape, float64: the top 53
    bits of the hash of (key, counter)."""
    k = np.asarray(k, np.uint64)
    shape = tuple(shape)
    ctr = np.arange(int(np.prod(shape, dtype=np.int64)),
                    dtype=np.uint64).reshape(shape)
    z = _mix(k.reshape(k.shape + (1,) * len(shape)) ^ _mix(ctr))
    return (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


def _exponential(k, shape) -> np.ndarray:
    """Exp(1) draws, -log1p(-u) in float64, rounded to fp32."""
    return (-np.log1p(-_uniform(k, shape))).astype(np.float32)


# ---------------------------------------------------------------------------
# Deterministic draws: pure functions of (round key, edge index)
# ---------------------------------------------------------------------------

def _edge_tx_ms(link: Optional[LinkModel], payload_bits: float) -> float:
    if link is None or link.bandwidth_bps is None:
        return 0.0
    return 1e3 * payload_bits / link.bandwidth_bps


def _edge_draws(k, i: int, link: Optional[LinkModel], shape=()):
    """(erased, latency_ms fp32) draws for edge index `i`, of shape
    k.shape + shape: deterministic in (k, i)."""
    k = np.asarray(k, np.uint64)
    full = k.shape + tuple(shape)
    if link is None:
        return np.zeros(full, bool), np.zeros(full, np.float32)
    erased = (_uniform(fold_in(k, 2 * i), shape) < link.erasure) \
        if link.erasure > 0 else np.zeros(full, bool)
    lat = np.full(full, link.latency_ms, np.float32)
    if link.jitter_ms > 0:
        lat = lat + np.float32(link.jitter_ms) \
            * _exponential(fold_in(k, 2 * i + 1), shape)
    return erased, lat


def _route(topo, name: str):
    """Edges from view node `name` to the fuse node, with their declaration
    indices (the fault-draw index space)."""
    idx = {e.key: i for i, e in enumerate(topo.edges)}
    out = []
    cur = name
    while cur != topo.fuse_node:
        e = topo.out_edge(cur)
        out.append((idx[e.key], e))
        cur = e.dst
    return out


def delivery_mask(k, topo, cfg, *, payload_scale: float = 1.0,
                  deadline: Optional[float] = None, dropout: float = 0.0,
                  dropout_key=None, shape=()) -> np.ndarray:
    """The (J,) + k.shape + shape boolean delivery mask of one fusion: view
    j is True iff every edge on its route survived erasure, its cumulative
    latency + transmission time met `deadline` (store-and-forward per hop,
    fp32; None disables the deadline), and it survived the training
    `dropout` draw.  `payload_scale` multiplies each edge's closed-form
    payload bits (batch size for a training round, 1 for a per-request
    fusion) when a bandwidth cap converts them to transmission time; each
    edge charges its own width (`topology.edge_bits`)."""
    k = np.asarray(k, np.uint64)
    full = k.shape + tuple(shape)
    draws = {}
    for i, e in enumerate(topo.edges):
        erased, lat = _edge_draws(k, i, e.link, shape)
        bits = (payload_scale * len(topo.payload(e))
                * cfg.d_bottleneck * topology_lib.edge_bits(e, cfg))
        draws[i] = (erased, lat + np.float32(_edge_tx_ms(e.link, bits)))
    masks = []
    for j, name in enumerate(topo.view_nodes()):
        ok = np.ones(full, bool)
        t = np.zeros(full, np.float32)
        for i, _e in _route(topo, name):
            erased, time_ms = draws[i]
            ok = ok & ~erased
            t = t + time_ms
        if deadline is not None:
            ok = ok & (t <= np.float32(deadline))
        if dropout > 0.0:
            kd = fold_in(fold_in(k if dropout_key is None else dropout_key,
                                 _SALT_DROPOUT), j)
            ok = ok & (_uniform(kd, shape) >= dropout)
        masks.append(ok)
    return np.stack(masks)


def round_delivery_mask(rng, topo, cfg, batch_size: int, *,
                        train: bool) -> np.ndarray:
    """The (J,) per-ROUND mask the training paths consume: link erasures,
    the fusion deadline (cfg.fusion_deadline_ms) and the cfg.edge_dropout
    training curriculum.  Pure in (rng, statics)."""
    return delivery_mask(
        fault_key(rng), topo, cfg, payload_scale=float(batch_size),
        deadline=deadline_ms(cfg),
        dropout=edge_dropout(cfg) if train else 0.0)


def sample_delivery_mask(k, topo, cfg, n: int, *,
                         deadline: Optional[float] = None) -> np.ndarray:
    """Per-REQUEST masks for inference under faults: (J, n), each of the n
    requests drawing its own erasures and latencies per edge (payload: one
    latent a view), judged against `deadline` (default
    cfg.fusion_deadline_ms)."""
    return delivery_mask(fault_key(k), topo, cfg, payload_scale=1.0,
                         deadline=deadline if deadline is not None
                         else deadline_ms(cfg), shape=(n,))


def request_delivery_mask(k, topo, cfg, request_ids, *,
                          deadline: Optional[float] = None) -> np.ndarray:
    """Delivery masks keyed PER REQUEST ID: (J, n) for `request_ids` (n,).
    Request r's draws are a pure function of (k, r, edge), so a request
    fused inside a padded serving bucket sees exactly the faults it would
    see served alone: batch composition and padding cannot move them."""
    keys = fold_in(fault_key(k), np.asarray(request_ids, np.int64))
    return delivery_mask(keys, topo, cfg, payload_scale=1.0,
                         deadline=deadline if deadline is not None
                         else deadline_ms(cfg))


# ---------------------------------------------------------------------------
# Partial fusion: mask the missing chunks, renormalise the survivors
# ---------------------------------------------------------------------------

def mask_tensor(mask, device) -> torch.Tensor:
    """A bool mask (an array or a tensor) as a bool tensor on `device`."""
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.array(mask, bool))
    return mask.to(device=device, dtype=torch.bool)


def partial_fuse(u: torch.Tensor, mask) -> torch.Tensor:
    """Fuse-what-arrived: u (J, B, d) latents as the fusion center receives
    them, mask (J,) per-round or (J, B) per-sample delivery (a bool array
    or tensor, moved to u's device).  Missing chunks are zeroed and the
    survivors scaled by J / n_delivered, in the reference's order:
    u * m * (J / max(n, 1)), the quotient a true division (a Python
    number over a tensor would take the reciprocal, then multiply).

    An all-ones mask multiplies by exactly 1.0, the identity bit for bit;
    backward, the masked multiply zeroes the dropped chunks' cotangents.
    An all-dropped fusion yields the zero vector."""
    J = u.shape[0]
    mask = mask_tensor(mask, u.device)
    m = mask.to(u.dtype)
    while m.dim() < u.dim():
        m = m[..., None]                        # (J,1,1) or (J,B,1)
    n = torch.sum(mask.to(torch.float32), dim=0)          # () or (B,)
    scale = torch.div(torch.full_like(n, float(J)),
                      torch.clamp(n, min=1.0)).to(u.dtype)
    if scale.dim():
        scale = scale[:, None]                  # (B,1) broadcasts over d
    return u * m * scale


# ---------------------------------------------------------------------------
# FL / SL semantics: one client <-> server uplink
# ---------------------------------------------------------------------------

def uplink_model(topo) -> LinkModel:
    """FL's weight exchange and SL's cut boundary ride ONE physical
    client <-> server uplink; its model is the worst case over the star's
    edges (max erasure / latency / jitter, min bandwidth cap)."""
    links = [e.link for e in topo.edges if e.link is not None]
    if not links:
        return LinkModel()
    caps = [lm.bandwidth_bps for lm in links if lm.bandwidth_bps is not None]
    return LinkModel(
        erasure=max(lm.erasure for lm in links),
        latency_ms=max(lm.latency_ms for lm in links),
        jitter_ms=max(lm.jitter_ms for lm in links),
        bandwidth_bps=min(caps) if caps else None)


def client_delivery_mask(rng, topo, cfg, *, train: bool) -> np.ndarray:
    """FL: which of the J client uploads reached the server this round —
    each client's own uplink erasure plus the training dropout curriculum
    (no fusion deadline: FedAvg rounds are synchronous barriers)."""
    return delivery_mask(fault_key(rng), topo, cfg,
                         dropout=edge_dropout(cfg) if train else 0.0)


def attempt_successes(rng, topo, cfg, attempts: int) -> np.ndarray:
    """SL's bounded retry: (attempts,) independent survival draws of the
    single uplink (erasure only: a retry re-sends the same payload).  The
    round runs iff ANY attempt succeeds."""
    link = uplink_model(topo)
    if link.erasure <= 0:
        return np.ones((attempts,), bool)
    k = fold_in(fault_key(rng), _SALT_RETRY)
    return _uniform(k, (attempts,)) >= link.erasure


def round_success(rng, topo, cfg, attempts: int) -> bool:
    return bool(np.any(attempt_successes(rng, topo, cfg, attempts)))


def request_survival(k, topo, cfg, n: int, *,
                     deadline: Optional[float] = None) -> np.ndarray:
    """(n,) per-request survival of the single client -> server uplink
    (FL/SL inference): the erasure draw, and latency against the deadline
    when one is configured.  A failed request gets no prediction: callers
    answer it with the uniform distribution."""
    link = uplink_model(topo)
    erased, lat = _edge_draws(fault_key(k), 0, link, (n,))
    ok = ~erased
    dl = deadline if deadline is not None else deadline_ms(cfg)
    if dl is not None:
        bits = cfg.num_clients * cfg.d_bottleneck * cfg.link_bits
        ok = ok & (lat + np.float32(_edge_tx_ms(link, float(bits)))
                   <= np.float32(dl))
    return ok


def degrade_probs(probs: torch.Tensor, ok) -> torch.Tensor:
    """Replace failed requests' predictions with the uniform distribution
    (the server answers, but not from this request's data)."""
    C = probs.shape[-1]
    ok = mask_tensor(ok, probs.device)
    return torch.where(ok[:, None], probs, torch.full_like(probs, 1.0 / C))


# ---------------------------------------------------------------------------
# Delivered-vs-offered bandwidth: host-side per-round charges
# ---------------------------------------------------------------------------

def retry_attempts() -> int:
    """SL's attempts a round: 1 + the registered scheme's
    max_link_retries."""
    from repro_torch.core import schemes
    return getattr(schemes.get("sl"), "max_link_retries", 2) + 1


def fault_charges_from_mask(scheme_name: str, topo, cfg, charges: Dict,
                            mask) -> Tuple[Dict, Dict]:
    """One faulty round's (offered, delivered) bandwidth from its mask,
    mirroring `charges` {edge_key_or_None: (bits, nbytes)}.  `mask` is the
    round's (J,) delivery mask for INL (and the hybrids) and FL, and SL's
    (attempts,) attempt successes.

    INL charges each edge the fraction of its payload views that reached
    the fusion (their error chunks return over the same edges); FL counts
    the full broadcast down plus only the surviving uploads; SL offers its
    exchange once per attempt made and delivers it only when one
    succeeded."""
    mask = np.asarray(mask, bool)
    if scheme_name in _FUSING_SCHEMES:
        dlv = {}
        for e in topo.edges:
            pay = topo.payload(e)
            frac = sum(bool(mask[v]) for v in pay) / len(pay)
            bits, nbytes = charges[e.key]
            dlv[e.key] = (bits * frac, nbytes * frac)
        return dict(charges), dlv
    if scheme_name == "fl":
        J = cfg.num_clients
        frac = (J + int(mask.sum())) / (2.0 * J)   # down full, up masked
        dlv = {k: (b * frac, n * frac) for k, (b, n) in charges.items()}
        return dict(charges), dlv
    if scheme_name == "sl":
        ok = bool(mask.any())
        used = int(mask.argmax()) + 1 if ok else len(mask)
        off = {k: (b * used, n * used) for k, (b, n) in charges.items()}
        dlv = {k: (b * ok, n * ok) for k, (b, n) in charges.items()}
        return off, dlv
    return dict(charges), dict(charges)


def round_fault_charges(rng, scheme_name: str, topo, cfg, batch_size: int,
                        charges: Dict) -> Tuple[Dict, Dict]:
    """One faulty round's (offered, delivered) bandwidth: the draws of
    round key `rng` replayed on the host (the same keys the round's masks
    came from), then `fault_charges_from_mask`."""
    if scheme_name in _FUSING_SCHEMES:
        mask = round_delivery_mask(rng, topo, cfg, batch_size, train=True)
    elif scheme_name == "fl":
        mask = client_delivery_mask(rng, topo, cfg, train=True)
    elif scheme_name == "sl":
        mask = attempt_successes(rng, topo, cfg, retry_attempts())
    else:
        return dict(charges), dict(charges)
    return fault_charges_from_mask(scheme_name, topo, cfg, charges, mask)
