"""Network topology: the inference graph as a declarative API.

Reference: src/repro/core/topology.py (`Node`, `Edge`, `Topology`, the
constructors `star`, `chain`, `tree`, `from_name`, `named_topologies`, the
resolution `resolve`, `nontrivial`, `require_star`, `edge_bits`,
`edge_wire`, `edge_dtype`, the per-edge bandwidth `round_edge_bits`,
`round_edge_wire_bytes`, `round_bits`, `round_wire_bytes`, and the graph's
execution `first_hop_groups` and `graph_cut_and_ship`).  The data model is
framework-free and copied; the execution runs on the port's kernels.
`check_wires`, the port's own, validates a round's wires when it is
built.

A Topology is any validated single-sink DAG: J view-holding nodes
("measure" leaves and "relay" forwarders, which observe a view AND forward
what they receive) and one "fuse" node.  `graph_cut_and_ship` compiles it
to a sequence of launches on one device:

  1. every view node cuts its latent at its OUTGOING edge's width: one
     `ops.cutlayer` launch per first-hop width group, on exactly its rows
     (the star's single launch when the graph is edge-homogeneous);
  2. the edges run in topological order: each re-encodes the payload it
     carries for its own link (`wirefmt.relay_hop`: a straight-through
     re-quantization at the edge's width, the edge's storage dtype on a
     dense link, and the edge's wire: on a packed edge one `pack` and one
     `unpack_dequant` launch).  On an edge-homogeneous graph the re-coding
     is the identity, so a dense chain or tree delivers the star's latents
     bit for bit;
  3. the fuse node receives every view's latent as the hops re-coded it.
     Backward, autograd routes each error chunk edge-reversed through the
     same hops ("packed_duplex" quantizes it on every traversal).

Bandwidth has a per-edge ledger: an edge's closed form is the §III-C
two-direction count for the payload it carries, its measured bytes the
`wirefmt.round_wire_bytes` of that payload, and for `star(J)` both sum to
the Table-I totals.  Link models on the edges (`Edge.link`, a
core/linkfault.LinkModel) do not change the graph's execution: they only
produce delivery masks, which the fuse node applies after the hops
(`linkfault.partial_fuse`), as in the reference.

On a mesh (core/sharded.py) `axis_name=` is the 'client' Axis and
`group_ids=` the first-hop group of each of this rank's nodes: each rank
cuts its own nodes at their first-hop widths, the 'client' all_gather of
the cut latents stays the one physical collective, and the hops run
replicated on the gathered buffer (the values are the modelled multi-hop
network's; the per-edge meter charges the modelled links).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import paper_model, wirefmt
from repro_torch.kernels import ops

ROLES = ("measure", "relay", "fuse")
FUSE = "fuse"                     # canonical name of the fusion-center node


@dataclass(frozen=True)
class Node:
    name: str
    role: str                     # "measure" | "relay" | "fuse"


@dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    link_bits: Optional[int] = None     # None -> cfg.link_bits
    wire: Optional[str] = None          # None -> the round's wire=
    dtype: Optional[str] = None         # None -> cfg compute dtype
    # unreliability model (core/linkfault.LinkModel); None is a PERFECT,
    # unmodelled link.  A model only produces delivery masks: the edge's
    # hop runs as it would without one.
    link: Optional[object] = None

    @property
    def key(self) -> str:
        return f"{self.src}->{self.dst}"


@dataclass(frozen=True)
class Topology:
    """A validated single-sink routing graph.  Hashable (usable as a key
    and inside a frozen config)."""
    nodes: Tuple[Node, ...]
    edges: Tuple[Edge, ...]

    def __post_init__(self):
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate node name(s) {dupes} in {names}; "
                             "every node needs a unique name — edge keys "
                             "and the per-view payload map are keyed on it")
        for n in self.nodes:
            if n.role not in ROLES:
                raise ValueError(f"node {n.name!r} has unknown role "
                                 f"{n.role!r}; roles: {ROLES}")
            if not n.name:
                raise ValueError("node names must be non-empty")
        fuse = [n.name for n in self.nodes if n.role == "fuse"]
        if len(fuse) != 1:
            roles = {n.name: n.role for n in self.nodes}
            raise ValueError(f"a topology needs exactly ONE fuse node "
                             f"(the single sink); got "
                             f"{fuse or 'none'} among nodes {roles}")
        known = set(names)
        seen = set()
        out: Dict[str, Edge] = {}
        for e in self.edges:
            if e.src not in known or e.dst not in known:
                missing = sorted({e.src, e.dst} - known)
                raise ValueError(f"edge {e.key} references unknown node(s) "
                                 f"{missing}; declared nodes: "
                                 f"{sorted(known)}")
            if e.src == e.dst:
                raise ValueError(f"self-loop {e.key}")
            if e.key in seen:
                raise ValueError(f"duplicate edge {e.key}")
            seen.add(e.key)
            if e.src in out:
                raise ValueError(
                    f"node {e.src!r} has two outgoing edges ({out[e.src].key}"
                    f", {e.key}); multicast routing duplicates latents and "
                    "has no eq.-(5) reading — every non-fuse node forwards "
                    "along exactly one edge")
            out[e.src] = e
        (fuse_name,) = fuse
        if fuse_name in out:
            raise ValueError(f"the fuse node {fuse_name!r} is the sink; it "
                             f"cannot have an outgoing edge "
                             f"({out[fuse_name].key})")
        indeg = {n.name: 0 for n in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
        for n in self.nodes:
            if n.role == "measure" and indeg[n.name]:
                raise ValueError(f"measure node {n.name!r} has incoming "
                                 "edges; sensors are sources — use role="
                                 "'relay' for a fusing forwarder")
            if n.role == "relay" and not indeg[n.name]:
                raise ValueError(f"relay node {n.name!r} receives nothing; "
                                 "use role='measure' for a leaf")
        # single out-edge per node => the graph is a union of paths into the
        # sink iff acyclic; walk each node's unique route and demand it
        # reaches the fuse node without revisiting anything
        for n in self.nodes:
            if n.role == "fuse":
                continue
            cur, hops = n.name, 0
            while cur != fuse_name:
                if cur not in out:
                    raise ValueError(f"node {n.name!r} cannot reach the "
                                     f"fuse node: route dead-ends at "
                                     f"{cur!r}")
                cur = out[cur].dst
                hops += 1
                if hops > len(self.nodes):
                    raise ValueError(f"cycle on the route from {n.name!r} "
                                     "(topologies must be DAGs)")

    # -- structure --------------------------------------------------------

    @property
    def fuse_node(self) -> str:
        return next(n.name for n in self.nodes if n.role == "fuse")

    def view_nodes(self) -> Tuple[str, ...]:
        """View-holding nodes in declaration order: views[j] feeds the j-th
        name here.  Every measure AND relay node observes a view."""
        return tuple(n.name for n in self.nodes if n.role != "fuse")

    def num_views(self) -> int:
        return len(self.view_nodes())

    def out_edge(self, name: str) -> Edge:
        return next(e for e in self.edges if e.src == name)

    def in_edges(self, name: str) -> Tuple[Edge, ...]:
        return tuple(e for e in self.edges if e.dst == name)

    def topo_edges(self) -> Tuple[Edge, ...]:
        """Edges in topological order: an edge appears only after every edge
        into its source (the order hops execute in)."""
        done: set = set()
        ordered = []
        pending = list(self.edges)
        while pending:
            progress = False
            rest = []
            for e in pending:
                if all(i.key in done for i in self.in_edges(e.src)):
                    ordered.append(e)
                    done.add(e.key)
                    progress = True
                else:
                    rest.append(e)
            pending = rest
            if pending and not progress:     # unreachable post-validation
                raise ValueError("cyclic edge set")
        return tuple(ordered)

    def payload(self, edge: Edge) -> Tuple[int, ...]:
        """View indices whose latents `edge` carries: every view node in the
        subtree draining through the edge (the source's own latent last —
        relays append their observation to what they received)."""
        idx = {name: j for j, name in enumerate(self.view_nodes())}
        acc: Tuple[int, ...] = ()
        for e_in in self.in_edges(edge.src):
            acc = acc + self.payload(e_in)
        return acc + (idx[edge.src],)

    def levels(self) -> Tuple[Tuple[str, ...], ...]:
        """Non-fuse nodes grouped by longest hop-distance from a leaf —
        the per-level schedule the hops (and a real multi-host placement)
        execute in."""
        depth: Dict[str, int] = {}
        for e in self.topo_edges():
            ins = [depth[i.src] + 1 for i in self.in_edges(e.src)]
            depth[e.src] = max(ins) if ins else 0
        if not depth:
            return ()
        out = [[] for _ in range(max(depth.values()) + 1)]
        for name in self.view_nodes():
            out[depth[name]].append(name)
        return tuple(tuple(level) for level in out)

    def is_default_star(self) -> bool:
        """True when this topology IS the implicit star the legacy code
        paths assume: every view node a measure node wired straight into
        the fuse node, in declaration order, every edge at the inherited
        (cfg-level) width/wire/dtype.  Those paths stay bit-identical, so
        resolvers dispatch them to the pre-topology code.  LinkModels
        (`Edge.link`) are deliberately NOT considered: they only produce
        delivery masks (the reference's core/linkfault.py), so a faulty
        star still runs the star's paths — with partial fusion layered
        on."""
        fuse = self.fuse_node
        if any(n.role == "relay" for n in self.nodes):
            return False
        views = self.view_nodes()
        if len(self.edges) != len(views):
            return False
        for name, e in zip(views, self.edges):
            if (e.src, e.dst) != (name, fuse):
                return False
            if (e.link_bits, e.wire, e.dtype) != (None, None, None):
                return False
        return True

    def describe(self) -> str:
        levels = " | ".join(",".join(lv) for lv in self.levels())
        return (f"Topology({self.num_views()} views -> {self.fuse_node}; "
                f"levels {levels}; edges "
                f"{[e.key for e in self.topo_edges()]})")


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def _per_edge_bits(link_bits, n: int):
    if link_bits is None or isinstance(link_bits, int):
        return (link_bits,) * n
    bits = tuple(link_bits)
    if len(bits) != n:
        raise ValueError(f"need one link_bits per edge ({n}), got {bits}")
    return bits


def star(J: int, *, link_bits=None) -> Topology:
    """The paper's setting: J measure nodes, each one hop from the fusion
    center.  `link_bits` — scalar or per-edge sequence; None inherits
    cfg.link_bits (and keeps the topology on the legacy fast path)."""
    if J < 1:
        raise ValueError(f"star needs J >= 1, got {J}")
    bits = _per_edge_bits(link_bits, J)
    nodes = tuple(Node(f"m{j}", "measure") for j in range(J)) \
        + (Node(FUSE, "fuse"),)
    edges = tuple(Edge(f"m{j}", FUSE, link_bits=bits[j]) for j in range(J))
    return Topology(nodes, edges)


def chain(J: int, *, link_bits=None) -> Topology:
    """A line: m0 -> r1 -> ... -> r{J-1} -> fuse.  Every hop aggregates the
    upstream latents with the local view, so the last link carries all J —
    the bandwidth-extreme opposite of the star."""
    if J < 1:
        raise ValueError(f"chain needs J >= 1, got {J}")
    bits = _per_edge_bits(link_bits, J)
    nodes = (Node("m0", "measure"),) \
        + tuple(Node(f"r{j}", "relay") for j in range(1, J)) \
        + (Node(FUSE, "fuse"),)
    names = [n.name for n in nodes[:-1]] + [FUSE]
    edges = tuple(Edge(names[j], names[j + 1], link_bits=bits[j])
                  for j in range(J))
    return Topology(nodes, edges)


def tree(branching: int, depth: int, *, link_bits=None) -> Topology:
    """A complete `branching`-ary in-tree of view nodes under the fusion
    center: `depth` levels, measure leaves at the bottom, relays above.
    num_views == branching + branching^2 + ... + branching^depth
    (e.g. tree(2, 2) -> 6 views).  `link_bits` — scalar applied to every
    edge, or None to inherit."""
    if branching < 1 or depth < 1:
        raise ValueError(f"tree needs branching >= 1 and depth >= 1, got "
                         f"({branching}, {depth})")
    nodes, edges = [], []

    def grow(parent: str, level: int):
        for i in range(branching):
            name = f"{parent}.{i}" if parent != FUSE else f"t{i}"
            role = "measure" if level == depth else "relay"
            nodes.append(Node(name, role))
            edges.append(Edge(name, parent, link_bits=link_bits))
            if level < depth:
                grow(name, level + 1)

    grow(FUSE, 1)
    nodes.append(Node(FUSE, "fuse"))
    return Topology(tuple(nodes), tuple(edges))


# ---------------------------------------------------------------------------
# Named constructor instances (the reference's search space)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^(star|chain|tree)\((\d+)(?:,\s*(\d+))?\)$")


def from_name(name: str) -> Topology:
    """Parse a constructor spec — "star(5)", "chain(4)", "tree(2,2)" — into
    the Topology it names; the inverse of the names `named_topologies`
    emits."""
    m = _NAME_RE.match(name.replace(" ", ""))
    if not m:
        raise ValueError(f"unparseable topology spec {name!r}; expected "
                         f"star(J), chain(J) or tree(branching,depth)")
    kind, a, b = m.group(1), int(m.group(2)), m.group(3)
    if kind == "tree":
        if b is None:
            raise ValueError(f"tree spec needs two arguments, got {name!r}")
        return tree(a, int(b))
    if b is not None:
        raise ValueError(f"{kind} spec takes one argument, got {name!r}")
    return star(a) if kind == "star" else chain(a)


def named_topologies(J: int, *, families=("star", "chain", "tree")):
    """Every named constructor instance with exactly J view nodes, keyed by
    its `from_name` spec: "star(J)", "chain(J)" (J >= 2 — chain(1) IS
    star(1)), and every complete "tree(b,d)" whose level sum b + b^2 + ...
    + b^d == J with d >= 2 (depth-1 trees are stars, branching-1 trees are
    chains, so no graph appears twice)."""
    out = {}
    if "star" in families:
        out[f"star({J})"] = star(J)
    if "chain" in families and J >= 2:
        out[f"chain({J})"] = chain(J)
    if "tree" in families:
        for b in range(2, J):
            views, d = 0, 0
            while views < J:
                d += 1
                views += b ** d
            if views == J and d >= 2:
                out[f"tree({b},{d})"] = tree(b, d)
    return out


# ---------------------------------------------------------------------------
# Resolution against a config
# ---------------------------------------------------------------------------

def resolve(topology: Optional[Topology], cfg) -> Topology:
    """The topology a round runs: the explicit argument, else cfg.topology,
    else the implicit `star(cfg.num_clients)`.  Validates the view count
    against cfg."""
    topo = topology if topology is not None \
        else getattr(cfg, "topology", None)
    if topo is None:
        return star(cfg.num_clients)
    if topo.num_views() != cfg.num_clients:
        raise ValueError(
            f"topology has {topo.num_views()} view nodes "
            f"{list(topo.view_nodes())} but cfg.num_clients == "
            f"{cfg.num_clients}; every measure/relay node observes one of "
            "the J views")
    return topo


def nontrivial(topology: Optional[Topology], cfg) -> Optional[Topology]:
    """`resolve`, then None when the result is the default star — callers
    dispatch None to the pre-topology code paths, which stay bit-identical
    (golden trajectories included)."""
    topo = resolve(topology, cfg)
    return None if topo.is_default_star() else topo


def require_star(topology: Optional[Topology], cfg, *, scheme: str):
    """Schemes whose exchange has no multi-hop reading (FL's weight
    transfer, SL's single client->server boundary) accept `topology=` for
    interface parity but only run the star."""
    topo = nontrivial(topology, cfg)
    if topo is not None:
        relays = [n.name for n in topo.nodes if n.role == "relay"]
        custom = [e.key for e in topo.edges
                  if (e.link_bits, e.wire, e.dtype) != (None, None, None)]
        detail = []
        if relays:
            detail.append(f"relay node(s) {relays}")
        if custom:
            detail.append(f"per-edge transport override(s) on {custom}")
        if not detail:
            detail.append(f"non-star edge(s) "
                          f"{[e.key for e in topo.edges]}")
        raise ValueError(
            f"scheme {scheme!r} runs the star topology only (its exchange "
            f"is a single client<->server transaction) but the given "
            f"topology has {'; '.join(detail)}; multi-hop graphs are an "
            "INL execution concept")


def edge_bits(edge: Edge, cfg) -> int:
    return cfg.link_bits if edge.link_bits is None else edge.link_bits


def edge_wire(edge: Edge, default: str) -> str:
    return default if edge.wire is None else edge.wire


def check_wires(topo: Optional[Topology], cfg, wire: str) -> None:
    """Validate `wire` against the star's width (topo None, the
    `nontrivial` default star), else each edge's wire against its own
    width (`wirefmt.resolve_wire`)."""
    if topo is None:
        wirefmt.resolve_wire(wire, cfg.link_bits)
        return
    for e in topo.edges:
        wirefmt.resolve_wire(edge_wire(e, wire), edge_bits(e, cfg))


def edge_dtype(edge: Edge, cfg):
    if edge.dtype is None:
        return paper_model.compute_dtype(cfg)
    try:
        return paper_model.COMPUTE_DTYPES[edge.dtype]
    except KeyError:
        raise ValueError(f"edge {edge.key} has unknown dtype {edge.dtype!r};"
                         f" known: {sorted(paper_model.COMPUTE_DTYPES)}"
                         ) from None


# ---------------------------------------------------------------------------
# Per-edge bandwidth: closed forms and measured bytes
# ---------------------------------------------------------------------------

def round_edge_bits(topo: Topology, cfg, batch_size: int) -> Dict[str, float]:
    """Closed-form §III-C charge of ONE training round, per edge: the
    forward activations and backward error vectors for every latent the
    edge carries — 2 * batch * |payload| * d_bottleneck * link_bits.  For
    `star(J)` the J edges sum to the Table-I total."""
    return {e.key: float(2 * batch_size * len(topo.payload(e))
                         * cfg.d_bottleneck * edge_bits(e, cfg))
            for e in topo.topo_edges()}


def round_edge_wire_bytes(topo: Topology, cfg, batch_size: int, *,
                          wire: str = "dense") -> Dict[str, float]:
    """MEASURED bytes of one round, per edge: what the edge's wire buffers
    occupy for its payload (core/wirefmt.round_wire_bytes), both
    directions."""
    out = {}
    for e in topo.topo_edges():
        n_vec = batch_size * len(topo.payload(e))
        out[e.key] = float(wirefmt.round_wire_bytes(
            n_vec, cfg.d_bottleneck, link_bits=edge_bits(e, cfg),
            wire=edge_wire(e, wire), dtype=edge_dtype(e, cfg))["total"])
    return out


def round_bits(topo: Topology, cfg, batch_size: int) -> float:
    return float(sum(round_edge_bits(topo, cfg, batch_size).values()))


def round_wire_bytes(topo: Topology, cfg, batch_size: int, *,
                     wire: str = "dense") -> float:
    return float(sum(round_edge_wire_bytes(topo, cfg, batch_size,
                                           wire=wire).values()))


# ---------------------------------------------------------------------------
# Graph execution: the sequence of cut and hop launches
# ---------------------------------------------------------------------------

def first_hop_groups(topo: Topology, cfg):
    """View nodes grouped by their outgoing edge's link width — each group
    is ONE fused `ops.cutlayer` launch.  Returns (groups, gid_of_view):
    groups is a tuple of (gid, link_bits); gid_of_view a tuple assigning
    every view index its group.  Edge-homogeneous graphs have a single
    group — the star's one launch."""
    by_bits: Dict[int, int] = {}
    gid_of_view = []
    for name in topo.view_nodes():
        b = edge_bits(topo.out_edge(name), cfg)
        gid_of_view.append(by_bits.setdefault(b, len(by_bits)))
    groups = tuple((gid, b) for b, gid in sorted(by_bits.items(),
                                                 key=lambda kv: kv[1]))
    return groups, tuple(gid_of_view)


def graph_cut_and_ship(topo: Topology, cfg, mu, logvar, eps, *,
                       rate_estimator: str = "sample", wire: str = "dense",
                       prior: dict = None, axis_name=None, group_ids=None):
    """Run the inference graph on stacked latents.

    mu/logvar: (J, B, d) per-view-node encoder outputs, eps (J, B, d) fp32
    (on a mesh this rank's J_local nodes, `group_ids` their first-hop
    groups, and `axis_name` the 'client' Axis that gathers them).
    Returns (u, rate, u_fused):

      u        (J, B, d)  each node's OWN cut-layer output (first-hop
                          width) — branch heads and the rate read this;
      rate     (J, B)     the eq.-(6) rate term per node;
      u_fused  (J, B, d)  the latents as the fuse node RECEIVES them after
                          every hop's re-coding, in view-node order —
                          eq. (5) concatenates them (all J rows on a
                          mesh).

    Stage 1 runs one fused cutlayer per first-hop width group present, each
    on exactly its group's rows (with the group's rows of a learned (J, d)
    prior).  On a mesh the cut latents are then gathered over the axis.
    Stage 2 applies every edge in topological order through
    `wirefmt.relay_hop`, to exactly the payload rows the edge carries:
    (|payload| * B, d) rows a hop.  Backward, autograd reverses the edge
    sequence — each node's error chunk traverses its route's hops
    transposed."""
    axis = wirefmt.check_axis(axis_name)
    prior = prior or {}
    groups, gid_of_view = first_hop_groups(topo, cfg)
    if group_ids is not None:
        gid_of_view = tuple(int(g) for g in group_ids)
    if len(gid_of_view) != mu.shape[0]:
        raise ValueError(f"{mu.shape[0]} latent rows but {len(gid_of_view)} "
                         f"first-hop group ids; on a mesh pass this rank's "
                         f"group_ids")
    groups = tuple((gid, bits) for gid, bits in groups
                   if gid in gid_of_view)
    pmu, plv = prior.get("mu"), prior.get("logvar")
    if len(groups) == 1:
        u, rate = ops.cutlayer(mu, logvar, eps, link_bits=groups[0][1],
                               rate_estimator=rate_estimator, prior_mu=pmu,
                               prior_logvar=plv)
    else:
        # group membership is static: each launch takes exactly its rows,
        # gathered by stacking views of them (indexing with a host list
        # would copy the index to the device, which a captured round
        # cannot)
        u_rows, r_rows = [None] * len(gid_of_view), [None] * len(gid_of_view)
        for gid, bits in groups:
            idx = [j for j, g in enumerate(gid_of_view) if g == gid]

            def rows(t):
                return None if t is None else torch.stack([t[j] for j in idx])
            ug, rg = ops.cutlayer(
                rows(mu), rows(logvar), rows(eps), link_bits=bits,
                rate_estimator=rate_estimator, prior_mu=rows(pmu),
                prior_logvar=rows(plv))
            for k, j in enumerate(idx):
                u_rows[j], r_rows[j] = ug[k], rg[k]
        u, rate = torch.stack(u_rows), torch.stack(r_rows)

    fused = list((u if axis is None else axis.all_gather(u)).unbind(0))
    for e in topo.topo_edges():
        ids = topo.payload(e)
        hopped = wirefmt.relay_hop(
            torch.stack([fused[j] for j in ids]),
            link_bits=edge_bits(e, cfg), wire=edge_wire(e, wire),
            dtype=edge_dtype(e, cfg))
        for k, j in enumerate(ids):
            fused[j] = hopped[k]
    return u, rate, torch.stack(fused)
