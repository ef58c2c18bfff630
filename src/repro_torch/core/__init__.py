"""In-network learning: the paper's architecture, its bottleneck, the conv
model, topology, wire format, bandwidth ledgers and the Scheme API
(reference: src/repro/core/)."""
