"""Model layers (reference: src/repro/models/)."""
