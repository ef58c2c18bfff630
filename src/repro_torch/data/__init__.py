"""Data (reference: src/repro/data/)."""
