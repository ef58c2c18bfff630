"""Roofline analysis (reference: src/repro/roofline/)."""
