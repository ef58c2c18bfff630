"""Experiment configurations (reference: src/repro/configs/)."""
