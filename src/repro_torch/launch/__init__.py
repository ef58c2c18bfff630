"""Launchers: the step functions and the serving driver (reference:
src/repro/launch/)."""
