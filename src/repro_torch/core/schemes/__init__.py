"""Unified Scheme API: the registry.

Reference: src/repro/core/schemes/__init__.py (`register`, `get`,
`available`).  The port registers the reference's five schemes: INL, SL
and FL, the paper's three-way comparison, first; then the hybrids,
splitfed (SL-style cut exchange plus a FedAvg of the client encoders) and
hybrid (per-client cut- or weight-mode participation).
"""
from __future__ import annotations

from repro_torch.core.schemes.base import Scheme  # noqa: F401  (public API)

_REGISTRY: dict = {}


def register(cls):
    """Class decorator: instantiate and register a Scheme under cls.name."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[inst.name] = inst
    return cls


def get(name: str) -> Scheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scheme {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def available():
    """Registered scheme names, INL first (the paper's ordering)."""
    order = {"inl": 0, "sl": 1, "fl": 2}
    return tuple(sorted(_REGISTRY, key=lambda n: (order.get(n, 99), n)))


# importing the built-in schemes self-registers them
from repro_torch.core.schemes import fl, hybrid, inl, sl, \
    splitfed  # noqa: E402,F401
