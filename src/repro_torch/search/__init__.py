"""Auto-placement search: the paper's three-way comparison as a design
space.

Reference: src/repro/search/ (`space`, `pricing`, `pareto`, `driver`).
The registry (core/schemes), the topologies (core/topology) and the exact
per-edge ledgers price any (scheme, cut depth, topology, link width,
wire) configuration in closed form, so the search enumerates the space
(`space.py`), prices every point without training (`pricing.py`, exact,
and the basis of two sound prunes), trains the surviving candidates
through `runner.run_scheme` on the card (`driver.py`), and extracts the
accuracy-per-Gbit Pareto frontier (`pareto.py`).
"""
from repro_torch.search.pareto import dominates, pareto_frontier  # noqa: F401
from repro_torch.search.pricing import PricedPoint, price  # noqa: F401
from repro_torch.search.space import ConfigPoint, SearchSpace  # noqa: F401
from repro_torch.search.driver import MeasuredPoint, SearchResult, \
    run_search  # noqa: F401
