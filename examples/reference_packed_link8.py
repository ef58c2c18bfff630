"""The JAX reference's packed INL at link_bits=8, full width, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python examples/reference_packed_link8.py

Trains `run_scheme("inl", wire=...)` of the JAX package at
`PaperExperimentConfig(link_bits=8)` for one epoch of 16 rounds at batch
64 (1024 samples of `make_base_dataset(seed=1)`, seed 0, accuracy over
the first 512 samples), the settings of the port's packed runs in
`chip_smoke.py` (`graphs:` lines, "inl packed"), and prints every round's
loss and mean rate and the final accuracy, for each wire in `--wires`.
It answers whether the reference runs away at this width as the port
does on the card.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wires", default="packed,dense")
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro.configs.paper_inl import PaperExperimentConfig
    from repro.core import schemes
    from repro.core.schemes import runner
    from repro.data import multiview

    cfg = PaperExperimentConfig(link_bits=8)
    n = args.rounds * args.batch
    imgs, labels = multiview.make_base_dataset(n, seed=1)
    views = multiview.make_views(imgs, cfg.noise_stds)
    scheme = schemes.get("inl")
    for wire in args.wires.split(","):
        losses, rates = [], []
        make = scheme.make_round

        def recording(*a, **kw):
            fn = make(*a, **kw)

            def rec(*ra):
                st, m = fn(*ra)
                losses.append(float(m["loss"]))
                rates.append(float(m.get("rate_mean", float("nan"))))
                return st, m
            return rec
        scheme.make_round = recording
        t0 = time.perf_counter()
        try:
            curve = runner.run_scheme(
                "inl", views, labels, cfg, epochs=1, batch_size=args.batch,
                seed=args.seed, eval_n=512, wire=wire, dispatch="per_round")
        finally:
            del scheme.make_round
        print(json.dumps({
            "wire": wire, "link_bits": cfg.link_bits, "rounds": len(losses),
            "losses": losses, "rate_mean": rates,
            "accuracy": curve[-1].accuracy,
            "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
