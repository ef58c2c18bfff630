"""The paper's three-way comparison (Figures 5/7, reduced scale) on the
PyTorch port: INL vs split learning vs federated learning, and the hybrids
SplitFed and hybrid FL/SL, accuracy per epoch and per Gbit exchanged, on
one shared runner and one cut-layer substrate (the port's CUDA kernels on
the card).  Every registered scheme runs unless --schemes names some.

The twin of examples/compare_schemes.py (the JAX package) on its reduced
configuration: convs (8, 16), 16-d bottlenecks, dense (64,), 1024 images
under the Exp-2 protocol (every client sees every image at its own noise
level), batch 64.  Each epoch runs on the runner's default dispatch,
"scan": on the card one CUDA graph of the round, replayed once a round.

    PYTHONPATH=src python examples/compare_schemes_torch.py        # the card
    PYTHONPATH=src python examples/compare_schemes_torch.py --device cpu
    PYTHONPATH=src python examples/compare_schemes_torch.py \\
        --schemes inl,splitfed --device cpu

--wire packed moves the cut-layer latents as bit-packed codewords (needs
--link-bits 1..16); the measured column then shows the lanes' bytes, while
the closed-form Gbit column (Table I) is unchanged.
"""
import argparse

from repro_torch.configs.paper_inl import PaperExperimentConfig
from repro_torch.core import schemes
from repro_torch.core.schemes import runner
from repro_torch.data import multiview

BATCH = 64


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--link-bits", type=int, default=32)
    ap.add_argument("--wire", default="dense",
                    choices=["dense", "packed", "packed_duplex"])
    ap.add_argument("--schemes", default="",
                    help="comma list (default: every registered scheme)")
    args = ap.parse_args()
    names = tuple(n.strip() for n in args.schemes.split(",") if n.strip()) \
        or schemes.available()
    unknown = sorted(set(names) - set(schemes.available()))
    if unknown:
        ap.error(f"unknown scheme(s) {unknown}; registered: "
                 f"{schemes.available()}")
    cfg = PaperExperimentConfig(conv_channels=(8, 16), d_bottleneck=16,
                                dense_units=(64,), dataset_size=1024,
                                link_bits=args.link_bits)
    imgs, labels = multiview.make_base_dataset(cfg.dataset_size, seed=0)
    views = multiview.make_views(imgs, cfg.noise_stds)
    results = runner.run_all(names, views, labels, cfg, epochs=args.epochs,
                             batch_size=BATCH, wire=args.wire,
                             device=args.device)

    print(f"\nExperiment 2 (paper fig 7), link_bits={args.link_bits}, "
          f"wire={args.wire}:")
    print(f"{'epoch':>6} | " + " | ".join(
        f"{s + ' acc / Gbit':>19}" for s in results))
    for i in range(args.epochs):
        print(f"{i + 1:>6} | " + " | ".join(
            f"{results[s][i].accuracy:>10.3f} / {results[s][i].gbits:.4f}"
            for s in results))
    print("\nbandwidth-efficiency (final acc / Gbit):")
    for s, curve in results.items():
        pt = curve[-1]
        print(f"  {s:8s}: {runner.efficiency(curve):10.2f} acc/Gbit "
              f"(acc {pt.accuracy:.3f}, {pt.gbits:.4f} Gbit closed form, "
              f"{pt.measured_gbits:.4f} Gbit measured)")
    print("\npaper's qualitative claim: INL >> SL > FL per bit; "
          "INL >= SL > FL in accuracy.")


if __name__ == "__main__":
    main()
