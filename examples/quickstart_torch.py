"""Quickstart of the PyTorch port: the paper's in-network learning on the
multi-view task, trained on the card.

The twin of examples/quickstart.py (the JAX package) on SMOKE: five edge
nodes each observe a differently-noised view of the same image, run their
own conv encoder and ship only a 16-dim stochastic bottleneck latent to the
central node, which fuses them and classifies.  Training optimises eq. (6)
end to end through the port's CUDA cut-layer kernels; only activations and
error vectors cross the links.

    PYTHONPATH=src python examples/quickstart_torch.py             # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch import optim, resolve_device
from repro_torch.configs.paper_inl import SMOKE as CFG
from repro_torch.core import inl
from repro_torch.data import multiview


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args()
    device = resolve_device(args.device)

    imgs, labels = multiview.make_base_dataset(512, seed=0)
    views = multiview.make_views(imgs, CFG.noise_stds)      # (J, n, 32,32,3)
    print(f"J={CFG.num_clients} nodes, views {views.shape}, "
          f"bottleneck {CFG.d_bottleneck}-d per node, device {device}")

    params, state = inl.init(CFG, torch.Generator(device=device)
                             .manual_seed(0), device=device)
    opt = optim.adam(2e-3)
    opt_state = opt.init(params)
    step = inl.make_train_step(CFG, opt)
    gen = torch.Generator(device=device).manual_seed(1)
    views_t = torch.from_numpy(views).to(device)
    labels_t = torch.from_numpy(labels).to(device).long()

    bits = 0.0
    for epoch in range(args.epochs):
        for idx in multiview.batch_indices(len(labels), 64, seed=epoch):
            idx = torch.from_numpy(idx).to(device)
            params, state, opt_state, m = step(
                params, state, opt_state, views_t[:, idx], labels_t[idx],
                gen)
            bits += float(m["bits_sent"])
        acc = inl.evaluate(params, state, views_t, labels_t, device=device)
        print(f"epoch {epoch}: loss={float(m['loss']):.3f} "
              f"acc={float(acc):.3f} rate={float(m['rate_mean']):.2f} nats "
              f"bandwidth={bits/1e6:.2f} Mbit")

    probs = inl.predict(params, state, views_t[:, :4], device=device)
    print("soft predictions (first 4):",
          [round(p, 3) for p in probs.max(-1).values.tolist()],
          "labels:", labels[:4].tolist())


if __name__ == "__main__":
    main()
