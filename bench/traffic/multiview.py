"""The paper cells' data: a CIFAR-like multi-view set made on the device
from the seed.

CIFAR-10 is not in the repository, so the set follows the recipe of the
repository's synthetic one (smooth class prototypes, a smooth deformation
and pixel noise per image, normalised; view j = image + N(0, sigma_j^2)),
drawn here in torch on the device in a few large calls.  Its values differ
from the program's numpy set; the work does not.
"""
from __future__ import annotations

import torch

from bench.lib import weights


def _upsample(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(n, h, w, C) grids -> (n, H, W, C): blocks, then two box passes."""
    up = x.repeat_interleave(H // x.shape[1], dim=1) \
        .repeat_interleave(W // x.shape[2], dim=2)
    for dim in (1, 2):
        up = (torch.roll(up, 1, dim) + up + torch.roll(up, -1, dim)) / 3.0
    return up


def make(cfg: dict, seed: int, device):
    """(views (J, n, H, W, C) fp32, labels (n,) int64) on `device`."""
    gen = torch.Generator(device=device).manual_seed(
        weights.leaf_seed(seed, "multiview"))
    n, C_ = cfg["dataset_size"], cfg["num_classes"]
    H, W, C = cfg["image_shape"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    protos = _upsample(normal(C_, 4, 4, C), H, W)
    protos = protos / protos.std(dim=(1, 2, 3), keepdim=True)
    labels = torch.randint(0, C_, (n,), generator=gen, device=device)
    images = protos[labels] + _upsample(normal(n, 4, 4, C) * 0.6, H, W)
    images += normal(n, H, W, C) * 0.1
    images = (images - images.mean()) / images.std()
    views = torch.empty((len(cfg["noise_stds"]), n, H, W, C), device=device)
    for j, s in enumerate(cfg["noise_stds"]):
        torch.add(images, normal(n, H, W, C), alpha=s, out=views[j])
    return views, labels
