"""Synthetic multi-view image-classification data (the paper's §IV setting).

Reference: src/repro/data/multiview.py.  A numpy copy of it, so its arrays
are bit-identical to the reference's for the same seeds (the port imports
nothing of the JAX package).

CIFAR-10 is not downloadable in this container, so we generate a CIFAR-like
dataset that preserves the structure the experiments depend on: 10 classes,
32x32x3 normalised images with intra-class variation, and J noisy VIEWS of
each image (additive Gaussian noise, sigma per client = 0.4, 1, 2, 3, 4).
Relative scheme ordering (INL vs FL vs SL) and the accuracy/bandwidth
trade-off remain meaningful; absolute CIFAR accuracies do not transfer.

Experiment 1 (paper §IV-A): the dataset is PARTITIONED per scheme's needs —
INL: every client sees its own noisy view of every image; FL: disjoint
1/J-th shards, all J views of an image go to the same client; SL: same
partition as FL.

Experiment 2 (paper §IV-B): all clients see ALL images; clients differ only
by their noise level.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def make_base_dataset(n: int, num_classes: int = 10,
                      image_shape=(32, 32, 3), seed: int = 0):
    """Returns (images (n,H,W,C) float32 normalised, labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    H, W, C = image_shape
    # class prototypes: smooth low-frequency patterns, distinct per class
    fx = rng.normal(size=(num_classes, 4, 4, C)).astype(np.float32)
    protos = np.stack([_upsample(fx[c], H, W) for c in range(num_classes)])
    protos = protos / protos.std(axis=(1, 2, 3), keepdims=True)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    # intra-class variation: per-sample smooth deformation + pixel noise
    var = rng.normal(size=(n, 4, 4, C)).astype(np.float32) * 0.6
    images = protos[labels] + np.stack([_upsample(v, H, W) for v in var])
    images += rng.normal(size=images.shape).astype(np.float32) * 0.1
    images = (images - images.mean()) / images.std()    # "normalised CIFAR"
    return images.astype(np.float32), labels


def _upsample(x, H, W):
    """Bilinear-ish upsample of a (h,w,C) grid to (H,W,C) via np.kron+smooth."""
    h, w, C = x.shape
    up = np.kron(x.transpose(2, 0, 1), np.ones((H // h, W // w))) \
        .transpose(1, 2, 0)
    # cheap smoothing: two passes of a box filter
    for axis in (0, 1):
        up = (np.roll(up, 1, axis) + up + np.roll(up, -1, axis)) / 3.0
    return up.astype(np.float32)


def make_views(images: np.ndarray, noise_stds, seed: int = 1) -> np.ndarray:
    """(n,H,W,C) -> (J,n,H,W,C): view j = image + N(0, sigma_j^2)."""
    rng = np.random.default_rng(seed)
    return np.stack([
        images + rng.normal(size=images.shape).astype(np.float32) * s
        for s in noise_stds])


def average_view(views: np.ndarray) -> np.ndarray:
    """FL inference input for Experiment 2: the average-quality image."""
    return views.mean(axis=0)


# ---------------------------------------------------------------------------
# Per-scheme splits
# ---------------------------------------------------------------------------

def split_experiment1(views, labels, num_clients: int, seed: int = 2):
    """Paper Exp-1 partition.

    INL: client j gets view j of ALL images (+ labels at node J+1).
    FL/SL: disjoint shards of the image index set; client j receives all J
    views of its shard's images (FL trains the full Fig.-4 network on them).
    Returns dict with 'inl' -> (views, labels) and 'fl' -> list of
    (views_shard (J,n_j,...), labels_shard).
    """
    n = labels.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    shards = np.array_split(perm, num_clients)
    fl = [(views[:, idx], labels[idx]) for idx in shards]
    return {"inl": (views, labels), "fl": fl, "sl": fl}


def split_experiment2(views, labels, num_clients: int):
    """Paper Exp-2: every client sees all images; only the noise differs."""
    per_client = [(views[j], labels) for j in range(num_clients)]
    return {"inl": (views, labels), "fl": per_client, "sl": per_client}


def batch_indices(n: int, batch_size: int, *, seed: int = 0,
                  epochs: int = 1) -> Iterator[np.ndarray]:
    """Seeded, shuffled, DROP-REMAINDER minibatch index stream.

    The single source of batching truth for every scheme/trainer: each epoch
    is a fresh permutation of [0, n) cut into exactly ``n // batch_size``
    full-size batches.  The trailing partial batch is always dropped — a
    short batch would retrace/recompile every jitted step it reaches and
    shape-mismatch a stacked whole-epoch `lax.scan`."""
    rng = np.random.default_rng(seed)
    per_epoch = (n // batch_size) * batch_size
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, per_epoch, batch_size):
            yield perm[i:i + batch_size]


def multiview_batches(views: np.ndarray, labels: np.ndarray, batch_size: int,
                      *, seed: int = 0, epochs: int = 1
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled mini-batches of ((J,b,H,W,C) views, (b,) labels)."""
    for idx in batch_indices(labels.shape[0], batch_size, seed=seed,
                             epochs=epochs):
        yield views[:, idx], labels[idx]


def image_batches(images: np.ndarray, labels: np.ndarray, batch_size: int,
                  *, seed: int = 0, epochs: int = 1
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled mini-batches of ((b,H,W,C) images, (b,) labels)."""
    for idx in batch_indices(labels.shape[0], batch_size, seed=seed,
                             epochs=epochs):
        yield images[idx], labels[idx]
