"""Deterministic synthetic image datasets (counterpart of ``repro/data/synthetic.py``).

A numpy copy: for the same arguments and seed the arrays are bit-identical
to the JAX package's.  Seeded class-conditional Gaussian mixtures stand in
for MNIST / So2Sat / CIFAR-10, with matched shapes and class counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ImageDataset", "make_image_classification", "mnist_like", "so2sat_like", "cifar10_like"]


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    x: np.ndarray  # (N, H, W, C) float32
    y: np.ndarray  # (N,) int32
    n_classes: int
    name: str

    def __len__(self) -> int:
        return self.x.shape[0]


def make_image_classification(
    n_samples: int,
    image_shape: tuple[int, int, int],
    n_classes: int,
    seed: int = 0,
    class_sep: float = 2.0,
    n_prototypes: int = 4,
    name: str = "synthetic",
) -> ImageDataset:
    """Each class has ``n_prototypes`` smooth prototype images; a sample is a
    random prototype of its class plus white noise, then standardised."""
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    # low-frequency prototypes: random coefficients on coarse 2D cosine basis
    n_basis = 8
    fy = np.cos(np.pi * np.arange(h)[:, None] * np.arange(n_basis)[None, :] / h)
    fx = np.cos(np.pi * np.arange(w)[:, None] * np.arange(n_basis)[None, :] / w)
    protos = np.empty((n_classes, n_prototypes, h, w, c), dtype=np.float32)
    for k in range(n_classes):
        for p in range(n_prototypes):
            coef = rng.standard_normal((n_basis, n_basis, c)).astype(np.float32)
            img = np.einsum("hb,wB,bBc->hwc", fy, fx, coef) / n_basis
            protos[k, p] = img * class_sep
    labels = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    proto_pick = rng.integers(0, n_prototypes, size=n_samples)
    x = protos[labels, proto_pick] + rng.standard_normal((n_samples, h, w, c)).astype(np.float32)
    x = (x - x.mean()) / (x.std() + 1e-8)
    return ImageDataset(x=x.astype(np.float32), y=labels, n_classes=n_classes, name=name)


def mnist_like(n_samples: int, seed: int = 0) -> ImageDataset:
    """28×28×1, 10 classes — stands in for MNIST (paper cfg. A/D)."""
    return make_image_classification(n_samples, (28, 28, 1), 10, seed=seed, name="mnist-like")


def so2sat_like(n_samples: int, seed: int = 0) -> ImageDataset:
    """32×32×10, 17 classes — stands in for So2Sat LCZ42 (cfg. B)."""
    return make_image_classification(n_samples, (32, 32, 10), 17, seed=seed, name="so2sat-like")


def cifar10_like(n_samples: int, seed: int = 0) -> ImageDataset:
    """32×32×3, 10 classes — stands in for CIFAR-10 (cfg. C)."""
    return make_image_classification(n_samples, (32, 32, 3), 10, seed=seed, name="cifar10-like")
