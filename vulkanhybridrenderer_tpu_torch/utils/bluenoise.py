"""Blue-noise texture generation (void-and-cluster, Ulichney 1993; a numpy
copy of the reference package's ``utils/bluenoise.py``).

The reference ships four prebaked 128x128 LDR_RGBA blue-noise PNGs
(data/misc/blue_noise, uploaded at renderer.cpp:32-36 and exposed through
PerFrameData.blue_noise_texture_index).  We generate equivalent textures
procedurally at first use and cache them; rank-order the void-and-cluster
selection into a uniform [0, 1) threshold map per channel.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


def _gaussian_energy(size: int, sigma: float = 1.9) -> np.ndarray:
    """Toroidal Gaussian splat kernel (FFT-friendly layout)."""
    ax = np.arange(size)
    d = np.minimum(ax, size - ax).astype(np.float64)
    dx, dy = np.meshgrid(d, d, indexing="ij")
    return np.exp(-(dx**2 + dy**2) / (2.0 * sigma * sigma))


def _energy_of(mask: np.ndarray, kernel_fft: np.ndarray) -> np.ndarray:
    return np.real(np.fft.ifft2(np.fft.fft2(mask) * kernel_fft))


def void_and_cluster(size: int = 64, seed: int = 0) -> np.ndarray:
    """Returns a (size, size) float32 blue-noise threshold map in [0, 1)."""
    rng = np.random.default_rng(seed)
    n = size * size
    kernel_fft = np.fft.fft2(_gaussian_energy(size))

    # initial pattern: 10% random ones relaxed to the tightest-cluster/void rule
    mask = np.zeros((size, size), bool)
    ones = rng.choice(n, n // 10, replace=False)
    mask.flat[ones] = True
    for _ in range(4 * (n // 10)):
        e = _energy_of(mask.astype(np.float64), kernel_fft)
        cluster = np.argmax(np.where(mask, e, -np.inf))
        mask.flat[cluster] = False
        e = _energy_of(mask.astype(np.float64), kernel_fft)
        void = np.argmin(np.where(mask, np.inf, e))
        if void == cluster:
            mask.flat[cluster] = True
            break
        mask.flat[void] = True

    rank = np.zeros(n, np.int64)
    # phase 1: remove tightest clusters downward
    m = mask.copy()
    count = int(m.sum())
    for r in range(count - 1, -1, -1):
        e = _energy_of(m.astype(np.float64), kernel_fft)
        cluster = np.argmax(np.where(m, e, -np.inf))
        m.flat[cluster] = False
        rank[cluster] = r
    # phase 2: fill largest voids upward
    m = mask.copy()
    for r in range(count, n):
        e = _energy_of(m.astype(np.float64), kernel_fft)
        void = np.argmin(np.where(m, np.inf, e))
        m.flat[void] = True
        rank[void] = r
    return (rank.reshape(size, size).astype(np.float32) + 0.5) / n


@lru_cache(maxsize=4)
def blue_noise_rgba(size: int = 64, seed: int = 0) -> np.ndarray:
    """(size, size, 4) float32 blue noise, one independent channel per seed --
    the stand-in for the reference's LDR_RGBA_{0..3}.png."""
    return np.stack(
        [void_and_cluster(size, seed * 4 + c) for c in range(4)], axis=-1
    )
