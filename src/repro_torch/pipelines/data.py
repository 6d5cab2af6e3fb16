"""Synthetic natural-image generator (profiling / training sets).

The Oxford Buildings set used by the paper is not available offline; per
Torralba & Oliva (paper ref [26]) natural images share a ~1/f amplitude
spectrum, so we synthesize seeded 1/f-spectrum textures overlaid with
geometric structure (edges and corners matter for HCD/OF).  Deterministic
given the seed.

The port's own copy of `repro.pipelines.data`: numpy arrays, bit-equal
to the reference's for the same seed (`tests/test_torch_dse.py`).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def natural_image(shape: Tuple[int, int] = (64, 64), seed: int = 0,
                  spectral_slope: float = 1.0) -> np.ndarray:
    """One synthetic 8-bit grayscale image in [0, 255]."""
    rng = np.random.default_rng(np.random.PCG64(seed))
    H, W = shape
    # 1/f^slope spectrum noise
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = 1.0 / (f ** spectral_slope)
    phase = rng.uniform(0, 2 * np.pi, size=(H, W))
    spec = amp * np.exp(1j * phase)
    tex = np.real(np.fft.ifft2(spec))
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-12)

    img = 0.6 * tex
    # geometric structure: rectangles and diagonal edges (corners for HCD)
    for _ in range(rng.integers(3, 8)):
        y0, x0 = rng.integers(0, H - 4), rng.integers(0, W - 4)
        h = int(rng.integers(3, max(H // 3, 4)))
        w = int(rng.integers(3, max(W // 3, 4)))
        val = rng.uniform(0.0, 1.0)
        img[y0:min(y0 + h, H), x0:min(x0 + w, W)] = (
            0.5 * img[y0:min(y0 + h, H), x0:min(x0 + w, W)] + 0.5 * val)
    # global illumination gradient
    gy = np.linspace(0, rng.uniform(-0.3, 0.3), H)[:, None]
    img = np.clip(img + gy, 0, 1)
    return np.round(img * 255.0).astype(np.float64)


def image_set(n: int, shape: Tuple[int, int] = (64, 64), seed: int = 0
              ) -> List[np.ndarray]:
    return [natural_image(shape, seed=seed * 10007 + i) for i in range(n)]


def shifted_pair(shape: Tuple[int, int] = (64, 64), seed: int = 0,
                 shift: Tuple[int, int] = (1, 1)) -> Tuple[np.ndarray, np.ndarray]:
    """An image and its translate — ground-truth-flow pair for OF."""
    base = natural_image((shape[0] + 8, shape[1] + 8), seed=seed)
    dy, dx = shift
    a = base[4:4 + shape[0], 4:4 + shape[1]]
    b = base[4 + dy:4 + dy + shape[0], 4 + dx:4 + dx + shape[1]]
    return a, b


def train_test_split(n_total: int = 20, shape=(64, 64), seed: int = 7):
    """Paper §V-A: a sample set split into equal train/test halves."""
    imgs = image_set(n_total, shape, seed)
    half = n_total // 2
    return imgs[:half], imgs[half:]
