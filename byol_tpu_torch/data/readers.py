"""Synthetic array datasets (a copy of ``load_fake`` and ``load_synth`` from
byol_tpu/data/readers.py, which are numpy only).  Images are uint8 NHWC,
labels int64."""
from __future__ import annotations

from typing import Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]


def load_fake(num_samples: int = 512, image_size: int = 32,
              num_classes: int = 10, seed: int = 0) -> Arrays:
    """Deterministic noise images: nothing to learn, real shapes."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, size=(num_samples, image_size, image_size, 3),
                    dtype=np.uint8)
    y = rng.randint(0, num_classes, size=(num_samples,)).astype(np.int64)
    return x, y


def load_synth(num_samples: int = 10_000, image_size: int = 32,
               num_classes: int = 10, seed: int = 0, train: bool = True
               ) -> Arrays:
    """A learnable procedural dataset: each class is a fixed smooth color
    template (4x4 noise upsampled bilinearly), each sample the template
    times a brightness gain plus a bias and pixel noise.  Templates depend
    only on (num_classes, image_size), so train and test share classes
    but not samples."""
    tmpl_rng = np.random.RandomState(123)           # class identity, fixed
    rng = np.random.RandomState(seed + (0 if train else 10_007))
    coarse = tmpl_rng.rand(num_classes, 4, 4, 3)
    xs = np.linspace(0, 3, image_size)
    i0 = np.clip(np.floor(xs).astype(int), 0, 2)
    frac = xs - i0

    def _up(t):                                     # bilinear 4x4 -> S x S
        t = (t[i0] * (1 - frac)[:, None, None]
             + t[i0 + 1] * frac[:, None, None])
        return (t[:, i0] * (1 - frac)[None, :, None]
                + t[:, i0 + 1] * frac[None, :, None])

    templates = np.stack([0.2 + 0.6 * _up(c) for c in coarse])
    y = rng.randint(0, num_classes, size=(num_samples,))
    gain = rng.uniform(0.6, 1.0, size=(num_samples, 1, 1, 1))
    bias = rng.uniform(-0.1, 0.1, size=(num_samples, 1, 1, 1))
    noise = rng.normal(0.0, 0.06, size=(num_samples, image_size,
                                        image_size, 3))
    x = np.clip(templates[y] * gain + bias + noise, 0.0, 1.0)
    return (x * 255).astype(np.uint8), y.astype(np.int64)
