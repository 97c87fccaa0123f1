"""Synthetic input clouds, made from a seed.

:func:`synth_cloud` is a copy of ``bench.py``'s (the reference's bench
cloud), for ``chip_smoke.py`` and the tests; a test holds it equal to
the original.
"""

from __future__ import annotations

import numpy as np


def synth_cloud(n: int, seed: int = 0) -> np.ndarray:
    """LiDAR-like mix: a ground plane sheet + building clusters + scatter."""
    rng = np.random.default_rng(seed)
    n_ground = n // 2
    n_clusters = n // 4
    n_scatter = n - n_ground - n_clusters

    ground = np.empty((n_ground, 3), np.float32)
    ground[:, :2] = rng.uniform(-400, 400, (n_ground, 2))
    ground[:, 2] = rng.normal(0.0, 0.3, n_ground)

    centers = rng.uniform(-350, 350, (64, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(5, 40, 64)
    which = rng.integers(0, 64, n_clusters)
    clusters = centers[which] + rng.normal(0, 8.0, (n_clusters, 3))

    scatter = rng.uniform(-500, 500, (n_scatter, 3))
    return np.concatenate(
        [ground, clusters.astype(np.float32), scatter.astype(np.float32)]
    ).astype(np.float32)

