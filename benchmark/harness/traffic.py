"""Open-loop arrivals.

A Poisson process at ``rate`` per second for ``seconds``, made so that
every seed sends the same work: the number of requests is
``round(rate * seconds)``, and the gaps between arrivals are the
exponential distribution's quantiles at (i + 1/2) / n, scaled to sum to
``seconds`` exactly, in an order that the seed shuffles.  Two seeds then
differ in when each burst comes, not in how many requests or how much
idle time there is.  Each request's image is drawn from the pool, each
pool image as often as any other (to within one).
"""
from __future__ import annotations

import numpy as np


def poisson_schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival times in seconds from the window's start, ascending; the
    first at 0."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng([seed, 1])
    gaps = rng.permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def pool_indices(n: int, pool: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 2])
    return rng.permutation(np.resize(np.arange(pool), n))
