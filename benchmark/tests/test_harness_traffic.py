"""The open-loop schedule and the statistics the bounds are read with."""
import statistics

import numpy as np
import pytest


def test_every_seed_sends_the_same_work_in_another_order():
    from harness.traffic import poisson_schedule
    a = poisson_schedule(3000.0, 10.0, 1)
    b = poisson_schedule(3000.0, 10.0, 2 ** 31 + 7)
    assert len(a) == len(b) == 30000
    assert a[0] == 0.0 and np.all(np.diff(a) >= 0) and a[-1] < 10.0
    gaps = lambda t: np.sort(np.diff(np.append(t, 10.0)))
    assert np.allclose(gaps(a), gaps(b))
    assert not np.allclose(a, b)
    assert np.diff(a).mean() == pytest.approx(10.0 / 30000, rel=1e-3)


def test_gaps_are_exponential():
    """The gaps' quantiles are the exponential distribution's: a Poisson
    process at the rate."""
    from harness.traffic import poisson_schedule
    gaps = np.diff(poisson_schedule(1000.0, 20.0, 5)) * 1000.0
    assert np.median(gaps) == pytest.approx(np.log(2), rel=0.02)
    assert np.percentile(gaps, 90) == pytest.approx(np.log(10), rel=0.02)


def test_pool_is_drawn_evenly():
    from harness.traffic import pool_indices
    idx = pool_indices(1000, 256, 3)
    counts = np.bincount(idx, minlength=256)
    assert counts.min() >= 3 and counts.max() <= 4


def test_percentile_and_spread():
    from harness.stats import percentile, spread
    xs = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0]
    for q in (0, 25, 50, 90, 99, 100):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert percentile([1.0, float("inf")], 99) == float("inf")
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / med)
