"""The arithmetic of the end-to-end metrics on known inputs."""

import numpy as np
import pytest

from slambench import stats


def test_percentile_of_known_values():
    values = list(range(1, 101))                 # 1 .. 100
    assert stats.percentile(values, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5


def test_percentile_takes_all_values_with_a_stall():
    # 99 frames of 100 ms and one stall of 5 s: the 90th percentile stays
    # among the ordinary frames, the rate pays for the whole stall
    lat = [0.1] * 99 + [5.0]
    assert stats.percentile(lat, 90) == pytest.approx(0.1)
    window = sum(lat)
    assert stats.rate(len(lat), window) == pytest.approx(100 / 14.9)
    # ten stalls in a hundred frames reach the 90th percentile
    lat = [0.1] * 90 + [5.0] * 10
    assert stats.percentile(lat, 90) == pytest.approx(0.1 + 0.1 * 4.9)


def test_rate_refuses_an_empty_window():
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = np.asarray([10.75, 12.5, 14.25])
    assert stats.spread(values) == pytest.approx((q3 - q1) / 12.5)
