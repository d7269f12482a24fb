"""The search's work counted from the inputs, on a hand-sized cloud."""
import numpy as np
import pytest

from portbench import roofline
from portbench.reference.registration import in_radius_counts


def test_in_radius_counts_by_hand():
    target = np.array([[0.0, 0, 0], [0.3, 0, 0], [0.6, 0, 0], [2.0, 0, 0], [0, 0.45, 0]])
    source = np.array([[0.0, 0, 0], [0.6, 0, 0], [5.0, 5, 5]])
    # radius 0.5: (0,0,0) sees 0, 0.3, (0,0.45); (0.6,0,0) sees 0.3, 0.6; the far row none.
    np.testing.assert_array_equal(in_radius_counts(source, target, 0.5), [3, 2, 0])


def test_search_work_by_hand():
    nbytes, flops = roofline.search_work(np.array([3, 2, 0]), k=4)
    assert nbytes == 3 * 12 + 5 * 12 + 3 * 4 * 20
    assert flops == 8 * 5
    assert roofline.least_seconds(nbytes, flops) == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))
