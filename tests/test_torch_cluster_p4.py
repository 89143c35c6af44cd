"""``test_torch_cluster.py``'s comparisons with ``repro.cluster.execute`` at P = 4.

A file of its own so that a second worker runs the reference at P = 4 while
the first runs P = 2.
"""
import pytest

from test_torch_cluster import CASES, check_against_reference, dense  # noqa: F401 (fixture)


@pytest.mark.parametrize("seed,use_mxu,rebalance", CASES)
def test_executor_equals_reference(dense, seed, use_mxu, rebalance):  # noqa: F811
    want = check_against_reference(dense, 4, seed, use_mxu, rebalance)
    if rebalance:  # the case is one where the rebalancer moves work
        assert want.report.donations
