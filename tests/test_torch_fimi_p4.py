"""``test_torch_fimi.py``'s comparisons with ``repro.core.fimi.run`` at P = 4.

A file of its own so that a second worker pays the reference's compilation
for P = 4 while the first compiles P = 2.
"""
import pytest

from test_torch_fimi import check_fitable, check_plan, dense  # noqa: F401 (fixture)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fitable_equals_reference(dense, seed):  # noqa: F811
    check_fitable(dense, 4, seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_equals_reference_with_its_draws(dense, seed):  # noqa: F811
    check_plan(dense, 4, seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_repl_min_fitable_equals_reference(dense, seed):  # noqa: F811
    check_fitable(dense, 4, seed, scheduler="repl_min")
