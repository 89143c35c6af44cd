"""``test_torch_variants.py``'s comparisons with ``repro.core.fimi.run`` at
P = 4.

A file of its own so that a second worker pays the reference's compilation
for P = 4 while the first compiles P = 2.
"""
import pytest

from test_torch_variants import (  # noqa: F401 (fixtures)
    VARIANTS, check_fitable, check_plan, dense, dense150)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fitable_equals_reference(dense, variant, seed):  # noqa: F811
    check_fitable(dense, variant, 4, seed)


@pytest.mark.parametrize("variant", ["seq", "par"])
def test_plan_equals_reference_with_its_draws(dense, variant):  # noqa: F811
    check_plan(dense, variant, 4, 0)


@pytest.mark.parametrize("variant", ["reservoir", "par"])
def test_fitable_at_150_items(dense150, variant):  # noqa: F811
    check_fitable(dense150, variant, 4, 0)
