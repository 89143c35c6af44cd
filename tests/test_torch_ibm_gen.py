"""The port's IBM generator is bit-equal to the JAX package's."""
import dataclasses

import numpy as np
import pytest

from repro.data import ibm_gen as ref_gen
from repro_torch.data import ibm_gen


@pytest.mark.parametrize(
    "name,seed",
    [
        ("T1I0.032P20PL6TL10", 0),
        ("T2I0.024P10PL5TL8", 7),
        ("T0.5I0.1P50PL10TL40", 3),
    ],
)
def test_generate_dense_bit_equal(name, seed):
    got = ibm_gen.generate_dense(ibm_gen.params_from_name(name, seed=seed))
    want = ref_gen.generate_dense(ref_gen.params_from_name(name, seed=seed))
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_params_from_name_matches_reference():
    name = "T500I0.1P50PL10TL40"
    got = ibm_gen.params_from_name(name, seed=5)
    want = ref_gen.params_from_name(name, seed=5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_tx, got.n_items) == (500_000, 100)
    with pytest.raises(ValueError):
        ibm_gen.params_from_name("not-a-db-name")

