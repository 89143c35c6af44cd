import numpy as np
import pytest

# NOTE: no XLA_FLAGS here by design — smoke tests and benches must see ONE
# device (the dry-run sets its own 512-device flag in its own process).


@pytest.fixture(scope="session")
def thesis_db():
    """The thesis' running example (Example 8.1), items shifted to 0-based."""
    import jax.numpy as jnp

    from repro.core import bitmap as bm

    tx = [
        {1, 2, 3, 4, 6}, {3, 5, 6}, {1, 3, 4}, {1, 2, 6}, {1, 3, 4, 5, 6},
        {1, 2, 3, 4, 5}, {2, 3, 4, 5}, {2, 3, 4, 5}, {3, 4, 5, 6}, {2, 4, 5},
        {1, 2, 4, 5}, {2, 3, 4, 5, 6}, {3, 4, 5, 6}, {4, 5, 6}, {1, 3, 4, 5, 6},
    ]
    return bm.BitmapDB.from_transactions([[i - 1 for i in t] for t in tx], 6)


@pytest.fixture(scope="session")
def small_db():
    """A 512-tx synthetic IBM-style DB (dense + BitmapDB + oracle at 8%)."""
    import jax.numpy as jnp

    from repro.core import bitmap as bm
    from repro.core import eclat
    from repro.data.ibm_gen import IBMParams, generate_dense

    dense = generate_dense(
        IBMParams(n_tx=512, n_items=24, n_patterns=8, avg_pattern_len=5,
                  avg_tx_len=8, seed=3)
    )
    db = bm.BitmapDB.from_dense(jnp.asarray(dense))
    minsup = int(np.ceil(0.08 * 512))
    oracle = eclat.brute_force_fis(dense, minsup)
    return dense, db, minsup, oracle


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped when CUDA is not available"
    )
