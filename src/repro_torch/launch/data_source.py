"""Shared --dataset / --store / --db data-source resolution for the port's
launchers.

``launch/mine.py`` and ``launch/cluster_mine.py`` take the same three data
sources, as the JAX package's launchers do; this resolves them in one place:

  * ``--dataset f.dat``  — ingest a FIMI file into a store (at ``--store``
    or a temp dir) and mine it out of core;
  * ``--store dir/``     — open an existing
    :class:`~repro_torch.store.store.TxStore`, or spill the ``--db`` IBM
    database into it block by block first;
  * neither              — generate the ``--db`` database dense in RAM.

Returns ``(store, dense, label)`` where exactly one of ``store`` /
``dense`` is set.  Host side only: nothing here touches a device.
"""
from __future__ import annotations

import tempfile
from typing import Optional, Tuple

import numpy as np

from repro_torch.data.ibm_gen import generate_dense, params_from_name
from repro_torch.store import TxStore, ingest_dat, write_ibm_store


def resolve_source(
    dataset: str,
    store_dir: str,
    db: str,
    *,
    block_tx: int,
    seed: int,
) -> Tuple[Optional[TxStore], Optional[np.ndarray], str]:
    """Resolve the launcher's data source; see module docstring."""
    if dataset:
        directory = store_dir or tempfile.mkdtemp(prefix="txstore_")
        store = ingest_dat(dataset, directory, block_tx=block_tx)
        return store, None, f"dataset={dataset}"
    if store_dir:
        if TxStore.exists(store_dir):
            return TxStore.open(store_dir), None, f"store={store_dir}"
        store = write_ibm_store(
            params_from_name(db, seed=seed), store_dir, block_tx=block_tx
        )
        return store, None, f"store={store_dir} (spilled from {db})"
    return None, generate_dense(params_from_name(db, seed=seed)), f"db={db}"
