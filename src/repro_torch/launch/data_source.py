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

:func:`resolve_source` returns ``(store, dense, label)`` where exactly one
of ``store`` / ``dense`` is set.  :func:`store_argv` makes the store once,
before a launcher starts its ranks (``--devices``), and points their command
line at it, so no two ranks write one store.  Host side only: nothing here
touches a device.
"""
from __future__ import annotations

import tempfile
from typing import List, Optional, Sequence, Tuple

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


def _without(argv: Sequence[str], flags: Sequence[str]) -> List[str]:
    """``argv`` with every ``--flag VALUE`` / ``--flag=VALUE`` of ``flags`` removed."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        elif not any(a.startswith(f + "=") for f in flags):
            out.append(a)
    return out


def store_argv(args, argv: Sequence[str]) -> List[str]:
    """The command line of a launcher's ranks: with a ``--dataset`` or
    ``--store`` source, the store is made here (ingested or spilled, as
    :func:`resolve_source` does) and the ranks get ``--store DIR`` alone;
    any other ``argv`` is returned as it is."""
    if not (args.dataset or args.store):
        return list(argv)
    store, _, _ = resolve_source(args.dataset, args.store, args.db,
                                 block_tx=args.blocktx, seed=args.seed)
    return _without(argv, ("--dataset", "--store")) + ["--store", store.directory]
