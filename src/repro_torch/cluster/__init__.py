"""Distributed mining executor of the port: the paper's pipeline in rounds.

``planner``    Phase-1/2 control plane: Thm 6.1 database sample → reservoir FI
               sample → PBEC partition → LPT / DB-Repl-Min assignment priced
               by replicated-transaction volume.
``executor``   Phase-3/4 data plane: all_to_all transaction exchange +
               frontier-batched Eclat per miner (kernel B1, or B2 with
               ``use_mxu``), merged into one global :class:`FITable`.
``rebalance``  Per-round load telemetry and bounded donation of unexplored
               PBEC subtrees from overloaded to idle miners.
``checkpoint`` Atomic round checkpoints (CRC32C-guarded payload, plan-hash
               binding) in the JAX package's format, for bit-exact resume.

``executor.cluster_mine_fn`` plugs the executor into the streaming miner as
its re-miner.
"""
from repro_torch.cluster.checkpoint import (  # noqa: F401
    CheckpointError,
    RoundState,
    plan_fingerprint,
)
from repro_torch.cluster.executor import (  # noqa: F401
    ClusterParams,
    ClusterReport,
    ClusterResult,
    FITable,
    RoundStats,
    cluster_mine_fn,
    execute,
)
from repro_torch.cluster.planner import (  # noqa: F401
    MiningPlan,
    PlannerParams,
    pack_seeds,
    plan,
    plan_from_reference,
)
from repro_torch.cluster.rebalance import (  # noqa: F401
    Donation,
    LoadLedger,
    rebalance,
    remaining_loads,
)
