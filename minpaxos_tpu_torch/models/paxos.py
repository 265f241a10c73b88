"""Classic per-instance Multi-Paxos: the MinPaxos step with explicit commits.

The port's counterpart of the JAX package's ``models/paxos.py``: the
same batched step (models/minpaxos.py) specialized by the static
``explicit_commit`` flag — followers commit only on COMMIT/COMMIT_SHORT
rows, the leader commits each instance at its own ballot and broadcasts
its frontier every step.
"""

from __future__ import annotations

from minpaxos_tpu_torch.models.minpaxos import (
    MinPaxosConfig,
    ReplicaState,
    become_leader,
    init_replica,
    replica_step_impl,
)

__all__ = ["classic_config", "become_leader", "init_replica",
           "replica_step_impl", "ReplicaState", "MinPaxosConfig"]


def classic_config(**kw) -> MinPaxosConfig:
    """A MinPaxosConfig running classic per-instance Multi-Paxos."""
    kw.setdefault("explicit_commit", True)
    return MinPaxosConfig(**kw)
