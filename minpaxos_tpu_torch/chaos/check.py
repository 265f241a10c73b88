"""The cluster invariant checker under its ``chaos.check`` name.

The predicates live in :mod:`minpaxos_tpu_torch.verify.invariants`, so
the model checker and the chaos campaigns certify the same properties;
this module re-exports them, as the JAX package's ``chaos/check.py``
does.

The checker runs against a QUIESCED cluster (load stopped, chaos
healed, frontiers converged): the campaign runner guarantees that
before calling in, so reading the in-process stores' mirrors does not
race the protocol threads.
"""

from __future__ import annotations

from minpaxos_tpu_torch.verify.invariants import (  # noqa: F401
    CheckReport,
    VALUE_FIELDS as _VALUE_FIELDS,
    check_cluster,
    check_frontier_monotonic,
    check_linearizable,
    check_log_agreement,
    check_snapshot_agreement,
)

__all__ = ["CheckReport", "check_cluster", "check_frontier_monotonic",
           "check_linearizable", "check_log_agreement",
           "check_snapshot_agreement"]
