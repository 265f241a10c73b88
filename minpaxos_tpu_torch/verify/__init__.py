"""paxmc on the port: verification of the port's consensus steps.

The port of the JAX package's ``verify/`` package, importing nothing of
it:

* :mod:`~minpaxos_tpu_torch.verify.invariants` — the safety predicates
  (committed-slot agreement, validity, frontier monotonicity, per-key
  linearizable history) as plain-numpy functions;
* :mod:`~minpaxos_tpu_torch.verify.quorum` — quorum-intersection
  certificates, with the certified ledger in
  :mod:`~minpaxos_tpu_torch.verify.quorum_golden`;
* :mod:`~minpaxos_tpu_torch.verify.spec` — the executable abstract
  Multi-Paxos spec;
* :mod:`~minpaxos_tpu_torch.verify.mc` — the bounded model checker
  that drives the port's step functions, one batched step per chunk of
  a BFS layer (the hand-written kernels on the card);
* :mod:`~minpaxos_tpu_torch.verify.refine` and
  :mod:`~minpaxos_tpu_torch.verify.liveness` — refinement checking
  against the spec, and liveness under weak fairness.

CLI: ``python -m minpaxos_tpu_torch.cli.mc`` (``--smoke`` runs the
reference's smoke legs).
"""

from minpaxos_tpu_torch.verify.invariants import (  # noqa: F401
    CheckReport,
    check_cluster,
    check_frontier_monotonic,
    check_linearizable,
    check_log_agreement,
    check_slot_agreement,
    check_validity,
)
from minpaxos_tpu_torch.verify.quorum import (  # noqa: F401
    Certificate,
    certify_grid,
    certify_threshold,
)

__all__ = [
    "CheckReport", "check_cluster", "check_frontier_monotonic",
    "check_linearizable", "check_log_agreement", "check_slot_agreement",
    "check_validity", "Certificate", "certify_grid", "certify_threshold",
]
