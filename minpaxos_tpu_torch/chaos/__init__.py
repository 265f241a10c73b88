"""paxchaos on the port: seeded network fault injection + invariant checks.

The port's counterpart of the JAX package's ``chaos/`` (numpy and the
standard library only, like the reference's). Every failure a kill or
revive exercises is a clean process death; this package injects the
messy ones between live replicas, reproducibly from a seed:

* ``plan``     — :class:`FaultPlan` / :class:`LinkPolicy`: per-directed-
  link drop / delay+jitter / duplicate / reorder / block policies, all
  driven by seeded ``np.random.Generator`` streams, so a failing
  campaign replays exactly from its seed.
* ``shim``     — :class:`ChaosShim`: the injection point the port's TCP
  transport consults in ``send_peer`` (outbound partition blackhole)
  and ``_read_loop`` (inbound drop/delay/dup/reorder). Without one
  installed a frame pays one attribute load.
* ``check``    — the cluster invariant checker (``verify/invariants.py``,
  re-exported).
* ``campaign`` — seeded fault schedules and the in-process campaign
  runner behind ``python -m minpaxos_tpu_torch.cli.chaos`` (imported
  directly, not re-exported here: it pulls in the replica runtime and
  torch).

Fault model scope: replica<->replica data-plane links only. Client and
control-plane connections are never faulted.
"""

from minpaxos_tpu_torch.chaos.plan import FaultPlan, LinkPolicy
from minpaxos_tpu_torch.chaos.shim import ChaosShim

__all__ = ["FaultPlan", "LinkPolicy", "ChaosShim"]
