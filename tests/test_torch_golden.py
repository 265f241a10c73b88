"""The port's Cluster reproduces the JAX golden state digests, step for step.

``tests/fixtures/kernel_golden.json`` holds a blake2b digest of the
whole cluster state (replica states, routed pending inboxes, alive
mask) after every step of the golden scenario, recorded from the JAX
package. The port's ``Cluster(device="cpu")`` runs the same scenario
(minpaxos_tpu_torch/golden.py) and must reproduce every digest; a
failure names the first divergent step. The fixture is only read.
"""

from __future__ import annotations

import pytest
import torch

from minpaxos_tpu_torch.golden import PROTOCOLS, drive, first_divergence, load_fixture

torch.set_num_threads(1)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_port_reproduces_golden_digests(protocol):
    want = load_fixture()[protocol]
    got = drive(protocol, device="cpu")
    div = first_divergence(got, want)
    assert div is None, (
        f"{protocol}: state digest diverged at step {div} "
        f"({len(got)} steps run, {len(want)} recorded)")


def test_golden_replies_are_exactly_once():
    """The scenario's proposals reply once each, with no duplicates."""
    from minpaxos_tpu_torch.golden import GOLDEN_SHAPE
    from minpaxos_tpu_torch.models.cluster import Cluster
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig

    import numpy as np

    cl = Cluster(MinPaxosConfig(**GOLDEN_SHAPE), ext_rows=8, device="cpu")
    cl.elect(0)
    cl.run(2)
    n = 12
    cl.propose(np.ones(n, np.int32), np.arange(n), np.arange(n) * 3, np.arange(n),
               client_id=4, to=0)
    cl.run(8)
    assert sorted(k[1] for k in cl.replies) == list(range(n))
    assert not any(r["duplicate"] for r in cl.reply_log)
    assert all(cl.replies[(4, i)]["value"] == 3 * i for i in range(n))
