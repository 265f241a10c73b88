"""The golden cluster scenario and its state digest.

A deterministic mixed-traffic scenario (elections, chunked proposals,
kills down to a lost majority, revival, a leader change) driven through
``Cluster``, with a blake2b digest of the whole cluster state — replica
states, routed pending inboxes, alive mask, in the JAX package's leaf
order and dtypes — after every step. The JAX package's
``tests/fixtures/kernel_golden.json`` records the reference digests for
the ``minpaxos``, ``classic`` and ``mencius`` protocols at ``GOLDEN_SHAPE``;
this module only reads them. Mencius has no elections: its scenario
proposes to several owners and kills and revives owners instead.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from minpaxos_tpu_torch.models.cluster import Cluster, numpy_leaves
from minpaxos_tpu_torch.models.mencius import MenciusCluster
from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
from minpaxos_tpu_torch.models.paxos import classic_config
from minpaxos_tpu_torch.wire.messages import Op

GOLDEN_SHAPE = dict(n_replicas=5, window=64, inbox=32, exec_batch=16,
                    kv_pow2=8, catchup_rows=8, recovery_rows=8)
PROTOCOLS = ("minpaxos", "classic", "mencius")
FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "kernel_golden.json"


def digest(cs) -> str:
    h = hashlib.blake2b(digest_size=16)
    for leaf in numpy_leaves(cs):
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


def drive(protocol: str, device="cuda") -> list[str]:
    """Run the scenario; one state digest per step."""
    if protocol == "mencius":
        cl = MenciusCluster(MinPaxosConfig(**GOLDEN_SHAPE), ext_rows=8, device=device)
    else:
        cfg = (classic_config(**GOLDEN_SHAPE) if protocol == "classic"
               else MinPaxosConfig(**GOLDEN_SHAPE))
        cl = Cluster(cfg, ext_rows=8, device=device)
    rng = np.random.default_rng(7)
    digests: list[str] = []

    def step(n=1):
        for _ in range(n):
            cl.step()
            digests.append(digest(cl.cs))

    def propose(n, client, to):
        keys = rng.integers(0, 40, n)
        vals = rng.integers(0, 1 << 16, n)
        ops = np.where(rng.random(n) < 0.7, int(Op.PUT), int(Op.GET))
        mids = np.arange(n) + len(digests) * 100 + client * 10_000
        cl.propose(ops, keys, vals, mids, client_id=client, to=to)

    if protocol == "mencius":
        propose(10, client=1, to=0)
        propose(7, client=2, to=1)
        step(6)
        cl.kill(2)
        propose(6, client=1, to=3)
        step(6)
        cl.kill(1)
        cl.kill(3)
        propose(4, client=2, to=0)
        step(8)
        cl.revive(1)
        cl.revive(2)
        cl.revive(3)
        step(10)
        propose(5, client=1, to=2)
        step(8)
        return digests
    cl.elect(0)
    step(2)
    propose(20, client=1, to=0)
    propose(5, client=2, to=0)
    step(6)
    cl.kill(2)
    propose(6, client=1, to=0)
    step(4)
    cl.kill(1)
    cl.kill(3)
    propose(4, client=2, to=0)
    step(8)
    cl.revive(1)
    cl.revive(2)
    cl.revive(3)
    step(6)
    cl.elect(1)
    step(3)
    propose(6, client=1, to=1)
    step(8)
    return digests


def load_fixture(path=FIXTURE) -> dict:
    with open(path) as f:
        return json.load(f)


def first_divergence(got: list[str], want: list[str]):
    """Index of the first differing step (or of the length mismatch),
    None when the runs agree."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))
