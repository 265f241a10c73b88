"""Mencius over the port's TCP serving path: one client, the round-robin
MultiClient, a dead owner's slots taken over and the owner revived from
its store, the proposer killed, and owner churn.

The port's counterparts of ``tests/test_distributed.py``'s Mencius
tests, with their assertions and deadlines, on ``test_torch_serving``'s
harness (in-process port master and servers, stepped on the CPU). After
every scenario the port's and the JAX package's ``check_cluster`` hold
the port's stable stores, the clients' replies and the workload (one
cmd_id space across phases, ``Workload``) to the same invariants.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from minpaxos_tpu_torch.runtime.client import MultiClient
from tests.test_torch_serving import Workload, harness, settle_and_hold  # noqa: F401

torch.set_num_threads(1)


def test_mencius_over_tcp(harness, tmp_path):
    """One client proposes to replica 0; the idle owners cede their
    interleaved slots by SKIP frames and every command commits exactly
    once."""
    h = harness(mencius=True)
    cli, wl = h.client(), Workload()
    stats = wl.run(cli, wl.add(400, seed=13), 60)
    assert stats["acked"] == 400, stats
    assert stats["duplicates"] == 0
    settle_and_hold(h, tmp_path, wl, cli)


def test_multiclient_rr_drives_all_mencius_owners(harness, tmp_path):
    """The round-robin MultiClient drives every owner at once: exactly
    once across its connections, and every owner serves proposals."""
    h = harness(mencius=True)
    mc, wl = MultiClient(("127.0.0.1", h.mport), check=True, mode="rr"), Workload()
    wl.add(300, seed=91)
    stats = mc.run_workload(*wl.table, timeout_s=60)
    assert stats["acked"] == 300, stats
    assert stats["duplicates"] == 0
    served = [h.servers[r].stats["proposals"] for r in range(3)]
    assert all(s > 0 for s in served), served
    settle_and_hold(h, tmp_path, wl, mc)


def test_mencius_dead_owner_takeover_and_revive(harness, tmp_path):
    """Kill an idle owner: the frontier blocks on its slots until the
    takeover sweep no-op-fills them. Revive it from its durable store:
    it heals back to the cluster's frontier within the deadline."""
    h = harness(mencius=True, durable=True)
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(200, seed=14), 60)["acked"] == 200
    h.kill(2)
    stats = wl.run(cli, wl.add(200, seed=15), 60)
    assert stats["acked"] == 200, stats  # commits despite the dead owner
    h.start_replica(2)
    target = h.servers[0].snapshot["frontier"]
    h.wait(lambda: h.servers[2].snapshot["frontier"] >= target, 30,
           lambda: (h.servers[2].snapshot, target))
    settle_and_hold(h, tmp_path, wl, cli)


def test_mencius_proposer_kill_failover(harness, tmp_path):
    """Kill the replica clients propose to: the master hints another,
    the client fails over, the dead owner's slots are taken over and
    commits go on exactly once."""
    h = harness(mencius=True)
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(150, seed=31), 60)["acked"] == 150
    h.kill(0)
    h.wait(lambda: h.master.leader != 0, 15, "master never moved its hint")
    stats = wl.run(cli, wl.add(150, seed=32), 60)
    assert stats["acked"] == 150, stats
    assert stats["duplicates"] == 0
    settle_and_hold(h, tmp_path, wl, cli)


def test_mencius_owner_churn_exactly_once(harness, tmp_path):
    """Owners killed and revived under load, in a seeded order: each
    death forces takeover fills, each revival a heal from the store;
    every command acks exactly once."""
    rng = np.random.default_rng(6001)
    h = harness(mencius=True, durable=True)
    cli, wl = h.client(), Workload()
    for phase in range(3):
        victim = int(rng.integers(1, 3))  # keep the hinted proposer up
        if victim in h.servers:
            h.kill(victim)
        n = int(rng.integers(60, 120))
        stats = wl.run(cli, wl.add(n, conflict_pct=30, seed=80 + phase), 60)
        assert stats["acked"] == n, (phase, stats)
        assert stats["duplicates"] == 0, (phase, stats)
        if victim not in h.servers:
            h.start_replica(victim)
        time.sleep(0.3)
    settle_and_hold(h, tmp_path, wl, cli)
