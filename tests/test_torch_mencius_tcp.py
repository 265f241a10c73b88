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


def test_cede_ranges_of_one_owner_never_merge_across_its_proposal(tmp_path):
    """The Mencius step merges one step's SKIP rows of an owner into one
    range (min start, max end), in the JAX package's step as in the
    port's: two cede ranges with the owner's accepted PUT between them
    no-op it when one inbox holds both. The server's drain ends an
    inbox before such a SKIP row, so the PUT stays accepted."""
    import functools

    import jax

    from minpaxos_tpu.models.mencius import init_mencius as jax_init
    from minpaxos_tpu.models.mencius import mencius_step_impl as jax_step
    from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
    from minpaxos_tpu.models.minpaxos import MsgBatch as JaxMsgBatch
    from minpaxos_tpu_torch.models import mencius as tmc
    from minpaxos_tpu_torch.models import minpaxos as tmp
    from minpaxos_tpu_torch.runtime.replica import ReplicaServer, RuntimeFlags
    from minpaxos_tpu_torch.wire.messages import MsgKind, Op, make_batch

    shape = dict(n_replicas=3, window=64, inbox=16, exec_batch=8, kv_pow2=6,
                 catchup_rows=4, recovery_rows=4, noop_delay=100)
    srv = ReplicaServer(1, [("127.0.0.1", 1)] * 3, tmp.MinPaxosConfig(**shape),
                        RuntimeFlags(device="cpu", store_dir=str(tmp_path)),
                        protocol="mencius")
    frames = [
        (MsgKind.SKIP, make_batch(MsgKind.SKIP, leader_id=0, start_inst=0, end_inst=0)),
        (MsgKind.ACCEPT, make_batch(MsgKind.ACCEPT, leader_id=0, inst=3, ballot=0,
                                    last_committed=-1, op=int(Op.PUT), key=7, val=9,
                                    cmd_id=5, client_id=1)),
        (MsgKind.SKIP, make_batch(MsgKind.SKIP, leader_id=0, start_inst=6, end_inst=6)),
    ]
    # the three frames in one inbox: both steps no-op slot 3
    whole = batches_of(srv, frames, split=False)
    assert len(whole) == 1
    jstep = jax.jit(functools.partial(jax_step, JaxCfg(**shape)))
    for inboxes in (whole, batches_of(srv, frames)):
        ts = tmc.init_mencius(tmp.MinPaxosConfig(**shape), [1], device="cpu")
        js = jax_init(JaxCfg(**shape), 1)
        for cols in inboxes:
            ts = tmc.mencius_step_impl(srv.cfg, ts, tmp.MsgBatch(
                **{c: torch.from_numpy(v[None]) for c, v in cols.items()}))[0]
            js = jstep(js, JaxMsgBatch(**cols))[0]
        got = [(int(ts.status[0, i]), int(ts.op[0, i])) for i in (0, 3, 6)]
        assert got == [(int(js.status[i]), int(js.op[i])) for i in (0, 3, 6)]
        if inboxes is whole:
            assert got[1] == (tmp.COMMITTED, int(Op.NONE)), got
    # the drain: the second cede range waits for the next inbox
    assert len(inboxes) == 2, inboxes
    assert srv.stats["skips_deferred"] == 1
    assert got[1] == (tmp.ACCEPTED, int(Op.PUT)), got
    assert all(st >= tmp.COMMITTED and op == int(Op.NONE)
               for st, op in (got[0], got[2])), got


def batches_of(srv, frames, split=True) -> list[dict]:
    """The inboxes the server's drain builds from ``frames`` queued from
    peer 0 (``split=False``: every row in one inbox, as a drain without
    the cede-range gate built it)."""
    from minpaxos_tpu_torch.runtime import batches
    from minpaxos_tpu_torch.runtime.transport import FROM_PEER

    if not split:
        for kind, rows in frames:
            batches.frame_to_rows(srv.inbox, kind, rows, 0)
        cols, n = srv.inbox.drain()
        return [cols]
    for kind, rows in frames:
        srv.queue.put((FROM_PEER, 0, kind, rows))
    out = []
    while srv._carry or srv.queue.qsize():
        srv._drain(0.01)
        out.append(srv.inbox.drain()[0])
    return out
