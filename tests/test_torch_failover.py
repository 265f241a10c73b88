"""The port's TCP serving path under faults, MinPaxos and classic: leader
kill, master-driven election and client failover, laggard heals, a lost
majority, master death, follower churn and KV fail-stop.

The port's counterparts of ``tests/test_distributed.py``'s fault tests,
with their assertions and deadlines, on ``test_torch_serving``'s harness
(in-process port master and servers, stepped on the CPU). Each phase's
commands are drawn as the JAX tests draw them but driven under one
cmd_id space (``Workload``), so after every scenario the port's and the
JAX package's ``check_cluster`` hold the port's stable stores, the
client's replies and the whole workload to the same invariants.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_serving import Workload, harness, settle_and_hold  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("protocol,seeds,timeout_s", [
    ("minpaxos", (3, 4), 30),   # test_leader_kill_election_failover
    ("classic", (21, 22), 40),  # test_classic_paxos_leader_kill_election
])
def test_leader_kill_election_failover(harness, tmp_path, protocol, seeds,
                                       timeout_s):
    """Kill the leader: the master promotes a live replica, the client
    fails over and finishes the workload with no duplicates. Classic
    commits only through explicit COMMITs, so its new leader finishes
    the old leader's in-flight instances through the phase-1 sweep."""
    h = harness(classic=protocol == "classic")
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(200, seed=seeds[0]), 30)["acked"] == 200
    h.kill(0)
    h.wait(lambda: h.master.leader != 0, 15, "master never promoted")
    stats = wl.run(cli, wl.add(200, seed=seeds[1]), timeout_s)
    assert stats["acked"] == 200, stats
    assert stats["duplicates"] == 0
    settle_and_hold(h, tmp_path, wl, cli)


def test_master_adopts_protocol_leader(harness, tmp_path):
    """Leadership moved without the master (a direct be_the_leader):
    the master adopts the majority of the replicas' leader views, and
    clients routed through it commit against the new leader."""
    h = harness()
    assert h.master.leader == 0
    assert h.control(2, {"m": "be_the_leader"})["ok"]
    h.wait(lambda: h.master.leader == 2, 20,
           lambda: f"master stuck on {h.master.leader}")
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(100, seed=77), 30)["acked"] == 100
    settle_and_hold(h, tmp_path, wl, cli)


def test_master_elects_highest_frontier(harness, tmp_path):
    """Follower 1 lags far behind when leader 0 dies: the master must
    promote 2, the most caught-up replica, and the cluster serves."""
    h = harness(durable=True)
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(200, seed=21), 30)["acked"] == 200
    h.kill(1)
    assert wl.run(cli, wl.add(600, seed=22), 60)["acked"] == 600
    h.start_replica(1)
    h.kill(0)
    h.wait(lambda: h.master.leader == 2, 20,
           lambda: f"master elected {h.master.leader}; "
           f"frontiers {h.master.frontiers}")
    # the revived laggard answers the PREPARE only after its store replay
    h.wait(lambda: h.servers[2].snapshot["prepared"], 30,
           "new leader never prepared")
    stats = wl.run(cli, wl.add(100, seed=23), 40)
    assert stats["acked"] == 100, stats
    assert stats["duplicates"] == 0
    settle_and_hold(h, tmp_path, wl, cli)


def test_stale_boot_self_election_skipped(harness, tmp_path):
    """A replica 0 restarted empty while a non-0 leader serves must not
    depose it with its boot self-election: it re-follows."""
    h = harness()
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(300, seed=3), 30)["acked"] == 300
    assert h.control(2, {"m": "be_the_leader"})["ok"]
    h.wait(lambda: h.master.leader == 2, 20, "replica 2 never led")
    h.kill(0)
    for f in tmp_path.glob("stable-store-replica0"):
        f.unlink()
    ids = wl.add(1200, seed=4)
    c2 = h.client()
    pump_stats = {}

    def pump():
        pump_stats.update(wl.run(c2, ids, 60))

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    time.sleep(0.3)
    h.start_replica(0)
    t.join(timeout=90)
    assert pump_stats.get("acked") == 1200, pump_stats
    assert pump_stats.get("duplicates") == 0
    h.wait(lambda: h.servers[0].snapshot["leader"] == 2, 20,
           lambda: f"replica 0 deposed the leader: {h.servers[0].snapshot}")
    assert h.master.leader == 2
    settle_and_hold(h, tmp_path, wl, cli, c2)


def test_laggard_leader_heals_via_store_served_sweep(harness, tmp_path):
    """A leader elected with a nearly empty log heals through its
    phase-1 sweep even for slots that slid out of every follower's
    window: the followers answer those from their durable stores."""
    h = harness(durable=True)
    h.kill(2)  # dies before any traffic: revives with an empty log
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(1400, seed=13), 60)["acked"] == 1400
    lead_base = h.servers[0].snapshot["window_base"]
    assert lead_base > 250, (
        f"window never slid (base={lead_base}); test setup is vacuous")
    h.start_replica(2)
    deadline = time.monotonic() + 20
    while True:  # promote the empty laggard before it can catch up
        try:
            assert h.control(2, {"m": "be_the_leader"})["ok"]
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    h.wait(lambda: h.servers[2].snapshot["frontier"] >= 1399, 90,
           lambda: "laggard leader stuck at "
           f"{h.servers[2].snapshot['frontier']}")
    cli2 = h.client()
    stats = wl.run(cli2, wl.add(100, seed=14), 60)
    assert stats["acked"] == 100 and stats["duplicates"] == 0, stats
    settle_and_hold(h, tmp_path, wl, cli, cli2)


def test_beyond_retention_heal_from_stable_store(harness, tmp_path):
    """A follower dead while the leader's window slid past its frontier
    heals from the leader's durable store (the device's catch-up rows
    no longer hold those slots)."""
    h = harness(durable=True)
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(200, seed=11), 30)["acked"] == 200
    h.kill(2)
    assert wl.run(cli, wl.add(1400, seed=12), 60)["acked"] == 1400
    lead_base = h.servers[0].snapshot["window_base"]
    assert lead_base > 250, (
        f"window never slid (base={lead_base}); test setup is vacuous")
    h.start_replica(2)
    target = h.servers[0].snapshot["frontier"]
    h.wait(lambda: h.servers[2].snapshot["frontier"] >= target, 40,
           lambda: f"laggard stuck at {h.servers[2].snapshot['frontier']}"
           f" < {target}")
    settle_and_hold(h, tmp_path, wl, cli)


def test_majority_loss_stalls_then_resumes(harness, tmp_path):
    """Both followers killed: nothing commits. One revived: the same
    commands, re-driven by the same client, all commit and each is
    acknowledged once, however many connections carried them."""
    h = harness(durable=True)
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(100, seed=41), 30)["acked"] == 100
    before = h.servers[0].snapshot["frontier"]
    h.kill(1)
    h.kill(2)
    ids = wl.add(100, seed=42)
    stats = wl.run(cli, ids, 6)
    assert stats["acked"] == 0, stats  # no quorum -> no commits
    assert h.servers[0].snapshot["frontier"] == before
    h.start_replica(1)
    stats = wl.run(cli, ids, 40)
    assert stats["acked"] == 100, stats
    assert stats["duplicates"] == 0
    settle_and_hold(h, tmp_path, wl, cli)


def test_abandoned_connection_replies_are_dropped(harness, tmp_path):
    """Commands held on a connection the client left (a re-dial while
    no majority could commit them) and re-sent on the new one commit
    twice once a follower returns; the client hears only the new
    connection's replies, one per command."""
    h = harness(durable=True)
    cli, wl = h.client(), Workload()
    assert wl.run(cli, wl.add(50, seed=43), 30)["acked"] == 50
    h.kill(1)
    h.kill(2)
    ids = wl.add(100, seed=44)
    cli.propose(ids, *(t[ids] for t in wl.table))  # held by the leader
    cli.connect(0)  # the re-dial a failover makes
    assert wl.run(cli, ids, 3)["acked"] == 0
    h.start_replica(1)
    stats = wl.run(cli, ids, 40)
    assert stats["acked"] == 100, stats
    assert stats["duplicates"] == 0
    settle_and_hold(h, tmp_path, wl, cli)


class _SlowServer:
    """A replica's data port that holds every PROPOSE it reads and acks
    them all, on the connection that carried them, ``delay_s`` after the
    first one; it records each connection's cmd_ids."""

    def __init__(self, port, delay_s):
        import socket
        import threading

        from minpaxos_tpu_torch.wire.codec import FrameWriter, StreamDecoder
        from minpaxos_tpu_torch.wire.messages import MsgKind, make_batch

        self.seen: list[list[int]] = []
        self.sock = socket.create_server(("127.0.0.1", port))

        def serve(conn, ids):
            dec, first = StreamDecoder(), None
            conn.settimeout(0.05)
            while True:
                try:
                    chunk = conn.recv(1 << 16)
                    if not chunk:
                        return
                    for kind, rows in dec.feed(chunk):
                        if kind == MsgKind.PROPOSE:
                            ids.extend(rows["cmd_id"].tolist())
                            first = first or time.monotonic()
                except socket.timeout:
                    pass
                except OSError:
                    return
                if first and time.monotonic() - first > delay_s:
                    w = FrameWriter(conn)
                    w.write(MsgKind.PROPOSE_REPLY, make_batch(
                        MsgKind.PROPOSE_REPLY, ok=1, cmd_id=np.asarray(ids, np.int32),
                        val=0, timestamp=0, leader=np.int8(0)))
                    w.flush()
                    first = None

        def accept():
            while True:
                try:
                    conn, _ = self.sock.accept()
                except OSError:
                    return
                conn.recv(1)  # the client handshake
                self.seen.append([])
                threading.Thread(target=serve, args=(conn, self.seen[-1]),
                                 daemon=True).start()

        threading.Thread(target=accept, daemon=True).start()

    def close(self):
        self.sock.close()


def test_client_keeps_a_slow_connection():
    """A live server that holds a batch longer than one 3 s wait keeps
    the client: no failover, each command sent once, on one connection
    (re-sending it on a new one would commit it twice)."""
    from minpaxos_tpu_torch.runtime.client import Client, gen_workload
    from minpaxos_tpu_torch.runtime.master import Master, _rpc
    from minpaxos_tpu_torch.utils.netutil import CONTROL_OFFSET, free_ports

    mport = free_ports(1)[0]
    port = free_ports(1, sibling_offset=CONTROL_OFFSET)[0]
    m = Master("127.0.0.1", mport, 1, ping_s=0.3)
    m.start()
    srv = _SlowServer(port, delay_s=4.0)
    try:
        _rpc(("127.0.0.1", mport), {"m": "register", "addr": "127.0.0.1", "port": port})
        cli = Client(("127.0.0.1", mport), check=True)
        stats = cli.run_workload(*gen_workload(100, seed=61), timeout_s=20)
        assert stats["acked"] == 100 and stats["duplicates"] == 0, stats
        assert cli.metrics.counters()["failovers"] == 0
        assert [sorted(ids) for ids in srv.seen] == [list(range(100))]
        cli.close_conn()
    finally:
        srv.close()
        m.stop()


def test_data_plane_survives_master_death(harness, tmp_path):
    """The master is control plane only: killing it does not interrupt
    committed writes for connected clients."""
    h = harness()
    cli, wl = h.client(), Workload()
    ids = wl.add(300, seed=9)
    assert wl.run(cli, ids[:100], 30)["acked"] == 100
    h.master.stop()
    stats = wl.run(cli, ids[100:], 30)
    assert stats["acked"] == 200, stats
    assert stats["duplicates"] == 0
    settle_and_hold(h, tmp_path, wl, cli)


def test_follower_churn_exactly_once(harness, tmp_path):
    """Followers killed and revived under load, in a seeded order:
    every command acks exactly once and the followers meet the
    leader's frontier at the end."""
    rng = np.random.default_rng(5150)
    h = harness(durable=True)
    cli, wl = h.client(), Workload()
    for phase in range(4):
        victim = int(rng.integers(1, 3))
        if victim in h.servers:
            h.kill(victim)
        n = int(rng.integers(80, 160))
        stats = wl.run(cli, wl.add(n, conflict_pct=30, seed=60 + phase), 40)
        assert stats["acked"] == n, (phase, stats)
        assert stats["duplicates"] == 0, (phase, stats)
        if victim not in h.servers:
            h.start_replica(victim)
        time.sleep(0.2)
    target = h.servers[0].snapshot["frontier"]
    h.wait(lambda: all(h.servers[i].snapshot["frontier"] >= target
                       for i in (1, 2)), 30, "followers never met the leader")
    settle_and_hold(h, tmp_path, wl, cli)


def test_kv_saturation_fails_stop(harness):
    """A full KV table fail-stops the replica loudly (ping ok=False with
    the reason) instead of dropping an acknowledged write."""
    h = harness(cfg_overrides=dict(kv_pow2=3))  # 8 KV slots
    cli = h.client(check=False)
    n = 64  # 64 distinct keys >> 8 slots: guaranteed saturation
    ops = np.full(n, 1, np.int64)  # Op.PUT
    keys = np.arange(n, dtype=np.int64) + 1000
    vals = np.arange(n, dtype=np.int64)
    deadline = time.monotonic() + 60
    fatal = None
    while time.monotonic() < deadline and fatal is None:
        cli.replies.clear()
        try:
            cli.run_workload(ops, keys, vals, timeout_s=5)
        except OSError:
            pass  # the proposed-to replica may itself have fail-stopped
        for s in h.servers.values():
            if s.fatal is not None:
                fatal = s.fatal
                break
        time.sleep(0.1)
    assert fatal is not None and "saturated" in fatal, fatal
    resp = h.control(0, {"m": "ping"})
    if resp["fatal"] is not None:  # replica 0 may or may not be first
        assert not resp["ok"] and "saturated" in resp["fatal"]
    cli.close_conn()


def test_jax_package_client_fails_over_across_port_cluster(harness, tmp_path):
    """Wire compatibility under a fault: the JAX package's Client (its
    codec, its retry and failover driver) finishes its workload across
    a port cluster whose leader is killed, exactly once."""
    from minpaxos_tpu.runtime.client import Client as JaxClient

    h = harness(durable=True)
    cli, wl = JaxClient(("127.0.0.1", h.mport), check=True), Workload()
    assert wl.run(cli, wl.add(200, seed=5), 30)["acked"] == 200
    h.kill(0)
    h.wait(lambda: h.master.leader != 0, 15, "master never promoted")
    stats = wl.run(cli, wl.add(200, seed=6), 40)
    assert stats["acked"] == 200, stats
    assert stats["duplicates"] == 0
    settle_and_hold(h, tmp_path, wl, cli)
