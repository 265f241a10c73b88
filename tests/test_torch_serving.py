"""The port's TCP serving path end to end: master + replica servers +
clients over localhost TCP, in-process (threads), on the CPU.

The port's counterparts of ``tests/test_distributed.py``'s smoke, READ,
durable follower kill/revive, classic and Mencius tests, at its SMALL
shape, plus wire compatibility: the JAX package's client drives a
cluster of port servers. Every cluster takes fresh ports from the
port's ``free_ports`` and every wait has its own deadline.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
from minpaxos_tpu_torch.runtime.client import Client, MultiClient, gen_workload
from minpaxos_tpu_torch.runtime.master import Master, _rpc
from minpaxos_tpu_torch.runtime.replica import ReplicaServer, RuntimeFlags
from minpaxos_tpu_torch.runtime.stable import StableStore
from minpaxos_tpu_torch.utils.netutil import CONTROL_OFFSET, free_ports

torch.set_num_threads(1)

SMALL = dict(window=1 << 10, inbox=1024, exec_batch=512, kv_pow2=12,
             catchup_rows=64, recovery_rows=64)


class Harness:
    """A port master + N port replica servers on fresh localhost ports."""

    def __init__(self, tmp_path, n=3, durable=False, classic=False,
                 mencius=False, cfg_overrides=None, flags=None):
        self.protocol = ("mencius" if mencius
                         else "classic" if classic else "minpaxos")
        self.tmp_path = tmp_path
        self.mport = free_ports(1)[0]
        self.addrs = [("127.0.0.1", p) for p in
                      free_ports(n, sibling_offset=CONTROL_OFFSET)]
        self.master = Master("127.0.0.1", self.mport, n, ping_s=0.3)
        self.master.start()
        # register every replica in id order (the server binary's startup
        # step; ids follow registration order), one RPC each
        for i, (host, port) in enumerate(self.addrs):
            resp = _rpc(("127.0.0.1", self.mport),
                        {"m": "register", "addr": host, "port": port})
            assert resp["ok"] and resp["id"] == i, resp
        self.cfg = MinPaxosConfig(n_replicas=n, explicit_commit=classic,
                                  **{**SMALL, **(cfg_overrides or {})})
        self.durable = durable
        self.flags = flags or {}  # extra RuntimeFlags fields, every replica
        self.servers: dict[int, ReplicaServer] = {}
        for i in range(n):
            self.start_replica(i)
        if not mencius:
            self.wait(lambda: self.servers[0].snapshot["prepared"], 20,
                      "replica 0 never prepared")

    @staticmethod
    def wait(pred, timeout_s, what):
        """Poll ``pred`` until it holds or ``timeout_s`` runs out; then
        fail with ``what`` (a callable is called then, so its message
        shows the state at the deadline)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.05)
        raise AssertionError(what() if callable(what) else what)

    def start_replica(self, i) -> None:
        flags = RuntimeFlags(durable=self.durable, store_dir=str(self.tmp_path),
                             tick_s=0.001, device="cpu", **self.flags)
        s = ReplicaServer(i, self.addrs, self.cfg, flags, protocol=self.protocol)
        s.start()
        self.servers[i] = s

    def kill(self, i) -> None:
        self.servers.pop(i).stop()

    def stop(self) -> None:
        """Stop every server (their stores closed) and the master; a
        second call is a no-op for the servers."""
        for s in self.servers.values():
            s.stop()
        self.servers.clear()
        self.master.stop()

    def client(self, check=True) -> Client:
        return Client(("127.0.0.1", self.mport), check=check)

    def control(self, i, req: dict) -> dict:
        """One JSON request to replica i's control port."""
        import json
        import socket

        host, port = self.addrs[i]
        with socket.create_connection((host, port + CONTROL_OFFSET), timeout=5) as s:
            f = s.makefile("rw")
            f.write(json.dumps(req) + "\n")
            f.flush()
            return json.loads(f.readline())


class Workload:
    """One cmd_id space across a scenario's phases: each phase's
    ``gen_workload`` draws are appended to one table and driven under
    their global ids, so every command in the stores and every reply
    the client holds can be checked against the one table."""

    def __init__(self):
        self.ops = self.keys = self.vals = np.zeros(0, np.int64)

    def add(self, n, **kw) -> np.ndarray:
        """Append ``gen_workload(n, **kw)``; returns the new cmd_ids."""
        ops, keys, vals = gen_workload(n, **kw)
        lo = len(self.ops)
        self.ops = np.concatenate([self.ops, ops])
        self.keys = np.concatenate([self.keys, keys])
        self.vals = np.concatenate([self.vals, vals])
        return np.arange(lo, lo + n)

    def run(self, cli, ids, timeout_s) -> dict:
        """Drive ``ids`` through one client (its retry driver); acked
        counts these ids, duplicates the client's whole life."""
        return cli.run_partition(ids, self.ops, self.keys, self.vals,
                                 timeout_s=timeout_s)

    @property
    def table(self):
        return self.ops, self.keys, self.vals


def settle_and_hold(h, store_dir, wl, *clients):
    """End of a scenario: close the clients (a MultiClient's too), wait
    until every live replica has committed every slot any of them has
    seen (the stores' committed prefixes then cover every acked command:
    Mencius executes and acks a committed slot above a gap), stop the
    cluster and hold its stores, with every reply, to both packages'
    invariants."""
    replies = {}
    for c in clients:
        for sub in getattr(c, "clients", [c]):
            sub.close_conn()
            replies.update(sub.replies)

    def frontiers():
        return {i: s.snapshot["frontier"] for i, s in h.servers.items()}

    def tip():
        return max(s.snapshot.get("crt_inst", 0) for s in h.servers.values()) - 1

    h.wait(lambda: min(frontiers().values()) >= tip(), 30,
           lambda: f"cluster never settled: frontiers {frontiers()}, tip {tip()}")
    h.stop()
    hold_to_reference(store_dir, len(h.addrs), replies, wl.table)


def hold_to_reference(store_dir, n, replies=None, workload=None):
    """The port's and the JAX package's ``check_cluster`` over the
    port's stable stores (one format, each read by its own package's
    ``StableStore``), with the client's replies and the workload table
    where given: both must pass, over the same slots."""
    from minpaxos_tpu.runtime.stable import StableStore as RefStore
    from minpaxos_tpu.verify import invariants as ref_inv

    from minpaxos_tpu_torch.verify import invariants as port_inv

    reports = []
    for store_cls, inv in ((StableStore, port_inv), (RefStore, ref_inv)):
        stores = {i: store_cls(f"{store_dir}/stable-store-replica{i}", sync=False)
                  for i in range(n)}
        try:
            reports.append(inv.check_cluster(stores, replies=replies,
                                             workload=workload))
        finally:
            for s in stores.values():
                s.close()
    port, ref = reports
    assert port.ok, port.violations
    assert ref.ok, ref.violations
    assert (port.frontiers, port.compared_slots, port.replayed_slots) == (
        ref.frontiers, ref.compared_slots, ref.replayed_slots)


@pytest.fixture
def harness(tmp_path):
    h = None

    def make(**kw):
        nonlocal h
        h = Harness(tmp_path, **kw)
        return h

    yield make
    if h is not None:
        h.stop()


@pytest.mark.parametrize("protocol", ["minpaxos", "classic"])
def test_thousand_ops_exactly_once(harness, protocol):
    """simpletest.sh through port servers: 1,000 checked PUTs, every one
    acknowledged exactly once; the servers stepped on the CPU."""
    h = harness(classic=protocol == "classic")
    cli = h.client()
    ops, keys, vals = gen_workload(1000, seed=42)
    stats = cli.run_workload(ops, keys, vals, timeout_s=60)
    assert stats["acked"] == 1000, stats
    assert stats["duplicates"] == 0
    assert all(str(s.dev) == "cpu" for s in h.servers.values())
    assert h.servers[0].stats["executed"] >= 1000
    cli.close_conn()


def test_mencius_multiclient_thousand_ops(harness):
    """Mencius over TCP: a round-robin MultiClient proposes to every
    owner on its own connection; 1,000 checked ops, exactly once."""
    h = harness(mencius=True)
    mc = MultiClient(("127.0.0.1", h.mport), check=True, mode="rr")
    ops, keys, vals = gen_workload(1000, seed=13)
    stats = mc.run_workload(ops, keys, vals, timeout_s=60)
    assert stats["acked"] == 1000, stats
    assert stats["duplicates"] == 0
    mc.close()


def test_reads_are_served(harness):
    """READ frames are served as linearizable GETs through the log."""
    h = harness()
    cli = h.client()
    stats = cli.run_workload(np.array([1]), np.array([77]), np.array([123]),
                             timeout_s=30)
    assert stats["acked"] == 1
    cli.read([1000], [77])
    assert cli.wait([1000], timeout_s=20)
    assert cli.replies[1000]["val"] == 123
    cli.close_conn()


def test_follower_kill_revive_durable(harness, tmp_path):
    """checklog.sh: kill a follower, keep committing, revive it from its
    stable store, and it catches back up; the durable logs of the three
    replicas agree on the committed prefix, read back by the port's
    StableStore."""
    h = harness(durable=True)
    cli = h.client()
    ops, keys, vals = gen_workload(300, seed=1)
    assert cli.run_workload(ops, keys, vals, timeout_s=60)["acked"] == 300
    h.kill(2)
    ops2, keys2, vals2 = gen_workload(300, seed=2)
    cli.replies.clear()
    assert cli.run_workload(ops2, keys2, vals2, timeout_s=60)["acked"] == 300
    h.start_replica(2)
    target = h.servers[0].snapshot["frontier"]
    h.wait(lambda: h.servers[2].snapshot["frontier"] >= target, 30,
           f"revived follower stuck below {target}")
    cli.close_conn()
    h.stop()
    stores = [StableStore(str(tmp_path / f"stable-store-replica{i}"), sync=False)
              for i in range(3)]
    try:
        upto = min(s.committed_prefix() for s in stores)
        assert upto >= 599
        recs = [s.read_range(0, upto) for s in stores]
        for r in recs[1:]:
            for f in ("inst", "op", "key", "val", "cmd_id", "client_id"):
                np.testing.assert_array_equal(r[f], recs[0][f], err_msg=f)
    finally:
        for s in stores:
            s.close()
    h.servers.clear()


def test_jax_package_client_drives_port_cluster(harness):
    """Wire compatibility: the JAX package's Client (its codec, its
    retry driver) runs 200 checked ops against port servers."""
    from minpaxos_tpu.runtime.client import Client as JaxClient
    from minpaxos_tpu.runtime.client import gen_workload as jax_gen

    h = harness()
    cli = JaxClient(("127.0.0.1", h.mport), check=True)
    ops, keys, vals = jax_gen(200, seed=5)
    stats = cli.run_workload(ops, keys, vals, timeout_s=60)
    assert stats["acked"] == 200, stats
    assert stats["duplicates"] == 0
    cli.read([5000], [int(keys[-1])])
    assert cli.wait([5000], timeout_s=20)
    last = {int(k): int(v) for k, v in zip(keys, vals)}
    assert cli.replies[5000]["val"] == last[int(keys[-1])]
    cli.close_conn()


def test_control_verbs(harness):
    """ping, stats, chaos (status), events, trace, tracespans and
    be_the_leader on a port replica's control port; other verbs (the
    JAX package's ``phase``, not carried over) answer an error."""
    h = harness()

    def rpc(req):
        return h.control(1, req)

    ping = rpc({"m": "ping"})
    assert ping["ok"] and ping["leader"] == 0 and ping["fatal"] is None
    st = rpc({"m": "stats"})
    assert st["ok"] and st["device"] == "cpu" and "dispatches" in st["metrics"]["counters"]
    ch = rpc({"m": "chaos"})
    assert ch["ok"] and ch["installed"] is False and ch["faults_total"] == 0
    assert rpc({"m": "chaos", "op": "no_such_op"})["ok"] is False
    ev = rpc({"m": "events"})
    assert ev["ok"] and ev["id"] == 1 and "anchor" in ev["journal"]
    tr = rpc({"m": "trace", "last": 8})
    assert tr["ok"] and tr["recorder"] is True and tr["events"]
    sp = rpc({"m": "tracespans"})
    assert sp["ok"] and sp["trace"]["enabled"] and "anchor" in sp["trace"]
    assert rpc({"m": "phase"})["ok"] is False
    assert rpc({"m": "be_the_leader"})["ok"]
    h.wait(lambda: h.servers[1].snapshot["leader"] == 1
           and h.servers[1].snapshot["prepared"], 20, "promotion never landed")


def test_client_reader_survives_a_quiet_stream(harness):
    """A client whose connection hears nothing for longer than the 5 s
    connect timeout still reads later replies (a cluster healing a
    revived replica can be quiet that long)."""
    h = harness()
    cli = h.client()
    assert cli.run_workload(np.array([1]), np.array([5]), np.array([9]),
                            timeout_s=30)["acked"] == 1
    time.sleep(5.5)
    cli.read([2000], [5])
    assert cli.wait([2000], timeout_s=20)
    assert cli.replies[2000]["val"] == 9
    cli.close_conn()


class _FakeControl:
    """A replica's control port that answers ping and records
    be_the_leader (no replica behind it)."""

    def __init__(self, port, frontier):
        import json
        import socket
        import threading

        self.promoted = threading.Event()
        self.sock = socket.create_server(("127.0.0.1", port + CONTROL_OFFSET))

        def serve():
            while True:
                try:
                    conn, _ = self.sock.accept()
                except OSError:
                    return
                f = conn.makefile("rw")
                for line in f:
                    req = json.loads(line)
                    if req["m"] == "be_the_leader":
                        self.promoted.set()
                    f.write(json.dumps({"ok": True, "frontier": frontier,
                                        "leader": -1}) + "\n")
                    f.flush()
                conn.close()

        threading.Thread(target=serve, daemon=True).start()

    def close(self):
        self.sock.close()


def test_master_waits_out_boot_and_missed_pings():
    """The master promotes no replica while the leader has not answered
    since the membership completed (boot grace), nor after a single
    missed ping of a replica it has seen; a leader that never comes up
    is replaced once the grace runs out."""
    mport = free_ports(1)[0]
    ports = free_ports(3, sibling_offset=CONTROL_OFFSET)
    m = Master("127.0.0.1", mport, 3, ping_s=0.05)
    m.BOOT_GRACE_S = 1.5
    m.start()
    fakes = []
    try:
        for p in ports:
            _rpc(("127.0.0.1", mport), {"m": "register", "addr": "127.0.0.1", "port": p})
        fakes = [_FakeControl(p, fr) for p, fr in zip(ports[1:], (5, 9))]
        time.sleep(0.8)  # replica 0 silent, inside its boot grace
        assert m.leader == 0 and m.alive[0] and not fakes[1].promoted.is_set()
        Harness.wait(lambda: fakes[1].promoted.is_set(), 10, "no promotion after the grace")
        Harness.wait(lambda: m.leader == 2, 5, "promotion not recorded")  # highest frontier
        # a seen replica that stops answering is alive until it has
        # missed MISS_LIMIT pings in a row
        m.MISS_LIMIT = 10 ** 6
        fakes[0].close()
        Harness.wait(lambda: m._misses[1] >= 3, 5, "pings not missed")
        assert m.alive[1]
        m.MISS_LIMIT = 3
        Harness.wait(lambda: not m.alive[1], 5, "replica 1 never declared dead")
    finally:
        m.stop()
        for f in fakes:
            f.close()


@pytest.mark.parametrize("case", ["sibling_reserved", "collision_skipped",
                                  "impossible_raises", "below_ephemeral",
                                  "reserved_across_processes"])
def test_free_ports(case):
    """The JAX package's ``free_ports`` cases on the port's copy, ports
    drawn from below the kernel's ephemeral range (an outbound
    connection cannot take one between selection and a server's bind),
    and a port handed out in one process not handed out again in
    another before its server binds (two harnesses booting at once)."""
    import socket
    import subprocess
    import sys

    from minpaxos_tpu_torch.utils.netutil import _ephemeral_floor

    if case == "sibling_reserved":
        ports = free_ports(3, sibling_offset=CONTROL_OFFSET)
        assert len(set(ports)) == 3
        for p in ports:
            for q in (p, p + CONTROL_OFFSET):
                s = socket.socket()
                try:
                    s.bind(("127.0.0.1", q))
                finally:
                    s.close()
    elif case == "collision_skipped":
        # hold the sibling of a port the allocator could hand out (a
        # candidate's sibling can be taken again before this bind: try
        # the next one)
        held = socket.socket()
        for cand in free_ports(8, sibling_offset=CONTROL_OFFSET):
            try:
                held.bind(("127.0.0.1", cand + CONTROL_OFFSET))
                break
            except OSError:
                continue
        try:
            blocked = held.getsockname()[1] - CONTROL_OFFSET
            for _ in range(20):
                assert blocked not in free_ports(20, sibling_offset=CONTROL_OFFSET)
        finally:
            held.close()
    elif case == "impossible_raises":
        with pytest.raises(OSError):
            free_ports(1, sibling_offset=70000)
    elif case == "reserved_across_processes":
        # another process whose every random draw is this port: the port
        # and its sibling are free on the host, but handed out here
        (mine,) = free_ports(1, sibling_offset=CONTROL_OFFSET)
        code = ("import random, sys\n"
                f"random.Random.randint = lambda self, a, b: {mine}\n"
                "from minpaxos_tpu_torch.utils.netutil import free_ports\n"
                f"print(free_ports(1, sibling_offset={CONTROL_OFFSET})[0])\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=60, check=True)
        assert int(out.stdout) != mine
    else:
        floor = _ephemeral_floor()
        ports = free_ports(50, sibling_offset=CONTROL_OFFSET)
        assert all(p + CONTROL_OFFSET < floor for p in ports), (floor, ports)
