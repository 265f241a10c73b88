"""Cluster master: registration, liveness pings, leader election.

The port's copy of the JAX package's ``runtime/master.py``, with its
``stats``, ``chaos`` and ``events`` fan-outs (the ``phase``, ``trace``
and ``tracespans`` fan-outs are not carried over).

Counterpart of reference src/master/master.go: collect N registrations
(master.go:114-152), declare an initial leader (:79), ping every
replica on a 3s loop (:81-97), and on leader death promote a live
replica via its BeTheLeader control RPC (:101-110). Clients ask it
GetLeader / GetReplicaList (:154-176).

Differences, both deliberate:
* JSON-lines over TCP instead of Go net/rpc-over-HTTP — same control
  semantics, no data-path involvement.
* Election picks the alive replica with the HIGHEST committed frontier
  (the pings carry it), not merely the first alive one — a laggard
  leader beyond the others' retained windows would wedge the cluster
  (models/minpaxos.py window-slide LIMIT note); the reference's
  first-alive choice has the same hazard and simply never hits it at
  its scale.
"""

from __future__ import annotations

import json
import socket
import threading
import time

from minpaxos_tpu_torch.utils.dlog import dlog
from minpaxos_tpu_torch.utils.netutil import CONTROL_OFFSET


def _rpc(addr: tuple[str, int], req: dict, timeout: float = 2.0) -> dict:
    with socket.create_connection(addr, timeout=timeout) as s:
        f = s.makefile("rw")
        f.write(json.dumps(req) + "\n")
        f.flush()
        line = f.readline()
    if not line:
        raise OSError("empty rpc reply")
    return json.loads(line)


class Master:
    # A replica whose control port does not answer is declared dead only
    # after MISS_LIMIT pings in a row, and one that has not answered
    # since the membership completed only after BOOT_GRACE_S: a replica
    # registers before it builds its device state (a CUDA context and
    # the step's first launches take seconds), and promoting another
    # replica then, while the booting replica 0 runs its own boot
    # election, set up two leaders deposing each other. A replica that
    # answers ok=False (fail-stopped) is dead at once.
    MISS_LIMIT = 3
    BOOT_GRACE_S = 60.0

    def __init__(self, host: str, port: int, n_replicas: int,
                 ping_s: float = 1.0):
        self.addr = (host, port)
        self.n = n_replicas
        self.ping_s = ping_s
        self.nodes: list[tuple[str, int]] = []  # data-port addrs by id
        self.alive: list[bool] = []
        self.frontiers: list[int] = []
        self._misses: list[int] = []  # unanswered pings in a row
        self._seen: list[bool] = []   # answered at least once
        self._full_at = 0.0           # monotonic time the membership completed
        self.leader = -1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock: socket.socket | None = None

    # -- lifecycle --

    def start(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(self.addr)
        s.listen(64)
        self._sock = s
        threading.Thread(target=self._serve, daemon=True).start()
        threading.Thread(target=self._ping_loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    # -- RPC service --

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,),
                             daemon=True).start()

    def _conn(self, conn) -> None:
        f = conn.makefile("rw")
        try:
            for line in f:
                try:
                    req = json.loads(line)
                except json.JSONDecodeError:
                    break
                f.write(json.dumps(self._handle(req)) + "\n")
                f.flush()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, req: dict) -> dict:
        m = req.get("m")
        if m in ("stats", "chaos", "events"):
            # the fan-out polls every replica's control socket, so it
            # must NOT run under the membership lock — one slow
            # replica's 2 s control timeout would stall the ping loop
            # and every registration behind it
            return self._observe(m, req)
        with self._lock:
            if m == "register":
                addr = (req["addr"], int(req["port"]))
                if addr in self.nodes:
                    rid = self.nodes.index(addr)
                else:
                    if len(self.nodes) >= self.n:
                        return {"ok": False, "error": "cluster full"}
                    self.nodes.append(addr)
                    self.alive.append(True)
                    self.frontiers.append(-1)
                    self._misses.append(0)
                    self._seen.append(False)
                    rid = len(self.nodes) - 1
                    if len(self.nodes) == self.n and self.leader < 0:
                        self.leader = 0  # initial leader (master.go:79)
                        self._full_at = time.monotonic()
                return {"ok": True, "id": rid, "n": self.n,
                        "ready": len(self.nodes) == self.n}
            if m == "get_replica_list":
                # reference blocks until all registered (master.go:165)
                return {"ok": len(self.nodes) == self.n,
                        "nodes": [list(a) for a in self.nodes]}
            if m == "get_leader":
                if self.leader < 0:
                    return {"ok": False}
                host, port = self.nodes[self.leader]
                return {"ok": True, "leader": self.leader,
                        "addr": host, "port": port}
            return {"ok": False, "error": f"unknown method {m}"}

    # -- cluster-wide STATS / CHAOS / EVENTS fan-out --

    def _observe(self, m: str, req: dict) -> dict:
        """Forward the replica-level ``stats``, ``chaos`` or ``events``
        verb to every registered replica and merge the answers: a chaos
        campaign flips a cluster-wide fault plan this way (every replica
        installs the same plan and enforces its own slice). A dead
        replica contributes an error stanza, never a fan-out failure.
        Membership is copied under the lock; the per-replica RPCs run
        outside it (they block up to their timeout), one poller thread
        per replica."""
        with self._lock:
            nodes = list(enumerate(self.nodes))
            leader = self.leader
            alive = list(self.alive)
        if m == "chaos":
            sub = {"m": "chaos", "op": req.get("op", "status"),
                   "plan": req.get("plan")}
        else:
            sub = {"m": m}
        timeout = 2.0
        slots: list[dict | None] = [None] * len(nodes)

        def poll(i, rid, host, port):
            try:
                r = _rpc((host, port + CONTROL_OFFSET), sub,
                         timeout=timeout)
            except (OSError, ValueError, json.JSONDecodeError) as e:
                r = {"ok": False, "error": repr(e)[:120]}
            r.setdefault("id", rid)
            slots[i] = r  # last write: a non-None slot is fully built

        pollers = [threading.Thread(target=poll,
                                    args=(i, rid, host, port), daemon=True)
                   for i, (rid, (host, port)) in enumerate(nodes)]
        for t in pollers:
            t.start()
        for t in pollers:
            t.join(timeout=timeout + 2.0)
        replicas = [r if r is not None else
                    {"ok": False, "id": nodes[i][0],
                     "error": "control rpc timed out"}
                    for i, r in enumerate(slots)]
        out = {"ok": True, "leader": leader, "alive": alive,
               "n": self.n, "replicas": replicas}
        if m == "chaos" and sub["op"] in ("install", "clear"):
            # a partial install or clear (half the cluster faulted, and
            # the campaign thinks it healed) is ok only if every one of
            # the n replicas acknowledged; a read-only status keeps the
            # dead-replica-tolerant contract above
            out["ok"] = (len(replicas) == self.n
                         and all(bool(r.get("ok")) for r in replicas))
        return out

    # -- liveness + election (master.go:81-111) --

    def _ping_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.ping_s)
            with self._lock:
                nodes = list(enumerate(self.nodes))
                leader = self.leader
            if not nodes:
                continue
            views: dict[int, int] = {}  # rid -> that replica's leader view
            for rid, (host, port) in nodes:
                answered = True
                try:
                    resp = _rpc((host, port + CONTROL_OFFSET), {"m": "ping"},
                                timeout=1.0)
                    ok = bool(resp.get("ok"))
                    fr = int(resp.get("frontier", -1))
                    views[rid] = int(resp.get("leader", -1))
                except (OSError, json.JSONDecodeError):
                    ok, fr, answered = False, -1, False
                with self._lock:
                    if answered:
                        self._seen[rid] = True
                        self._misses[rid] = 0
                        self.alive[rid] = ok
                    else:
                        self._misses[rid] += 1
                        booting = (not self._seen[rid] and time.monotonic()
                                   - self._full_at < self.BOOT_GRACE_S)
                        self.alive[rid] = booting or (
                            self._seen[rid]
                            and self._misses[rid] < self.MISS_LIMIT)
                    if ok:
                        self.frontiers[rid] = fr
            # Adopt the leader a MAJORITY of replicas report when it
            # differs from our belief: the protocol can move the
            # leadership without us (a deposal election after a
            # spurious promotion under load), and a stale GetLeader
            # answer strands clients on a rejecting non-leader. The
            # reference master has the same staleness (its GetLeader
            # returns its own belief, master.go:154-163); here the
            # pings already carry each replica's live view, so honesty
            # is one majority vote away. Mencius replicas report -1
            # (leaderless) and never trigger adoption.
            with self._lock:
                tally: dict[int, int] = {}
                for rid, v in views.items():
                    if self.alive[rid] and 0 <= v < len(self.nodes):
                        tally[v] = tally.get(v, 0) + 1
                if tally:
                    top, cnt = max(tally.items(), key=lambda kv: kv[1])
                    if (cnt >= self.n // 2 + 1 and top != self.leader
                            and self.alive[top]):
                        dlog(f"master: adopting protocol leader {top} "
                             f"(was {self.leader})")
                        self.leader = top
                # the election branch below must see the adoption: its
                # stale local would otherwise treat the DEAD old leader
                # as current and fire a spurious be_the_leader that
                # deposes the leader just adopted
                leader = self.leader
            with self._lock:
                leader_dead = (0 <= leader < len(self.alive)
                               and not self.alive[leader])
                if leader_dead:
                    cand = [(self.frontiers[r], -r) for r in range(len(self.nodes))
                            if self.alive[r]]
                    if not cand:
                        continue
                    _, neg = max(cand)
                    new_leader = -neg
                    host, port = self.nodes[new_leader]
                else:
                    continue
            dlog(f"master: leader {leader} dead -> promoting {new_leader}")
            # commit the promotion only once the be_the_leader RPC
            # lands — recording it first and swallowing a failed RPC
            # would wedge the cluster on a phantom leader (the promoted
            # replica never elects, yet answers pings, so leader_dead
            # stays false forever); on failure the next ping round
            # re-elects
            try:
                _rpc((host, port + CONTROL_OFFSET), {"m": "be_the_leader"}, timeout=2.0)
            except (OSError, json.JSONDecodeError):
                continue
            with self._lock:
                if self.leader == leader:  # no concurrent re-election
                    self.leader = new_leader


def backoff_sleeps(base_s: float, cap_s: float, rng) -> "Iterator[float]":
    """Bounded exponential backoff with jitter: base*2^i capped at
    ``cap_s``, each scaled by a U[0.5, 1.0] draw from ``rng``. Seeding
    ``rng`` differently per caller decorrelates redials — N replicas
    (or a client fleet) hammering a dead master must not fall into
    lockstep and arrive as one synchronized storm when it revives."""
    i = 0
    while True:
        yield min(base_s * (2 ** i), cap_s) * (0.5 + 0.5 * float(rng.random()))
        i += 1


def register_with_master(maddr: tuple[str, int], my_host: str, my_port: int,
                         retry_s: float = 0.25, timeout_s: float = 60.0,
                         seed: int | None = None) -> int:
    """Server-side registration retry loop (server.go:91-108). Returns
    the assigned replica id once the full membership is known. Retries
    back off exponentially (jittered, seeded by ``seed`` or the
    caller's port so concurrent registrants decorrelate) instead of
    the old fixed 0.5 s cadence."""
    import numpy as _np

    rng = _np.random.default_rng(my_port if seed is None else seed)
    sleeps = backoff_sleeps(retry_s, 3.0, rng)
    deadline = time.monotonic() + timeout_s
    rid = None
    while time.monotonic() < deadline:
        try:
            resp = _rpc(maddr, {"m": "register",
                                "addr": my_host, "port": my_port})
            if resp.get("ok"):
                rid = int(resp["id"])
                if resp.get("ready"):
                    return rid
            # reachable master, membership not complete yet: this is a
            # readiness poll, not a failure — base cadence, streak reset
            sleeps = backoff_sleeps(retry_s, 3.0, rng)
            sleep_s = retry_s
        except (OSError, json.JSONDecodeError):
            sleep_s = next(sleeps)
        time.sleep(min(sleep_s, max(deadline - time.monotonic(), 0.05)))
    if rid is not None:
        return rid
    raise TimeoutError("could not register with master")


def get_replica_list(maddr: tuple[str, int],
                     timeout_s: float = 60.0) -> list[tuple[str, int]]:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            resp = _rpc(maddr, {"m": "get_replica_list"})
            if resp.get("ok"):
                return [tuple(a) for a in resp["nodes"]]
        except (OSError, json.JSONDecodeError):
            pass
        time.sleep(0.3)
    raise TimeoutError("replica list never completed")


def cluster_stats(maddr: tuple[str, int], timeout_s: float = 15.0) -> dict:
    """One-shot cluster metrics snapshot via the master's ``stats``
    fan-out."""
    return _rpc(maddr, {"m": "stats"}, timeout=timeout_s)


def cluster_chaos(maddr: tuple[str, int], op: str = "status",
                  plan: dict | None = None,
                  timeout_s: float = 15.0) -> dict:
    """Install / clear / query a fault plan (``FaultPlan.to_dict()``) on
    every replica of a live cluster through the master. ``ok`` is True
    only when every replica acknowledged an install or a clear."""
    return _rpc(maddr, {"m": "chaos", "op": op, "plan": plan},
                timeout=timeout_s)


def cluster_events(maddr: tuple[str, int],
                   timeout_s: float = 15.0) -> dict:
    """Every replica's event-journal collection, each with its (mono,
    wall) clock anchor; ``obs.watch.align_event_collections`` merges
    them into one cluster timeline."""
    return _rpc(maddr, {"m": "events"}, timeout=timeout_s)


def get_leader(maddr: tuple[str, int], timeout_s: float = 60.0) -> int:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            resp = _rpc(maddr, {"m": "get_leader"})
            if resp.get("ok"):
                return int(resp["leader"])
        except (OSError, json.JSONDecodeError):
            pass
        time.sleep(0.3)
    raise TimeoutError("no leader known")
