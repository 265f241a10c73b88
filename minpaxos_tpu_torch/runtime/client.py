"""Benchmark client library: leader discovery, batched proposes,
failover retry, exactly-once checking.

The port's copy of the JAX package's ``runtime/client.py`` (``Client``
with its event journal of failovers, ``MultiClient``, ``gen_workload``
with its legacy knobs; per-command tracing, workload profiles and the
soak swarm are not carried over). It speaks the same wire protocol, so
it drives a cluster of either package's servers.

Counterpart of the reference's client family:
``client`` (closed-loop rounds, conflict-% / Zipfian keys, -check),
``clientretry`` (outer retry loop that re-dials and adopts any
reachable replica when the leader dies, clientretry.go:120-150), and
the latency/throughput probes (clientlat, clienttot, client-ol-lat)
whose measurement styles the CLI reproduces.

Retry semantics: unacknowledged commands are re-sent with the SAME
cmd_id after failover, and replies are deduplicated by cmd_id — an
explicit upgrade over the reference, which restarts CommandIds from 0
on retry and can observe duplicates (clientretry.go:152). On one
connection a command is sent again only after the server bounced it
(a reply with ok = 0): a server answers every command it holds exactly
once, by a reply or a bounce, and a re-send racing the reply would take
a second slot and bring a second reply.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np

from minpaxos_tpu_torch.obs.metrics import MetricsRegistry
from minpaxos_tpu_torch.obs.watch import EV_CLIENT_FAILOVER, EventJournal
from minpaxos_tpu_torch.runtime.master import (
    backoff_sleeps,
    get_leader,
    get_replica_list,
)
from minpaxos_tpu_torch.utils.dlog import dlog
from minpaxos_tpu_torch.wire.codec import FrameWriter, StreamDecoder
from minpaxos_tpu_torch.wire.messages import MsgKind, Op, make_batch


def gen_workload(n: int, conflict_pct: int = 0, key_range: int = 100000,
                 zipf_s: float = 0.0, write_pct: int = 100,
                 seed: int = 42) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pre-generated request arrays (ops, keys, vals) — the reference
    pre-builds karray/put with conflict-% or Zipfian keys
    (client.go:68-103; seed 42 at :45). The same draws as the JAX
    package's generator for the same arguments."""
    rng = np.random.default_rng(seed)
    if zipf_s > 0:
        keys = (rng.zipf(zipf_s, n) - 1) % key_range
    else:
        keys = rng.integers(0, key_range, n)
        conflicted = rng.integers(0, 100, n) < conflict_pct
        keys = np.where(conflicted, 42, keys)  # all conflicts hit one key
    ops = np.where(rng.integers(0, 100, n) < write_pct,
                   int(Op.PUT), int(Op.GET))
    vals = rng.integers(1, 1 << 20, n)
    return ops.astype(np.int64), keys.astype(np.int64), vals.astype(np.int64)


class Client:
    """One TCP connection to one replica + reply collection thread."""

    # waits in a row that ack nothing on a live connection before the
    # client fails over anyway (a server that holds its commands but no
    # longer answers)
    STALL_WAITS = 3
    # seconds before commands a server bounced are sent again
    BOUNCE_PAUSE_S = 0.05

    def __init__(self, maddr: tuple[str, int], check: bool = False,
                 backoff_seed: int | None = None):
        self.maddr = maddr
        self.check = check
        self.nodes = get_replica_list(maddr)
        self.leader = get_leader(maddr)
        self.sock: socket.socket | None = None
        self.writer: FrameWriter | None = None
        self.replies: dict[int, dict] = {}  # cmd_id -> reply
        self.dup_replies = 0
        self.rejected: list[int] = []
        # cmd_ids sent on this connection and neither answered nor
        # bounced yet: the server holds them
        self._outstanding: set[int] = set()
        # client-side registry: retries and failovers are
        # otherwise invisible in bench artifacts (a trial that quietly
        # failed over twice is not the same measurement as a clean one)
        self.metrics = MetricsRegistry(namespace="client")
        self._c_proposed = self.metrics.counter(
            "proposed_rows", "command rows written to the wire "
            "(> workload size means retries happened)")
        self._c_failovers = self.metrics.counter(
            "failovers", "connection re-routes (leader hint / master "
            "/ scan)")
        self._c_connect_attempts = self.metrics.counter(
            "connect_attempts", "individual replica dials tried during "
            "failovers (>> failovers means the cluster was hard to "
            "reach)")
        self._c_backoff_sleeps = self.metrics.counter(
            "backoff_sleeps", "failover rounds that found NO reachable "
            "replica and slept a jittered exponential backoff")
        # failovers as journal events (which replica the client landed
        # on, -1 for none), mergeable with the cluster's journals
        self.journal = EventJournal(capacity=256)
        # failover backoff (seeded): when no replica answers, sleeps
        # grow 50 ms -> 2 s with U[0.5, 1.0] jitter — a fleet of
        # clients redialing a dead cluster must decorrelate, not arrive
        # as one synchronized storm on revival.
        self._backoff_rng = np.random.default_rng(backoff_seed)
        self._backoff = None  # live generator while a streak lasts
        self.leader_hint = -1
        self._lock = threading.Lock()
        self._got = threading.Condition(self._lock)
        self._reader: threading.Thread | None = None
        self._closed = threading.Event()
        self._ended = threading.Event()
        self._stalls = 0
        # permanent shutdown (unlike _closed, never cleared): a
        # wait_less straggler partition must stop retrying when its
        # MultiClient is closed, not resurrect the connection via
        # _failover under a fresh conn_id (which would sidestep the
        # server's same-connection dedup and duplicate slots)
        self._done = False

    # -- connection management --

    def connect(self, replica: int | None = None) -> None:
        self.close_conn()
        # one event per connection: the reader of a connection that was
        # closed drops whatever still arrives on it, so a failover never
        # hears the abandoned connection's replies (its commands may
        # also commit in the slots the re-proposal takes)
        self._closed = threading.Event()
        self._ended = threading.Event()  # the server ended the connection
        self._stalls = 0
        with self._lock:
            self._outstanding = set()
        rid = self.leader if replica is None else replica
        host, port = self.nodes[rid]
        self.sock = socket.create_connection((host, port), timeout=5.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.sendall(bytes([int(MsgKind.HANDSHAKE_CLIENT)]))
        # the 5 s bounds the connect only: with it left on the socket, a
        # reply stream quiet for 5 s (a cluster healing a revived
        # replica, an idle client) ended the reader thread, and every
        # later reply went unread
        self.sock.settimeout(None)
        self.writer = FrameWriter(self.sock)
        self._reader = threading.Thread(
            target=self._read_loop, args=(self.sock, self._closed, self._ended),
            daemon=True)
        self._reader.start()
        self.connected_to = rid

    def close_conn(self) -> None:
        self._closed.set()
        if self.sock is not None:
            # shutdown wakes the reader blocked in recv: close alone
            # leaves the connection open while that call holds it
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def _read_loop(self, sock: socket.socket, closed: threading.Event,
                   ended: threading.Event) -> None:
        dec = StreamDecoder()
        while not closed.is_set():
            try:
                chunk = sock.recv(1 << 16)
            except OSError:
                break
            if not chunk:
                break
            try:
                for kind, rows in dec.feed(chunk):
                    self._on_frame(kind, rows, closed)
            except ValueError:
                break  # corrupt frame: close and let failover re-dial
            if dec.error is not None:
                break
        if not closed.is_set():
            ended.set()
        with self._got:
            self._got.notify_all()

    def _on_frame(self, kind: MsgKind, rows: np.ndarray,
                  closed: threading.Event) -> None:
        if kind not in (MsgKind.PROPOSE_REPLY, MsgKind.READ_REPLY):
            return
        # t_arrive: reader-thread arrival time (one stamp per frame —
        # the rows arrived together), for the open-loop latency probe
        t = time.monotonic()
        with self._got:
            if closed.is_set():
                return  # the connection was abandoned (see connect)
            # column extraction + zip over plain Python scalars: per-row
            # structured access (r["field"]) cost ~0.8 ms per 512-row
            # frame of pure client CPU on the shared bench core
            if kind == MsgKind.PROPOSE_REPLY:
                okm = rows["ok"] != 0
                rej = rows[~okm]
                if len(rej):
                    self.leader_hint = int(rej["leader"][-1])
                    bounced = rej["cmd_id"].tolist()
                    self.rejected.extend(bounced)
                    self._outstanding.difference_update(bounced)
                    rows = rows[okm]
                replies = self.replies
                cmds = rows["cmd_id"].tolist()
                self._outstanding.difference_update(cmds)
                for cmd, val, ts in zip(cmds, rows["val"].tolist(),
                                        rows["timestamp"].tolist()):
                    if cmd in replies:
                        self.dup_replies += 1  # -check duplicates
                    else:
                        replies[cmd] = {"val": val, "t_arrive": t,
                                        "ts": ts}
            else:
                replies = self.replies
                cmds = rows["cmd_id"].tolist()
                self._outstanding.difference_update(cmds)
                for cmd, val in zip(cmds, rows["val"].tolist()):
                    if cmd in replies:
                        self.dup_replies += 1
                    else:
                        replies[cmd] = {"val": val, "t_arrive": t}
            self._got.notify_all()

    # -- propose / wait --

    def propose(self, cmd_ids, ops, keys, vals) -> None:
        frame = make_batch(MsgKind.PROPOSE, cmd_id=np.asarray(cmd_ids, np.int32),
                           op=np.asarray(ops), key=np.asarray(keys),
                           val=np.asarray(vals),
                           timestamp=time.monotonic_ns())
        with self._lock:
            self._outstanding.update(frame["cmd_id"].tolist())
        self.writer.write(MsgKind.PROPOSE, frame)
        self.writer.flush()
        self._c_proposed.inc(len(frame))

    def read(self, cmd_ids, keys) -> None:
        frame = make_batch(MsgKind.READ, cmd_id=np.asarray(cmd_ids, np.int32),
                           key=np.asarray(keys))
        with self._lock:
            self._outstanding.update(frame["cmd_id"].tolist())
        self.writer.write(MsgKind.READ, frame)
        self.writer.flush()

    def wait(self, cmd_ids, timeout_s: float = 10.0,
             held: bool = False) -> bool:
        """Block until every cmd_id has a success reply (or timeout);
        with ``held``, also return once one of them is no longer held by
        the server (bounced: it must be sent again)."""
        deadline = time.monotonic() + timeout_s
        want = set(int(c) for c in cmd_ids)
        with self._got:
            while True:
                missing = want - self.replies.keys()
                if not missing:
                    return True
                left = deadline - time.monotonic()
                if (left <= 0 or self._closed.is_set()
                        or held and not missing <= self._outstanding):
                    return False
                self._got.wait(timeout=min(left, 0.25))

    # -- the retry driver (clientretry.go:120-150 semantics) --

    def run_workload(self, ops, keys, vals, batch: int = 512,
                     timeout_s: float = 60.0) -> dict:
        """Send everything, retrying unacked commands across failovers
        with the same cmd_ids. Returns stats incl. -check results."""
        n = len(ops)
        t0 = time.monotonic()
        stats = self.run_partition(np.arange(n), ops, keys, vals,
                                   batch=batch, timeout_s=timeout_s)
        wall = time.monotonic() - t0
        done = stats["acked"]
        return {"sent": n, "acked": done, "wall_s": wall,
                "ops_per_s": done / wall if wall > 0 else 0.0,
                "duplicates": stats["duplicates"],
                "missing": n - done,
                "client_metrics": self.metrics.counters()}

    def run_partition(self, idx: np.ndarray, ops, keys, vals,
                      batch: int = 512, timeout_s: float = 60.0) -> dict:
        """run_workload over an explicit cmd_id subset (`idx`), keeping
        the GLOBAL ids — the per-connection driver MultiClient uses."""
        n = len(idx)
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        if self.sock is None:
            self.connect(getattr(self, "connected_to", None))
        # persistent pending list; each loop filters only the HEAD
        # window under the lock (O(batch), so the reader thread is
        # never stalled behind an O(n) scan), and unacked heads are
        # pushed back for retry — an id leaves pending only acked, so
        # commands lost to failover are re-swept without a cursor
        pending = [int(c) for c in idx]
        while pending and not self._done and time.monotonic() < deadline:
            with self._lock:
                head = [c for c in pending[:batch]
                        if c not in self.replies]
                # send what this connection does not hold (see the
                # module's retry semantics)
                fresh = [c for c in head if c not in self._outstanding]
            tail = pending[batch:]
            if not head:
                pending = tail
                continue
            broken = False
            n_bounced = len(self.rejected)
            t_wait = time.monotonic()
            try:
                if fresh:
                    w = np.asarray(fresh)
                    self.propose(w, ops[w], keys[w], vals[w])
                ok = self.wait(head, timeout_s=3.0, held=True)
            except OSError:
                ok, broken = False, True
            if ok:
                self._stalls = 0
                pending = tail
                continue
            # fail over when the connection ended, when a bounce during
            # this wait names another leader, or after STALL_WAITS full
            # waits in a row that acked nothing. A slow but live server
            # keeps the SAME connection: it answers every command it
            # holds there, and re-sending them on a fresh conn_id would
            # commit them twice (a retry storm behind a slow Mencius
            # takeover). A wait a bounce ended early re-sends the bounced
            # commands after a pause (backpressure).
            early = time.monotonic() - t_wait < 3.0
            with self._lock:
                progressed = any(c in self.replies for c in head)
                hint = self.leader_hint
                moved = (len(self.rejected) > n_bounced
                         and 0 <= hint < len(self.nodes)
                         and hint != self.connected_to)
            if not early:
                self._stalls = 0 if progressed else self._stalls + 1
            if (broken or moved or self._ended.is_set()
                    or self._stalls >= self.STALL_WAITS):
                self._failover()
            elif early:
                time.sleep(self.BOUNCE_PAUSE_S)
            pending = head + tail
        with self._lock:
            done = sum(1 for c in idx if int(c) in self.replies)
        return {"sent": n, "acked": done,
                "duplicates": self.dup_replies, "missing": n - done}

    def _failover(self) -> None:
        """Leader died or rejected us: prefer its hint, else ask the
        master, else scan replicas for any that accepts TCP
        (clientretry.go:242-251)."""
        if self._done:
            return
        self._c_failovers.inc()
        candidates: list[int] = []
        if 0 <= self.leader_hint < len(self.nodes):
            candidates.append(self.leader_hint)
        try:
            candidates.append(get_leader(self.maddr, timeout_s=3.0))
        except TimeoutError:
            pass
        candidates.extend(r for r in range(len(self.nodes)))
        for rid in candidates:
            self._c_connect_attempts.inc()
            try:
                self.connect(rid)
                self.leader = rid
                self._backoff = None  # reachable again: reset the streak
                self.journal.record(EV_CLIENT_FAILOVER, subject=rid,
                                    value=self._c_failovers.value)
                dlog(f"client: failed over to replica {rid}")
                return
            except OSError:
                continue
        # nothing reachable: jittered exponential backoff (see __init__)
        self.journal.record(EV_CLIENT_FAILOVER, subject=-1,
                            value=self._c_failovers.value)
        if self._backoff is None:
            self._backoff = backoff_sleeps(0.05, 2.0, self._backoff_rng)
        self._c_backoff_sleeps.inc()
        time.sleep(next(self._backoff))


class MultiClient:
    """One connection per replica: the reference client's multi-target
    send modes (client.go:19-31, send paths :148-209).

    * ``mode="rr"`` — leaderless round-robin (`-e`): command i goes to
      replica i % N on that replica's own connection. This is the
      natural Mencius driver — every owner serves proposals into its
      own slots concurrently, which is the whole point of the
      protocol; a single hinted proposer makes the other owners cede
      every slot.
    * ``mode="fast"`` — fast mode (`-f`): every command goes to ALL
      replicas; the first success reply on any connection wins.
      Non-leaders reject (MinPaxos/classic), so exactly one success
      arrives per command; with -check, per-connection reply books
      keep rejections from counting as duplicates. Not meaningful for
      Mencius (each owner would commit the command into its own slot
      = N× execution).

    Exactly-once bookkeeping is per connection (the server replies on
    the proposing connection only), so sub-clients never see each
    other's replies; stats aggregate across them.
    """

    def __init__(self, maddr: tuple[str, int], check: bool = False,
                 mode: str = "rr", bar_one: bool = False,
                 wait_less: bool = False):
        """``bar_one``: send to all replicas except the LAST (reference
        clienttot -barOne, clienttot/client.go:31, :76-78 — the
        excluded replica still learns/executes via the protocol, it
        just serves no proposals). ``wait_less``: in rr mode, stop
        waiting once all but one partition finished (clienttot
        -waitLess, :32, :191-199 — tolerate one straggler replica's
        batch; its partition keeps draining in the background)."""
        assert mode in ("rr", "fast")
        self.mode = mode
        self.wait_less = wait_less
        self.nodes = get_replica_list(maddr)
        self.clients: list[Client] = []
        n_targets = len(self.nodes) - 1 if bar_one else len(self.nodes)
        assert n_targets >= 1, "-barOne needs at least 2 replicas"
        for rid in range(n_targets):
            c = Client(maddr, check=check)
            c.connect(rid)
            self.clients.append(c)

    def run_workload(self, ops, keys, vals, batch: int = 512,
                     timeout_s: float = 60.0) -> dict:
        n = len(ops)
        t0 = time.monotonic()
        if self.mode == "rr":
            parts = [np.arange(n)[np.arange(n) % len(self.clients) == r]
                     for r in range(len(self.clients))]
            results: list[dict | None] = [None] * len(self.clients)

            def drive(r):
                results[r] = self.clients[r].run_partition(
                    parts[r], ops, keys, vals, batch=batch,
                    timeout_s=timeout_s)

            threads = [threading.Thread(target=drive, args=(r,),
                                        daemon=True)
                       for r in range(len(self.clients))]
            for t in threads:
                t.start()
            if self.wait_less and len(threads) > 1:
                # stop waiting once all but one partition finished
                # (clienttot -waitLess): poll results, leave the
                # straggler's daemon thread draining. Count acks from
                # the reply books, not per-thread results — the
                # straggler HAS acked most of its partition by now and
                # those are real commits
                deadline = time.monotonic() + timeout_s + 10
                while (sum(r is not None for r in results)
                       < len(threads) - 1
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                # stop the straggler (bounded): a partition thread left
                # proposing into the next -r round's reused cmd_id
                # space would corrupt its ack counts and -check
                for r, res in enumerate(results):
                    if res is None:
                        self.clients[r]._done = True
                for t in threads:
                    t.join(timeout=4.0)
                # re-arm ONLY clients whose thread actually exited: a
                # straggler still inside a blocking failover after the
                # bounded join would resume proposing into the next
                # round's reused cmd_id space if its _done were cleared
                for c, t in zip(self.clients, threads):
                    if not t.is_alive():
                        c._done = False
                done = sum(len(c.replies) for c in self.clients)
                dups = sum(c.dup_replies for c in self.clients)
            else:
                for t in threads:
                    t.join(timeout=timeout_s + 10)
                done = sum(r["acked"] for r in results if r)
                dups = sum(r["duplicates"] for r in results if r)
        else:  # fast: fan out to all, first success wins
            deadline = t0 + timeout_s
            for lo in range(0, n, batch):
                idx = np.arange(lo, min(lo + batch, n))
                for c in self.clients:
                    try:
                        c.propose(idx, ops[idx], keys[idx], vals[idx])
                    except OSError:
                        # dead connection: re-dial the SAME replica (fast
                        # mode offers every command to every replica, so
                        # failing over elsewhere would double-offer) and
                        # retry once; if the replica itself is down the
                        # others cover
                        try:
                            c.connect(c.connected_to)
                            c.propose(idx, ops[idx], keys[idx], vals[idx])
                        except OSError:
                            pass
                while time.monotonic() < deadline:
                    if all(any(int(i) in c.replies for c in self.clients)
                           for i in idx):
                        break
                    time.sleep(0.002)
            done = sum(1 for i in range(n)
                       if any(i in c.replies for c in self.clients))
            # a duplicate = the SAME connection receiving two success
            # replies for one cmd (cross-connection replies are the
            # mode's design, not duplicates)
            dups = sum(c.dup_replies for c in self.clients)
        wall = time.monotonic() - t0
        cm: dict = {}
        for c in self.clients:  # summed across the per-replica conns
            for name, v in c.metrics.counters().items():
                cm[name] = cm.get(name, 0) + v
        return {"sent": n, "acked": done, "wall_s": wall,
                "ops_per_s": done / wall if wall > 0 else 0.0,
                "duplicates": dups, "missing": n - done,
                "client_metrics": cm}

    def close(self) -> None:
        for c in self.clients:
            c._done = True  # stragglers must not resurrect via failover
            c.close_conn()
