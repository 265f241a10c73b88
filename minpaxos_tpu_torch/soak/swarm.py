"""OpenLoopSwarm — ClientSwarm's selector loop, sharded across worker
processes, driven by an open-loop arrival schedule.

ClientSwarm (runtime/client.py) drives up to ~1k closed-loop sessions
from ONE ``selectors`` loop; beyond that the single Python thread is
the bottleneck, and closed loops can't produce overload at all (each
session waits for its ack, so offered load collapses to the service
rate). This module shards the loop: each **shard** is a worker
process owning ``sessions/shards`` real TCP connections to the leader
and injecting commands on a seeded open-loop schedule
(soak/profiles.py) — a command is sent when its arrival time comes
due, regardless of what's outstanding, so a slow cluster faces a
growing backlog exactly like production ingress. When the injector
falls behind (single-core hosts under burst), all due arrivals go out
immediately as multi-row frames — offered load is conserved, it just
arrives clumpier, which is precisely the shape the ingress coalescer
and admission gate exist for.

Exactly-once accounting is per shard and merges at the driver: every
injected command id is unique (per-shard monotonic counter, never
reused across phases — the server's same-connection dedup is keyed by
cmd_id forever), an ack moves it from ``outstanding`` to ``acked``,
late retransmit echoes of acked commands count as ``duplicates``
(absorbed, not double-counted), and anything still outstanding after
the final drain is ``lost`` — the number that must be 0.

Workers import numpy + stdlib + the wire codec + the master's RPC
helpers + obs.trace only (never torch); they are started with the
``spawn`` context so nothing of the parent's torch or CUDA state leaks
in, and with spawn pointed at this module, not at the parent's
``__main__`` (a script that imports torch would otherwise load it in
every worker). The port's copy of the JAX package's ``soak/swarm.py``.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import selectors
import socket
import sys
import time

import numpy as np

from minpaxos_tpu_torch.obs.trace import (
    ST_REPLY_RECV,
    ST_SEND,
    TraceSink,
    monotonic_ns,
    trace_id_for,
)
from minpaxos_tpu_torch.soak.profiles import (
    ArrivalSpec,
    WorkloadProfile,
    arrival_times,
    profile_rows,
    resolve_profile,
)
from minpaxos_tpu_torch.wire.codec import FrameWriter, StreamDecoder
from minpaxos_tpu_torch.wire.messages import MsgKind, make_batch

#: consecutive arrivals share a session in blocks of 2**SESSION_BLOCK_POW2
#: — under load, due arrivals then batch into multi-row frames per
#: session instead of one syscall each, without giving up multiplexed
#: ingress (blocks rotate round-robin across every session).
SESSION_BLOCK_POW2 = 3

#: per-shard, per-phase latency reservoir bound (first-ack latencies).
#: Beyond this, seeded reservoir sampling keeps a uniform subsample —
#: a week-long phase must not grow an unbounded list.
LAT_RESERVOIR = 1 << 16

#: retransmit backoff: attempt k waits retransmit_s * 2**min(k, CAP)
#: since the last send. Without this, every kernel reject (window
#: full, stale leader) re-offered instantly and the swarm's own
#: retransmits became a self-sustaining flood that starved the
#: cluster it was measuring (observed: a 12 s burst's rejects
#: amplified into ~10 kHz of retransmit traffic, peer connections
#: flapped, and the post-burst cluster never recovered).
BACKOFF_CAP_POW2 = 3

#: this many rejects with no intervening ack = the shard's sessions
#: are probably pointed at a deposed leader; re-ask the master.
REJECT_STREAK_FAILOVER = 512


class _Shard:
    """One worker's engine: N blocking sockets + one selectors loop +
    the open-loop injector. Lives entirely inside the worker process;
    the parent talks to it over a Pipe (see ``_shard_main``)."""

    def __init__(self, shard_id: int, maddr: tuple[str, int],
                 sessions: int, retransmit_s: float,
                 trace_pow2: int | None):
        # imported here so the PARENT process can build OpenLoopSwarm
        # without the runtime package; workers resolve the cluster
        # themselves through the master like every other client
        from minpaxos_tpu_torch.runtime.master import (get_leader,
                                                       get_replica_list)
        self._get_leader = get_leader
        self.shard_id = shard_id
        self.maddr = maddr
        self.sessions = sessions
        self.retransmit_s = retransmit_s
        self.nodes = get_replica_list(maddr)
        self.leader = get_leader(maddr)
        self.trace = (None if trace_pow2 is None else
                      TraceSink(enabled=True, sample_pow2=trace_pow2))
        self.sel = selectors.DefaultSelector()
        self.states: list[dict] = []
        self.live_ids: list[int] = []
        self.next_cmd = 0  # NEVER reused across phases (server dedup)
        # cmd -> [sid, t_sched, t_last_send, op, key, val, attempts]
        self.outstanding: dict[int, list] = {}
        self.acked: set[int] = set()
        self.duplicates = 0
        self.dead_sessions = 0
        self.sent_unique = 0
        self._res_rng = np.random.default_rng(0x50AC + shard_id)
        self._reject_streak = 0
        self._last_leader_check = 0.0
        self._connect_all()

    def _connect_all(self) -> None:
        """(Re)connect every session to the current leader."""
        for st in self.states:
            if not st["dead"]:
                try:
                    self.sel.unregister(st["sock"])
                except (KeyError, ValueError):
                    pass
                try:
                    st["sock"].close()
                except OSError:
                    pass
        self.states, self.live_ids = [], []
        host, port = self.nodes[self.leader]
        for s in range(self.sessions):
            st = {"sock": None, "writer": None,
                  "dec": StreamDecoder(), "dead": True, "sid": s}
            try:
                sock = socket.create_connection((host, port),
                                                timeout=10.0)
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
                sock.sendall(bytes([int(MsgKind.HANDSHAKE_CLIENT)]))
                st.update(sock=sock, writer=FrameWriter(sock),
                          dead=False)
                self.sel.register(sock, selectors.EVENT_READ, st)
                self.live_ids.append(s)
            except OSError:
                self.dead_sessions += 1
            self.states.append(st)
        if not self.live_ids:
            raise OSError(f"shard {self.shard_id}: no session could "
                          f"reach leader {self.leader} at {host}:{port}")

    def _maybe_failover(self, now: float) -> None:
        """A long run of rejects with no ack usually means the leader
        moved (a deposed leader keeps answering, with ok=0) — re-ask
        the master and reconnect the whole shard if it did. The
        server's dedup window is per connection, so a retransmit on
        the new connection may re-execute a command the old leader
        already committed; the extra reply lands in ``duplicates``
        (same books as any other retransmit echo)."""
        if self._reject_streak < REJECT_STREAK_FAILOVER:
            return
        if now - self._last_leader_check < 2.0:
            return
        self._last_leader_check = now
        try:
            leader = self._get_leader(self.maddr)
        except (OSError, ValueError):
            return
        if leader == self.leader and all(not st["dead"]
                                         for st in self.states):
            return
        self.leader = leader
        self._connect_all()
        self._reject_streak = 0

    # ------------------------------------------------------ sending

    def _write_rows(self, st: dict, cmds: list[int],
                    rows: list[list]) -> None:
        """One PROPOSE frame (+ TRACE_CTX for sampled ids) carrying
        every due command assigned to this session."""
        cmd_arr = np.asarray(cmds, np.int32)
        frame = make_batch(
            MsgKind.PROPOSE, cmd_id=cmd_arr,
            op=np.asarray([r[3] for r in rows], np.int64),
            key=np.asarray([r[4] for r in rows], np.int64),
            val=np.asarray([r[5] for r in rows], np.int64),
            timestamp=time.monotonic_ns())
        tr = self.trace
        if tr is not None:
            m = tr.sampled(frame["cmd_id"])
            if m.any():
                ids = frame["cmd_id"][m]
                t_s0 = monotonic_ns()
                ctx = make_batch(MsgKind.TRACE_CTX, cmd_id=ids,
                                 trace_id=trace_id_for(ids),
                                 origin_wall_ns=time.time_ns())
                st["writer"].write(MsgKind.TRACE_CTX, ctx)
                st["writer"].write(MsgKind.PROPOSE, frame)
                st["writer"].flush()
                t_s1 = monotonic_ns()
                ring = tr.ring()
                for tid, cid in zip(ctx["trace_id"].tolist(),
                                    ctx["cmd_id"].tolist()):
                    ring.record(tid, ST_SEND, t_s0, t_s1, cid)
                return
        st["writer"].write(MsgKind.PROPOSE, frame)
        st["writer"].flush()

    def _kill_session(self, st: dict) -> None:
        if st["dead"]:
            return
        st["dead"] = True
        self.dead_sessions += 1
        try:
            self.sel.unregister(st["sock"])
        except (KeyError, ValueError):
            pass
        try:
            st["sock"].close()
        except OSError:
            pass
        if st["sid"] in self.live_ids:
            self.live_ids.remove(st["sid"])

    def _session_for(self, cmd: int) -> dict | None:
        """Block-round-robin home session for a command, skipping dead
        sessions (their outstanding commands re-home on retransmit)."""
        if not self.live_ids:
            return None
        sid = (cmd >> SESSION_BLOCK_POW2) % self.sessions
        st = self.states[sid]
        if st["dead"]:
            st = self.states[self.live_ids[sid % len(self.live_ids)]]
        return st

    def _flush_due(self, due: list[int]) -> int:
        """Group due commands by home session, one frame per session.
        Returns frames written."""
        by_sid: dict[int, tuple[dict, list, list]] = {}
        for cmd in due:
            st = self._session_for(cmd)
            if st is None:
                continue
            ent = self.outstanding[cmd]
            ent[0] = st["sid"]
            ent[2] = time.monotonic()
            b = by_sid.setdefault(st["sid"], (st, [], []))
            b[1].append(cmd)
            b[2].append(ent)
        frames = 0
        for st, cmds, rows in by_sid.values():
            try:
                self._write_rows(st, cmds, rows)
                frames += 1
            except OSError:
                self._kill_session(st)
                for c in cmds:  # re-home on the retransmit sweep
                    self.outstanding[c][2] = 0.0
        return frames

    # ----------------------------------------------------- receiving

    def _drain_events(self, events, lats: list[float],
                      counters: dict) -> None:
        now = time.monotonic()
        t_ns = monotonic_ns()
        for key, _ in events:
            st = key.data
            try:
                chunk = st["sock"].recv(1 << 16)
            except OSError:
                chunk = b""
            if not chunk:
                self._kill_session(st)
                continue
            for kind, rows in st["dec"].feed(chunk):
                if kind != MsgKind.PROPOSE_REPLY:
                    continue
                if self.trace is not None and len(rows):
                    self.trace.stamp_batch(ST_REPLY_RECV,
                                           rows["cmd_id"], t_ns, t_ns)
                for r in range(len(rows)):
                    cmd = int(rows["cmd_id"][r])
                    ent = self.outstanding.get(cmd)
                    if ent is None:
                        if cmd in self.acked:
                            # retransmit echo after the first ack: the
                            # server absorbed the duplicate execution,
                            # we absorb the duplicate reply
                            self.duplicates += 1
                            counters["duplicates"] += 1
                        continue
                    if int(rows["ok"][r]) == 0:
                        # the cluster said no (admission shed, window
                        # full, stale leader): back off, never
                        # re-offer instantly — instant re-offers turn
                        # rejects into a self-sustaining flood
                        counters["rejects"] += 1
                        ent[6] += 1
                        self._reject_streak += 1
                        continue
                    lat = (now - ent[1]) * 1e3
                    if len(lats) < LAT_RESERVOIR:
                        lats.append(lat)
                    else:  # seeded uniform reservoir replacement
                        counters["lat_overflow"] += 1
                        j = int(self._res_rng.integers(
                            0, counters["acked"] + 1))
                        if j < LAT_RESERVOIR:
                            lats[j] = lat
                    counters["acked"] += 1
                    self.acked.add(cmd)
                    del self.outstanding[cmd]
                    self._reject_streak = 0

    def _sweep_retransmits(self, now: float, counters: dict) -> None:
        rs = self.retransmit_s
        stale = [(c, e) for c, e in self.outstanding.items()
                 if now - e[2] > rs * (1 << min(e[6], BACKOFF_CAP_POW2))]
        if not stale:
            return
        by_sid: dict[int, tuple[dict, list, list]] = {}
        for cmd, ent in stale:
            st = self.states[ent[0]]
            if st["dead"]:
                home = self._session_for(cmd)
                if home is None:
                    continue
                st = home
                ent[0] = st["sid"]
            ent[2] = now
            ent[6] += 1
            b = by_sid.setdefault(st["sid"], (st, [], []))
            b[1].append(cmd)
            b[2].append(ent)
        for st, cmds, rows in by_sid.values():
            try:
                self._write_rows(st, cmds, rows)
                counters["retransmits"] += len(cmds)
            except OSError:
                self._kill_session(st)
                for c in cmds:
                    self.outstanding[c][2] = 0.0

    # -------------------------------------------------------- phases

    def run_phase(self, profile: WorkloadProfile, arrival: ArrivalSpec,
                  seed: int) -> dict:
        """Inject one phase's open-loop schedule and service replies
        until the phase clock runs out. Outstanding commands carry
        over (the next phase's traffic piles on top — that is the
        soak, not a bug); ``drain()`` settles them at scenario end."""
        offs, ops, keys, vals = shard_phase(profile, arrival, seed)
        n = len(offs)
        ops_l, keys_l, vals_l = (ops.tolist(), keys.tolist(),
                                 vals.tolist())
        base = self.next_cmd
        self.next_cmd += n
        self.sent_unique += n
        lats: list[float] = []
        counters = {"acked": 0, "retransmits": 0, "rejects": 0,
                    "duplicates": 0, "lat_overflow": 0}
        t0 = time.monotonic()
        sched = t0 + offs  # absolute deadlines, float64 array
        send_i = 0
        end = t0 + arrival.duration_s
        behind_max = 0.0
        while True:
            now = time.monotonic()
            if now >= end and send_i >= n:
                break
            # deadline-based injection: everything due goes NOW, as
            # one frame per home session — late injection batches up.
            # A command enters ``outstanding`` only here (never
            # earlier), so the retransmit sweep can't see un-injected
            # futures
            if send_i < n and sched[send_i] <= now:
                j = int(np.searchsorted(sched, now, side="right"))
                due = list(range(base + send_i, base + j))
                behind_max = max(behind_max, now - sched[send_i])
                for cmd in due:
                    k = cmd - base
                    self.outstanding[cmd] = [
                        -1, sched[k], 0.0, ops_l[k], keys_l[k],
                        vals_l[k], 0]
                self._flush_due(due)
                send_i = j
            nxt = sched[send_i] if send_i < n else end
            wait = min(0.05, max(nxt - time.monotonic(), 0.0))
            events = self.sel.select(timeout=wait)
            self._drain_events(events, lats, counters)
            now = time.monotonic()
            self._sweep_retransmits(now, counters)
            self._maybe_failover(now)
        return {"shard": self.shard_id, "sent": n,
                "acked": counters["acked"],
                "retransmits": counters["retransmits"],
                "rejects": counters["rejects"],
                "duplicates": counters["duplicates"],
                "lat_overflow": counters["lat_overflow"],
                "lat_ms": lats, "behind_max_s": behind_max,
                "outstanding": len(self.outstanding),
                "dead_sessions": self.dead_sessions,
                "wall_s": time.monotonic() - t0}

    def drain(self, timeout_s: float) -> dict:
        """Retransmit until nothing is outstanding (or timeout): the
        scenario's settle phase, where exactly-once gets decided."""
        lats: list[float] = []
        counters = {"acked": 0, "retransmits": 0, "rejects": 0,
                    "duplicates": 0, "lat_overflow": 0}
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        while self.outstanding and time.monotonic() < deadline:
            events = self.sel.select(timeout=0.05)
            self._drain_events(events, lats, counters)
            now = time.monotonic()
            self._sweep_retransmits(now, counters)
            self._maybe_failover(now)
        return {"shard": self.shard_id, "sent": 0,
                "acked": counters["acked"],
                "retransmits": counters["retransmits"],
                "rejects": counters["rejects"],
                "duplicates": counters["duplicates"],
                "lat_overflow": counters["lat_overflow"],
                "lat_ms": lats, "behind_max_s": 0.0,
                "outstanding": len(self.outstanding),
                "dead_sessions": self.dead_sessions,
                "wall_s": time.monotonic() - t0}

    def final(self) -> dict:
        out = {"shard": self.shard_id, "sent_unique": self.sent_unique,
               "acked_unique": len(self.acked),
               "lost": len(self.outstanding),
               "duplicates": self.duplicates,
               "dead_sessions": self.dead_sessions,
               "trace": (None if self.trace is None
                         else self.trace.collect())}
        for st in self.states:
            if not st["dead"]:
                try:
                    st["sock"].close()
                except OSError:
                    pass
        self.sel.close()
        return out


def shard_phase(profile: WorkloadProfile, arrival: ArrivalSpec,
                seed: int) -> tuple[np.ndarray, ...]:
    """One shard's phase: its arrival offsets and, row for row, the
    commands it injects ``(offs, ops, keys, vals)``; row j goes out as
    cmd_id ``base + j``, ``base`` the shard's count of commands of
    earlier phases."""
    offs = arrival_times(arrival, seed)
    return (offs, *profile_rows(profile, len(offs), seed ^ 0x9E3779B9))


def _shard_specs(arrival: ArrivalSpec, seed: int,
                 shards: int) -> list[tuple[ArrivalSpec, int]]:
    """Each shard's arrival spec and seed: the SAME envelope at
    ``rate_hz / shards`` (the aggregate offered load matches the
    spec); per-shard seeds decorrelate the Poisson streams while
    keeping the whole schedule a pure function of (seed, shards)."""
    arr = ArrivalSpec.from_dict(
        {**arrival.to_dict(), "rate_hz": arrival.rate_hz / shards})
    return [(arr, seed * 131 + sh) for sh in range(shards)]


def phase_rows(profile, arrival: ArrivalSpec | dict, seed: int,
               shards: int) -> list[tuple[np.ndarray, ...]]:
    """What ``OpenLoopSwarm.run_phase(profile, arrival, seed)`` makes
    each of ``shards`` shards inject (``shard_phase``), computed
    without a swarm: the commands a checker holds the stores to."""
    prof = resolve_profile(profile)
    arr = (arrival if isinstance(arrival, ArrivalSpec)
           else ArrivalSpec.from_dict(arrival))
    return [shard_phase(prof, a, s) for a, s in _shard_specs(arr, seed, shards)]


def _shard_main(conn, cfg: dict) -> None:
    """Worker entry point (spawn target). Protocol on the pipe:
    parent sends ``("phase", profile_dict, arrival_dict, seed)``,
    ``("drain", timeout_s)`` or ``("stop",)``; worker answers each
    with one result dict (first message is the connect ack)."""
    try:
        shard = _Shard(cfg["shard_id"], tuple(cfg["maddr"]),
                       cfg["sessions"], cfg["retransmit_s"],
                       cfg["trace_pow2"])
    # paxlint: disable=broad-except -- worker boot failure of ANY kind
    # must reach the parent as a result dict, not die silently
    except Exception as e:
        conn.send({"ok": False, "error": repr(e)[:300]})
        return
    conn.send({"ok": True, "shard": cfg["shard_id"],
               "sessions": cfg["sessions"]})
    while True:
        msg = conn.recv()
        op = msg[0]
        try:
            if op == "phase":
                res = shard.run_phase(WorkloadProfile.from_dict(msg[1]),
                                      ArrivalSpec.from_dict(msg[2]),
                                      int(msg[3]))
            elif op == "drain":
                res = shard.drain(float(msg[1]))
            elif op == "stop":
                conn.send(shard.final())
                return
            else:
                res = {"ok": False, "error": f"unknown op {op!r}"}
        # paxlint: disable=broad-except -- the pipe protocol's error
        # channel: any per-op failure becomes the op's result dict so
        # the driver can tear the run down with the cause in hand
        except Exception as e:
            res = {"ok": False, "error": repr(e)[:300],
                   "shard": cfg["shard_id"]}
        conn.send(res)


def _merge(results: list[dict]) -> dict:
    """Sum per-shard phase results; latencies merge into one sorted
    distribution (reservoirs are uniform subsamples, so the merge is
    a valid sample of the union)."""
    bad = [r for r in results if r.get("error")]
    if bad:
        raise RuntimeError(f"shard failure: {bad[0]['error']}")
    lats: list[float] = []
    for r in results:
        lats.extend(r["lat_ms"])
    lats.sort()
    out = {k: sum(r[k] for r in results)
           for k in ("sent", "acked", "retransmits", "rejects",
                     "duplicates", "lat_overflow", "outstanding",
                     "dead_sessions")}
    out["behind_max_s"] = max(r["behind_max_s"] for r in results)
    out["wall_s"] = max(r["wall_s"] for r in results)
    out["lat_ms_sorted"] = lats
    out["shards"] = results
    return out


@contextlib.contextmanager
def _spawn_main_here():
    """While workers start: a spawned worker first runs the parent's
    ``__main__`` again (by its module name, else by its path); name
    this module instead, which imports no torch. ``Process.start``
    reads the name synchronously, so restoring it afterwards is safe."""
    main = sys.modules.get("__main__")
    if main is None:
        yield
        return
    had = "__spec__" in vars(main)
    spec = getattr(main, "__spec__", None)
    main.__spec__ = sys.modules[__name__].__spec__
    try:
        yield
    finally:
        if had:
            main.__spec__ = spec
        else:
            del main.__spec__


class OpenLoopSwarm:
    """Driver-side handle: ``shards`` worker processes x
    ``sessions_per_shard`` TCP sessions, one pipe each. All phase
    calls are synchronous barriers across shards (every shard runs
    the same wall-clock phase window)."""

    def __init__(self, maddr: tuple[str, int], sessions: int = 1024,
                 shards: int = 4, retransmit_s: float = 1.0,
                 trace_pow2: int | None = None):
        if sessions % shards:
            raise ValueError(f"sessions ({sessions}) must divide "
                             f"evenly into shards ({shards})")
        self.maddr = maddr
        self.sessions = sessions
        self.shards = shards
        self.retransmit_s = retransmit_s
        self.trace_pow2 = trace_pow2
        self._procs: list = []
        self._pipes: list = []

    def start(self, timeout_s: float = 60.0) -> None:
        ctx = mp.get_context("spawn")  # workers must not inherit torch
        with _spawn_main_here():
            for sh in range(self.shards):
                parent, child = ctx.Pipe()
                cfg = {"shard_id": sh, "maddr": list(self.maddr),
                       "sessions": self.sessions // self.shards,
                       "retransmit_s": self.retransmit_s,
                       "trace_pow2": self.trace_pow2}
                p = ctx.Process(target=_shard_main, args=(child, cfg),
                                daemon=True)
                p.start()
                child.close()
                self._procs.append(p)
                self._pipes.append(parent)
        for sh, pipe in enumerate(self._pipes):
            if not pipe.poll(timeout_s):
                raise TimeoutError(f"shard {sh} never connected")
            ack = pipe.recv()
            if not ack.get("ok"):
                raise RuntimeError(
                    f"shard {sh} failed to start: {ack.get('error')}")

    def _round_trip(self, msgs: tuple | list, timeout_s: float) -> list[dict]:
        """Send one message per shard (a single tuple broadcasts) and
        collect one reply per shard."""
        if isinstance(msgs, tuple):
            msgs = [msgs] * len(self._pipes)
        for pipe, m in zip(self._pipes, msgs):
            pipe.send(m)
        msg = msgs[0]
        out = []
        for sh, pipe in enumerate(self._pipes):
            if not pipe.poll(timeout_s):
                raise TimeoutError(f"shard {sh} timed out on {msg[0]}")
            out.append(pipe.recv())
        return out

    def run_phase(self, profile, arrival: ArrivalSpec | dict,
                  seed: int) -> dict:
        """One phase across every shard: each shard runs the SAME
        arrival envelope at ``rate_hz / shards`` (the aggregate
        offered load matches the spec) with a shard-decorrelated
        seed (``_shard_specs``). Blocks for the phase duration."""
        prof = resolve_profile(profile)
        arr = (arrival if isinstance(arrival, ArrivalSpec)
               else ArrivalSpec.from_dict(arrival))
        msgs = [("phase", prof.to_dict(), a.to_dict(), s)
                for a, s in _shard_specs(arr, seed, self.shards)]
        res = self._round_trip(msgs, timeout_s=arr.duration_s + 120.0)
        return _merge(res)

    def drain(self, timeout_s: float = 30.0) -> dict:
        return _merge(self._round_trip(("drain", timeout_s),
                                       timeout_s + 30.0))

    def stop(self, timeout_s: float = 30.0) -> dict:
        finals = self._round_trip(("stop",), timeout_s)
        for p in self._procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
        self._procs, self._pipes = [], []
        traces = [f["trace"] for f in finals if f.get("trace")]
        return {"sent_unique": sum(f["sent_unique"] for f in finals),
                "acked_unique": sum(f["acked_unique"] for f in finals),
                "lost": sum(f["lost"] for f in finals),
                "duplicates": sum(f["duplicates"] for f in finals),
                "dead_sessions": sum(f["dead_sessions"] for f in finals),
                "traces": traces, "shards": finals}

    def kill(self) -> None:
        """Hard teardown for error paths."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        self._procs, self._pipes = [], []
