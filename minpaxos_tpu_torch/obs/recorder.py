"""Per-tick flight recorder, the telemetry-row layout of the resident
loop, and the Chrome trace-event export of both.

The port's copy of the JAX package's ``obs/recorder.py`` (numpy and
the standard library only; the same names, schema and defaults).

Every protocol-thread wakeup of a replica server appends ONE row to a
fixed-size int64 ring (a single slice-assign, no allocation): when it
happened, which dispatch regime ran (full / fused / narrow /
idle-skip), how many substeps fused, rows in/out, the commit frontier,
the exec backlog, and the per-phase wall in microseconds. The dispatch
splits into ``drain_us``, ``enqueue_us`` (host wall to issue the step,
K7 and the copy to pinned memory) and ``readback_us`` (host blocked on
that copy's CUDA event); the host phases into ``persist_us``,
``dispatch_us`` and ``reply_us``. ``overlap_us`` is the part of a
tick's host-phase wall that ran while the NEXT dispatch was in flight
on the device (0 when serial). The control plane's ``trace`` verb
exports the ring as Chrome trace-event JSON that loads in Perfetto
(``ui.perfetto.dev``) or ``chrome://tracing``.

Fields of the telemetry row the resident loop writes per protocol
round (``parallel/sharded.py``): round — absolute protocol round (-1 =
row never written); committed_delta — instances committed this round,
summed over groups at the cursor replica; in_flight — assigned but
uncommitted after the round; assigned — log slots assigned this round;
injected_rows — live workload rows in the round's ext batch;
inbox_rows — routed peer rows delivered from the pending inboxes
(drain sub-steps included); claim_rows — executed-slot delta (rows
through the KV apply); prepared_shards — groups whose cursor replica
is a prepared leader (every group for Mencius); inbox_hwm — the
round's largest delivered inbox of one replica, routed + injected.
``device_round_events`` renders a ring readback as device-round
tracks on the reserved ``DEVICE_PID``.

Timestamps are ``monotonic_ns`` (CLOCK_MONOTONIC is machine-wide on
Linux), so traces merged across the processes of one host share a
timeline.
"""

from __future__ import annotations

import threading

import numpy as np

#: ring-row layout revision; bumped whenever fields change meaning or
#: position (v1: 12 fields with a single step_us; v2: enqueue_us /
#: readback_us / overlap_us split, 14 fields; v3: trailing
#: chaos_faults — cumulative paxchaos injected-fault count at this
#: tick, so Perfetto shows fault bursts against tick regimes; v4:
#: paxray device-round tracks — the resident loop's post-window
#: telemetry readback rendered as round slices + counter tracks under
#: the reserved DEVICE_PID, mergeable with host flight-recorder events
#: into one validated timeline. The tick-row layout itself is
#: unchanged from v3. v5: paxtrace per-command span tracks
#: (obs/trace.py) — stage slices for sampled commands under the
#: reserved TRACE_PID, so one merged file shows a command's client ->
#: replica -> device-rounds -> reply chain next to the tick and
#: device-round tracks. Tick-row layout again unchanged. v6: paxwatch
#: cluster-event tracks (obs/watch.py) — journal events (elections,
#: leader changes, failovers, chaos installs, store-corruption
#: recoveries, narrow fallbacks, alarms) rendered as instant events
#: under the reserved WATCH_PID, so one merged file shows WHEN the
#: cluster's incidents happened against the tick / device-round /
#: command-span tracks. Tick-row layout unchanged from v3. v7:
#: ingress-coalescer fields — ``coal_occ`` (client rows the
#: event-driven ingress front batched into this tick's drain) and
#: ``coal_wake`` (cumulative condition-variable kicks that woke a
#: parked tick loop), appended AFTER chaos_faults so pre-v7 field
#: indices still hold.)
SCHEMA_VERSION = 7

# dispatch regimes (runtime/replica.py classifies one per tick:
# narrow > fused > full; idle-skip never reaches the device)
KIND_FULL, KIND_FUSED, KIND_NARROW, KIND_IDLE_SKIP = 0, 1, 2, 3
KIND_NAMES = ("full", "fused", "narrow", "idle_skip")

# ring-row field layout. Two
# timestamps because a pipelined tick's phases occupy two wall-time
# intervals: the dispatch phases (drain/enqueue/readback) end at
# t_rb_ns, the host phases (persist/dispatch/reply) end at t_ns —
# with the NEXT tick's dispatch phases in between when deferred.
# Stamping only completion time would draw the dispatch phases where
# they never ran and overlap consecutive tick slices in a viewer.
(F_T_NS, F_KIND, F_K, F_ROWS_IN, F_ROWS_OUT, F_FRONTIER, F_BACKLOG,
 F_DRAIN_US, F_ENQUEUE_US, F_READBACK_US, F_OVERLAP_US, F_PERSIST_US,
 F_DISPATCH_US, F_REPLY_US, F_T_RB_NS, F_CHAOS, F_COAL_OCC,
 F_COAL_WAKE) = range(18)
N_FIELDS = 18
FIELD_NAMES = ("t_ns", "kind", "k", "rows_in", "rows_out", "frontier",
               "exec_backlog", "drain_us", "enqueue_us", "readback_us",
               "overlap_us", "persist_us", "dispatch_us", "reply_us",
               "t_rb_ns", "chaos_faults", "coal_occ", "coal_wake")

# dispatch-side phases, laid end-to-end ENDING at t_rb_ns (tid 0),
# and host-side phases ending at t_ns (tid 1 — their own track, so a
# deferred tick's host work rendered under the next tick's dispatch
# slice is the overlap made visible). overlap_us is in NEITHER list:
# it is an attribute of the host walls (how much was device-hidden),
# not an additional phase — it rides the tick args + a counter track.
_DISPATCH_PHASES = (("drain", F_DRAIN_US), ("enqueue", F_ENQUEUE_US),
                    ("readback", F_READBACK_US))
_HOST_PHASES = (("persist", F_PERSIST_US), ("dispatch", F_DISPATCH_US),
                ("reply", F_REPLY_US))

_EVENT_PHASES = frozenset("XBEiICMsnbe")  # trace-event ph codes we accept

# ---------------------------------------------------------------- paxray
# Device-side telemetry of the resident loop (schema v4).

#: reserved pid for device-round tracks in merged traces. Host
#: flight-recorder events use replica-id pids (small ints); the
#: validator enforces that ``device_round`` events carry exactly this
#: pid so a merged file keeps one unambiguous device track group.
#: (obs/trace.py reserves the sibling TRACE_PID = 9998 for paxtrace
#: command-span tracks; the validator pins that one too.)
DEVICE_PID = 9999

#: schema v5: reserved pid for paxtrace per-command span tracks
#: (obs/trace.py emits them; it imports this constant)
TRACE_PID = 9998

#: schema v6: reserved pid for paxwatch cluster-event tracks
#: (obs/watch.py emits them; it imports this constant). The validator
#: pins the reservation both directions, like its two siblings.
WATCH_PID = 9997

(TEL_ROUND, TEL_COMMITTED, TEL_IN_FLIGHT, TEL_ASSIGNED, TEL_INJECTED,
 TEL_INBOX_ROWS, TEL_CLAIM_ROWS, TEL_PREPARED, TEL_INBOX_HWM) = range(9)
N_TEL_FIELDS = 9
TEL_FIELD_NAMES = ("round", "committed_delta", "in_flight", "assigned",
                   "injected_rows", "inbox_rows", "claim_rows",
                   "prepared_shards", "inbox_hwm")


def telemetry_valid_rows(buf) -> np.ndarray:
    """The written rows of a telemetry ring readback, sorted by round
    ([n, N_TEL_FIELDS]); rows never written (round -1) are dropped."""
    rows = np.asarray(buf)
    if rows.ndim != 2 or rows.shape[1] != N_TEL_FIELDS:
        raise ValueError(f"telemetry buffer must be [n, {N_TEL_FIELDS}], "
                         f"got {rows.shape}")
    rows = rows[rows[:, TEL_ROUND] >= 0]
    return rows[np.argsort(rows[:, TEL_ROUND], kind="stable")]


def device_round_events(rows, dispatches: list[dict], n_shards: int,
                        pid: int = DEVICE_PID) -> list[dict]:
    """Chrome trace events for a post-window telemetry readback.

    ``rows``: telemetry rows ([n, N_TEL_FIELDS]) — either the raw
    ring buffer or ``resident_telemetry()``'s already-clean output;
    the filter/sort applied here is idempotent, so pre-validated rows
    pass through unchanged. ``dispatches``: the host loop's per-dispatch log —
    dicts with ``t0_ns``/``t1_ns`` (monotonic_ns around the dispatch,
    the same clock the flight recorder stamps) and ``round0``/``k``
    (which rounds the dispatch ran) — device rounds have no wall
    timestamps of their own, so each dispatch's rounds are laid evenly
    across its measured wall interval. Emits one ``X`` round slice per
    telemetry row (tid 0, cat ``device_round``, named by the
    election/steady flag) plus ``device_frontier`` / ``device_in_flight``
    counter tracks — the device-side twin of ``to_events``, sharing
    its timeline so a resident dispatch and the TCP runtime merge into
    one Perfetto file.
    """
    rows = telemetry_valid_rows(rows)
    by_round = {int(r[TEL_ROUND]): r for r in rows}
    events: list[dict] = []
    frontier = 0
    for d in sorted(dispatches, key=lambda d: d["t0_ns"]):
        k = int(d["k"])
        per_us = max((int(d["t1_ns"]) - int(d["t0_ns"])) / max(k, 1) / 1e3,
                     1.0)
        for j in range(k):
            r = by_round.get(int(d["round0"]) + j)
            if r is None:
                continue  # telemetry off / ring overwrote this round
            ts = int(d["t0_ns"]) / 1e3 + j * per_us
            steady = int(r[TEL_PREPARED]) >= n_shards
            frontier += int(r[TEL_COMMITTED])
            events.append({
                "name": f"round:{'steady' if steady else 'election'}",
                "cat": "device_round", "ph": "X", "ts": ts,
                "dur": per_us, "pid": pid, "tid": 0,
                "args": {name: int(r[i])
                         for i, name in enumerate(TEL_FIELD_NAMES)}})
            t_end = ts + per_us
            events.append({"name": "device_frontier", "ph": "C",
                           "ts": t_end, "pid": pid, "tid": 0,
                           "args": {"device_frontier": frontier}})
            events.append({"name": "device_in_flight", "ph": "C",
                           "ts": t_end, "pid": pid, "tid": 0,
                           "args": {"device_in_flight":
                                    int(r[TEL_IN_FLIGHT])}})
    return events


class FlightRecorder:
    """Fixed-capacity ring buffer of per-tick rows.

    ``record`` is called by the protocol thread only; ``snapshot`` /
    ``to_events`` may be called from any thread (control plane) — the
    tiny lock only orders the one-row write against the copy, it is
    never held across anything blocking.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"recorder capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self._buf = np.zeros((capacity, N_FIELDS), np.int64)
        self.total = 0  # rows ever recorded (ring holds the last cap)
        self._lock = threading.Lock()

    def record(self, t_ns: int, kind: int, k: int, rows_in: int,
               rows_out: int, frontier: int, backlog: int, drain_us: int,
               enqueue_us: int, readback_us: int, overlap_us: int,
               persist_us: int, dispatch_us: int, reply_us: int,
               t_rb_ns: int = 0, chaos_faults: int = 0,
               coal_occ: int = 0, coal_wake: int = 0) -> None:
        """``t_ns``: when the tick's host phases completed. ``t_rb_ns``:
        when its readback completed (0 = unknown; to_events then lays
        the dispatch phases contiguously before the host phases, which
        is exact for serial ticks). ``chaos_faults``: the transport's
        CUMULATIVE injected-fault total at this tick (0 when paxchaos
        was never installed — traces without chaos are unchanged).
        ``coal_occ``: client rows the ingress coalescer batched into
        this tick's drain (0 = no coalescer / no client rows).
        ``coal_wake``: the coalescer's CUMULATIVE wakeup-kick count at
        this tick (schema v7; both default 0 so pre-v7 call sites are
        unchanged)."""
        with self._lock:
            self._buf[self.total % self.capacity] = (
                t_ns, kind, k, rows_in, rows_out, frontier, backlog,
                drain_us, enqueue_us, readback_us, overlap_us,
                persist_us, dispatch_us, reply_us, t_rb_ns, chaos_faults,
                coal_occ, coal_wake)
            self.total += 1

    def snapshot(self, last: int | None = None) -> np.ndarray:
        """Recorded rows oldest-first (a copy; [n, N_FIELDS] int64),
        wraparound resolved. ``last`` keeps only the newest N rows."""
        with self._lock:
            n = min(self.total, self.capacity)
            if self.total <= self.capacity:
                out = self._buf[:n].copy()
            else:
                i = self.total % self.capacity
                out = np.concatenate([self._buf[i:], self._buf[:i]])
        if last is not None and 0 <= last < len(out):
            out = out[len(out) - last:]
        return out

    def to_events(self, pid: int = 0, last: int | None = None) -> list[dict]:
        """Chrome trace events for the recorded rows, at the times the
        phases actually ran: the enclosing ``X`` tick event plus the
        drain/enqueue/readback children end at ``t_rb_ns`` on tid 0
        (the dispatch track), the persist/dispatch/reply children end
        at ``t_ns`` on tid 1 (the host-phase track) — so a deferred
        tick's host work renders UNDER the next tick's dispatch slice
        instead of producing overlapping same-track slices, and the
        pipeline's overlap is visible as exactly that. ``C`` (counter)
        events graph frontier / exec backlog / ``overlap_us``. ``pid``
        should be the replica id so merged cluster traces get one
        track group per replica."""
        events: list[dict] = []
        for r in self.snapshot(last):
            disp_dur = sum(int(r[i]) for _, i in _DISPATCH_PHASES)
            host_dur = sum(int(r[i]) for _, i in _HOST_PHASES)
            t_end = int(r[F_T_NS]) / 1e3  # trace-event ts unit: us
            t_rb = (int(r[F_T_RB_NS]) / 1e3 if r[F_T_RB_NS] > 0
                    else t_end - host_dur)  # pre-v2 rows: contiguous
            t0 = t_rb - disp_dur
            kind = KIND_NAMES[int(r[F_KIND])]
            events.append({
                "name": f"tick:{kind}", "cat": "tick", "ph": "X",
                "ts": t0, "dur": max(disp_dur, 1), "pid": pid, "tid": 0,
                "args": {"kind": kind, "k": int(r[F_K]),
                         "rows_in": int(r[F_ROWS_IN]),
                         "rows_out": int(r[F_ROWS_OUT]),
                         "frontier": int(r[F_FRONTIER]),
                         "exec_backlog": int(r[F_BACKLOG]),
                         "host_us": host_dur,
                         "overlap_us": int(r[F_OVERLAP_US]),
                         "coal_occ": int(r[F_COAL_OCC]),
                         "coal_wake": int(r[F_COAL_WAKE])}})
            if int(r[F_KIND]) != KIND_IDLE_SKIP:
                t = t0
                for name, i in _DISPATCH_PHASES:
                    d = int(r[i])
                    if d > 0:
                        events.append({"name": name, "cat": "phase",
                                       "ph": "X", "ts": t, "dur": d,
                                       "pid": pid, "tid": 0})
                    t += d
                t = t_end - host_dur
                for name, i in _HOST_PHASES:
                    d = int(r[i])
                    if d > 0:
                        events.append({"name": name, "cat": "phase",
                                       "ph": "X", "ts": t, "dur": d,
                                       "pid": pid, "tid": 1})
                    t += d
            events.append({"name": "frontier", "ph": "C", "ts": t_end,
                           "pid": pid, "tid": 0,
                           "args": {"frontier": int(r[F_FRONTIER])}})
            events.append({"name": "exec_backlog", "ph": "C", "ts": t_end,
                           "pid": pid, "tid": 0,
                           "args": {"exec_backlog": int(r[F_BACKLOG])}})
            events.append({"name": "overlap_us", "ph": "C", "ts": t_end,
                           "pid": pid, "tid": 0,
                           "args": {"overlap_us": int(r[F_OVERLAP_US])}})
            if r[F_CHAOS] > 0:
                # cumulative injected-fault counter track, emitted only
                # once chaos has fired: a fault burst shows as a step in
                # the line right where the tick regimes react to it
                events.append({"name": "chaos_faults", "ph": "C",
                               "ts": t_end, "pid": pid, "tid": 0,
                               "args": {"chaos_faults": int(r[F_CHAOS])}})
            if r[F_COAL_WAKE] > 0:
                # coalescer tracks (schema v7), emitted only once the
                # ingress front has kicked at least one wakeup: the
                # per-drain occupancy line shows batch formation doing
                # its job against the tick regimes above it
                events.append({"name": "coalesce_occupancy", "ph": "C",
                               "ts": t_end, "pid": pid, "tid": 0,
                               "args": {"coal_occ": int(r[F_COAL_OCC])}})
                events.append({"name": "coalesce_wakeups", "ph": "C",
                               "ts": t_end, "pid": pid, "tid": 0,
                               "args": {"coal_wake": int(r[F_COAL_WAKE])}})
        return events


def chrome_trace(events: list[dict]) -> dict:
    """Wrap an event list in the trace-event JSON object format. The
    paxmon schema revision rides ``otherData`` (viewers ignore it;
    ``validate_chrome_trace`` and offline consumers check it)."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms",
            "otherData": {"paxmonSchemaVersion": SCHEMA_VERSION}}


def validate_chrome_trace(trace) -> list[str]:
    """Schema errors for a trace-event JSON object ([] = valid).

    Checks the contract Perfetto/chrome://tracing actually rely on:
    the JSON-object form with a ``traceEvents`` list, and per event a
    string ``name``, a known ``ph`` code, numeric ``ts``, integer
    ``pid``/``tid``, a numeric non-negative ``dur`` on complete (X)
    events, and an ``args`` object of numbers on counter (C) events —
    plus the paxmon schema revision when stamped: a trace produced by
    a different ring layout (``otherData.paxmonSchemaVersion`` !=
    SCHEMA_VERSION) fails validation instead of silently mislabeling
    phases in a viewer. Schema v4 additionally pins the reserved-pid
    contract of merged device+host traces: ``device_round`` slices
    must carry DEVICE_PID and nothing else may squat on it — a host
    event landing on the device pid (or vice versa) would interleave
    the two timelines in a viewer. Used by the tests,
    ``chip_smoke.py`` and ``cli/tail.py``'s trace dump so a malformed
    export fails loudly at the source, not in a viewer.
    """
    errs: list[str] = []
    if not isinstance(trace, dict):
        return [f"trace must be a JSON object, got {type(trace).__name__}"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing/non-list traceEvents"]
    other = trace.get("otherData")
    if isinstance(other, dict) and "paxmonSchemaVersion" in other:
        ver = other["paxmonSchemaVersion"]
        if ver != SCHEMA_VERSION:
            errs.append(f"paxmon schema version mismatch: trace has "
                        f"{ver!r}, this build reads {SCHEMA_VERSION}")
    for i, ev in enumerate(evs):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where}: missing string name")
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _EVENT_PHASES:
            errs.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"{where}: non-numeric ts")
        for key in ("pid", "tid"):
            if key in ev and not isinstance(ev[key], int):
                errs.append(f"{where}: non-integer {key}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event needs numeric dur >= 0")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                errs.append(f"{where}: C event needs numeric args")
        is_device = (ev.get("cat") == "device_round"
                     or str(ev.get("name", "")).startswith("device_"))
        if is_device and ev.get("pid") != DEVICE_PID:
            errs.append(f"{where}: device track event must carry the "
                        f"reserved pid {DEVICE_PID}, got {ev.get('pid')!r}")
        if not is_device and ev.get("pid") == DEVICE_PID:
            errs.append(f"{where}: pid {DEVICE_PID} is reserved for "
                        f"device-round tracks")
        # schema v5: paxtrace command-span tracks live on TRACE_PID and
        # nothing else may squat there — and every span must carry its
        # trace id so a viewer selection can be joined back to spans
        is_span = ev.get("cat") == "paxtrace"
        if is_span:
            if ev.get("pid") != TRACE_PID:
                errs.append(f"{where}: paxtrace event must carry the "
                            f"reserved pid {TRACE_PID}, got "
                            f"{ev.get('pid')!r}")
            args = ev.get("args")
            if not isinstance(args, dict) or "trace_id" not in args:
                errs.append(f"{where}: paxtrace event needs "
                            f"args.trace_id")
        elif ev.get("pid") == TRACE_PID:
            errs.append(f"{where}: pid {TRACE_PID} is reserved for "
                        f"paxtrace command-span tracks")
        # schema v6: paxwatch cluster-event tracks live on WATCH_PID
        # and nothing else may squat there — instant events from the
        # journal must not interleave with replica/device/span tracks
        is_watch = ev.get("cat") == "paxwatch"
        if is_watch and ev.get("pid") != WATCH_PID:
            errs.append(f"{where}: paxwatch event must carry the "
                        f"reserved pid {WATCH_PID}, got "
                        f"{ev.get('pid')!r}")
        elif not is_watch and ev.get("pid") == WATCH_PID:
            errs.append(f"{where}: pid {WATCH_PID} is reserved for "
                        f"paxwatch cluster-event tracks")
    return errs
