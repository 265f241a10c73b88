"""paxwatch on the port: cluster health journal, retention, detectors.

The port's copy of the JAX package's ``obs/watch.py`` (numpy and the
standard library only):

* **Event journal** — fixed-size per-thread numpy event rings (single
  writer each) owned by one :class:`EventJournal` per process. Every
  event carries ``(mono_ns, wall_ns, kind, severity, subject, value,
  aux, trace_id)``, so journals of several processes align by their
  ``(mono, wall)`` anchor pairs. Served over a replica's ``events``
  control verb and fanned out cluster-wide by the master's
  ``cluster_events``.
* **Health samples + retention** — :func:`flatten_cluster_stats`
  turns one master ``stats`` fan-out into a numeric health sample;
  :class:`HealthSeries` persists samples append-only with a streaming
  downsample (raw recent, p50/p99/max per coarse bucket older,
  compaction keeps the file under a byte bound).
* **SLO/anomaly detectors** — pure functions over a sample window
  (:func:`stall_alarm`, :func:`churn_alarm`, :func:`backlog_alarm`,
  :func:`burn_alarm`), grouped under a declared :class:`SLO`;
  :class:`HealthWatcher` evaluates them on every poll and journals
  alarm raise/clear events with the evidence window: a chaos
  campaign's injected stall is detected and attributed while it lasts
  (``chaos/campaign.py`` asserts exactly that).
* **Merged traces** — :func:`event_chrome_events` renders journal rows
  as instant events on the flight recorder's reserved ``WATCH_PID``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from minpaxos_tpu_torch.utils.clock import monotonic_ns

# ------------------------------------------------------------- events

#: severities (EV_SEV field): INFO = lifecycle fact, WARN = degraded
#: but progressing, ALERT = an SLO/correctness signal an operator must
#: see.
SEV_INFO, SEV_WARN, SEV_ALERT = 0, 1, 2
SEV_NAMES = ("info", "warn", "alert")

#: event kinds (EV_KIND field). Kind 0 is reserved as the
#: never-written marker (ring rows are zero-initialized; a real event
#: always has mono_ns > 0 as well). Append-only: consumers key on the
#: value, so renumbering is a schema break.
(EV_NONE, EV_ELECTION, EV_LEADER_CHANGE, EV_CLIENT_FAILOVER,
 EV_CHAOS_INSTALL, EV_CHAOS_CLEAR, EV_STORE_CORRUPT,
 EV_NARROW_FALLBACK, EV_LATENCY_OVERFLOW, EV_PEER_DOWN, EV_PEER_UP,
 EV_FATAL, EV_ALARM, EV_ALARM_CLEAR, EV_PHASE, EV_SNAPSHOT,
 EV_TRUNCATE, EV_RECOVERY) = range(18)
EVENT_NAMES = ("none", "election", "leader_change", "client_failover",
               "chaos_install", "chaos_clear", "store_corrupt",
               "narrow_fallback", "latency_overflow", "peer_down",
               "peer_up", "fatal", "alarm", "alarm_clear", "phase",
               # durability lifecycle: snapshot taken (value =
               # snapshot frontier, aux = log bytes after), redo log
               # truncated (value = bytes freed, aux = log bytes
               # after), crash-restart recovery completed (value =
               # recovered frontier, aux = recovery wall ms)
               "snapshot", "truncate", "recovery")

#: per-event default severities (the recorder may override)
EVENT_SEVERITY = (SEV_INFO, SEV_INFO, SEV_INFO, SEV_WARN, SEV_WARN,
                  SEV_INFO, SEV_ALERT, SEV_WARN, SEV_WARN, SEV_WARN,
                  SEV_INFO, SEV_ALERT, SEV_ALERT, SEV_INFO, SEV_INFO,
                  SEV_INFO, SEV_INFO, SEV_WARN)

#: soak phase kinds (ride EV_PHASE events in the aux field; the
#: subject field carries the phase ordinal within the scenario, the
#: value field the planned duration in ms). Append-only like the kind
#: table: consumers key on these ids.
(PHASE_NONE, PHASE_WARMUP, PHASE_SKEW, PHASE_OVERLOAD,
 PHASE_PARTITION, PHASE_HEAL, PHASE_DRAIN, PHASE_CUSTOM,
 PHASE_CRASH_RESTART) = range(9)
PHASE_KIND_NAMES = ("none", "warmup", "skew", "overload", "partition",
                    "heal", "drain", "custom", "crash_restart")
PHASE_KIND_IDS = {n: i for i, n in enumerate(PHASE_KIND_NAMES)}

#: detector ids (ride EV_ALARM/EV_ALARM_CLEAR events in the aux field)
DET_STALL, DET_CHURN, DET_BACKLOG, DET_BURN = 1, 2, 3, 4
DETECTOR_NAMES = {DET_STALL: "frontier_stall", DET_CHURN:
                  "election_churn", DET_BACKLOG: "backlog_growth",
                  DET_BURN: "p99_burn_rate"}
DETECTOR_IDS = {v: k for k, v in DETECTOR_NAMES.items()}

# event-row field layout. subject: the replica/detector target the
# event is ABOUT (replica id, or -1 for cluster-wide); value: the
# event's one evidence scalar (corrupt-record count, overflow count,
# alarm window ms); aux: a second discriminator (old leader id on
# leader_change, DET_* id on alarms); trace_id: the paxtrace join key
# when the event belongs to a sampled command's story (0 = none).
(EV_MONO, EV_WALL, EV_KIND, EV_SEV, EV_SUBJECT, EV_VALUE, EV_AUX,
 EV_TRACE) = range(8)
N_EVENT_FIELDS = 8
EVENT_FIELD_NAMES = ("mono_ns", "wall_ns", "kind", "severity",
                     "subject", "value", "aux", "trace_id")


class EventRing:
    """Fixed-capacity ring of event rows, single-writer (one thread),
    snapshot-from-anywhere, eight int64
    fields per row. Wraparound keeps the NEWEST events."""

    __slots__ = ("capacity", "_buf", "total", "_lock")

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"event ring capacity must be >= 1: "
                             f"{capacity}")
        self.capacity = capacity
        self._buf = np.zeros((capacity, N_EVENT_FIELDS), np.int64)
        self.total = 0
        self._lock = threading.Lock()

    def record(self, mono_ns: int, wall_ns: int, kind: int, sev: int,
               subject: int, value: int, aux: int, trace_id: int) -> None:
        with self._lock:
            self._buf[self.total % self.capacity] = (
                mono_ns, wall_ns, kind, sev, subject, value, aux,
                trace_id)
            self.total += 1

    def snapshot(self) -> np.ndarray:
        """Recorded rows oldest-first (a copy), wraparound resolved."""
        with self._lock:
            n = min(self.total, self.capacity)
            if self.total <= self.capacity:
                return self._buf[:n].copy()
            i = self.total % self.capacity
            return np.concatenate([self._buf[i:], self._buf[:i]])

    @property
    def dropped(self) -> int:
        return max(0, self.total - self.capacity)


class EventJournal:
    """All of one process's event rings (per writer thread, created
    lazily, dead owners' rings adopted, so the protocol thread, control
    threads and transport readers each write into their own ring)."""

    def __init__(self, enabled: bool = True, capacity: int = 1024):
        self.enabled = enabled
        self.capacity = capacity
        self._rings: dict[EventRing, threading.Thread] = {}
        self._tls = threading.local()
        self._lock = threading.Lock()

    # -- hot path --

    def ring(self) -> EventRing:
        r = getattr(self._tls, "ring", None)
        if r is None:
            me = threading.current_thread()
            with self._lock:
                for cand, owner in self._rings.items():
                    if not owner.is_alive():
                        r = cand
                        break
                if r is None:
                    r = EventRing(self.capacity)
                self._rings[r] = me
            self._tls.ring = r
        return r

    def record(self, kind: int, subject: int = -1, value: int = 0,
               aux: int = 0, trace_id: int = 0,
               severity: int | None = None) -> None:
        """One journal event, stamped with both clocks. A disabled
        journal is one attribute test per call site. The ring write is
        inlined (not ``self.ring().record(...)``): two Python call
        frames fewer per event."""
        if not self.enabled:
            return
        r = getattr(self._tls, "ring", None)
        if r is None:
            r = self.ring()
        sev = EVENT_SEVERITY[kind] if severity is None else severity
        with r._lock:
            r._buf[r.total % r.capacity] = (
                monotonic_ns(), time.time_ns(), kind, sev, subject,
                value, aux, trace_id)
            r.total += 1

    # -- observability of the observer --

    def events_total(self) -> int:
        with self._lock:
            rings = list(self._rings)
        return sum(r.total for r in rings)

    def events_dropped(self) -> int:
        with self._lock:
            rings = list(self._rings)
        return sum(r.dropped for r in rings)

    # -- snapshots / collection (EVENTS verb payload) --

    def snapshot(self) -> np.ndarray:
        """Every ring's rows merged, sorted by mono_ns ([n, 8] int64,
        a copy)."""
        with self._lock:
            rings = list(self._rings)
        rows = ([r.snapshot() for r in rings]
                or [np.zeros((0, N_EVENT_FIELDS), np.int64)])
        out = np.concatenate(rows)
        return out[np.argsort(out[:, EV_MONO], kind="stable")]

    def counts_by_kind(self) -> dict[str, int]:
        """{kind name: count} over the retained events (queryable
        summary for artifacts)."""
        return counts_by_kind(self.snapshot())

    def collect(self) -> dict:
        """JSON-serializable journal snapshot plus the (mono, wall)
        clock anchor — the pair :func:`align_event_collections` shifts
        processes into one monotonic domain by (the paxtrace anchor
        contract)."""
        return {
            "enabled": self.enabled,
            "total": self.events_total(),
            "dropped": self.events_dropped(),
            "anchor": {"mono_ns": monotonic_ns(),
                       "wall_ns": time.time_ns()},
            "events": self.snapshot().tolist(),
        }


def counts_by_kind(rows) -> dict[str, int]:
    """{kind name: count} over event rows ([n, N_EVENT_FIELDS]) — the
    ONE aggregation every consumer shares (journal summaries, the
    campaign's cluster_events stanza)."""
    out: dict[str, int] = {}
    for k in np.asarray(rows, np.int64).reshape(
            -1, N_EVENT_FIELDS)[:, EV_KIND].tolist():
        if 0 < k < len(EVENT_NAMES):
            out[EVENT_NAMES[k]] = out.get(EVENT_NAMES[k], 0) + 1
    return out


def align_event_collections(collections: list[dict],
                            ref_anchor: dict | None = None) -> np.ndarray:
    """Merge ``collect()`` payloads from several processes into one
    event matrix in the REFERENCE process's monotonic domain, sorted
    by (shifted) mono_ns — the align_collections math, applied to the
    mono column only (wall_ns is already absolute)."""
    out = []
    ref = ref_anchor or next(
        (c["anchor"] for c in collections if c.get("anchor")), None)
    ref_off = (ref["wall_ns"] - ref["mono_ns"]) if ref else 0
    for c in collections:
        rows = np.asarray(c.get("events") or [], np.int64)
        if rows.size == 0:
            continue
        rows = rows.reshape(-1, N_EVENT_FIELDS).copy()
        a = c.get("anchor")
        rows[:, EV_MONO] += ((a["wall_ns"] - a["mono_ns"]) - ref_off
                             if a else 0)
        out.append(rows)
    if not out:
        return np.zeros((0, N_EVENT_FIELDS), np.int64)
    rows = np.concatenate(out)
    return rows[np.argsort(rows[:, EV_MONO], kind="stable")]


def event_chrome_events(rows, pid: int | None = None,
                        tid: int = 0) -> list[dict]:
    """Chrome trace instant events for journal rows, on the reserved
    WATCH_PID (schema v6): one ``i`` event per row, named by kind,
    carrying severity/subject/value/aux/trace_id args — merged with
    the flight-recorder / device-round / command-span tracks they
    share a timeline with. ``tid`` should be the replica id so a
    cluster merge keeps one event track per process."""
    from minpaxos_tpu_torch.obs.recorder import WATCH_PID

    if pid is None:
        pid = WATCH_PID
    events: list[dict] = []
    for r in np.asarray(rows, np.int64).reshape(-1, N_EVENT_FIELDS):
        kind = int(r[EV_KIND])
        if kind <= 0 or r[EV_MONO] <= 0:
            continue
        name = (EVENT_NAMES[kind] if kind < len(EVENT_NAMES)
                else f"event:{kind}")
        if kind in (EV_ALARM, EV_ALARM_CLEAR):
            name = f"{name}:{DETECTOR_NAMES.get(int(r[EV_AUX]), '?')}"
        events.append({
            "name": name, "cat": "paxwatch", "ph": "i",
            "ts": int(r[EV_MONO]) / 1e3, "s": "g", "pid": pid,
            "tid": tid,
            "args": {"severity": SEV_NAMES[min(int(r[EV_SEV]), 2)],
                     "subject": int(r[EV_SUBJECT]),
                     "value": int(r[EV_VALUE]), "aux": int(r[EV_AUX]),
                     "trace_id": int(r[EV_TRACE]),
                     "wall_ns": int(r[EV_WALL])}})
    return events


# ---------------------------------------------------- health samples


def flatten_cluster_stats(resp: dict, slo_ms: float | None = None,
                          t_wall: float | None = None) -> dict:
    """One numeric health sample from a master ``stats`` fan-out
    response — the detectors' input row and the retention layer's
    record. ``slo_ms`` (when declared) additionally derives per-replica
    cumulative ``hist_total``/``hist_bad`` from the tick-wall
    histogram: bad = ticks in buckets whose LOWER edge is at or above
    the SLO (conservative — a bucket straddling the threshold counts
    good), which is what the burn-rate detector differences."""
    reps: dict[str, dict] = {}
    tip = -1
    for r in resp.get("replicas", []):
        rid = r.get("id", -1)
        mx = r.get("metrics") or {}
        cnt = dict(mx.get("counters") or {})
        cnt.update(mx.get("gauges") or {})
        fr = int(r.get("frontier", -1) if r.get("ok") else -1)
        tip = max(tip, fr)
        row = {"ok": 1 if r.get("ok") else 0, "frontier": fr,
               "executed": int(r.get("executed", -1)),
               "proposals": int(cnt.get("proposals", 0)),
               "rejected": int(cnt.get("proposals_rejected", 0)),
               "elections": int(cnt.get("elections", 0)),
               "narrow_fallbacks": int(cnt.get("narrow_fallbacks", 0)),
               "chaos_injected": int(cnt.get("chaos_injected", 0)),
               "events": int(cnt.get("events", 0))}
        row["backlog"] = max(0, fr - row["executed"])
        if slo_ms is not None:
            h = (mx.get("histograms") or {}).get("tick_wall_ms") or {}
            bounds = h.get("bounds") or []
            counts = h.get("counts") or []
            total = int(h.get("count", 0))
            # counts[i] covers (bounds[i-1], bounds[i]]: a bucket is
            # bad when its LOWER edge clears the SLO (conservative —
            # a straddling bucket counts good). The implicit overflow
            # bucket (the last entry) is ALWAYS bad: even when the
            # declared SLO sits above the histogram's top edge, the
            # overflow bin is the only place an over-SLO tick can
            # land — treating it as good would blind the burn
            # detector exactly there.
            bad = sum(int(c) for i, c in enumerate(counts)
                      if i == len(counts) - 1
                      or (0 < i <= len(bounds)
                          and bounds[i - 1] >= slo_ms))
            row["hist_total"] = total
            row["hist_bad"] = bad
        reps[str(rid)] = row
    leader = int(resp.get("leader", -1))
    lead = reps.get(str(leader), {})
    proposals = int(lead.get("proposals", 0))
    sample = {
        "t": time.time() if t_wall is None else t_wall,
        "leader": leader,
        "alive": sum(r["ok"] for r in reps.values()),
        "tip": tip,
        "proposals": proposals,
        # in-flight estimate at the LEADER: admitted command rows,
        # minus rows the kernel bounced back unslotted (boot-window
        # rejections would otherwise bias this high FOREVER — found
        # driving the real cluster: 3 rejected batches left an idle
        # cluster reading in_flight=1536), minus committed slots.
        # Commands and slots are still not exactly 1:1 (noops,
        # election fills), so this is a load indicator, not a ledger —
        # the stall detector only asks "is anything trying".
        "in_flight": max(0, proposals - int(lead.get("rejected", 0))
                         - (int(lead.get("frontier", -1)) + 1)),
        "elections": sum(r["elections"] for r in reps.values()),
        "replicas": reps,
    }
    if slo_ms is not None:
        sample["hist_total"] = sum(r.get("hist_total", 0)
                                   for r in reps.values())
        sample["hist_bad"] = sum(r.get("hist_bad", 0)
                                 for r in reps.values())
    return sample


def _window(samples: list[dict], span_s: float) -> list[dict]:
    """The trailing samples covering at least ``span_s`` seconds
    ([] when the series is shorter than the span — a detector must
    not fire off a window it never observed, so "flat for T seconds"
    means T seconds were actually watched). The oldest sample at or
    before the window edge is included so the covered span reaches
    span_s even when poll times don't land exactly on it."""
    if len(samples) < 2:
        return []
    t_edge = samples[-1]["t"] - span_s
    i = len(samples) - 1
    while i > 0 and samples[i - 1]["t"] >= t_edge:
        i -= 1
    if i > 0:
        i -= 1  # one more sample to cover the edge
    win = samples[i:]
    if len(win) < 2 or samples[-1]["t"] - win[0]["t"] < span_s:
        return []
    return win


# ------------------------------------------------------- detectors


def stall_alarm(samples: list[dict], stall_s: float = 1.0,
                slack_slots: int = 8, lag_slots: int = 16) -> dict | None:
    """Frontier-stall: the cluster commit tip moved <= ``slack_slots``
    over a >= ``stall_s`` window while load was in flight (leader
    in-flight estimate > 0, or proposals still arriving). Attribution
    via the per-replica frontiers: a MINORITY of replicas lagging the
    tip by more than ``lag_slots`` points at those replicas (a
    partitioned follower starves alone); a MAJORITY lagging together
    points at the LEADER — followers only learn commitment from the
    leader's traffic, so a quorum of them freezing at once (each one
    in-flight batch behind, the piggyback pipeline lag at the moment
    the music stopped) has the leader's connectivity as the common
    cause: the isolated-leader chaos schedule's exact signature.
    Every frontier flat and level also blames the leader — nobody
    commits without it reaching a quorum.

    A moving tip is not automatically healthy either: a strict
    minority whose own frontier stayed FLAT while the tip pulled away
    beyond ``lag_slots`` is a scoped stall — under flexible quorums a
    partitioned q2-sized island starves exactly like this while the
    majority side commits on without it (the flex_partition chaos
    schedule's signature) — and is blamed by name."""
    win = _window(samples, stall_s)
    if not win:
        return None
    tip_delta = win[-1]["tip"] - win[0]["tip"]
    prop_delta = win[-1]["proposals"] - win[0]["proposals"]
    active = win[-1]["in_flight"] > 0 or prop_delta > 0
    if not active:
        return None
    last = win[-1]
    lags = {int(rid): last["tip"] - r["frontier"]
            for rid, r in last["replicas"].items() if r["ok"]}
    # a DEAD minority is invisible to the lag maps (no frontier to
    # lag with), yet it is the sharpest stall there is: a killed
    # replica's control socket answers nothing while the survivors'
    # tip moves on. Require it dead across the whole window so one
    # timed-out poll doesn't page, and name the replica (the
    # crash_restart chaos schedules' signature; clears on restart).
    dead = [int(rid) for rid, r in last["replicas"].items()
            if not r["ok"]
            and not win[0]["replicas"].get(rid, {"ok": True})["ok"]]
    if dead and len(dead) < len(last["replicas"]) // 2 + 1:
        suspect = min(dead)
        return {
            "detector": "frontier_stall", "subject": suspect,
            "evidence": {
                "window_s": round(last["t"] - win[0]["t"], 3),
                "tip_delta": tip_delta,
                "proposals_delta": prop_delta,
                "in_flight": last["in_flight"],
                "lags": lags, "dead": dead,
                "why": (f"replica {suspect} is down (no stats across "
                        f"the window) while the tip "
                        f"{'advanced' if tip_delta > 0 else 'held'}")}}
    if tip_delta > slack_slots:
        first_fr = {int(rid): r["frontier"]
                    for rid, r in win[0]["replicas"].items() if r["ok"]}
        last_fr = {int(rid): r["frontier"]
                   for rid, r in last["replicas"].items() if r["ok"]}
        starved = [rid for rid, fr in last_fr.items()
                   if rid in first_fr
                   and fr - first_fr[rid] <= slack_slots
                   and lags.get(rid, 0) > lag_slots]
        if starved and len(starved) < len(last_fr) // 2 + 1:
            suspect = max(starved, key=lags.get)
            return {
                "detector": "frontier_stall", "subject": suspect,
                "evidence": {
                    "window_s": round(last["t"] - win[0]["t"], 3),
                    "tip_delta": tip_delta,
                    "proposals_delta": prop_delta,
                    "in_flight": last["in_flight"],
                    "lags": lags,
                    "why": (f"replica {suspect} starved of commits: "
                            f"frontier flat while the tip advanced "
                            f"{tip_delta} slots (lag {lags[suspect]})")}}
        return None
    suspect = int(last["leader"])
    why = "leader cannot reach a quorum (every frontier flat)"
    lagging = [rid for rid, lag in lags.items() if lag > lag_slots]
    if lagging and len(lagging) < len(lags) // 2 + 1:
        suspect = max(lagging, key=lags.get)
        why = f"replica {suspect} lags the tip by {lags[suspect]} slots"
    elif lagging:
        why = (f"{len(lagging)}/{len(lags)} replicas starved of "
               f"commits at once — the leader is cut off")
    return {"detector": "frontier_stall", "subject": suspect,
            "evidence": {"window_s": round(last["t"] - win[0]["t"], 3),
                         "tip_delta": tip_delta,
                         "proposals_delta": prop_delta,
                         "in_flight": last["in_flight"],
                         "lags": lags, "why": why}}


def churn_alarm(samples: list[dict], window_s: float = 10.0,
                budget: int = 3) -> dict | None:
    """Election churn: more than ``budget`` election rounds across the
    cluster inside the window — a flapping leader (or a partition the
    master keeps re-promoting around) burns every election's prepare
    round against throughput."""
    win = _window(samples, window_s)
    if not win:
        return None
    delta = win[-1]["elections"] - win[0]["elections"]
    if delta <= budget:
        return None
    per = {int(rid): (win[-1]["replicas"][rid]["elections"]
                      - win[0]["replicas"].get(rid, {}).get("elections", 0))
           for rid in win[-1]["replicas"]}
    suspect = max(per, key=per.get) if per else -1
    return {"detector": "election_churn", "subject": suspect,
            "evidence": {"window_s": round(win[-1]["t"] - win[0]["t"], 3),
                         "elections": delta, "budget": budget,
                         "per_replica": per}}


def backlog_alarm(samples: list[dict], window_s: float = 5.0,
                  slope_per_s: float = 200.0,
                  min_backlog: int = 64) -> dict | None:
    """Exec-backlog growth: the worst per-replica committed-but-not-
    executed backlog grows faster than ``slope_per_s`` (least-squares
    over the window) and sits above ``min_backlog`` — execution is
    falling behind commitment, the precursor of the window-slide wedge
    ROADMAP item 4's admission control exists to prevent."""
    win = _window(samples, window_s)
    if not win:
        return None
    t0 = win[0]["t"]
    ts = np.asarray([s["t"] - t0 for s in win])
    bk = np.asarray([max((r["backlog"] for r in s["replicas"].values()
                          if r["ok"]), default=0) for s in win], float)
    if bk[-1] < min_backlog or ts[-1] <= 0:
        return None
    # least-squares slope (slots/s) over the window
    slope = float(np.polyfit(ts, bk, 1)[0]) if len(ts) > 1 else 0.0
    if slope <= slope_per_s:
        return None
    last = win[-1]
    per = {int(rid): r["backlog"] for rid, r in last["replicas"].items()
           if r["ok"]}
    suspect = max(per, key=per.get) if per else -1
    return {"detector": "backlog_growth", "subject": suspect,
            "evidence": {"window_s": round(last["t"] - t0, 3),
                         "slope_per_s": round(slope, 1),
                         "backlog": int(bk[-1]), "per_replica": per}}


def burn_alarm(samples: list[dict], window_s: float = 10.0,
               slo_ms: float = 50.0, budget_frac: float = 0.01,
               burn_x: float = 10.0, min_ticks: int = 50) -> dict | None:
    """p99 burn rate against the declared SLO: the fraction of ticks
    slower than ``slo_ms`` inside the window, divided by the SLO's
    error budget (``budget_frac``). A burn rate of 1.0 spends the
    budget exactly; >= ``burn_x`` means the tail is burning it
    ``burn_x`` times too fast — the standard multi-window burn alarm,
    evaluated on the tick-wall histograms the replicas already keep
    (``flatten_cluster_stats(slo_ms=...)`` derives the cumulative
    bad/total pair this differences)."""
    win = _window(samples, window_s)
    if not win or "hist_total" not in win[-1]:
        return None
    total = win[-1]["hist_total"] - win[0]["hist_total"]
    bad = win[-1]["hist_bad"] - win[0]["hist_bad"]
    if total < min_ticks:
        return None
    rate = bad / total
    burn = rate / budget_frac if budget_frac > 0 else float("inf")
    if burn < burn_x:
        return None
    per = {}
    for rid, r in win[-1]["replicas"].items():
        r0 = win[0]["replicas"].get(rid, {})
        t = r.get("hist_total", 0) - r0.get("hist_total", 0)
        b = r.get("hist_bad", 0) - r0.get("hist_bad", 0)
        if t > 0:
            per[int(rid)] = round(b / t, 4)
    suspect = max(per, key=per.get) if per else -1
    return {"detector": "p99_burn_rate", "subject": suspect,
            "evidence": {"window_s": round(win[-1]["t"] - win[0]["t"], 3),
                         "bad_ticks": int(bad), "ticks": int(total),
                         "bad_frac": round(rate, 4),
                         "slo_ms": slo_ms, "budget_frac": budget_frac,
                         "burn": round(burn, 2),
                         "per_replica_bad_frac": per}}


@dataclass
class SLO:
    """The declared service objective + detector tuning, evaluated as
    a unit (OBSERVABILITY.md has the catalogue and tuning notes)."""

    stall_s: float = 1.0          # frontier flat this long under load
    stall_slack_slots: int = 8    # in-flight traffic still landing
    stall_lag_slots: int = 16     # laggard attribution threshold
    churn_window_s: float = 10.0
    churn_budget: int = 3         # elections allowed per window
    backlog_window_s: float = 5.0
    backlog_slope_per_s: float = 200.0
    backlog_min: int = 64
    burn_window_s: float = 10.0
    p99_ms: float = 50.0          # the latency SLO ticks burn against
    burn_budget_frac: float = 0.01
    burn_x: float = 10.0
    burn_min_ticks: int = 50

    def evaluate(self, samples: list[dict]) -> list[dict]:
        """Every currently-firing alarm at the series' newest sample
        (deduped by detector; [] = healthy)."""
        out = []
        for a in (
            stall_alarm(samples, self.stall_s, self.stall_slack_slots,
                        self.stall_lag_slots),
            churn_alarm(samples, self.churn_window_s, self.churn_budget),
            backlog_alarm(samples, self.backlog_window_s,
                          self.backlog_slope_per_s, self.backlog_min),
            burn_alarm(samples, self.burn_window_s, self.p99_ms,
                       self.burn_budget_frac, self.burn_x,
                       self.burn_min_ticks),
        ):
            if a is not None:
                out.append(a)
        return out


# -------------------------------------------------- live evaluation


class HealthWatcher:
    """Streaming detector evaluation over a polled sample series.

    ``poll_once`` appends one sample (polled via ``poll_fn`` or passed
    in), evaluates the SLO, and edge-detects alarms: a detector firing
    that wasn't firing is RAISED (journal EV_ALARM, severity alert,
    subject = the attributed replica, value = the evidence window in
    ms, aux = the detector id); a raised detector that stopped firing
    is CLEARED (EV_ALARM_CLEAR). A detector that goes on firing at
    another subject clears its alarm and raises a new one: an alarm
    keeps the subject it was raised with (the JAX package's watcher
    relabels it in place, so a healed isolated leader's alarm could end
    naming a follower that caught up one batch late, its clear row
    naming another replica than its raise row). The full alarm dicts — raise/clear
    wall times plus the evidence window — accumulate on ``alarms`` for
    artifacts. The in-memory series is bounded to the longest detector
    window (plus slack); disk retention is :class:`HealthSeries`'s
    job, wired via ``series``."""

    def __init__(self, poll_fn=None, slo: SLO | None = None,
                 journal: EventJournal | None = None,
                 series: "HealthSeries | None" = None,
                 interval_s: float = 0.25):
        self.poll_fn = poll_fn
        self.slo = slo or SLO()
        self.journal = journal or EventJournal(capacity=512)
        self.series = series
        self.interval_s = interval_s
        keep_s = max(self.slo.stall_s, self.slo.churn_window_s,
                     self.slo.backlog_window_s, self.slo.burn_window_s)
        self._keep_s = keep_s * 2 + 5.0
        self.samples: list[dict] = []
        self.alarms: list[dict] = []
        self.poll_errors = 0
        self._active: dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def poll_once(self, resp: dict | None = None,
                  t_wall: float | None = None) -> list[dict]:
        """One sample + evaluation; returns the currently-raised
        alarms (after this sample)."""
        if resp is None:
            resp = self.poll_fn()
        sample = flatten_cluster_stats(resp, slo_ms=self.slo.p99_ms,
                                       t_wall=t_wall)
        self.samples.append(sample)
        cut = sample["t"] - self._keep_s
        while len(self.samples) > 2 and self.samples[0]["t"] < cut:
            self.samples.pop(0)
        if self.series is not None:
            self.series.append(sample)
        firing = {a["detector"]: a for a in self.slo.evaluate(self.samples)}
        now = sample["t"]
        for det in list(self._active):
            a = firing.get(det)
            if a is None or a["subject"] != self._active[det]["subject"]:
                # stopped firing, or firing at another subject: an alarm
                # keeps the subject it was raised with (its raise and
                # clear rows name one replica), and a moved attribution
                # (a healed isolated leader whose followers catch up one
                # batch apart) raises a new alarm below
                rec = self._active.pop(det)
                rec["t_cleared"] = now
                self.journal.record(EV_ALARM_CLEAR,
                                    subject=rec["subject"],
                                    aux=DETECTOR_IDS[det])
        for det, a in firing.items():
            if det not in self._active:
                rec = {"detector": det, "subject": a["subject"],
                       "t_raised": now, "t_cleared": None,
                       "evidence": a["evidence"]}
                self._active[det] = rec
                self.alarms.append(rec)
                self.journal.record(
                    EV_ALARM, subject=a["subject"],
                    value=int(a["evidence"].get("window_s", 0) * 1e3),
                    aux=DETECTOR_IDS[det])
            else:  # still firing at its subject: keep the evidence fresh
                self._active[det]["evidence"] = a["evidence"]
        return list(self._active.values())

    # -- background polling (the campaign / CLI watch loop) --

    def start(self) -> None:
        assert self.poll_fn is not None, "start() needs a poll_fn"
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except (OSError, ValueError, KeyError):
                # an unreachable master is a gap in the series, not a
                # watcher crash — the next poll may land again
                self.poll_errors += 1
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def summary(self) -> dict:
        """JSON-able verdict: alarms raised (with windows), detector
        counts, sample count — the campaign/artifact stanza."""
        counts: dict[str, int] = {}
        for a in self.alarms:
            counts[a["detector"]] = counts.get(a["detector"], 0) + 1
        return {"samples": len(self.samples),
                "alarm_counts": counts,
                "alarms": [dict(a) for a in self.alarms],
                "events": self.journal.counts_by_kind()}


# ------------------------------------------------------- retention


def _flat_numeric(sample: dict, prefix: str = "") -> dict[str, float]:
    """Flatten a health sample into {dotted key: number} (the
    downsample's per-key series)."""
    out: dict[str, float] = {}
    for k, v in sample.items():
        if isinstance(v, dict):
            out.update(_flat_numeric(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f"{prefix}{k}"] = float(v)
    return out


def _pcts(values: list[float]) -> dict:
    v = sorted(values)
    if not v:
        return {"p50": 0.0, "p99": 0.0, "max": 0.0, "n": 0}
    pick = lambda q: v[min(int(q * len(v)), len(v) - 1)]  # noqa: E731
    return {"p50": pick(0.50), "p99": pick(0.99), "max": v[-1],
            "n": len(v)}


class HealthSeries:
    """Append-only on-disk health series with streaming downsample.

    Recent samples are kept RAW (full flattened sample, one JSONL line
    each); samples older than ``raw_keep_s`` are folded into coarse
    buckets of ``coarse_s`` seconds holding p50/p99/max per key — the
    shape a week-long run needs: full recent detail, bounded history
    forever. The file is append-only between compactions; when it
    grows past ``max_bytes`` it is rewritten atomically from the
    in-memory state (coarse buckets + retained raws), which bounds it
    at roughly ``max_bytes`` for any run length — coarse buckets
    beyond ``max_coarse`` fold pairwise into double-width buckets
    (their value lists merge, so percentiles stay exact over the
    merged population).

    ``path=None`` keeps everything in memory (the campaign's
    short-lived watcher).
    """

    def __init__(self, path: str | None = None,
                 raw_keep_s: float = 300.0, coarse_s: float = 60.0,
                 max_bytes: int = 8 << 20, max_coarse: int = 4096):
        self.path = path
        self.raw_keep_s = raw_keep_s
        self.coarse_s = coarse_s
        self.max_bytes = max_bytes
        self.max_coarse = max_coarse
        self._raw: deque[tuple[float, dict]] = deque()
        self.coarse: list[dict] = []
        # open bucket: bucket index -> {key: [values]}
        self._open_id: int | None = None
        self._open_vals: dict[str, list[float]] = {}
        self._open_t0 = 0.0
        self._open_t1 = 0.0
        self._fh = None
        self.appended = 0
        if path:
            self._fh = open(path, "a", encoding="utf-8")

    # -- ingest --

    def append(self, sample: dict) -> None:
        t = float(sample["t"])
        flat = _flat_numeric(sample)
        self._raw.append((t, flat))
        self.appended += 1
        self._write({"raw": flat})
        while self._raw and self._raw[0][0] < t - self.raw_keep_s:
            self._fold(*self._raw.popleft())
        if (self._fh is not None
                and self._fh.tell() > self.max_bytes):
            self.compact()

    def _fold(self, t: float, flat: dict) -> None:
        """Move one expired raw sample into its coarse bucket."""
        bid = int(t // self.coarse_s)
        if self._open_id is not None and bid != self._open_id:
            self._close_bucket()
        if self._open_id is None:
            self._open_id = bid
            self._open_t0 = t
            self._open_vals = {}
        self._open_t1 = t
        for k, v in flat.items():
            self._open_vals.setdefault(k, []).append(v)

    def _close_bucket(self) -> None:
        if self._open_id is None:
            return
        bucket = {"t0": self._open_t0, "t1": self._open_t1,
                  "stats": {k: _pcts(v)
                            for k, v in self._open_vals.items()},
                  "_vals": self._open_vals}
        self.coarse.append(bucket)
        self._write({"coarse": {"t0": bucket["t0"], "t1": bucket["t1"],
                                "stats": bucket["stats"]}})
        self._open_id = None
        self._open_vals = {}
        if len(self.coarse) > self.max_coarse:
            self._merge_coarse()

    def _merge_coarse(self) -> None:
        """Pairwise-merge the OLDEST half of the coarse buckets into
        double-width ones: history depth doubles, bucket count halves,
        percentiles recomputed over the merged populations."""
        half = len(self.coarse) // 2
        old, keep = self.coarse[:half], self.coarse[half:]
        merged = []
        for i in range(0, len(old), 2):
            pair = old[i:i + 2]
            vals: dict[str, list[float]] = {}
            for b in pair:
                for k, v in b["_vals"].items():
                    vals.setdefault(k, []).extend(v)
            merged.append({"t0": pair[0]["t0"], "t1": pair[-1]["t1"],
                           "stats": {k: _pcts(v) for k, v in vals.items()},
                           "_vals": vals})
        self.coarse = merged + keep

    # -- disk --

    def _write(self, doc: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(doc) + "\n")
            self._fh.flush()

    def compact(self) -> None:
        """Atomically rewrite the file from in-memory state: coarse
        buckets then retained raw samples — the append-only log's
        periodic truncation that bounds it near ``max_bytes``."""
        if self.path is None:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for b in self.coarse:
                f.write(json.dumps({"coarse": {
                    "t0": b["t0"], "t1": b["t1"],
                    "stats": b["stats"]}}) + "\n")
            for t, flat in self._raw:
                f.write(json.dumps({"raw": flat}) + "\n")
        if self._fh is not None:
            self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        self._close_bucket()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def summary(self) -> dict:
        size = 0
        if self.path:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                size = 0
        span = 0.0
        if self.coarse:
            span = (self._raw[-1][0] if self._raw
                    else self.coarse[-1]["t1"]) - self.coarse[0]["t0"]
        elif len(self._raw) >= 2:
            span = self._raw[-1][0] - self._raw[0][0]
        return {"appended": self.appended, "raw": len(self._raw),
                "coarse": len(self.coarse), "span_s": round(span, 1),
                "file_bytes": size}


def load_series(path: str) -> dict:
    """Parse a HealthSeries file back into {"raw": [flat dicts],
    "coarse": [bucket dicts]}."""
    raw, coarse = [], []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            try:
                doc = json.loads(ln)
            except json.JSONDecodeError:
                continue  # torn tail of a killed watcher
            if "raw" in doc:
                raw.append(doc["raw"])
            elif "coarse" in doc:
                coarse.append(doc["coarse"])
    return {"raw": raw, "coarse": coarse}
