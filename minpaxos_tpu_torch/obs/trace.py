"""paxtrace — sampled per-command distributed tracing (stage spans).

The port's copy of the JAX package's ``obs/trace.py`` (numpy and the
standard library only; the same names, wire format and defaults).

The flight recorder sees per-tick aggregates and the telemetry ring
sees device rounds; neither can say where ONE slow command spent its
time. This module is that piece: a compact trace context per sampled
command, stage spans stamped by every component the command crosses
(client send, transport frame decode, replica drain, the dispatch
window to commit, execution, reply serialization, client reply
receipt), and the offline math that turns span chains into a
per-stage latency decomposition — "p99 is 497 ms" becomes "p99
commands spend X ms waiting in <stage>".

Design rules (all inherited from paxmon, OBSERVABILITY.md):

* **Deterministic sampling, no coordination.** A command is traced iff
  ``mix64(cmd_id)`` has its low ``sample_pow2`` bits zero — a pure
  function of the command id, so the client, every transport reader
  thread and every replica agree on the sample set without exchanging
  a single byte. ``sample_pow2 = k`` samples 1 in 2^k; 0 samples all.
* **Zero-alloc single-writer rings.** Spans go into per-thread
  fixed-size numpy rings (one slice-assign per span, newest spans
  survive wraparound) owned by a :class:`TraceSink`; collection copies
  under a tiny lock, exactly like the flight recorder.
* **Wire extension is append-only.** The context frame
  (``MsgKind.TRACE_CTX``: cmd_id + trace id + wall-clock origin
  timestamp) is a
  NEW opcode in the frozen ledger (analysis/wire_golden.py); tracing
  disabled emits nothing, so v1 peers see a byte-identical stream, and
  v2 peers parse v1 streams (no ctx frame) unchanged.
* **numpy + stdlib only** — importable by ``cli/tail.py`` with no
  torch import.

Clock domains: spans are stamped with ``time.perf_counter_ns``
(CLOCK_MONOTONIC — machine-wide on Linux, the flight recorder's
clock). Every collection carries a ``(mono_ns, wall_ns)`` anchor pair
taken at collection time; :func:`align_collections` uses the anchors
to shift every process's spans into one reference monotonic domain,
which is a ~0 shift for same-host processes and the honest correction
for cross-host ones.
"""

from __future__ import annotations

import threading
import time

import numpy as np

_U64 = np.uint64
_MASK64 = (1 << 64) - 1

#: default sampling exponent: 1 command in 2^4 = 16 is traced. The
#: per-command cost rides only on sampled commands (a handful of ring
#: writes); unsampled commands pay one vectorized hash per batch.
DEFAULT_SAMPLE_POW2 = 4

# ------------------------------------------------------------- sampling


def mix64(x):
    """splitmix64 finalizer over uint64 (vectorized). The one hash
    both sides of the wire compute: sampling and trace-id derivation
    are pure functions of the command id, so distributed agreement
    needs no coordination. Accepts ints or integer ndarrays; negative
    inputs wrap (two's complement), matching :func:`mix64_scalar`."""
    with np.errstate(over="ignore"):  # wraparound IS the hash
        z = (np.asarray(x).astype(np.int64).view(_U64)
             + _U64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        return z ^ (z >> _U64(31))


def mix64_scalar(x: int) -> int:
    """Pure-Python mix64 for single ids (the reply hot path stamps one
    command at a time; a numpy round-trip there costs more than the
    hash). Bit-identical to :func:`mix64` — pinned by test."""
    z = ((x & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sampled_mask(cmd_ids, sample_pow2: int) -> np.ndarray:
    """Boolean mask of traced commands (vectorized)."""
    if sample_pow2 <= 0:
        return np.ones(np.asarray(cmd_ids).shape, bool)
    return (mix64(cmd_ids) & _U64((1 << sample_pow2) - 1)) == 0


def is_sampled(cmd_id: int, sample_pow2: int) -> bool:
    """Scalar sampling decision — agrees with :func:`sampled_mask`."""
    if sample_pow2 <= 0:
        return True
    return (mix64_scalar(int(cmd_id)) & ((1 << sample_pow2) - 1)) == 0


def trace_id_for(cmd_id) -> np.ndarray | int:
    """Trace id for a command: mix64(cmd_id) reinterpreted as a signed
    i64 (the ring/wire field width), forced odd so 0 never appears (0
    marks spans whose writer did not know the id)."""
    if np.ndim(cmd_id) == 0:
        return int(np.int64(_U64(mix64_scalar(int(cmd_id)) | 1)))
    return (mix64(cmd_id) | _U64(1)).view(np.int64)


# ------------------------------------------------------------- span rings

#: span stages, in causal order along one command's path. ORIGIN is
#: the replica-side echo of the client's ctx origin timestamp (so a
#: cluster-only collection still has the chain's start); SEND is the
#: client's own measured send span and wins over ORIGIN when both were
#: collected.
(ST_SEND, ST_ORIGIN, ST_DECODE, ST_DRAIN, ST_COMMIT, ST_EXEC,
 ST_REPLY_SER, ST_REPLY_RECV) = range(8)
N_STAGES = 8
STAGE_NAMES = ("send", "origin", "decode", "drain", "commit", "exec",
               "reply_ser", "reply_recv")

# span-row field layout: trace id, stage, start/end ns (monotonic),
# aux (stage-specific: cmd_id for client/ingress stages, the log slot
# for COMMIT, the owner's dispatch count for DRAIN/EXEC — the round-id
# correlation into the flight recorder / paxray rows)
(SP_TRACE, SP_STAGE, SP_T0, SP_T1, SP_AUX) = range(5)
N_SPAN_FIELDS = 5

#: derived stage-decomposition buckets (consecutive differences of the
#: chain's boundary timestamps — they telescope, so their sum is
#: EXACTLY the traced end-to-end latency). client_send = the client's
#: frame build+flush; transport_in = wire transit + frame decode;
#: queue_wait = decoded frame sitting in the owner queue before the
#: protocol thread drained it; commit = drain -> the readback of the
#: dispatch whose frontier covered the command's slot (the proposal ->
#: commit device rounds); exec_wait = commit -> the reply pass that
#: executed it (exec backlog); reply_build = reply serialization on
#: the replica; transport_out = reply transit back (absent when only
#: cluster-side spans were collected).
DECOMP_STAGES = ("client_send", "transport_in", "queue_wait", "commit",
                 "exec_wait", "reply_build", "transport_out")


# the one span clock, shared with the runtime (utils.clock is
# stdlib-only, so the no-JAX paxtop contract holds) — two definitions
# would invite the trace clock domains silently splitting
from minpaxos_tpu_torch.utils.clock import monotonic_ns  # noqa: E402,F401


class SpanRing:
    """Fixed-capacity ring of span rows, single-writer (one thread),
    snapshot-from-anywhere — the flight recorder's discipline, five
    int64 fields per row. Wraparound keeps the NEWEST spans."""

    __slots__ = ("capacity", "_buf", "total", "_lock")

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"span ring capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self._buf = np.zeros((capacity, N_SPAN_FIELDS), np.int64)
        self.total = 0
        self._lock = threading.Lock()

    def record(self, trace_id: int, stage: int, t0_ns: int, t1_ns: int,
               aux: int = 0) -> None:
        with self._lock:
            self._buf[self.total % self.capacity] = (
                trace_id, stage, t0_ns, t1_ns, aux)
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


class TraceSink:
    """All of one process's span rings + the sampling config.

    ``ring()`` hands each calling thread its OWN ring (created lazily,
    registered under the sink lock), so every ``record`` stays
    single-writer with no hot-path lock. A ring whose owner thread has
    DIED is adopted by the next thread that needs one instead of
    leaking: transport spawns a reader thread per client connection,
    so on a long-lived server with client churn a never-reaped
    registry would grow a 160 KB ring per reconnect forever (and every
    TRACESPANS collect would serialize all of them). The dead owner's
    spans stay in the adopted ring, still collectable.
    """

    def __init__(self, enabled: bool = True,
                 sample_pow2: int = DEFAULT_SAMPLE_POW2,
                 ring_capacity: int = 4096):
        self.enabled = enabled
        self.sample_pow2 = sample_pow2
        self.ring_capacity = ring_capacity
        # ring -> owning Thread; rewritten on adoption under the lock
        self._rings: dict[SpanRing, threading.Thread] = {}
        self._tls = threading.local()
        self._lock = threading.Lock()

    # -- hot path --

    def ring(self) -> SpanRing:
        r = getattr(self._tls, "ring", None)
        if r is None:
            me = threading.current_thread()
            with self._lock:
                for cand, owner in self._rings.items():
                    if not owner.is_alive():
                        r = cand
                        break
                if r is None:
                    r = SpanRing(self.ring_capacity)
                self._rings[r] = me
            self._tls.ring = r
        return r

    def sampled(self, cmd_ids) -> np.ndarray:
        return sampled_mask(cmd_ids, self.sample_pow2)

    def is_sampled(self, cmd_id: int) -> bool:
        return is_sampled(cmd_id, self.sample_pow2)

    def stamp(self, stage: int, cmd_id: int, t0_ns: int, t1_ns: int,
              aux: int | None = None) -> None:
        """One span for one sampled command (caller already checked
        sampling)."""
        self.ring().record(trace_id_for(int(cmd_id)), stage, t0_ns, t1_ns,
                           int(cmd_id) if aux is None else int(aux))

    def stamp_batch(self, stage: int, cmd_ids, t0_ns: int, t1_ns: int,
                    aux: int | None = None) -> int:
        """Stamp every SAMPLED id of a batch with a shared span window;
        returns how many were stamped. The unsampled fast path is one
        vectorized hash over the batch."""
        ids = np.asarray(cmd_ids)
        if ids.size == 0:
            return 0
        m = self.sampled(ids)
        if not m.any():
            return 0
        ring = self.ring()
        take = ids[m]
        for tid, cid in zip(trace_id_for(take).tolist(), take.tolist()):
            ring.record(tid, stage, t0_ns, t1_ns,
                        cid if aux is None else aux)
        return int(m.sum())

    # -- observability of the observer --

    def spans_total(self) -> int:
        with self._lock:
            rings = list(self._rings)
        return sum(r.total for r in rings)

    def spans_dropped(self) -> int:
        with self._lock:
            rings = list(self._rings)
        return sum(r.dropped for r in rings)

    # -- collection (TRACESPANS verb payload) --

    def collect(self) -> dict:
        """JSON-serializable snapshot of every ring, plus the clock
        anchor: ``mono_ns``/``wall_ns`` sampled back-to-back at collect
        time, the pair :func:`align_collections` aligns processes by."""
        with self._lock:
            rings = list(self._rings)
        spans = [r.snapshot() for r in rings]
        rows = (np.concatenate(spans) if spans
                else np.zeros((0, N_SPAN_FIELDS), np.int64))
        return {
            "enabled": self.enabled,
            "sample_pow2": self.sample_pow2,
            "total": sum(r.total for r in rings),
            "dropped": sum(r.dropped for r in rings),
            "anchor": clock_anchor(),
            "spans": rows.tolist(),
        }


def clock_anchor() -> dict:
    """(monotonic, wall) ns pair for cross-process span alignment."""
    return {"mono_ns": monotonic_ns(), "wall_ns": time.time_ns()}


# --------------------------------------------------------- offline math


def align_collections(collections: list[dict],
                      ref_anchor: dict | None = None) -> np.ndarray:
    """Merge collections from several processes into one span matrix
    in the REFERENCE process's monotonic domain.

    Each process's offset is ``wall_ns - mono_ns`` from its anchor;
    shifting a span by ``(offset - ref_offset)`` lands it on the
    reference monotonic clock (exact up to wall-clock skew; ~0 between
    processes of one host, where CLOCK_MONOTONIC is already shared).
    ``ref_anchor`` defaults to the first collection's anchor.
    """
    out = []
    ref = ref_anchor or next(
        (c["anchor"] for c in collections if c.get("anchor")), None)
    ref_off = (ref["wall_ns"] - ref["mono_ns"]) if ref else 0
    for c in collections:
        rows = np.asarray(c.get("spans") or [], np.int64)
        if rows.size == 0:
            continue
        rows = rows.reshape(-1, N_SPAN_FIELDS).copy()
        a = c.get("anchor")
        shift = ((a["wall_ns"] - a["mono_ns"]) - ref_off) if a else 0
        rows[:, SP_T0] += shift
        rows[:, SP_T1] += shift
        out.append(rows)
    return (np.concatenate(out) if out
            else np.zeros((0, N_SPAN_FIELDS), np.int64))


#: backwards-walk selection order: the chain is anchored at its END
#: (the reply that actually happened) and each earlier stage picks
#: the newest duplicate that still FITS under the next boundary.
_SELECT_ORDER = (ST_REPLY_RECV, ST_REPLY_SER, ST_EXEC, ST_COMMIT,
                 ST_DRAIN, ST_DECODE, ST_SEND, ST_ORIGIN)
#: per-stage slack for the fit test (and stage_decomposition's stale
#: guard): writer threads stamp independently, so adjacent boundaries
#: can jitter ~µs out of order on a real host.
_STALE_CHAIN_NS = 1_000_000  # 1 ms


def span_chains(spans: np.ndarray) -> dict[int, dict[int, tuple]]:
    """Group spans by trace id: {trace_id: {stage: (t0, t1, aux)}}.

    When a stage appears more than once for a trace — a client RETRY
    re-stamps send/decode (the server's same-connection dedup keeps
    one drain/commit), and cmd_id reuse against long-lived rings mixes
    whole lives — duplicates are resolved by a backwards walk from the
    chain's end: anchor on the NEWEST reply, then each earlier stage
    keeps the newest span whose end still precedes the stage after it.
    A deduped retry therefore recovers its FIRST attempt's send/decode
    (the retry's re-stamps are newer than the admitted decode and get
    skipped), so the p99 tail the tool exists to explain is measured
    rather than dropped — while id-reusing benches resolve to the
    newest self-consistent life instead of splicing two lives into an
    impossible chain."""
    raw: dict[int, dict[int, list]] = {}
    for tid, stage, t0, t1, aux in np.asarray(spans, np.int64).tolist():
        if tid == 0:
            continue
        raw.setdefault(tid, {}).setdefault(stage, []).append((t0, t1, aux))
    chains: dict[int, dict[int, tuple]] = {}
    for tid, stages in raw.items():
        sel: dict[int, tuple] = {}
        bound = None  # no constraint until an anchor stage is found
        for stage in _SELECT_ORDER:
            cand = stages.get(stage)
            if not cand:
                continue
            cand.sort(key=lambda s: s[1])
            pick = None
            for s in reversed(cand):  # newest first
                if bound is None or s[1] <= bound + _STALE_CHAIN_NS:
                    pick = s
                    break
            if pick is None:
                continue  # stage only has spans from a NEWER life
            sel[stage] = pick
            bound = pick[1]
        chains[tid] = sel
    return chains


def stage_decomposition(chains: dict[int, dict[int, tuple]]) -> list[dict]:
    """Per-trace stage durations (ms) for every COMPLETE chain.

    A chain is complete when it has a start (SEND or ORIGIN) and the
    full replica path (DECODE..REPLY_SER); REPLY_RECV is optional
    (absent when only cluster-side spans were collected — the chain
    then ends at reply serialization and ``transport_out`` is 0).
    Stage values are consecutive boundary differences, so per trace
    ``sum(stages) == total`` holds exactly.

    Chains whose boundaries run BACKWARDS by more than ~clock jitter
    are dropped: causally a command's stages are ordered, so a
    decisively negative stage means the chain mixed spans from two
    lives of a reused cmd_id (e.g. bench trials sharing ids against
    long-lived rings — one trial's commit joined to another's exec)
    and would poison the aggregate table with impossible values.
    """
    out = []
    for tid, st in chains.items():
        start = st.get(ST_SEND) or st.get(ST_ORIGIN)
        if start is None:
            continue
        if not all(s in st for s in
                   (ST_DECODE, ST_DRAIN, ST_COMMIT, ST_EXEC, ST_REPLY_SER)):
            continue
        # boundary timestamps, causal order; each stage is the step to
        # the next boundary
        bounds = [start[0], start[1], st[ST_DECODE][1], st[ST_DRAIN][1],
                  st[ST_COMMIT][1], st[ST_EXEC][1], st[ST_REPLY_SER][1]]
        if ST_REPLY_RECV in st:
            bounds.append(st[ST_REPLY_RECV][1])
        if min(np.diff(bounds)) < -_STALE_CHAIN_NS:
            continue
        stages = {name: (bounds[i + 1] - bounds[i]) / 1e6
                  for i, name in enumerate(DECOMP_STAGES)
                  if i + 1 < len(bounds)}
        for name in DECOMP_STAGES:
            stages.setdefault(name, 0.0)
        out.append({
            "trace_id": tid,
            # aux conventions: cmd_id on SEND/ORIGIN/DECODE/REPLY_*,
            # the owner's dispatch count on DRAIN/EXEC (the round-id
            # correlation into flight-recorder rows), the log slot on
            # COMMIT
            "cmd_id": start[2],
            "slot": st[ST_COMMIT][2],
            "commit_dispatches": st[ST_EXEC][2] - st[ST_DRAIN][2],
            "total_ms": (bounds[-1] - bounds[0]) / 1e6,
            "stages": stages,
        })
    return out


def _pcts(values) -> dict:
    v = np.sort(np.asarray(values, float))
    if v.size == 0:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "p999": 0.0,
                "mean": 0.0, "max": 0.0}
    pick = lambda q: float(v[min(int(q * len(v)), len(v) - 1)])  # noqa: E731
    return {"p50": pick(0.50), "p90": pick(0.90), "p99": pick(0.99),
            "p999": pick(0.999), "mean": float(v.mean()),
            "max": float(v.max())}


def analyze_collections(
        collections: list[dict]) -> tuple[dict, list[dict], dict]:
    """(stage table, per-trace decomposition, chains) for a set of
    span collections — the ONE pipeline tools/tail.py, bench_tcp and
    the obs_smoke gate all share, so the bench artifact can never
    silently diverge from what tail.py prints."""
    chains = span_chains(align_collections(collections))
    decomp = stage_decomposition(chains)
    return stage_table(decomp), decomp, chains


def stage_table(decomp: list[dict]) -> dict:
    """Aggregate a decomposition into the tail-attribution record:
    per-stage p50/p90/p99/p999 (ms), the end-to-end distribution, and
    the worst-stage call-out — among the commands at or beyond the
    end-to-end p99, which stage ate the most time on average."""
    totals = [d["total_ms"] for d in decomp]
    table = {
        "n_traced": len(decomp),
        "total_ms": _pcts(totals),
        "stages": {name: _pcts([d["stages"][name] for d in decomp])
                   for name in DECOMP_STAGES},
    }
    if decomp:
        p99 = table["total_ms"]["p99"]
        tail = [d for d in decomp if d["total_ms"] >= p99] or decomp
        means = {name: float(np.mean([d["stages"][name] for d in tail]))
                 for name in DECOMP_STAGES}
        worst = max(means, key=means.get)
        table["tail"] = {
            "n": len(tail), "worst_stage": worst,
            "worst_stage_ms": means[worst],
            "stage_means_ms": means,
        }
    return table


def format_stage_table(table: dict) -> str:
    """Human-readable stage-decomposition table (tail.py's output)."""
    lines = [f"paxtrace stage decomposition — {table['n_traced']} traced "
             f"commands",
             f"{'stage':<14}{'p50':>9}{'p90':>9}{'p99':>9}{'p999':>10}"
             f"{'max':>10}  (ms)"]
    rows = list(table["stages"].items()) + [("TOTAL", table["total_ms"])]
    for name, p in rows:
        lines.append(f"{name:<14}{p['p50']:>9.2f}{p['p90']:>9.2f}"
                     f"{p['p99']:>9.2f}{p['p999']:>10.2f}{p['max']:>10.2f}")
    tail = table.get("tail")
    if tail:
        lines.append(
            f"p99-tail commands ({tail['n']}) spend "
            f"{tail['worst_stage_ms']:.2f} ms on average in "
            f"<{tail['worst_stage']}> — the worst stage")
    return "\n".join(lines)


# ------------------------------------------------- Perfetto span events

# reserved pid for per-command span tracks in merged traces (schema
# v5) — sibling of the paxray DEVICE_PID reservation: host recorder
# events use replica-id pids, device rounds 9999, command spans 9998.
# Canonical in obs/recorder.py next to DEVICE_PID (the validator
# enforces both reservations).
from minpaxos_tpu_torch.obs.recorder import TRACE_PID  # noqa: E402


def span_events(decomp: list[dict], chains: dict[int, dict[int, tuple]],
                pid: int = TRACE_PID) -> list[dict]:
    """Chrome trace events for traced commands: per command one
    enclosing slice plus one child slice per derived stage, on the
    reserved TRACE_PID with one tid per command — merged with the
    flight-recorder / device-round events they share a timeline with
    (all stamped from the same aligned monotonic domain)."""
    events: list[dict] = []
    for tidx, d in enumerate(sorted(decomp, key=lambda d: -d["total_ms"])):
        st = chains.get(d["trace_id"], {})
        start = st.get(ST_SEND) or st.get(ST_ORIGIN)
        if start is None:
            continue
        t = start[0] / 1e3  # trace-event ts unit: us
        events.append({
            "name": f"cmd:{d['cmd_id']}", "cat": "paxtrace", "ph": "X",
            "ts": t, "dur": max(d["total_ms"] * 1e3, 1.0),
            "pid": pid, "tid": tidx,
            "args": {"trace_id": d["trace_id"], "cmd_id": d["cmd_id"],
                     "slot": d["slot"], "total_ms": d["total_ms"]}})
        for name in DECOMP_STAGES:
            dur_us = d["stages"][name] * 1e3
            if dur_us > 0:
                events.append({
                    "name": name, "cat": "paxtrace", "ph": "X",
                    "ts": t, "dur": dur_us, "pid": pid, "tid": tidx,
                    "args": {"trace_id": d["trace_id"]}})
            t += dur_us
    return events
