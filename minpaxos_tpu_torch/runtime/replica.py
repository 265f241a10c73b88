"""The replica server process: one protocol thread, one packed step.

The port of the JAX package's ``runtime/replica.py``. Reader threads
enqueue decoded frames; the protocol thread drains them into a
fixed-shape column batch and advances the replica with one packed step
per dispatch (``_packed_step``: k protocol substeps, every substep's
outbox, exec results and scalars packed by kernel K7 into one int32
buffer); the outbox scatters back to peer and client sockets.
Durability, beacons, READ serving, beyond-window catch-up, snapshots
and the control verbs ride the host path around the device step.

The device step runs on the card (``RuntimeFlags.device``, default
``cuda``) or, on request, on the CPU through the kernels' plain twins.
The replica is a batch of one (B = 1) in the port's batched state.

Single owner: protocol state, writers and the stable store are touched
only by the protocol thread. The step updates ``state.kv`` in place on
the card, so no other thread may read ``self.state``; the control
plane reads the plain-Python ``snapshot`` published at each readback.

Readback: the dispatch enqueues the step and K7, then one
non-blocking copy of the packed buffer into a pinned host buffer and a
CUDA event; the previous dispatch's host phases run before the event
is waited on, so they overlap the device work (the depth-2 pipeline).
Two pinned buffers alternate, so the deferred dispatch's host arrays
are never overwritten by the copy in flight.

The event journal (``obs/watch.py``) records the JAX package's server
events at its sites (recovery, store corruption, snapshot and truncate,
election, leader change, narrow fallback, fail-stop, fault-plan install
and clear) and is served by the ``events`` control verb; the ``chaos``
verb installs, clears and reports a fault plan (``chaos/shim.py``) on
the live transport. The flight recorder (``obs/recorder.py``) writes
one row per dispatch and per idle skip: regime, substeps, rows, the
frontier and the wall of each phase (drain, enqueue, readback, persist,
dispatch, reply); the ``trace`` verb serves it as Chrome trace events
with the journal beside it. paxtrace (``obs/trace.py``) stamps sampled
commands' stage spans (origin, drain, commit, exec, reply
serialization; the transport's readers stamp decode), served by the
``tracespans`` verb. Both are host work around the dispatch: neither
adds a device sync. The ``stats`` verb also carries the kernels'
launches since the warm-up. Not carried over from the JAX package's
server (the soak harness's scenario side): the burn-rate admission arm
and the ``phase`` control verb.
"""

from __future__ import annotations

import heapq
import json
import queue
import socket
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.chaos import ChaosShim, FaultPlan
from minpaxos_tpu_torch.device import resolve_device
from minpaxos_tpu_torch.models.minpaxos import (
    ACCEPTED,
    COMMITTED,
    NO_BALLOT,
    MinPaxosConfig,
    MsgBatch,
    become_leader,
    init_replica,
    replica_step_impl,
)
from minpaxos_tpu_torch.obs.metrics import TICK_MS_BUCKETS, MetricsRegistry
from minpaxos_tpu_torch.obs.recorder import (
    KIND_FULL,
    KIND_FUSED,
    KIND_IDLE_SKIP,
    KIND_NARROW,
    FlightRecorder,
)
from minpaxos_tpu_torch.obs.trace import (
    ST_COMMIT,
    ST_DRAIN,
    ST_EXEC,
    ST_ORIGIN,
    ST_REPLY_SER,
    TraceSink,
    trace_id_for,
)
from minpaxos_tpu_torch.obs.watch import (
    EV_CHAOS_CLEAR,
    EV_CHAOS_INSTALL,
    EV_ELECTION,
    EV_FATAL,
    EV_LEADER_CHANGE,
    EV_NARROW_FALLBACK,
    EV_RECOVERY,
    EV_SNAPSHOT,
    EV_STORE_CORRUPT,
    EV_TRUNCATE,
    EventJournal,
    event_chrome_events,
)
from minpaxos_tpu_torch.ops.kvstore import LIVE, kv_insert_unique
from minpaxos_tpu_torch.ops.packed import join_i64, split_i64
from minpaxos_tpu_torch.ops.substeps import (
    SCAL_CRT_INST,
    SCAL_EXEC_COUNT,
    SCAL_EXECUTED,
    SCAL_FRONTIER,
    SCAL_HIGH_ANCHOR,
    SCAL_KV_DROPPED,
    SCAL_LEADER,
    SCAL_LOW_ANCHOR,
    SCAL_NAMES,
    SCAL_PREPARED,
    SCAL_WINDOW_BASE,
    SCAL_WORK_PENDING,
    merge_view,
    narrow_view,
    scan_ticks,
    unpack,
)
from minpaxos_tpu_torch.ops.util import I32
from minpaxos_tpu_torch.runtime import batches
from minpaxos_tpu_torch.runtime.stable import StableStore
from minpaxos_tpu_torch.runtime.transport import (
    CONN_LOST,
    FROM_CLIENT,
    FROM_PEER,
    Transport,
)
from minpaxos_tpu_torch.utils.clock import cputicks, monotonic_ns
from minpaxos_tpu_torch.utils.dlog import DLOG, dlog
from minpaxos_tpu_torch.utils.netutil import CONTROL_OFFSET
from minpaxos_tpu_torch.wire.messages import MsgKind, Op, empty_batch, make_batch

CONTROL = 3  # queue item source tag (transport uses 0..2)


def _packed_step(cfg, state, inbox, step_impl, k: int = 1, narrow: int = 0,
                 off: int = 0, alloc=None):
    """k protocol substeps and the packing of everything the host reads
    per dispatch into ONE int32 buffer [k, B, W] (ops/substeps.py: the
    JAX package's [k, 14, M] outbox, [k, 6, E] exec and [k, N_SCAL]
    scalar stacks, plus each replica's peer_commits, row by row).

    ``k``: fused substeps — the real inbox feeds substep 0, the rest run
    with empty inboxes. ``narrow``/``off`` (host ints): run the substeps
    on a ``narrow``-slot view of the window at offset ``off`` (the host
    selects it only when every slot the step could touch fits the view,
    see ReplicaServer._choose_narrow). The slot fields of ``state`` are
    then updated in place. Returns (state', buffer)."""
    if narrow:
        ncfg = cfg._replace(window=narrow, slide_window=False)
        view, fields = narrow_view(state, off, narrow)
        # the view's shifted window_base is an artifact (slide is off
        # in the view): the packed scalars report the full state's
        view, buf = scan_ticks(ncfg, view, inbox, step_impl, k, alloc,
                               report_base=state.window_base)
        return merge_view(state, view, off, fields), buf
    return scan_ticks(cfg, state, inbox, step_impl, k, alloc)


def _kv_install(kv, k_hi, k_lo, v, valid):
    """Batch-insert snapshot pairs into the KV table through K4 (pairs
    are distinct keys by construction — the stable store sorts them and
    the sender's table held them uniquely)."""
    return kv_insert_unique(kv, k_hi, k_lo, v, delete=torch.zeros_like(valid),
                            valid=valid)


@dataclass
class _InflightTick:
    """One dispatched tick's host-phase inputs, already read back. The
    pipeline completes them at once (serial order, -nopipeline or an
    empty queue) or one dispatch later, between the next dispatch's
    enqueue and its readback (the hidden wall is the recorder row's
    ``overlap_us``). The matrices are views of a pinned host buffer
    that the dispatch after next reuses."""

    cols: dict            # this tick's drained inbox columns
    n_rows: int
    out_mats: np.ndarray  # [k, 14, M] stacked outbox matrices
    exec_mats: np.ndarray  # [k, 6, E] stacked exec matrices
    scals: np.ndarray     # [k, N_SCAL] per-substep scalar vectors
    k: int
    kind: int             # recorder regime (KIND_FULL/FUSED/NARROW)
    persist: bool
    dispatch: bool
    frontier: int         # final (substep k-1) committed frontier
    backlog: int          # frontier - executed after the tick
    rows_out: int
    peer_commits: np.ndarray | None  # state's [R] vector (non-mencius)
    snap: dict            # the snapshot published at this readback
    drain_us: int
    enqueue_us: int
    readback_us: int
    t_rb_ns: int          # monotonic_ns at readback (trace anchoring)
    coal_occ: int = 0     # rows the ingress coalescer batched for this tick
    coal_wake: int = 0    # cumulative coalescer wakeup kicks at this tick


class FatalReplicaError(RuntimeError):
    """The replica can no longer execute correctly and must fail-stop
    (consensus tolerates a crashed replica; serving wrong data is the
    one thing it cannot tolerate)."""


@dataclass
class RuntimeFlags:
    """Server knobs — the reference's flag set (server.go:19-34) and the
    JAX package's runtime knobs (see its RuntimeFlags for the reasoning
    behind each default)."""

    dreply: bool = True    # -dreply: reply after execution (with value)
    durable: bool = False  # -durable: fsync accepted slots per tick
    thrifty: bool = False  # -thrifty: send accepts to a quorum only
    beacon: bool = False   # -beacon: RTT beacons -> preferred quorum
    tick_s: float = 0.002  # protocol tick
    idle_s: float = 0.05   # idle poll interval (arrivals wake at once)
    # fused substeps per dispatch when follow-up ticks are certain
    # (exec backlog, recovery-scale catch-up); 1 disables fusion
    fuse_ticks: int = 3
    # skip the dispatch when the inbox is empty and the device's
    # work_pending bit says an empty step is a no-op; one real tick at
    # least every idle_skip_max_s
    idle_fastpath: bool = True
    idle_skip_max_s: float = 0.25
    # narrow resident view of this many slots for low-occupancy ticks
    # (0 = off)
    narrow_window: int = 0
    # run every (k, narrow) step variant once before serving, so the
    # kernels' libraries load and the allocator warms before traffic
    warm_variants: bool = False
    key_hint: int = 0      # expected distinct keys (startup KV log line)
    # depth-2 pipeline: deferred host phases run under the next
    # dispatch's device work when traffic is queued
    pipeline: bool = True
    # event-driven ingress coalescer (batches.IngressCoalescer)
    coalesce: bool = True
    coalesce_wait_us: int = 200
    coalesce_rows: int = 0  # 0 = half the device inbox
    # chase committed-but-unexecuted slots with follow-up dispatches in
    # the same wakeup
    overlap_exec: bool = True
    # flight recorder (obs/recorder.py): one ring row per dispatch and
    # per idle skip, served by the trace verb (-norecorder, -recring)
    recorder: bool = True
    recorder_ring: int = 4096
    # paxtrace (obs/trace.py): stage spans of 1 command in
    # 2^trace_pow2, served by the tracespans verb; 0 traces every
    # command (-notrace, -tracepow2, -tracering)
    trace: bool = True
    trace_pow2: int = 4
    trace_ring: int = 4096
    # snapshot + truncation policy of the stable store
    snapshots: bool = True
    snap_every_bytes: int = 8 << 20
    snap_interval_s: float = 0.0
    store_dir: str = "."
    # a cProfile.Profile the protocol thread enables (-cpuprofile)
    profile: object | None = None
    # torch device of the replica's state and step: the card unless
    # the caller asks for the CPU
    device: str = "cuda"


class ReplicaServer:
    def __init__(self, me: int, addrs: list[tuple[str, int]],
                 cfg: MinPaxosConfig | None = None,
                 flags: RuntimeFlags | None = None,
                 protocol: str = "minpaxos"):
        self.me = me
        self.addrs = addrs
        self.cfg = cfg or MinPaxosConfig(
            n_replicas=len(addrs), window=1 << 14, inbox=4096,
            exec_batch=4096, kv_pow2=16, catchup_rows=256,
            recovery_rows=256)
        assert self.cfg.n_replicas == len(addrs)
        self.flags = flags or RuntimeFlags()
        self.dev = resolve_device(self.flags.device)
        # "minpaxos" / "classic" share replica_step (classic via
        # cfg.explicit_commit); "mencius" swaps in the rotating-
        # ownership step. Leaderless paths are gated on self.protocol.
        self.protocol = protocol
        if protocol == "mencius":
            from minpaxos_tpu_torch.models.mencius import (
                init_mencius,
                mencius_step_impl,
            )

            step_impl, init_fn = mencius_step_impl, init_mencius
        else:
            step_impl, init_fn = replica_step_impl, init_replica
        self._step_impl = step_impl
        self.metrics = MetricsRegistry(namespace=f"replica{me}")
        m = self.metrics
        self._c_ticks = m.counter(
            "ticks", "protocol-thread wakeups (wall ticks, not substeps)")
        self._c_dispatches = m.counter("dispatches", "device round-trips")
        self._c_fused_substeps = m.counter(
            "fused_substeps", "protocol substeps those dispatches ran")
        self._c_full_steps = m.counter(
            "full_steps", "dispatches through the full-width k=1 step")
        self._c_fused_dispatches = m.counter(
            "fused_dispatches", "dispatches that fused k>1 substeps")
        self._c_narrow_steps = m.counter(
            "narrow_steps", "dispatches through the small-window view")
        self._c_skips_deferred = m.counter(
            "skips_deferred", "Mencius SKIP rows held for a later inbox: "
            "their cede range would have merged with an earlier one of "
            "the same owner across slots it did not cede")
        self._c_idle_skips = m.counter(
            "idle_skips", "timer wakeups the idle fast path answered "
            "without touching the device")
        self._c_pipelined = m.counter(
            "pipelined_ticks", "dispatches whose host phases ran "
            "deferred, under the NEXT dispatch's device work")
        self._c_narrow_fallbacks = m.counter(
            "narrow_fallbacks", "narrow dispatches whose post-readback "
            "anchor validation failed")
        self._c_proposals = m.counter("proposals", "client command rows "
                                      "admitted to the inbox")
        self._c_rejected = m.counter(
            "proposals_rejected", "admitted command rows the step "
            "bounced back to the client (not leader / unprepared)")
        self._c_executed = m.counter("executed", "commands executed")
        self._c_elections = m.counter(
            "elections", "become_leader rounds this replica ran")
        # dispatch timing: host wall from drain to readback, and (on
        # the card) device time of the step + K7 between CUDA events
        self._c_wall_us = m.counter(
            "dispatch_wall_us", "host wall per dispatch, drain to "
            "readback, summed (microseconds)")
        self._c_device_us = m.counter(
            "device_step_us", "span between CUDA events recorded before "
            "the step and after its packing, summed (microseconds; 0 on "
            "the CPU): device work plus the device's idle gaps while the "
            "host issues the launches")
        self._g_committed = m.gauge("committed",
                                    "committed prefix length (frontier+1)")
        self._h_tick = m.histogram(
            "tick_wall_ms", "whole-dispatch host wall (drain work + "
            "enqueue + readback + persist + dispatch + reply)",
            TICK_MS_BUCKETS)
        self._h_step = m.histogram(
            "device_step_ms", "host-visible dispatch wall (enqueue + "
            "readback)", TICK_MS_BUCKETS)
        if self.dev.type == "cuda":
            m.fn_gauge("max_memory_allocated",
                       lambda: torch.cuda.max_memory_allocated(self.dev))
        self.recorder = (FlightRecorder(self.flags.recorder_ring)
                         if self.flags.recorder else None)
        # paxtrace sink: one per replica, shared with the transport's
        # reader threads (each thread gets its own ring). It exists
        # even when disabled, so every site is one `.enabled` test.
        self.trace_sink = TraceSink(enabled=self.flags.trace,
                                    sample_pow2=self.flags.trace_pow2,
                                    ring_capacity=self.flags.trace_ring)
        m.fn_gauge("trace_spans", self.trace_sink.spans_total)
        m.fn_gauge("trace_dropped", self.trace_sink.spans_dropped)
        # sampled proposals awaiting their commit stamp (protocol thread
        # only): a min-heap of (log slot, cmd_id), so a dispatch pops
        # only the slots its frontier covered
        self._trace_slots: list[tuple[int, int]] = []
        self._drain_wait_s = 0.0
        self._drain_work_s = 0.0
        self._last_scals = None  # newest published scalar vector
        # ingress admission: a few exec batches of committed-but-
        # unexecuted slots is normal pipeline depth, an order of
        # magnitude past it means execution lost the race; and a window
        # within one exec batch of full would reject admitted rows
        self._admit_backlog_limit = max(8 * self.cfg.exec_batch, 256)
        self._admit_window_limit = self.cfg.window - self.cfg.exec_batch
        self.coalescer = (batches.IngressCoalescer(
            max_wait_us=self.flags.coalesce_wait_us,
            max_rows=self.flags.coalesce_rows or max(self.cfg.inbox // 2, 1),
            admit_gate=self._ingress_overloaded,
            metrics=self.metrics) if self.flags.coalesce else None)
        self.transport = Transport(me, addrs, inbox_queue=self.coalescer,
                                   metrics=self.metrics)
        self.transport.trace = self.trace_sink
        # the event journal: one per replica, shared with the transport's
        # reader threads (each writer thread records into its own ring)
        self.journal = EventJournal(capacity=1024)
        m.fn_gauge("events", self.journal.events_total)
        m.fn_gauge("events_dropped", self.journal.events_dropped)
        self.transport.journal = self.journal
        self.queue = self.transport.queue
        self.state = init_fn(self.cfg, [me], device=self.dev)
        self._empty_inbox = MsgBatch.empty(1, self.cfg.inbox, self.dev)
        # packed buffers: one device buffer per (k, width); two pinned
        # host buffers per (k, width), alternating by dispatch parity
        self._dev_bufs: dict[tuple, torch.Tensor] = {}
        self._host_bufs: dict[tuple, torch.Tensor] = {}
        self._parity = 0
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event())
                        if self.dev.type == "cuda" else None)
        self.store = StableStore(
            f"{self.flags.store_dir}/stable-store-replica{me}",
            sync=self.flags.durable)
        m.fn_gauge("store_corrupt_records",
                   lambda: self.store.corrupt_records)
        m.fn_gauge("store_log_bytes", self.store.log_bytes)
        m.fn_gauge("snap_count", lambda: self.store.snapshots_taken)
        m.fn_gauge("store_truncated_bytes",
                   lambda: self.store.truncated_bytes)
        m.fn_gauge("snap_age_s", self._snap_age_s)
        self._snap_goal_bytes = max(self.flags.snap_every_bytes, 1)
        self._snap_last_s = time.monotonic()
        self._snap_check_s = 0.0
        self._snap_disabled = False
        self._snap_sent_s: dict[int, float] = {}
        self._snap_seq = 0
        self._snap_rx: dict[int, dict] = {}
        self._crashed = False
        self.inbox = batches.ColumnBuffer(self.cfg.inbox)
        # reply bookkeeping: (conn_id, cmd_id) -> reply kind to send
        self._pending: dict[tuple[int, int], MsgKind] = {}
        self.rtt_ewma = np.full(len(addrs), np.inf)
        self._stop = threading.Event()
        self._recovered = self.store.recovered
        self.fatal: str | None = None
        self._ctl_sock: socket.socket | None = None
        self._proto_thread: threading.Thread | None = None
        self._idle = False
        self._last_step = 0.0
        self._seen_leader = False  # any PREPARE/ACCEPT/COMMIT from a peer
        self._boot_pending: float | None = None  # deferred boot election
        self._last_elect = 0.0  # the last prepare round's start
        self._reprepare_s = self.REPREPARE_S
        # control-plane snapshot: a fresh plain dict per readback; other
        # threads read only this, never self.state. work_pending starts
        # True (no "low"/"high" yet): the idle fast path and the narrow
        # view stay off until the first dispatch publishes scalars.
        self.snapshot = {"frontier": -1, "leader": -1, "prepared": False,
                         "window_base": 0, "work_pending": True}
        self._last_dispatch = 0.0
        self._kv_warned = False
        self._inflight: _InflightTick | None = None
        self._narrow_doubt = False
        self.warm_launches: dict[str, int] = {}
        # _report_frontier: the frontier, since when it stands, and the
        # last report's time
        self._report_fr = -2
        self._report_since = self._report_last = 0.0
        # READ rows that found the inbox full, or Mencius SKIP rows that
        # would merge with an earlier cede range: drained first next tick
        self._carry: list = []

    @property
    def stats(self) -> dict:
        """Flat counter/gauge snapshot, a fresh dict per read."""
        return self.metrics.counters()

    # ---------------- lifecycle ----------------

    def start(self) -> None:
        self._log_kv_sizing()
        self.transport.listen()
        self._start_control()
        if self._recovered:
            self._recover_from_store()
        self.transport.connect_peers()
        self._proto_thread = threading.Thread(target=self._run, daemon=True)
        self._proto_thread.start()
        if self.flags.beacon:
            threading.Thread(target=self._beacon_loop, daemon=True).start()

    def _log_kv_sizing(self) -> None:
        """Startup line: KV capacity against the operator's key hint
        (the table fail-stops on saturation)."""
        cap = 1 << self.cfg.kv_pow2
        hint = self.flags.key_hint
        msg = (f"replica {self.me}: KV table capacity {cap} "
               f"(-kvpow2 {self.cfg.kv_pow2}); fail-stops if the live "
               f"key space saturates it")
        if hint > 0:
            load = hint / cap
            msg += (f"; workload hint {hint} distinct keys -> "
                    f"projected load {load:.2f}")
            if load > 0.7:
                msg += (" — OVER the 0.7 comfort bound for two-choice "
                        "placement; raise -kvpow2 or expect fail-stop")
        else:
            msg += ("; no -keyhint given — size -kvpow2 so distinct "
                    "keys stay under ~0.7 of capacity")
        print(msg, file=sys.stderr, flush=True)

    def _check_kv_load(self) -> None:
        """One-shot near-saturation warning, counted every 1024
        dispatches off the hot path."""
        if self._kv_warned or self._c_dispatches.value % 1024:
            return
        cap = 1 << self.cfg.kv_pow2
        live = int((self.state.kv.slot == LIVE).sum().item())
        if live > 0.7 * cap:
            self._kv_warned = True
            print(f"replica {self.me}: KV table NEAR SATURATION — "
                  f"{live}/{cap} slots live (load {live / cap:.2f} > "
                  f"0.7); the replica fail-stops when an insert "
                  f"cannot place. Raise -kvpow2.",
                  file=sys.stderr, flush=True)

    def stop(self) -> bool:
        """Signal, join the protocol thread (it may be mid-persist), and
        only then close the store. Returns whether the thread joined."""
        self._stop.set()
        joined = True
        if self._proto_thread is not None:
            self._proto_thread.join(timeout=10.0)
            joined = not self._proto_thread.is_alive()
        self.transport.stop()
        if self._ctl_sock is not None:
            try:
                self._ctl_sock.close()
            except OSError:
                pass
        self.store.close()
        return joined

    def crash(self) -> None:
        """Die like a killed process: the store's buffered bytes are
        lost, sockets close unflushed, no deferred host phase completes,
        and the control port goes dark."""
        self._crashed = True
        self.store.crash()
        self._stop.set()
        self.queue.put((CONTROL, 0, "crashed", None))
        self.transport.stop()
        if self._ctl_sock is not None:
            try:
                self._ctl_sock.close()
            except OSError:
                pass
        if self._proto_thread is not None:
            self._proto_thread.join(timeout=10.0)
        if self.dev.type == "cuda":
            # every launch of the dead protocol thread completes before
            # its tensors can go back to the allocator and to a
            # restarted server (both launch on this stream)
            torch.cuda.current_stream(self.dev).synchronize()

    def _snap_age_s(self) -> int:
        w = self.store.snap_wall_ns
        if not w:
            return -1
        return max(0, int((time.time_ns() - w) // 1_000_000_000))

    # ---------------- device buffers ----------------

    def _to_device(self, cols: dict) -> MsgBatch:
        x = torch.from_numpy(np.stack([cols[c] for c in batches.COLS]))
        return MsgBatch.from_stacked(x.to(self.dev)[:, None, :])

    def _dev_buf(self, k: int, b: int, w: int) -> torch.Tensor:
        key = (k, b, w)
        buf = self._dev_bufs.get(key)
        if buf is None:
            buf = self._dev_bufs[key] = torch.empty(
                (k, b, w), dtype=I32, device=self.dev)
        return buf

    def _host_buf(self, shape) -> torch.Tensor:
        key = (self._parity,) + tuple(shape)
        buf = self._host_bufs.get(key)
        if buf is None:
            buf = self._host_bufs[key] = torch.empty(
                tuple(shape), dtype=I32, pin_memory=self.dev.type == "cuda")
        return buf

    def step(self, inbox: MsgBatch, k: int = 1, narrow: int = 0, off: int = 0):
        """One packed dispatch on ``self.state``; returns the device
        buffer [k, 1, W]."""
        self.state, buf = _packed_step(self.cfg, self.state, inbox,
                                       self._step_impl, k, narrow, off,
                                       self._dev_buf)
        return buf

    # ---------------- recovery (stable-store replay) ----------------

    def _recover_from_store(self) -> None:
        """Rebuild device state by replaying the durable log through
        the same protocol step: the committed prefix as COMMIT rows,
        the accepted tail as ACCEPT rows; a truncated store first
        installs its newest snapshot's KV pairs and replays only the
        suffix above it."""
        t_rec0 = time.perf_counter()
        frontier = self.store.committed_prefix()
        max_ballot = self.store.max_ballot()
        chunk = self.cfg.exec_batch
        own_max = -1  # highest recorded slot owned by me (mencius)
        start = 0
        if self.store.base >= 0 and self.protocol != "mencius":
            self._install_snapshot_pairs(self.store.snapshot_pairs,
                                         self.store.base)
            start = self.store.base + 1

        def _own_slots_max(rec) -> int:
            mine = rec["inst"][rec["inst"] % self.cfg.n_replicas == self.me]
            return int(mine.max()) if len(mine) else -1

        for lo in range(start, frontier + 1, chunk):
            rec = self.store.read_range(lo, min(lo + chunk, frontier + 1) - 1)
            own_max = max(own_max, _own_slots_max(rec))
            self._feed_records(rec, MsgKind.COMMIT)
        tail = self.store.read_range(frontier + 1, self.store.max_inst())
        if len(tail):
            own_max = max(own_max, _own_slots_max(tail))
            self._feed_records(tail, MsgKind.ACCEPT)
        if self.protocol == "mencius":
            # crt_own must move past every recorded own slot: the
            # propose path writes at crt_own unguarded
            if own_max >= 0:
                want = torch.full_like(self.state.crt_own,
                                       own_max + self.cfg.n_replicas)
                self.state = self.state._replace(
                    crt_own=torch.maximum(self.state.crt_own, want))
        elif max_ballot > 0:
            # restore the ballot promise (ballot low 4 bits = proposer
            # id, bareminpaxos.go:383-385)
            buf = batches.ColumnBuffer(self.cfg.inbox)
            buf.append(1, kind=int(MsgKind.PREPARE), src=max_ballot % 16,
                       ballot=max_ballot,
                       last_committed=int(self.state.committed_upto[0].item()))
            self._device_tick(buf)
        if self.store.corrupt_records:
            self.journal.record(EV_STORE_CORRUPT, subject=self.me,
                                value=self.store.corrupt_records)
        # value = the recovered frontier, aux = recovery wall ms
        self.journal.record(
            EV_RECOVERY, subject=self.me, value=frontier,
            aux=int((time.perf_counter() - t_rec0) * 1e3))
        dlog(f"replica {self.me}: recovered frontier={frontier} "
             f"base={self.store.base} tail={len(tail)} "
             f"ballot={max_ballot}")

    def _feed_records(self, rec: np.ndarray, kind: MsgKind) -> None:
        if len(rec) == 0:
            return
        k_hi, k_lo = split_i64(rec["key"])
        v_hi, v_lo = split_i64(rec["val"])
        # row src: MinPaxos ballots encode the proposer in their low 4
        # bits; Mencius ownership is positional (owner = inst mod R)
        src_all = (rec["inst"] % self.cfg.n_replicas
                   if self.protocol == "mencius" else rec["ballot"] % 16)
        for lo in range(0, len(rec), self.cfg.inbox):
            sl = slice(lo, lo + self.cfg.inbox)
            buf = batches.ColumnBuffer(self.cfg.inbox)
            buf.append(len(rec[sl]), kind=int(kind),
                       src=src_all[sl], ballot=rec["ballot"][sl],
                       inst=rec["inst"][sl],
                       last_committed=self.store.frontier,
                       op=rec["op"][sl].astype(np.int32),
                       key_hi=k_hi[sl], key_lo=k_lo[sl],
                       val_hi=v_hi[sl], val_lo=v_lo[sl],
                       cmd_id=rec["cmd_id"][sl],
                       client_id=rec["client_id"][sl])
            self._device_tick(buf, persist=False, dispatch=False)

    def _install_snapshot_pairs(self, pairs: np.ndarray,
                                frontier: int) -> None:
        """Fast-forward the device state to a snapshot: install its live
        KV pairs (chunks of exec_batch rows through K4) and move every
        protocol cursor to frontier+1, with the log-window arrays
        zeroed — the state of a replica that executed slots
        0..frontier and slid its window."""
        chunk = max(self.cfg.exec_batch, 1)
        k_hi, k_lo = split_i64(np.ascontiguousarray(pairs["key"]))
        v_hi, v_lo = split_i64(np.ascontiguousarray(pairs["val"]))
        kv = self.state.kv
        for lo in range(0, len(pairs), chunk):
            n = min(chunk, len(pairs) - lo)
            ck = np.zeros((3, chunk), np.int32)
            cv = np.zeros((chunk, 2), np.int32)
            ck[0, :n], ck[1, :n] = k_hi[lo:lo + n], k_lo[lo:lo + n]
            ck[2, :n] = 1
            cv[:n, 0], cv[:n, 1] = v_hi[lo:lo + n], v_lo[lo:lo + n]
            t = torch.from_numpy(ck).to(self.dev)
            kv = _kv_install(kv, t[0][None], t[1][None],
                             torch.from_numpy(cv).to(self.dev)[None],
                             t[2][None] != 0)
        s, dev = self.cfg.window, self.dev
        st = self.state

        def z(dtype=I32):
            return torch.zeros((1, s), dtype=dtype, device=dev)

        fj = torch.full((1,), frontier, dtype=I32, device=dev)
        self.state = st._replace(
            ballot=torch.full((1, s), NO_BALLOT, dtype=I32, device=dev),
            status=z(torch.uint8), op=z(torch.uint8), key_hi=z(), key_lo=z(),
            val_hi=z(), val_lo=z(), cmd_id=z(), client_id=z(), votes=z(),
            pvotes=z(), kv=kv, window_base=fj + 1,
            crt_inst=torch.maximum(st.crt_inst, fj + 1),
            committed_upto=fj.clone(), executed_upto=fj.clone(),
            rec_cursor=torch.maximum(st.rec_cursor, fj + 1),
            tenure_start=torch.maximum(st.tenure_start, fj + 1),
            gossip_upto=fj.clone())

    # ---------------- control plane (port + 1000) ----------------

    def _start_control(self) -> None:
        host, port = self.addrs[self.me]
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # retry: the control port can transiently collide with an
        # ephemeral outbound port; those clear quickly
        deadline = time.monotonic() + 10.0
        while True:
            try:
                s.bind((host, port + CONTROL_OFFSET))
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.25)
        s.listen(16)
        self._ctl_sock = s
        threading.Thread(target=self._control_loop, daemon=True).start()

    def _control_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._ctl_sock.accept()
            except OSError:
                return
            threading.Thread(target=self._control_conn, args=(conn,),
                             daemon=True).start()

    def _control_conn(self, conn) -> None:
        f = conn.makefile("rw")
        try:
            for line in f:
                try:
                    req = json.loads(line)
                except json.JSONDecodeError:
                    break
                m = req.get("m")
                if m == "ping":
                    snap = self.snapshot  # one read: dict swap is atomic
                    resp = {"ok": self.fatal is None,
                            "frontier": snap["frontier"],
                            "leader": snap["leader"], "stats": self.stats,
                            "window_base": snap["window_base"],
                            "crt_inst": snap.get("crt_inst", -1),
                            "prepared": snap.get("prepared"),
                            "fatal": self.fatal}
                elif m == "stats":
                    snap = self.snapshot
                    scals = self._last_scals
                    resp = {"ok": self.fatal is None, "id": self.me,
                            "protocol": self.protocol,
                            "device": str(self.dev),
                            "leader": snap["leader"],
                            "frontier": snap["frontier"],
                            "window_base": snap["window_base"],
                            "executed": snap.get("executed", -1),
                            "work_pending": snap.get("work_pending", True),
                            "metrics": self.metrics.snapshot(),
                            "launches": self.serving_launches(),
                            "scalars": (None if scals is None else
                                        dict(zip(SCAL_NAMES,
                                                 scals.tolist()))),
                            "fatal": self.fatal}
                elif m == "trace":
                    # the flight recorder as Chrome trace events (pid =
                    # replica id, so a merged cluster trace keeps one
                    # track group per replica), the journal beside it
                    # as instant events on WATCH_PID; "last" bounds the
                    # rows. -norecorder answers empty but ok.
                    last = req.get("last")
                    events = ([] if self.recorder is None else
                              self.recorder.to_events(
                                  pid=self.me,
                                  last=int(last) if last else 1024))
                    if self.recorder is not None and self.journal.enabled:
                        events += event_chrome_events(
                            self.journal.snapshot(), tid=self.me)
                    resp = {"ok": True, "id": self.me,
                            "recorder": self.recorder is not None,
                            "events": events}
                elif m == "events":
                    # the journal's retained events with the (mono,
                    # wall) clock anchor align_event_collections uses
                    resp = {"ok": True, "id": self.me,
                            "journal": self.journal.collect()}
                elif m == "tracespans":
                    # every span ring of this process with the
                    # monotonic<->wall clock anchor tail aligns
                    # processes by
                    resp = {"ok": True, "id": self.me,
                            "trace": self.trace_sink.collect()}
                elif m == "chaos":
                    # install / clear / status a fault plan on the live
                    # transport: an attribute swap the reader threads
                    # observe per frame
                    resp = self._chaos_verb(req)
                elif m == "be_the_leader":
                    self.queue.put((CONTROL, 0, "be_the_leader", None))
                    resp = {"ok": True}
                else:
                    resp = {"ok": False, "error": f"unknown method {m}"}
                f.write(json.dumps(resp) + "\n")
                f.flush()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _chaos_verb(self, req: dict) -> dict:
        op = req.get("op", "status")
        try:
            if op == "install":
                plan = FaultPlan.from_dict(req["plan"])
                if plan.n != self.cfg.n_replicas:
                    raise ValueError(
                        f"plan sized for {plan.n} replicas, cluster "
                        f"has {self.cfg.n_replicas}")
                self.transport.set_chaos(
                    ChaosShim(self.me, plan, self.queue))
                # value = the plan's seed
                self.journal.record(EV_CHAOS_INSTALL, subject=self.me,
                                    value=int(plan.seed))
            elif op == "clear":
                self.transport.set_chaos(None)
                self.journal.record(EV_CHAOS_CLEAR, subject=self.me)
            elif op != "status":
                raise ValueError(f"unknown chaos op {op!r}")
        except (KeyError, TypeError, ValueError) as e:
            return {"ok": False, "id": self.me, "error": repr(e)[:200]}
        ch = self.transport.chaos
        return {"ok": True, "id": self.me, "installed": ch is not None,
                "faults": ch.counts() if ch is not None else {},
                "faults_total": self.transport.chaos_faults_total()}

    # ---------------- beacons ----------------

    def _beacon_loop(self) -> None:
        """Enqueue a beacon every 0.2 s; the protocol thread writes it
        (peer writers are single-threaded by contract)."""
        while not self._stop.is_set():
            self.queue.put((CONTROL, 0, "send_beacon", None))
            time.sleep(0.2)

    # ---------------- the protocol loop ----------------

    def _warm_step_variants(self) -> None:
        """Run every (k, narrow) step variant the tick loop can select
        once, on empty inboxes, before serving: the kernels' libraries
        load and the caching allocator warms outside traffic."""
        nw = self.flags.narrow_window
        narrows = [0] + ([nw] if nw and nw < self.cfg.window else [])
        for k in sorted({1, max(1, self.flags.fuse_ticks)}):
            for narrow in narrows:
                self.step(self._empty_inbox, k, narrow, 0)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.warm_launches = K.launch_counts()

    def serving_launches(self) -> dict:
        """Kernel launches of this process since the warm-up (all of
        them without one): what serving, recovery and catch-up ran."""
        base = self.warm_launches
        return {n: c - base.get(n, 0) for n, c in K.launch_counts().items()}

    def _run(self) -> None:
        prof = self.flags.profile
        if prof is not None:
            prof.enable()
        try:
            if self.flags.warm_variants:
                self._warm_step_variants()
            if (not self._recovered and self.me == 0
                    and self.protocol != "mencius"):
                # initial boot: replica 0 self-elects once the mesh is
                # up (bareminpaxos.go:286-290); Mencius has no leader
                self._wait_for_peers()
                self.queue.put((CONTROL, 0, "be_the_leader", "boot"))
            while not self._stop.is_set():
                self._tick()
            # clean shutdown: complete deferred host phases (a fatal
            # tick skips this — fail-stop must not keep serving)
            if not self._crashed:
                self._flush_inflight()
        except FatalReplicaError as e:
            print(f"FATAL: {e}", file=sys.stderr, flush=True)
        except Exception:
            # a crash() races the protocol thread mid-tick: whatever it
            # provokes is the kill itself. Everything else propagates.
            if not self._crashed:
                raise
        finally:
            if prof is not None:
                prof.disable()

    def _wait_for_peers(self, timeout_s: float = 15.0) -> None:
        """Until every peer is connected (or the timeout): the boot
        election's PREPARE needs the links. A higher-id peer dials us
        once, at its start; if we were not listening yet that dial was
        refused and nobody dials again. So a higher-id peer still
        missing after ``_DIAL_UP_S`` (a peer starting now dials us
        within it, and two dials crossing would replace each other's
        connection) is dialed from here too."""
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        need = self.cfg.n_replicas - 1
        while time.monotonic() < deadline and not self._stop.is_set():
            n = sum(self.transport.peer_alive(q)
                    for q in range(self.cfg.n_replicas) if q != self.me)
            if n >= need:
                return
            up = self.cfg.n_replicas if time.monotonic() - t0 > self._DIAL_UP_S else self.me
            for q in range(up):
                if q != self.me and not self.transport.peer_alive(q):
                    self.transport.dial_peer(q)
            time.sleep(0.05)

    # seconds before the boot wait dials higher-id peers itself
    _DIAL_UP_S = 1.0

    def _ingress_overloaded(self) -> bool:
        """Admission signal for the ingress coalescer, called by the
        transport's reader threads (reads only the published snapshot):
        the exec backlog beyond its bound, or the window nearly full."""
        snap = self.snapshot
        fr = int(snap.get("frontier", -1))
        ex = int(snap.get("executed", fr))
        wb = int(snap.get("window_base", 0))
        return (fr - ex > self._admit_backlog_limit
                or fr - wb >= self._admit_window_limit)

    def _tick(self) -> None:
        # a quiet replica polls at idle_s instead of tick_s; arrivals
        # still wake it at once through the queue
        timeout = self.flags.idle_s if self._idle else self.flags.tick_s
        # one wakeup = one wall tick, whatever k the dispatch fuses
        tick_inc = 1
        t0 = time.perf_counter()
        elect = self._drain(timeout)
        self._drain_work_s = (time.perf_counter() - t0
                              - self._drain_wait_s)
        if (self._boot_pending is not None
                and time.monotonic() >= self._boot_pending):
            self._boot_pending = None
            stale = (self._seen_leader
                     or self.snapshot["frontier"] >= 0
                     or self.snapshot["leader"] not in (-1, self.me))
            if stale:
                dlog(f"replica {self.me}: skipping stale boot "
                     f"self-election (leader={self.snapshot['leader']},"
                     f" frontier={self.snapshot['frontier']})")
            else:
                elect = True
        if (self._idle and not elect and self.inbox.fill == 0
                and time.monotonic() - self._last_step < self.flags.idle_s):
            self._flush_inflight()
            return
        # idle fast path: the device published (work_pending) that an
        # empty-inbox step would be a no-op — skip the dispatch
        if (self.flags.idle_fastpath and not elect
                and self.inbox.fill == 0
                and not self.snapshot.get("work_pending", True)
                and time.monotonic() - self._last_dispatch
                < self.flags.idle_skip_max_s):
            self._flush_inflight()
            self._c_idle_skips.inc()
            self._c_ticks.inc(tick_inc)
            if self.recorder is not None:
                self.recorder.record(
                    monotonic_ns(), KIND_IDLE_SKIP, 0, 0, 0,
                    self.snapshot["frontier"], 0,
                    int(self._drain_work_s * 1e6), 0, 0, 0, 0, 0, 0,
                    chaos_faults=self.transport.chaos_faults_total(),
                    coal_wake=(self.coalescer._c_wakeups.value
                               if self.coalescer is not None else 0))
            self._idle = True
            # beacons and beacon replies may sit in the writers
            self.transport.flush_all()
            return
        if elect:
            self._become_leader()
            self._last_elect = time.monotonic()
            self._reprepare_s = self.REPREPARE_S
        elif (self.snapshot["leader"] == self.me
              and not self.snapshot["prepared"]
              and time.monotonic() - self._last_elect > self._reprepare_s):
            # the one-shot PREPARE broadcast can be lost; re-run the
            # prepare round at a fresh ballot until a quorum answers.
            # A fresh ballot makes the last round's replies stale, so
            # each retry waits twice as long as the one before: a round
            # trip slower than the interval (replicas stepping on a
            # loaded host) would otherwise restart the round forever
            self._become_leader()
            self._last_elect = time.monotonic()
            self._reprepare_s = min(2 * self._reprepare_s, self.REPREPARE_MAX_S)
        self._device_tick(self.inbox)
        # exec chase: run the follow-up dispatch(es) in this wakeup
        # while committed slots wait to execute and nothing is queued;
        # each is the deterministic step the next wakeup would run
        if self.flags.overlap_exec:
            for _ in range(8):
                snap = self.snapshot
                prev_exec = int(snap.get("executed", -1))
                if (snap["frontier"] <= prev_exec or self.inbox.fill
                        or not self.queue.empty()):
                    break
                self._device_tick(self.inbox)
                if int(self.snapshot.get("executed", -1)) <= prev_exec:
                    break  # no forward progress: stop chasing
        self._maybe_snapshot()
        self._last_step = time.monotonic()
        self._c_ticks.inc(tick_inc)

    # seconds an elected leader waits for a quorum of prepare replies
    # before it runs the round again; doubled on every retry, up to the
    # cap, and back to the base at an election or once prepared
    REPREPARE_S = 0.5
    REPREPARE_MAX_S = 4.0

    def _maybe_snapshot(self) -> None:
        """Snapshot + truncation policy, rate-limited to 4 Hz; off for
        Mencius (its recovery replays the full log)."""
        fl = self.flags
        if (not fl.snapshots or self._snap_disabled or self._crashed
                or self.protocol == "mencius" or self.fatal is not None):
            return
        now = time.monotonic()
        if now < self._snap_check_s:
            return
        self._snap_check_s = now + 0.25
        exec_upto = int(self.snapshot.get("executed", -1))
        if exec_upto < 0 or exec_upto <= self.store.snap_frontier:
            return
        size_due = (fl.snap_every_bytes > 0
                    and self.store.log_bytes() >= self._snap_goal_bytes)
        time_due = (fl.snap_interval_s > 0
                    and now - self._snap_last_s >= fl.snap_interval_s)
        if size_due or time_due:
            self._take_snapshot(exec_upto)

    def _take_snapshot(self, exec_upto: int) -> None:
        """Checkpoint the applied KV state at ``exec_upto`` into the
        stable store and truncate its redo log (deferred host phases
        complete first, so every record at/below exec_upto is in the
        store before the rewrite)."""
        self._flush_inflight()
        kv = self.state.kv
        live = (kv.slot[0] == LIVE).cpu().numpy()
        keys = join_i64(kv.key_hi[0].cpu().numpy()[live],
                        kv.key_lo[0].cpu().numpy()[live])
        v = kv.val[0].cpu().numpy()
        vals = join_i64(v[live, 0], v[live, 1])
        freed = self.store.take_snapshot(keys, vals, exec_upto,
                                         wall_ns=time.time_ns())
        if freed == -1:
            # v1 store file (no CRC framing): never retry on this file
            self._snap_disabled = True
            return
        lb = self.store.log_bytes()
        # EV_SNAPSHOT: value = checkpointed frontier, aux = log bytes
        # after; EV_TRUNCATE only when the file shrank: value = freed
        self.journal.record(EV_SNAPSHOT, subject=self.me,
                            value=exec_upto, aux=lb)
        if freed > 0:
            self.journal.record(EV_TRUNCATE, subject=self.me,
                                value=freed, aux=lb)
        self._snap_goal_bytes = lb + max(self.flags.snap_every_bytes, 1)
        self._snap_last_s = time.monotonic()
        dlog(f"replica {self.me}: snapshot@{exec_upto} "
             f"({len(keys)} pairs, freed {freed} B, log {lb} B)")

    def _drain(self, timeout_s: float) -> bool:
        """Pull queued frames into the inbox buffer; returns whether a
        be_the_leader control event arrived."""
        elect = False
        t0 = time.perf_counter()
        try:
            item = (self._carry.pop() if self._carry
                    else self.queue.get(timeout=timeout_s))
        except queue.Empty:
            self._drain_wait_s = time.perf_counter() - t0
            return False
        self._drain_wait_s = time.perf_counter() - t0
        while True:
            src_kind, conn_id, kind, rows = item
            if src_kind == CONTROL:
                if kind == "be_the_leader":
                    # the boot self-election defers half a second, so
                    # traffic racing it can show an active leader;
                    # master promotions stay unconditional
                    if rows == "boot":
                        self._boot_pending = time.monotonic() + 0.5
                    else:
                        elect = True
                elif kind == "bounce":
                    self._bounce(conn_id, rows)  # refused at ingress
                elif kind == "send_beacon":
                    rows = make_batch(MsgKind.BEACON, rid=self.me,
                                      timestamp=np.uint64(cputicks()))
                    for q in range(self.cfg.n_replicas):
                        if q != self.me:
                            self.transport.send_peer(q, MsgKind.BEACON,
                                                     rows)
            elif src_kind == CONN_LOST:
                pass  # peer redial is lazy (dispatch path)
            elif kind == MsgKind.BEACON:
                self.transport.send_peer(
                    int(rows["rid"][0]), MsgKind.BEACON_REPLY, rows)
            elif kind == MsgKind.BEACON_REPLY:
                rtt = cputicks() - int(rows["timestamp"][0])
                q = conn_id if src_kind == FROM_PEER else int(rows["rid"][0])
                if q != self.me:
                    old = self.rtt_ewma[q]
                    self.rtt_ewma[q] = (rtt if np.isinf(old)
                                        else 0.99 * old + 0.01 * rtt)
            elif kind == MsgKind.READ:
                # linearizable read: through the log as a GET. A READ
                # has no bounce (its reply carries no ok), so the rows
                # past the inbox's room wait for the next drain
                room = max(self.inbox.room(), 0)
                if room < len(rows):
                    self._carry.append((src_kind, conn_id, kind, rows[room:]))
                    rows = rows[:room]
                n = len(rows)
                k_hi, k_lo = split_i64(rows["key"])
                self.inbox.append(
                    n, kind=int(MsgKind.PROPOSE), src=-1, op=int(Op.GET),
                    key_hi=k_hi, key_lo=k_lo, cmd_id=rows["cmd_id"],
                    client_id=conn_id)
                for c in rows["cmd_id"]:
                    self._pending[(conn_id, int(c))] = MsgKind.READ_REPLY
            elif kind == MsgKind.TRACE_CTX:
                # the client's origin time as the chain's start span,
                # moved into this replica's monotonic domain (wall
                # minus our wall-mono offset). Filtered through our own
                # sampling exponent: a client sampling more than the
                # cluster degrades to the intersection.
                if self.trace_sink.enabled and len(rows):
                    m = self.trace_sink.sampled(rows["cmd_id"])
                    if m.any():
                        ring = self.trace_sink.ring()
                        my_off = time.time_ns() - monotonic_ns()
                        take = rows[m]
                        for cmd, tid, wall in zip(
                                take["cmd_id"].tolist(),
                                take["trace_id"].tolist(),
                                take["origin_wall_ns"].tolist()):
                            ring.record(tid, ST_ORIGIN, wall - my_off,
                                        wall - my_off, cmd)
            elif kind == MsgKind.SNAP_META:
                # snapshot catch-up announcement: one assembly buffer
                # per announced frontier ahead of our own
                for r in rows:
                    fr = int(r["frontier"])
                    if (fr > int(self.snapshot.get("executed", -1))
                            and fr not in self._snap_rx):
                        self._snap_rx[fr] = {"count": int(r["count"]),
                                             "src": int(r["leader_id"]),
                                             "rows": []}
                self._snap_rx_install()  # count=0 installs immediately
            elif kind == MsgKind.SNAP_ROWS:
                for fr in np.unique(rows["frontier"]):
                    st = self._snap_rx.get(int(fr))
                    if st is not None:
                        st["rows"].append(rows[rows["frontier"] == fr])
                self._snap_rx_install()
            else:
                if src_kind == FROM_PEER and kind in (
                        MsgKind.PREPARE, MsgKind.ACCEPT, MsgKind.COMMIT,
                        MsgKind.COMMIT_SHORT):
                    self._seen_leader = True
                if src_kind == FROM_CLIENT and kind == MsgKind.PROPOSE:
                    # drop same-connection re-sends of still-pending
                    # commands (a retry must not allocate a second slot)
                    fresh = np.fromiter(
                        ((conn_id, int(c)) not in self._pending
                         for c in rows["cmd_id"]), bool, len(rows))
                    if not fresh.all():
                        rows = rows[fresh]
                    # truncate to inbox room BEFORE registering: a row
                    # registered but dropped would blackhole its retries
                    room = max(self.inbox.room(), 0)
                    self._bounce(conn_id, rows["cmd_id"][room:])
                    rows = rows[:room]
                    for c in rows["cmd_id"]:
                        self._pending[(conn_id, int(c))] = MsgKind.PROPOSE_REPLY
                    self._c_proposals.inc(len(rows))
                    if self.trace_sink.enabled and len(rows):
                        # drain stamp; aux = the dispatch count, so the
                        # exec stamp's count says how many dispatches
                        # admission -> execution took
                        t_dr = monotonic_ns()
                        self.trace_sink.stamp_batch(
                            ST_DRAIN, rows["cmd_id"], t_dr, t_dr,
                            aux=self._c_dispatches.value)
                    if DLOG:
                        dlog(f"replica {self.me}: drain PROPOSE "
                             f"n={len(rows)}")
                if kind == MsgKind.PREPARE_INST:
                    # a sweep asking about slots below our window: the
                    # stable store's mirror answers with COMMIT rows
                    self._store_answer_sweep(rows)
                elif (kind == MsgKind.ACCEPT_REPLY
                      and self.protocol == "mencius"
                      and not rows["ok"].all()):
                    self._store_answer_report(rows[rows["ok"] == 0])
                elif kind == MsgKind.SKIP:
                    # a cede range that would merge with an earlier one
                    # of its owner across a proposed slot ends this
                    # inbox: it and the frames behind it go to the next
                    fit = batches.skip_rows_that_fit(
                        self.inbox, rows, self.cfg.n_replicas)
                    if fit < len(rows):
                        self._c_skips_deferred.inc(len(rows) - fit)
                        self._carry.append((src_kind, conn_id, kind,
                                            rows[fit:]))
                        batches.frame_to_rows(self.inbox, kind, rows[:fit],
                                              conn_id)
                        break
                batches.frame_to_rows(self.inbox, kind, rows, conn_id)
            if self.inbox.room() <= 0:
                break
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
        return elect

    def _bounce(self, conn_id: int, cmd_ids) -> None:
        """Answer client commands this replica does not hold (no inbox
        room, or refused at ingress) with ok = 0: the client sends them
        again (runtime/client.py's retry semantics)."""
        if len(cmd_ids) == 0:
            return
        lead = self.snapshot["leader"]
        frame = make_batch(MsgKind.PROPOSE_REPLY, ok=0,
                           cmd_id=np.asarray(cmd_ids, np.int32), val=0,
                           timestamp=monotonic_ns(),
                           leader=np.int8(lead if lead >= 0 else self.me))
        self.transport.send_client(conn_id, MsgKind.PROPOSE_REPLY, frame)
        self.transport.flush_all()

    def _store_commit_frame(self, lo: int, hi: int, frontier: int):
        """A COMMIT frame of store-mirror records for [lo, hi], or None."""
        rec = self.store.read_range(lo, hi)
        if len(rec) == 0:
            return None
        return make_batch(
            MsgKind.COMMIT, leader_id=self.me, inst=rec["inst"],
            ballot=rec["ballot"], op=rec["op"], key=rec["key"],
            val=rec["val"], cmd_id=rec["cmd_id"],
            client_id=rec["client_id"], last_committed=frontier)

    def _store_answer_sweep(self, rows) -> None:
        """Serve a PREPARE_INST sweep that reaches below our window from
        the durable mirror: COMMIT rows for [lowest asked slot,
        committed prefix], chunked by catchup_rows (a snapshot first
        when the sweep reaches below our truncation frontier)."""
        base = self.snapshot["window_base"]
        lo = int(rows["inst"].min())
        if lo >= base:
            return  # in-window: the device answers
        q = int(rows["leader_id"][0])
        if not (0 <= q < self.cfg.n_replicas) or q == self.me:
            return
        sb = self.store.base
        if sb >= 0 and lo <= sb:
            self._send_snapshot(q)
            lo = sb + 1
        hi = min(lo + self.cfg.catchup_rows - 1, self.store.committed_prefix())
        if hi < lo:
            self.transport.flush_all()
            return
        frame = self._store_commit_frame(lo, hi, self.snapshot["frontier"])
        if frame is not None:
            self._send_or_redial(q, MsgKind.COMMIT, frame)
        self.transport.flush_all()

    def _store_answer_report(self, rows) -> None:
        """Serve a Mencius peer that reported a frontier below ours
        (_report_frontier) from the durable mirror: COMMIT rows from its
        frontier up, half an inbox of them (a Mencius store is never
        truncated, so it holds the slots that slid out of our window as
        well as those the device could push, models/mencius.py 9d)."""
        top = self.store.committed_prefix()
        sent = False
        for q in np.unique(rows["id"]).tolist():
            lc = int(rows["last_committed"][rows["id"] == q].min())
            if not (0 <= q < self.cfg.n_replicas) or q == self.me or lc >= top:
                continue
            hi = min(lc + max(self.cfg.inbox // 2, 1), top)
            frame = self._store_commit_frame(lc + 1, hi, self.snapshot["frontier"])
            if frame is not None:
                self._send_or_redial(q, MsgKind.COMMIT, frame)
                sent = True
        if sent:
            self.transport.flush_all()

    def _become_leader(self) -> None:
        if self.protocol == "mencius":
            return  # no leaders; master promotions no-op
        # deferred host phases first: the PREPARE must not overtake the
        # previous tick's buffered accepts/commits on the wire
        self._flush_inflight()
        which = torch.ones(1, dtype=torch.bool, device=self.dev)
        self.state, prep = become_leader(self.cfg, self.state, which)
        x = prep.stacked()[:, 0, :].cpu().numpy()
        cols = {c: x[j] for j, c in enumerate(batches.COLS)}
        frames = batches.rows_to_frames(cols, np.array([True]))
        for kind, frame in frames:
            for q in range(self.cfg.n_replicas):
                if q != self.me:
                    self._send_or_redial(q, kind, frame)
        self.transport.flush_all()
        self._c_elections.inc()
        self.journal.record(EV_ELECTION, subject=self.me,
                            value=self.snapshot["frontier"])
        dlog(f"replica {self.me}: running election")

    # kinds whose rows address log slots (narrow-view gating reads
    # their ranges host-side)
    _ADDR_KINDS = (int(MsgKind.ACCEPT), int(MsgKind.COMMIT),
                   int(MsgKind.PREPARE_INST),
                   int(MsgKind.PREPARE_INST_REPLY))
    # kinds that can move crt_inst beyond any row's inst: full step
    _FULL_STEP_KINDS = (int(MsgKind.PREPARE), int(MsgKind.PREPARE_REPLY))

    def _choose_fuse(self, n_rows: int) -> int:
        """Fused substeps for this dispatch: kf only when the snapshot
        shows follow-up ticks are certain — an exec backlog deeper than
        (kf-1) exec batches, or cursors trailing the frontier by a
        recovery-scale gap — and no traffic is queued; else 1."""
        kf = max(1, self.flags.fuse_ticks)
        snap = self.snapshot
        if kf == 1 or "low" not in snap:
            return 1
        if not self.queue.empty():
            return 1
        backlog = snap["frontier"] - snap["executed"]
        trail = snap["frontier"] + 1 - snap["low"]
        lag_floor = max(2 * self.cfg.inbox, self.cfg.catchup_rows)
        if trail > lag_floor:
            return kf
        if backlog > (kf - 1) * self.cfg.exec_batch:
            return kf
        return 1

    def _choose_narrow(self, cols, n_rows: int) -> tuple[int, int]:
        """(narrow, off) for this dispatch, or (0, 0) for the full step:
        the narrow view is exact only when every slot the substeps could
        read or write lies inside it — the published low/high anchors
        bound the timer-driven paths, the inbox bound the message-driven
        writes, and proposals extend the tip by at most n_rows slots
        (times R for Mencius's strided ownership)."""
        nw = self.flags.narrow_window
        snap = self.snapshot
        if not nw or nw >= self.cfg.window or "low" not in snap:
            return 0, 0
        if self._narrow_doubt:
            self._narrow_doubt = False
            return 0, 0
        base = snap["window_base"]
        low = max(snap["low"], base)
        off = low - base
        if off > self.cfg.window - nw:
            return 0, 0
        top = base + off + nw  # absolute, exclusive
        stride = self.cfg.n_replicas if self.protocol == "mencius" else 1
        if snap["high"] + n_rows * stride + 1 > top:
            return 0, 0
        if n_rows:
            k = cols["kind"][:n_rows]
            if np.isin(k, self._FULL_STEP_KINDS).any():
                return 0, 0
            inst = cols["inst"][:n_rows]
            lo_req, hi_req = top, low - 1  # empty bounds
            addr = np.isin(k, self._ADDR_KINDS)
            if addr.any():
                lo_req = min(lo_req, int(inst[addr].min()))
                hi_req = max(hi_req, int(inst[addr].max()))
            ar = k == int(MsgKind.ACCEPT_REPLY)
            if ar.any():
                lo_req = min(lo_req, int(inst[ar].min()))
                # run-length acks cover [inst, inst + (count-1)*stride]
                hi_req = max(hi_req, int(
                    (inst[ar] + (np.maximum(cols["cmd_id"][:n_rows][ar], 1)
                                 - 1) * stride).max()))
            sk = k == int(MsgKind.SKIP)
            if sk.any():
                lo_req = min(lo_req, int(
                    cols["last_committed"][:n_rows][sk].min()))
                hi_req = max(hi_req, int(inst[sk].max()))
            if self.protocol == "mencius":
                com = k == int(MsgKind.COMMIT)
                if com.any():
                    hi_req = max(hi_req, int(
                        cols["last_committed"][:n_rows][com].max()))
            if lo_req < low or hi_req >= top:
                return 0, 0
        return nw, off

    def _device_tick(self, buf: batches.ColumnBuffer,
                     persist: bool = True, dispatch: bool = True) -> None:
        """One dispatch as a depth-2 pipeline: enqueue this tick's step
        and packing and one non-blocking copy of the packed buffer, run
        the PREVIOUS tick's deferred host phases while the device works,
        then wait for the copy. Host phases are deferred to the next
        call only when follow-up traffic is already queued; otherwise
        they complete here, in the serial order (-nopipeline always)."""
        if DLOG and buf.fill:
            dlog(f"replica {self.me}: tick start fill={buf.fill}")
        t0 = time.perf_counter()
        cols, n_rows = buf.drain()
        inbox = self._to_device(cols)
        k = self._choose_fuse(n_rows)
        narrow, off = self._choose_narrow(cols, n_rows)
        view_lo = self.snapshot.get("window_base", 0) + off
        ev = self._events
        if ev is not None:
            ev[0].record()
        dbuf = self.step(inbox, k, narrow, off)
        if ev is not None:
            ev[1].record()
        hbuf = self._host_buf(dbuf.shape)
        self._parity ^= 1
        hbuf.copy_(dbuf, non_blocking=True)
        if ev is not None:
            ev[2].record()
        t_enq = time.perf_counter()
        # the previous tick's host phases, hidden under this device work
        self._flush_inflight(overlapped=True)
        t_host = time.perf_counter()
        if ev is not None:
            ev[2].synchronize()
            self._c_device_us.inc(int(ev[0].elapsed_time(ev[1]) * 1e3))
        out_mats, exec_mats, scals, pcs = unpack(
            hbuf.numpy()[:, 0], self.cfg.exec_batch, self.cfg.n_replicas)
        t_rb = time.perf_counter()
        t_rb_ns = monotonic_ns()  # trace anchor of the dispatch phases
        self._c_wall_us.inc(int((t_rb - t0) * 1e6))
        self._c_dispatches.inc()
        self._c_fused_substeps.inc(k)
        if narrow:
            self._c_narrow_steps.inc()
        elif k > 1:
            self._c_fused_dispatches.inc()
        else:
            self._c_full_steps.inc()
        self._last_dispatch = time.monotonic()
        self._check_kv_load()
        if DLOG and n_rows:
            dlog(f"replica {self.me}: enqueue+readback k={k} "
                 f"narrow={narrow} {(t_rb - t0) * 1e3:.2f}ms")
        mencius = self.protocol == "mencius"
        last = scals[-1]
        self._last_scals = last.copy()
        frontier_last = int(last[SCAL_FRONTIER])
        if frontier_last < self.snapshot["frontier"]:
            dlog(f"replica {self.me}: FRONTIER WENT BACKWARD "
                 f"{self.snapshot['frontier']} -> {frontier_last}")
        # published at readback — before the next tick's fuse/narrow/
        # idle decisions and before this tick's catch-up
        prev_leader = self.snapshot["leader"]
        self.snapshot = {
            "frontier": frontier_last,
            "window_base": int(last[SCAL_WINDOW_BASE]),
            "crt_inst": int(last[SCAL_CRT_INST]),
            "leader": -1 if mencius else int(last[SCAL_LEADER]),
            "prepared": True if mencius else bool(last[SCAL_PREPARED]),
            "executed": int(last[SCAL_EXECUTED]),
            "low": int(last[SCAL_LOW_ANCHOR]),
            "high": int(last[SCAL_HIGH_ANCHOR]),
            "work_pending": bool(last[SCAL_WORK_PENDING]),
        }
        if self.snapshot["prepared"]:
            self._reprepare_s = self.REPREPARE_S
        if self.snapshot["leader"] != prev_leader:
            # the published leader moved: an election landed
            self.journal.record(EV_LEADER_CHANGE,
                                subject=self.snapshot["leader"],
                                value=frontier_last, aux=prev_leader)
        if narrow:
            # post-readback anchor validation: the choose-time proof
            # said every touched slot lies in [view_lo, view_lo+narrow);
            # the device-published anchors must agree, else recount
            # through one full-width step
            lows = np.maximum(scals[:, SCAL_LOW_ANCHOR],
                              scals[:, SCAL_WINDOW_BASE])
            if (int(lows.min()) < view_lo
                    or int(scals[:, SCAL_HIGH_ANCHOR].max())
                    > view_lo + narrow):
                self._c_narrow_fallbacks.inc()
                self._narrow_doubt = True
                self.journal.record(
                    EV_NARROW_FALLBACK, subject=self.me,
                    value=self._c_narrow_fallbacks.value)
                dlog(f"replica {self.me}: narrow anchor validation "
                     f"FAILED (view [{view_lo}, {view_lo + narrow})); "
                     f"next dispatch recounts full-width")
        # this tick's [R] peer-commit vector rides the packed row
        pc = None if mencius else pcs[-1].copy()
        rows_out = int((out_mats[:, 0, :] != 0).sum())  # col 0 = kind
        exec_total = int(scals[:, SCAL_EXEC_COUNT].sum())
        self._idle = (n_rows == 0 and rows_out == 0 and exec_total == 0)
        # KV saturation is a correctness failure: a dropped insert
        # belongs to an acknowledged command. Fail-stop before this
        # tick's replies can leave.
        dropped = int(last[SCAL_KV_DROPPED])
        if dropped and self.fatal is None:
            self.fatal = (
                f"replica {self.me}: KV table saturated — {dropped} "
                f"write(s) dropped (kv_pow2={self.cfg.kv_pow2} is too "
                f"small for the live key space); failing stop")
            self.journal.record(EV_FATAL, subject=self.me, value=dropped)
            raise FatalReplicaError(self.fatal)
        drain_s, self._drain_work_s = self._drain_work_s, 0.0
        # the rows the ingress coalescer batched into this tick's drain
        # and its cumulative wakeup kicks (a chased dispatch reads 0)
        coal = self.coalescer
        coal_occ = coal_wake = 0
        if coal is not None:
            coal_occ, coal.last_occupancy = coal.last_occupancy, 0
            coal_wake = coal._c_wakeups.value
        rec = _InflightTick(
            cols=cols, n_rows=n_rows, out_mats=out_mats,
            exec_mats=exec_mats, scals=scals, k=k,
            kind=(KIND_NARROW if narrow
                  else KIND_FUSED if k > 1 else KIND_FULL),
            persist=persist, dispatch=dispatch, frontier=frontier_last,
            backlog=frontier_last - int(last[SCAL_EXECUTED]),
            rows_out=rows_out, peer_commits=pc, snap=self.snapshot,
            drain_us=int(drain_s * 1e6),
            enqueue_us=int((t_enq - t0) * 1e6),
            readback_us=int((t_rb - t_host) * 1e6),
            t_rb_ns=t_rb_ns, coal_occ=coal_occ, coal_wake=coal_wake)
        self._inflight = rec
        if not (self.flags.pipeline and persist and dispatch
                and not self.queue.empty()):
            self._flush_inflight()

    def _flush_inflight(self, overlapped: bool = False) -> None:
        """Complete the deferred tick's host phases, if any."""
        rec, self._inflight = self._inflight, None
        if rec is not None:
            self._finish_host(rec, overlapped)

    def _finish_host(self, rec: _InflightTick, overlapped: bool) -> None:
        """persist -> dispatch -> reply -> catch-up for one dispatched
        tick, one vectorized pass each over the stacked [k, ...]
        matrices. The store flush (fsync under -durable) happens before
        any buffered reply frame reaches a socket (flush_all is last)."""
        t_f0 = time.perf_counter()
        cols, n_rows, k = rec.cols, rec.n_rows, rec.k
        out_mats, exec_mats, scals = rec.out_mats, rec.exec_mats, rec.scals
        ncols = len(batches.COLS)
        if self.trace_sink.enabled:
            self._trace_commits(rec)
        persist_s = dispatch_s = reply_s = 0.0
        if rec.persist:
            tp = time.perf_counter()
            out0 = {c: out_mats[0][j] for j, c in enumerate(batches.COLS)}
            acked0 = out_mats[0][ncols + 1].astype(bool)
            wrote = self._persist(cols, n_rows, out0, acked0,
                                  int(scals[0][SCAL_FRONTIER]))
            if k > 1:
                # substeps 1..k-1 ran empty inboxes: every persistable
                # row of theirs is an outbox tail row
                big = {c: out_mats[1:, j, :].reshape(-1)
                       for j, c in enumerate(batches.COLS)}
                wrote |= self._persist(cols, 0, big,
                                       np.zeros(0, bool), rec.frontier)
            if wrote:
                # one store flush (fsync under -durable) for all k
                # substeps, before any frame leaves (flush_all below)
                self.store.flush()
            persist_s = time.perf_counter() - tp
        if rec.dispatch:
            td = time.perf_counter()
            if rec.rows_out:
                flat = {c: out_mats[:, j, :].reshape(-1)
                        for j, c in enumerate(batches.COLS)}
                self._dispatch(flat, out_mats[:, ncols, :].reshape(-1))
            tr = time.perf_counter()
            self._reply_stacked(exec_mats, scals, k, rec.frontier)
            t_cu = time.perf_counter()
            self._host_catchup(rec.peer_commits, rec.snap)
            self._report_frontier(rec.snap)
            self.transport.flush_all()
            t_de = time.perf_counter()
            dispatch_s = (tr - td) + (t_de - t_cu)
            reply_s = t_cu - tr
        # one recorder row per dispatch, carrying k (a fused burst is
        # one wall tick); overlap_us = this tick's host-phase wall run
        # while the next dispatch was in flight (0 when serial)
        host_s = time.perf_counter() - t_f0
        if overlapped:
            self._c_pipelined.inc()
        step_s = (rec.enqueue_us + rec.readback_us) / 1e6
        self._h_tick.observe((rec.drain_us / 1e6 + step_s + host_s) * 1e3)
        self._h_step.observe(step_s * 1e3)
        if self.recorder is not None:
            self.recorder.record(
                monotonic_ns(), rec.kind, k, n_rows, rec.rows_out,
                rec.frontier, rec.backlog, rec.drain_us, rec.enqueue_us,
                rec.readback_us, int(host_s * 1e6) if overlapped else 0,
                int(persist_s * 1e6), int(dispatch_s * 1e6),
                int(reply_s * 1e6), rec.t_rb_ns,
                chaos_faults=self.transport.chaos_faults_total(),
                coal_occ=rec.coal_occ, coal_wake=rec.coal_wake)

    # -- paxtrace: slot assignment + commit stamps (protocol thread) --

    def _trace_commits(self, rec: _InflightTick) -> None:
        """Two paxtrace duties per dispatch, both O(sampled): learn the
        log slot of every sampled proposal this tick admitted (the
        ACCEPT broadcast at outbox row i carries the slot assigned to
        inbox PROPOSE row i, the alignment ``_persist`` relies on), and
        stamp ST_COMMIT, at the tick's readback time, for the tracked
        slots the tick's frontier covered. The tracked set is a
        min-heap keyed on slot: slots can sit above the frontier for
        many dispatches, and a scan of all of them every dispatch would
        cost the protocol thread under load."""
        sink = self.trace_sink
        n = rec.n_rows
        if n:
            ik = rec.cols["kind"][:n]
            pm = ik == int(MsgKind.PROPOSE)
            if pm.any():
                ids = rec.cols["cmd_id"][:n]
                out_kind = rec.out_mats[0, 0, :n]  # col 0 = kind
                sm = pm & sink.sampled(ids) \
                    & (out_kind == int(MsgKind.ACCEPT))
                if sm.any():
                    out_inst = rec.out_mats[0, 3, :n]  # col 3 = inst
                    ccol = rec.cols["client_id"][:n]
                    for i in np.nonzero(sm)[0]:
                        # READs ride the log as PROPOSE rows; their
                        # chains never complete, so no commit stamp
                        if self._pending.get(
                                (int(ccol[i]), int(ids[i]))) \
                                == MsgKind.READ_REPLY:
                            continue
                        heapq.heappush(self._trace_slots,
                                       (int(out_inst[i]), int(ids[i])))
        if self._trace_slots and self._trace_slots[0][0] <= rec.frontier:
            ring = sink.ring()
            while self._trace_slots and \
                    self._trace_slots[0][0] <= rec.frontier:
                s, cmd = heapq.heappop(self._trace_slots)
                ring.record(trace_id_for(cmd), ST_COMMIT,
                            rec.t_rb_ns, rec.t_rb_ns, s)

    # -- durability: reconstruct accepted slots from (inbox, outbox) --

    def _persist(self, in_cols, n_rows, out_cols, acked,
                 frontier: int) -> bool:
        """Accepted slots reconstructed from the inbox plus the step's
        outputs; returns whether anything was appended (the caller
        flushes once per dispatch):

        * follower acks: the per-inbox-row ``acked`` mask -> slot from
          inbox ACCEPT row i
        * leader self-accepts: out ACCEPT broadcast at i -> command from
          inbox PROPOSE row i
        * commits applied: inbox COMMIT rows
        * retry/no-op rows (appended tail): out ACCEPT rows beyond the
          inbox range
        * Mencius SKIP ranges: no-op records for the ceder's slots
        """
        n = n_rows
        ik = in_cols["kind"][:n]
        ok_acc = acked[:n] & (ik == int(MsgKind.ACCEPT))
        lead_acc = out_cols["kind"][:n] == int(MsgKind.ACCEPT)
        com = ik == int(MsgKind.COMMIT)
        recs = []
        if ok_acc.any() or com.any():
            m = ok_acc | com
            # drop rows the store already holds committed, and all but
            # the first COMMIT row per inst in this batch
            idx = np.nonzero(m)[0]
            dup = self.store.is_committed(in_cols["inst"][:n][idx])
            m[idx[dup]] = False
            com = com & m
            cidx = np.nonzero(com)[0]
            if len(cidx) > 1:
                _, first = np.unique(in_cols["inst"][:n][cidx],
                                     return_index=True)
                drop = np.ones(len(cidx), bool)
                drop[first] = False
                m[cidx[drop]] = False
                com = com & m
            recs.append((in_cols["inst"][:n][m], in_cols["ballot"][:n][m],
                         np.where(com[m], COMMITTED, ACCEPTED),
                         in_cols["op"][:n][m],
                         join_i64(in_cols["key_hi"][:n][m], in_cols["key_lo"][:n][m]),
                         join_i64(in_cols["val_hi"][:n][m], in_cols["val_lo"][:n][m]),
                         in_cols["cmd_id"][:n][m], in_cols["client_id"][:n][m]))
        if lead_acc.any():
            m = lead_acc
            recs.append((out_cols["inst"][:n][m], out_cols["ballot"][:n][m],
                         np.full(m.sum(), ACCEPTED),
                         out_cols["op"][:n][m],
                         join_i64(out_cols["key_hi"][:n][m], out_cols["key_lo"][:n][m]),
                         join_i64(out_cols["val_hi"][:n][m], out_cols["val_lo"][:n][m]),
                         out_cols["cmd_id"][:n][m], out_cols["client_id"][:n][m]))
        t = slice(n, None)
        tail_acc = (out_cols["kind"][t] == int(MsgKind.ACCEPT)) \
            & ~self.store.is_committed(out_cols["inst"][t])
        if tail_acc.any():
            m = tail_acc
            recs.append((out_cols["inst"][t][m], out_cols["ballot"][t][m],
                         np.full(m.sum(), ACCEPTED),
                         out_cols["op"][t][m],
                         join_i64(out_cols["key_hi"][t][m], out_cols["key_lo"][t][m]),
                         join_i64(out_cols["val_hi"][t][m], out_cols["val_lo"][t][m]),
                         out_cols["cmd_id"][t][m], out_cols["client_id"][t][m]))
        if self.protocol == "mencius":
            for cols_, hi in ((in_cols, n), (out_cols, None)):
                ks = cols_["kind"][:hi]
                for j in np.nonzero(ks == int(MsgKind.SKIP))[0]:
                    owner = int(cols_["src"][:hi][j])
                    start = int(cols_["last_committed"][:hi][j])
                    end = int(cols_["inst"][:hi][j])
                    if end < start:
                        continue
                    slots = np.arange(start, end + 1, dtype=np.int64)
                    slots = slots[slots % self.cfg.n_replicas == owner]
                    slots = slots[~self.store.is_committed(slots)]
                    if len(slots):
                        z = np.zeros(len(slots), np.int64)
                        recs.append((slots.astype(np.int32),
                                     z.astype(np.int32),
                                     np.full(len(slots), COMMITTED),
                                     np.full(len(slots), int(Op.NONE)),
                                     z, z, z.astype(np.int32),
                                     np.full(len(slots), -1, np.int32)))
        wrote = False
        for inst, ballot, status, op, key, val, cmd, cli in recs:
            if len(inst):
                self.store.append_slots(inst, ballot, status, op, key, val,
                                        cmd, cli)
                wrote = True
        if frontier > self.store.frontier:
            self.store.append_frontier(frontier)
            wrote = True
        return wrote

    # -- outbox dispatch --

    def _quorum_targets(self) -> list[int]:
        """Thrifty: accepts go to floor(N/2) peers only; with beacons
        on, the lowest-RTT peers."""
        peers = [q for q in range(self.cfg.n_replicas) if q != self.me]
        if self.flags.beacon:
            peers.sort(key=lambda q: self.rtt_ewma[q])
        return peers[: self.cfg.n_replicas // 2]

    def _send_or_redial(self, q, kind, frame) -> None:
        if not self.transport.send_peer(q, kind, frame):
            if self.transport.dial_peer(q):
                self.transport.send_peer(q, kind, frame)

    def _dispatch(self, out_cols, dst) -> None:
        kinds = out_cols["kind"]
        live = kinds != 0
        if not live.any():
            return
        if DLOG:
            dlog(f"replica {self.me}: dispatch "
                 f"{np.bincount(kinds[live]).nonzero()[0].tolist()}")
        thrifty_q = self._quorum_targets() if self.flags.thrifty else None
        for q in range(self.cfg.n_replicas):
            if q == self.me:
                continue
            mask = live & ((dst == q) | (dst == -1))
            if thrifty_q is not None and q not in thrifty_q:
                mask = mask & ~((dst == -1) & (kinds == int(MsgKind.ACCEPT)))
            if not mask.any():
                continue
            for kind, frame in batches.rows_to_frames(out_cols, mask):
                self._send_or_redial(q, kind, frame)
        # client-bound rejections (dst == -2): ProposeReplyTS{FALSE,
        # Leader} so clients re-route (bareminpaxos.go:618-625)
        rej = live & (dst == -2) & (kinds == int(MsgKind.PROPOSE_REPLY))
        if rej.any():
            self._c_rejected.inc(int(rej.sum()))
            leader_hint = out_cols["ballot"][rej]
            cids = out_cols["client_id"][rej]
            cmds = out_cols["cmd_id"][rej]
            for cid in np.unique(cids):
                m = cids == cid
                frame = make_batch(MsgKind.PROPOSE_REPLY, ok=0,
                                   cmd_id=cmds[m], val=0,
                                   timestamp=monotonic_ns(),
                                   leader=leader_hint[m].astype(np.int8))
                self.transport.send_client(int(cid), MsgKind.PROPOSE_REPLY,
                                           frame)
                for c in cmds[m]:
                    self._pending.pop((int(cid), int(c)), None)

    # -- execution replies --

    def _reply_stacked(self, exec_mats: np.ndarray, scals: np.ndarray,
                       k: int, frontier: int) -> None:
        """Execution replies for all k substeps in one pass, one frame
        per (connection, kind); no-op fills (client id < 0) dropped."""
        counts = scals[:, SCAL_EXEC_COUNT]
        total = int(counts.sum())
        self._c_executed.inc(total)
        self._g_committed.set(frontier + 1)
        if total == 0 or not self.flags.dreply:
            return
        if DLOG:
            dlog(f"replica {self.me}: reply n={total}")
        live = [i for i in range(k) if counts[i] > 0]
        cids = np.concatenate(
            [exec_mats[i][5][:int(counts[i])] for i in live])
        cmds = np.concatenate(
            [exec_mats[i][4][:int(counts[i])] for i in live])
        vals = join_i64(
            np.concatenate([exec_mats[i][0][:int(counts[i])]
                            for i in live]),
            np.concatenate([exec_mats[i][1][:int(counts[i])]
                            for i in live]))
        writes: dict[int, tuple[list, list]] = {}
        reads: dict[int, tuple[list, list]] = {}
        sink = self.trace_sink
        tracing = sink.enabled
        traced: list[int] = []
        t_x0 = monotonic_ns() if tracing else 0
        # one vectorized sampling hash for the whole pass
        smask = sink.sampled(cmds) if tracing else None
        for i in np.nonzero(cids >= 0)[0]:
            key = (int(cids[i]), int(cmds[i]))
            want = self._pending.pop(key, None)
            if want is None:
                continue  # not proposed on this conn (or already replied)
            if tracing and want != MsgKind.READ_REPLY and smask[i]:
                traced.append(key[1])  # writes only, as the drain stamps
            book = reads if want == MsgKind.READ_REPLY else writes
            cs_, vs_ = book.setdefault(key[0], ([], []))
            cs_.append(key[1])
            vs_.append(int(vals[i]))
        ts = monotonic_ns()
        for conn, (cs_, vs_) in writes.items():
            frame = make_batch(MsgKind.PROPOSE_REPLY, ok=1,
                               cmd_id=np.asarray(cs_, np.int32),
                               val=np.asarray(vs_, np.int64),
                               timestamp=ts, leader=np.int8(self.me))
            self.transport.send_client(conn, MsgKind.PROPOSE_REPLY, frame)
        for conn, (cs_, vs_) in reads.items():
            frame = make_batch(MsgKind.READ_REPLY,
                               cmd_id=np.asarray(cs_, np.int32),
                               val=np.asarray(vs_, np.int64))
            self.transport.send_client(conn, MsgKind.READ_REPLY, frame)
        if traced:
            # one exec stamp (commit -> here is the exec-backlog wait;
            # aux = the dispatch count, closing the drain stamp's) and
            # one reply-serialization span per sampled command. The
            # span ends at ``ts``, taken before the sends: a same-host
            # client can receive a frame before this code runs again,
            # and a later end would put reply_recv before it.
            ring = sink.ring()
            disp = self._c_dispatches.value
            for cmd in traced:
                tid = trace_id_for(cmd)
                ring.record(tid, ST_EXEC, t_x0, t_x0, disp)
                ring.record(tid, ST_REPLY_SER, t_x0, ts, cmd)

    # -- beyond-window catch-up from the durable log --

    def _host_catchup(self, pc: np.ndarray | None, snap: dict) -> None:
        """A peer lagging behind window_base can't be healed by device
        catch-up rows (they slid out): serve it from the stable store's
        mirror (or its retained snapshot). ``pc``/``snap`` are the
        tick's own, captured at its readback."""
        if self.protocol == "mencius" or pc is None:
            return  # leaderless: healing is pull-based (sweeps)
        if not snap["prepared"] or snap["leader"] != self.me:
            return
        base = snap["window_base"]
        fr = snap["frontier"]
        sb = self.store.base
        for q in range(self.cfg.n_replicas):
            if q == self.me or pc[q] + 1 >= base:
                continue
            if sb >= 0 and pc[q] < sb:
                self._send_snapshot(q)
                continue
            frame = self._store_commit_frame(
                int(pc[q]) + 1, min(int(pc[q]) + 256, base - 1), fr)
            if frame is not None:
                self._send_or_redial(q, MsgKind.COMMIT, frame)

    # seconds a Mencius frontier stays stuck before it is reported, and
    # between two reports
    _REPORT_S = 0.05

    def _report_frontier(self, snap: dict) -> None:
        """Mencius heal push. Peers catch a lagging replica up from the
        frontier it last reported (models/mencius.py step 9d), and a
        replica reports it only on the accept traffic it sends: a
        revived owner sends none until its takeover timer fires, tens of
        stalled steps later, and then heals one sweep of recovery_rows
        per firing. So a Mencius replica whose frontier is stuck below
        slots it has seen reports the frontier itself, as an accept
        reply that carries no vote (ok = 0), at most every _REPORT_S."""
        if self.protocol != "mencius":
            return
        now = time.monotonic()
        fr = snap["frontier"]
        if fr != self._report_fr:
            self._report_fr, self._report_since = fr, now
            return
        if (snap["crt_inst"] - 1 <= fr
                or now - self._report_since < self._REPORT_S
                or now - self._report_last < self._REPORT_S):
            return
        self._report_last = now
        frame = make_batch(MsgKind.ACCEPT_REPLY, id=self.me, ok=0,
                           inst=fr + 1, count=1, ballot=0,
                           last_committed=fr)
        for q in range(self.cfg.n_replicas):
            if q != self.me:
                self._send_or_redial(q, MsgKind.ACCEPT_REPLY, frame)

    # minimum seconds between snapshot re-pushes to one peer
    _SNAP_RESEND_S = 2.0

    def _send_snapshot(self, q: int) -> None:
        """Push the newest retained snapshot to peer q: one SNAP_META,
        then its live pairs as SNAP_ROWS frames (every row repeats the
        frontier, so two transfers never splice)."""
        now = time.monotonic()
        if now - self._snap_sent_s.get(q, -1e9) < self._SNAP_RESEND_S:
            return
        fr = self.store.snap_frontier
        pairs = self.store.snapshot_pairs
        if fr < 0:
            return
        self._snap_sent_s[q] = now
        self._snap_seq += 1
        meta = make_batch(MsgKind.SNAP_META, leader_id=self.me,
                          frontier=fr, count=len(pairs),
                          seq=self._snap_seq)
        self._send_or_redial(q, MsgKind.SNAP_META, meta)
        for lo in range(0, len(pairs), 4096):
            ch = pairs[lo:lo + 4096]
            rows = make_batch(MsgKind.SNAP_ROWS, frontier=fr,
                              key=np.ascontiguousarray(ch["key"]),
                              val=np.ascontiguousarray(ch["val"]))
            self._send_or_redial(q, MsgKind.SNAP_ROWS, rows)
        dlog(f"replica {self.me}: pushed snapshot@{fr} "
             f"({len(pairs)} pairs) to replica {q}")

    def _snap_rx_install(self) -> None:
        """Install a complete received snapshot that is ahead of our own
        executed frontier: the KV pairs and cursors
        (_install_snapshot_pairs), then the snapshot into our own
        stable store, so a restart replays from it."""
        for fr in sorted(self._snap_rx):
            st = self._snap_rx[fr]
            if sum(len(r) for r in st["rows"]) < st["count"]:
                continue
            del self._snap_rx[fr]
            if fr <= int(self.snapshot.get("executed", -1)):
                continue  # stale by the time it completed
            t0 = time.perf_counter()
            self._flush_inflight()
            pairs = (np.concatenate(st["rows"]) if st["rows"]
                     else empty_batch(MsgKind.SNAP_ROWS))
            self._install_snapshot_pairs(pairs, fr)
            self.store.take_snapshot(
                np.ascontiguousarray(pairs["key"]),
                np.ascontiguousarray(pairs["val"]), fr,
                wall_ns=time.time_ns())
            self.snapshot = dict(
                self.snapshot, frontier=fr, executed=fr,
                window_base=fr + 1,
                crt_inst=max(int(self.snapshot.get("crt_inst", 0)),
                             fr + 1),
                work_pending=True)
            self.journal.record(
                EV_RECOVERY, subject=self.me, value=fr,
                aux=int((time.perf_counter() - t0) * 1e3))
            dlog(f"replica {self.me}: installed snapshot@{fr} "
                 f"({len(pairs)} pairs) from replica {st['src']}")
        done = int(self.snapshot.get("executed", -1))
        for fr in [f for f in self._snap_rx if f <= done]:
            del self._snap_rx[fr]
