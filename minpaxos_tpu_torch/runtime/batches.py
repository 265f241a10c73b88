"""Host-side packing: wire frames <-> device MsgBatch columns.

The port's copy of the JAX package's ``runtime/batches.py``.

The device consumes ``MsgBatch`` — 12 parallel i32 columns, one row per
log slot touched (models/minpaxos.py). The wire carries structured
frames (wire/messages.py). This module is the boundary: decoded frames
append into a column buffer that becomes the next step's inbox; outbox
rows flatten back into frames per destination.

Counterpart of the reference's per-message Marshal/Unmarshal +
channel-dispatch plumbing (genericsmr.go:402-446 and the *marsh.go
files); here a 5000-row Accept frame becomes 5000 device rows with a
handful of numpy column copies.

AcceptReply compression is kernel-native: the device emits
one ACCEPT_REPLY row per contiguous run with the run length in cmd_id
(like the reference's batched AcceptReply covering a whole Accept
batch, minpaxosproto.go:75-80), and consumes ranges the same way — so
this boundary maps count <-> cmd_id 1:1 in both directions with no
expansion.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from minpaxos_tpu_torch.obs.metrics import MetricsRegistry
from minpaxos_tpu_torch.ops.packed import join_i64, split_i64
from minpaxos_tpu_torch.wire.messages import MsgKind, make_batch

COLS = ("kind", "src", "ballot", "inst", "last_committed", "op",
        "key_hi", "key_lo", "val_hi", "val_lo", "cmd_id", "client_id")

#: mirrors transport.FROM_CLIENT (transport imports nothing from here's
#: coalescer, but keeping the literal avoids a runtime import cycle;
#: the wire ledger pins the queue item protocol, not this module)
_FROM_CLIENT = 1
#: mirrors replica.CONTROL, the tag of the bounce items put() queues
_CONTROL = 3

#: per-drain coalesced-row buckets for the occupancy histogram —
#: powers of two up to the largest inbox the shape ladder drives
COALESCE_ROW_BUCKETS: tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


class IngressCoalescer:
    """Event-driven ingress front for the protocol thread's inbox queue.

    Drop-in replacement for the ``queue.Queue`` the transport's reader
    threads feed (``put`` / ``get(timeout=...)`` / ``get_nowait`` /
    ``empty`` / ``qsize`` — the whole surface replica.py touches),
    injected via ``Transport(inbox_queue=...)``. Three behaviors turn
    the cadence-driven poll loop into an event-driven one:

    * **Condition-variable kick** — ``put`` notifies a blocked getter
      immediately, so queued traffic wakes the tick loop the moment
      rows arrive instead of riding out the poll sleep (the
      ``work_pending`` idle fast path is untouched: an idle replica
      still parks on the long timeout).
    * **Batch formation (max-wait µs / max-rows)** — once the first
      item lands, the blocking ``get`` lingers up to ``max_wait_us``
      for more client PROPOSE rows (stopping early at ``max_rows``),
      coalescing many small client writes into one device-sized
      proposal batch: one dispatch amortizes its fixed cost over the
      concurrent sessions instead of paying it per connection. A
      linger that times out short of ``max_rows`` counts a
      ``deadline_hit`` (the lone-serial-command case: it pays
      ``max_wait_us``, not a poll interval). ``max_wait_us=0``
      disables lingering entirely.
    * **Admission control** — when ``admit_gate`` (wired by the
      replica to the exec-backlog and window-occupancy bounds)
      reports overload AND the pending client rows already exceed ``max_rows``, new PROPOSE frames are refused at
      ingress and counted: only their cmd_ids are queued, for the
      protocol thread to answer with ok = 0 (the client sends them
      again) — overload degrades to bounded queueing instead of an
      unbounded tail.

    Lock discipline: every
    mutation happens under the wakeup condition variable, and nothing
    blocking — no socket ops, no sleeps — ever runs while holding it;
    ``wait`` releases the lock by construction. Peer frames, CONTROL
    verbs and CONN_LOST notices pass straight through in arrival
    order; only client PROPOSE rows participate in row accounting.
    """

    def __init__(self, max_wait_us: int = 200, max_rows: int = 256,
                 admit_gate=None, metrics: MetricsRegistry | None = None):
        self.max_wait_us = max_wait_us
        self.max_rows = max_rows
        self._admit_gate = admit_gate
        self._items: list = []
        self._cv = threading.Condition()
        self._pending_rows = 0  # client PROPOSE rows queued
        self._waiting = 0       # getters currently blocked
        self.last_occupancy = 0  # rows coalesced by the newest drain
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            namespace="coalescer")
        self._c_wakeups = self.metrics.counter(
            "coalesce_wakeups", "puts that kicked a blocked tick loop "
            "awake (the event-driven path; 0 means the loop never "
            "slept while traffic arrived)")
        self._c_deadline_hits = self.metrics.counter(
            "coalesce_deadline_hits", "batch-formation lingers that "
            "timed out at max_wait_us short of max_rows (the lone "
            "serial command's bounded wait)")
        self._c_rejects = self.metrics.counter(
            "coalesce_admission_rejects", "client PROPOSE rows dropped "
            "at ingress under overload (exec-backlog / burn-rate "
            "gate) — clients retry with the same cmd_id")
        self._h_batch = self.metrics.histogram(
            "coalesce_batch_rows", "client rows coalesced per blocking "
            "drain", bounds=COALESCE_ROW_BUCKETS)
        self.metrics.fn_gauge("coalesce_pending_rows",
                              lambda: self._pending_rows)

    @staticmethod
    def _client_rows(item) -> int:
        """Row count when the item is a client PROPOSE frame, else 0."""
        src_kind, _conn, kind, rows = item
        if (src_kind == _FROM_CLIENT and kind == MsgKind.PROPOSE
                and rows is not None):
            return len(rows)
        return 0

    # -- producer side (transport reader threads, control threads) --

    def put(self, item, block: bool = True,
            timeout: float | None = None) -> None:
        n = self._client_rows(item)
        with self._cv:
            if (n > 0 and self._admit_gate is not None
                    and self._pending_rows + n > self.max_rows
                    and self._admit_gate()):
                self._c_rejects.inc(n)
                self._items.append((_CONTROL, item[1], "bounce",
                                    item[3]["cmd_id"].copy()))
                self._cv.notify()
                return
            self._items.append(item)
            self._pending_rows += n
            if self._waiting:
                self._c_wakeups.inc()
            self._cv.notify()

    # -- consumer side (the protocol thread only) --

    def get(self, block: bool = True, timeout: float | None = None):
        with self._cv:
            if not self._items:
                if not block:
                    raise queue.Empty
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                self._waiting += 1
                try:
                    while not self._items:
                        left = (None if deadline is None
                                else deadline - time.monotonic())
                        if left is not None and left <= 0:
                            raise queue.Empty
                        self._cv.wait(left)
                finally:
                    self._waiting -= 1
            # batch formation: linger for more client rows, bounded by
            # max_wait_us (deadline hit) or max_rows (early dispatch)
            if self.max_wait_us > 0 and 0 < self._pending_rows < self.max_rows:
                t_end = time.monotonic() + self.max_wait_us / 1e6
                while 0 < self._pending_rows < self.max_rows:
                    left = t_end - time.monotonic()
                    if left <= 0:
                        self._c_deadline_hits.inc()
                        break
                    self._cv.wait(left)
            self.last_occupancy = self._pending_rows
            if self._pending_rows > 0:
                self._h_batch.observe(self._pending_rows)
            return self._pop_locked()

    def get_nowait(self):
        with self._cv:
            if not self._items:
                raise queue.Empty
            return self._pop_locked()

    def _pop_locked(self):
        item = self._items.pop(0)
        self._pending_rows -= self._client_rows(item)
        return item

    def empty(self) -> bool:
        with self._cv:
            return not self._items

    def qsize(self) -> int:
        with self._cv:
            return len(self._items)


class ColumnBuffer:
    """Grows rows of MsgBatch columns; drained once per protocol tick."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.cols = {c: np.zeros(capacity, np.int32) for c in COLS}
        self.fill = 0
        self.dropped = 0

    def room(self) -> int:
        return self.capacity - self.fill

    def append(self, n: int, **cols) -> None:
        """Append n rows; unspecified columns stay zero. Overflow rows
        are dropped (legal: Paxos tolerates loss; peers retry)."""
        n_take = min(n, self.room())
        self.dropped += n - n_take
        if n_take <= 0:
            return
        sl = slice(self.fill, self.fill + n_take)
        for name, v in cols.items():
            a = np.asarray(v)
            self.cols[name][sl] = a[:n_take] if a.ndim else a
        self.fill += n_take

    def drain(self) -> tuple[dict, int]:
        """Return (columns, n_rows) and reset. Columns are the full
        capacity-size arrays (zero-padded past n_rows) so the device
        sees a fixed shape."""
        out, n = self.cols, self.fill
        self.cols = {c: np.zeros(self.capacity, np.int32) for c in COLS}
        self.fill = 0
        return out, n


def skip_rows_that_fit(buf: ColumnBuffer, rows: np.ndarray,
                       stride: int) -> int:
    """How many leading rows of a SKIP frame can join this inbox.

    The Mencius step merges one step's SKIP rows per owner into one
    range (min start, max end; models/mencius.py step 4). Two ranges of
    one owner with a slot it proposed into between them would merge
    into a range that no-ops that slot's accepted command. So a row
    joins only while each owner's rows in the inbox cover one run of
    its slots (every ``stride``-th slot); the rest wait for a later
    step."""
    n = buf.fill
    c = buf.cols
    sk = c["kind"][:n] == int(MsgKind.SKIP)
    span: dict[int, tuple[int, int]] = {}
    for q in np.unique(c["src"][:n][sk]).tolist():
        m = sk & (c["src"][:n] == q)
        span[q] = (int(c["last_committed"][:n][m].min()),
                   int(c["inst"][:n][m].max()))
    for j in range(len(rows)):
        q = int(rows["leader_id"][j])
        s, e = int(rows["start_inst"][j]), int(rows["end_inst"][j])
        if q in span:
            lo, hi = span[q]
            if s > hi + stride or e < lo - stride:
                return j
            s, e = min(s, lo), max(e, hi)
        span[q] = (s, e)
    return len(rows)


def frame_to_rows(buf: ColumnBuffer, kind: MsgKind, rows: np.ndarray,
                  conn_id: int) -> None:
    """Append one decoded frame's rows into the inbox column buffer.

    ``conn_id``: for client frames, the server-assigned connection id
    (becomes client_id); for peer frames, unused (frames carry ids).
    """
    n = len(rows)
    if n == 0:
        return
    k = int(kind)
    if kind == MsgKind.PROPOSE:
        k_hi, k_lo = split_i64(rows["key"])
        v_hi, v_lo = split_i64(rows["val"])
        buf.append(n, kind=k, src=-1, op=rows["op"].astype(np.int32),
                   key_hi=k_hi, key_lo=k_lo, val_hi=v_hi, val_lo=v_lo,
                   cmd_id=rows["cmd_id"], client_id=conn_id)
    elif kind in (MsgKind.ACCEPT, MsgKind.COMMIT):
        k_hi, k_lo = split_i64(rows["key"])
        v_hi, v_lo = split_i64(rows["val"])
        buf.append(n, kind=k, src=rows["leader_id"].astype(np.int32),
                   ballot=rows["ballot"], inst=rows["inst"],
                   last_committed=rows["last_committed"],
                   op=rows["op"].astype(np.int32),
                   key_hi=k_hi, key_lo=k_lo, val_hi=v_hi, val_lo=v_lo,
                   cmd_id=rows["cmd_id"], client_id=rows["client_id"])
    elif kind == MsgKind.ACCEPT_REPLY:
        # (inst, count) runs pass straight through: the kernel consumes
        # ranges natively (count rides the cmd_id column; vote coverage
        # via difference array + prefix sum in step 6 / mencius step 5).
        # The old per-slot re-expansion would undo the compression and
        # re-inflate the inbox by the ack factor.
        buf.append(n, kind=k, src=rows["id"].astype(np.int32),
                   ballot=rows["ballot"], inst=rows["inst"],
                   last_committed=rows["last_committed"],
                   op=rows["ok"].astype(np.int32),
                   cmd_id=np.maximum(rows["count"], 1).astype(np.int32))
    elif kind == MsgKind.PREPARE:
        buf.append(n, kind=k, src=rows["leader_id"].astype(np.int32),
                   ballot=rows["ballot"],
                   last_committed=rows["last_committed"])
    elif kind == MsgKind.PREPARE_INST:
        buf.append(n, kind=k, src=rows["leader_id"].astype(np.int32),
                   ballot=rows["ballot"], inst=rows["inst"])
    elif kind == MsgKind.PREPARE_REPLY:
        buf.append(n, kind=k, src=rows["id"].astype(np.int32),
                   ballot=rows["ballot"], inst=rows["crt_instance"],
                   last_committed=rows["last_committed"],
                   op=rows["ok"].astype(np.int32))
    elif kind == MsgKind.PREPARE_INST_REPLY:
        # device convention (models/minpaxos.py step 1b/1c): row ballot
        # = the slot's accepted vballot; last_committed = the prepare
        # ballot this reply answers (context tag)
        k_hi, k_lo = split_i64(rows["key"])
        v_hi, v_lo = split_i64(rows["val"])
        buf.append(n, kind=k, src=rows["id"].astype(np.int32),
                   ballot=rows["vballot"], inst=rows["inst"],
                   last_committed=rows["ballot"],
                   op=rows["op"].astype(np.int32),
                   key_hi=k_hi, key_lo=k_lo, val_hi=v_hi, val_lo=v_lo,
                   cmd_id=rows["cmd_id"], client_id=rows["client_id"])
    elif kind == MsgKind.COMMIT_SHORT:
        # frontier broadcast: inst carries committed_upto (count==0)
        buf.append(n, kind=k, src=rows["leader_id"].astype(np.int32),
                   ballot=rows["ballot"], last_committed=rows["inst"])
    elif kind == MsgKind.SKIP:
        # Mencius cede range (menciusproto.go:7-11); device convention
        # (models/mencius.py step 3): inst = cede end, last_committed =
        # cede start
        buf.append(n, kind=k, src=rows["leader_id"].astype(np.int32),
                   inst=rows["end_inst"],
                   last_committed=rows["start_inst"])
    # READ / BEACON / TRACE_CTX / handshake kinds are handled on the
    # host path (transport/replica), never as device rows — a
    # TRACE_CTX frame reaching here (tracing toggled off mid-stream)
    # is deliberately a no-op, not an error.


def rows_to_frames(cols: dict, mask: np.ndarray) -> list[tuple[MsgKind, np.ndarray]]:
    """Convert masked outbox rows (one destination's worth) into wire
    frames, one frame per message kind present."""
    out: list[tuple[MsgKind, np.ndarray]] = []
    kinds = cols["kind"][mask]
    if len(kinds) == 0:
        return out
    sub = {c: cols[c][mask] for c in COLS}
    for k in np.unique(kinds):
        m = kinds == k
        kind = MsgKind(int(k))
        if kind in (MsgKind.ACCEPT, MsgKind.COMMIT):
            frame = make_batch(
                kind, leader_id=sub["src"][m], inst=sub["inst"][m],
                ballot=sub["ballot"][m],
                op=sub["op"][m], key=join_i64(sub["key_hi"][m], sub["key_lo"][m]),
                val=join_i64(sub["val_hi"][m], sub["val_lo"][m]),
                cmd_id=sub["cmd_id"][m], client_id=sub["client_id"][m],
                last_committed=sub["last_committed"][m])
        elif kind == MsgKind.ACCEPT_REPLY:
            # rows arrive pre-compressed from the kernel (cmd_id = run
            # length); map them 1:1 onto wire rows
            frame = make_batch(
                kind, id=sub["src"][m], ok=sub["op"][m],
                inst=sub["inst"][m],
                count=np.maximum(sub["cmd_id"][m], 1).astype(np.int32),
                ballot=sub["ballot"][m],
                last_committed=sub["last_committed"][m])
        elif kind == MsgKind.PREPARE:
            frame = make_batch(kind, leader_id=sub["src"][m],
                               ballot=sub["ballot"][m],
                               last_committed=sub["last_committed"][m])
        elif kind == MsgKind.PREPARE_INST:
            frame = make_batch(kind, leader_id=sub["src"][m],
                               inst=sub["inst"][m], ballot=sub["ballot"][m])
        elif kind == MsgKind.PREPARE_REPLY:
            frame = make_batch(kind, id=sub["src"][m], ok=sub["op"][m],
                               ballot=sub["ballot"][m],
                               last_committed=sub["last_committed"][m],
                               crt_instance=sub["inst"][m])
        elif kind == MsgKind.PREPARE_INST_REPLY:
            frame = make_batch(
                kind, id=sub["src"][m], ok=1, inst=sub["inst"][m],
                ballot=sub["last_committed"][m], vballot=sub["ballot"][m],
                op=sub["op"][m],
                key=join_i64(sub["key_hi"][m], sub["key_lo"][m]),
                val=join_i64(sub["val_hi"][m], sub["val_lo"][m]),
                cmd_id=sub["cmd_id"][m], client_id=sub["client_id"][m])
        elif kind == MsgKind.COMMIT_SHORT:
            frame = make_batch(kind, leader_id=sub["src"][m],
                               inst=sub["last_committed"][m], count=0,
                               ballot=sub["ballot"][m])
        elif kind == MsgKind.SKIP:
            frame = make_batch(kind, leader_id=sub["src"][m],
                               start_inst=sub["last_committed"][m],
                               end_inst=sub["inst"][m])
        else:
            continue  # PROPOSE_REPLY etc. are built by the reply path
        out.append((kind, frame))
    return out
