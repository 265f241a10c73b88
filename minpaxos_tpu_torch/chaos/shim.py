"""The chaos shim: where a FaultPlan touches real frames.

The port's copy of the JAX package's ``chaos/shim.py``: the same plan
and seed make the same decision for every frame of a link.

One shim serves one replica's :class:`~minpaxos_tpu_torch.runtime.transport.
Transport`. The transport consults it at exactly two points:

* ``send_peer`` calls :meth:`allow_send`: a link the plan blocks
  outbound is a silent blackhole — the sender sees success (TCP under
  an asymmetric partition gives no error either), so no redial storm
  is triggered and ``peer_alive`` stays honest about the socket.
* ``_read_loop`` calls :meth:`ingest` for decoded peer frames instead
  of enqueuing them: the frame is dropped, delayed, duplicated,
  reordered or delivered per the link's policy. Delivery is a
  ``queue.Queue.put`` — thread-safe by construction, so the pump
  thread that releases delayed frames needs no access to any
  transport internals.

Threading: each inbound link's decision state is owned by that
connection's reader thread (the transport runs one reader per peer),
so the RNG draws and fault tallies are single-writer without locks —
the same discipline as the transport's per-connection counters — with
ONE exception: the ``delayed`` tally, which the pump thread's stale-
reorder flush can also advance, is serialized by the condition
variable its heap push needs anyway. The shared delay heap and
reorder buffers are guarded by that same condition variable; nothing
blocking ever runs under it, and ``stop`` flips the stopped flag
under it too, so a frame can never be parked in a drained shim.

Client connections and the control plane are never shimmed (see the
package docstring for the fault-model scope).
"""

from __future__ import annotations

import heapq
import threading
import time

import numpy as np

from minpaxos_tpu_torch.chaos.plan import FaultPlan, LinkPolicy

#: transport queue source tag for peer frames (mirrors
#: runtime/transport.py FROM_PEER; kept literal so chaos never imports
#: the runtime: the transport asserts agreement at install time)
FROM_PEER = 0

#: reorder buffers older than this are released in arrival order even
#: if the window never filled — a fault must delay traffic, not park
#: the tail of a burst forever
REORDER_HOLD_S = 0.05

TALLY_KEYS = ("blocked_in", "dropped", "delayed", "duplicated",
              "reordered")


class _LinkState:
    """Per-inbound-link decision stream + fault tallies.

    ``decide`` consumes exactly one ``random(3)`` draw per frame, so
    the decision sequence for frame i on this link is a pure function
    of (plan seed, src, dst, i) — timing, other links, and the reorder
    flush cadence cannot perturb it. Reorder permutations come from a
    separate stream for the same reason.
    """

    __slots__ = ("pol", "rng", "reorder_rng", "buf", "buf_t", "tally")

    def __init__(self, pol: LinkPolicy, seed: int, src: int, dst: int):
        self.pol = pol
        self.rng = np.random.default_rng([seed, src, dst])
        self.reorder_rng = np.random.default_rng([seed, src, dst, 1])
        self.buf: list[tuple] = []  # (kind, rows, delay_s) awaiting flush
        self.buf_t = 0.0            # monotonic time of oldest buffered
        self.tally = dict.fromkeys(TALLY_KEYS, 0)

    def decide(self) -> tuple[bool, bool, float]:
        """(drop, duplicate, delay_s) for the next frame."""
        u = self.rng.random(3)
        return (bool(u[0] < self.pol.drop), bool(u[1] < self.pol.dup),
                float(self.pol.delay_s + u[2] * self.pol.jitter_s))


class ChaosShim:
    """Enforces one replica's slice of a cluster FaultPlan."""

    def __init__(self, me: int, plan: FaultPlan, queue):
        self.me = me
        self.plan = plan
        self.queue = queue
        # inbound links with a real policy; everything else bypasses
        self._in: dict[int, _LinkState] = {}
        for src in range(plan.n):
            pol = plan.link(src, me)
            if src != me and pol is not None and not pol.is_noop():
                self._in[src] = _LinkState(pol, plan.seed, src, me)
        self._blocked_out = frozenset(
            dst for (s, dst), p in plan.links.items()
            if s == me and p.block)
        self._blocked_out_n = 0  # protocol thread is the only writer
        # delay heap: (due_monotonic, seq, src, kind, rows); seq breaks
        # ties so heapq never compares ndarrays
        self._pending: list[tuple] = []
        self._seq = 0
        self._cv = threading.Condition()
        self._stopped = threading.Event()
        self._pump: threading.Thread | None = None
        if any(s.pol.delay_s or s.pol.jitter_s or s.pol.reorder >= 2
               for s in self._in.values()):
            self._pump = threading.Thread(target=self._pump_loop,
                                          daemon=True)
            self._pump.start()

    # -- transport hooks --

    def allow_send(self, dst: int) -> bool:
        """Outbound gate (protocol thread): False = blackhole the
        frame silently. Only ``block`` is enforced here; probabilistic
        policies run once, at the receiver."""
        if dst in self._blocked_out:
            self._blocked_out_n += 1
            return False
        return True

    def ingest(self, src: int, kind, rows) -> None:
        """Inbound gate (the src connection's reader thread): apply the
        link policy and deliver surviving frames to the owner queue."""
        st = self._in.get(src)
        if st is None or self._stopped.is_set():
            # no policy — or a reader that loaded this shim's reference
            # just before a heal swapped it out: the healed network
            # delivers plainly (a late frame must not be parked in a
            # stopped shim's heap, where no pump would ever release it)
            self.queue.put((FROM_PEER, src, kind, rows))
            return
        if st.pol.block:
            st.tally["blocked_in"] += 1
            return
        drop, dup, delay = st.decide()
        if drop:
            st.tally["dropped"] += 1
            return
        copies = 2 if dup else 1
        if dup:
            st.tally["duplicated"] += 1
        if st.pol.reorder >= 2:
            self._buffer_reordered(st, src, kind, rows, delay, copies)
            return
        for _ in range(copies):
            self._deliver(st, src, kind, rows, delay)

    # -- internals --

    def _deliver(self, st: _LinkState, src: int, kind, rows,
                 delay_s: float) -> None:
        if delay_s <= 0.0:
            self.queue.put((FROM_PEER, src, kind, rows))
            return
        due = time.monotonic() + delay_s
        with self._cv:
            # the delayed tally is the one tally BOTH the reader and
            # the pump (stale-reorder flush) can advance — serialized
            # here by the cv the push needs anyway. stop() sets
            # _stopped under this cv before draining, so checking it
            # here makes push-after-drain impossible.
            if not self._stopped.is_set():
                st.tally["delayed"] += 1
                self._seq += 1
                heapq.heappush(self._pending,
                               (due, self._seq, src, kind, rows))
                self._cv.notify()
                return
        self.queue.put((FROM_PEER, src, kind, rows))  # healed: plain

    def _buffer_reordered(self, st: _LinkState, src: int, kind, rows,
                          delay_s: float, copies: int) -> None:
        """Hold frames until the window fills, then release them in a
        seeded permutation; the pump's time-flush releases a stale
        partial buffer in arrival order (no permutation draw, so the
        drop/dup/delay streams stay aligned with frame index)."""
        flushed: list[tuple] | None = None
        with self._cv:
            if self._stopped.is_set():  # healed mid-ingest: see ingest
                flushed = [(kind, rows, 0.0)] * copies
            else:
                if not st.buf:
                    st.buf_t = time.monotonic()
                for _ in range(copies):
                    st.buf.append((kind, rows, delay_s))
                if len(st.buf) >= st.pol.reorder:
                    order = st.reorder_rng.permutation(len(st.buf))
                    flushed = [st.buf[i] for i in order]
                    st.tally["reordered"] += len(flushed)
                    st.buf = []
                self._cv.notify()
        if flushed is not None:
            for k, r, d in flushed:
                self._deliver(st, src, k, r, d)

    def _pump_loop(self) -> None:
        """Release due delayed frames and stale reorder buffers. All
        queue puts happen outside the condition lock."""
        while not self._stopped.is_set():
            now = time.monotonic()
            due_items: list[tuple] = []
            stale: list[tuple] = []  # (_LinkState, src, buffered frames)
            with self._cv:
                while self._pending and self._pending[0][0] <= now:
                    due_items.append(heapq.heappop(self._pending))
                timeout = REORDER_HOLD_S
                if self._pending:
                    timeout = min(timeout, self._pending[0][0] - now)
                for src, st in self._in.items():
                    if st.buf and now - st.buf_t > REORDER_HOLD_S:
                        stale.append((st, src, st.buf))
                        st.buf = []
                if not due_items and not stale:
                    self._cv.wait(timeout=max(timeout, 0.005))
            for _, _, src, kind, rows in due_items:
                self.queue.put((FROM_PEER, src, kind, rows))
            for st, src, buf in stale:
                for k, r, d in buf:  # arrival order; delay already decided
                    self._deliver(st, src, k, r, d)

    def stop(self, flush: bool = True) -> None:
        """Tear down (heal): optionally deliver everything still held —
        healing a link must not lose the frames it was delaying."""
        with self._cv:
            self._stopped.set()  # under the cv: see _deliver's check
            self._cv.notify_all()
            pending, self._pending = self._pending, []
            held = [(src, st.buf) for src, st in self._in.items() if st.buf]
            for st in self._in.values():
                st.buf = []
        if self._pump is not None:
            self._pump.join(timeout=2.0)
        if flush:
            for _, _, src, kind, rows in sorted(pending):
                self.queue.put((FROM_PEER, src, kind, rows))
            for src, buf in held:
                for kind, rows, _ in buf:
                    self.queue.put((FROM_PEER, src, kind, rows))

    # -- observability --

    def counts(self) -> dict:
        """Per-kind fault tallies (lock-free reads of single-writer
        ints: totals are monotonic, a torn read is at worst stale)."""
        out = dict.fromkeys(TALLY_KEYS, 0)
        for st in self._in.values():
            for key, v in st.tally.items():
                out[key] += v
        out["blocked_out"] = self._blocked_out_n
        return out

    def faults_total(self) -> int:
        return sum(self.counts().values())
