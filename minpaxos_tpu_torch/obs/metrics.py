"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of the JAX package's ``obs/metrics.py``.

Replaces the bare ``stats`` dict the replica runtime used to hand out
over the control socket (a live dict the tick thread mutated while the
control thread serialized it — the snapshot-vs-live fix this registry
exists for).

Concurrency contract — tuned for the runtime's single-owner design
(transport.py docstring):

* **Advances are single-writer.** ``Counter.inc`` / ``Gauge.set`` /
  ``Histogram.observe`` are plain attribute updates with no lock and
  no allocation: the protocol thread is the only writer of a replica's
  metrics (transport's per-connection tallies are each owned by that
  connection's reader thread and aggregated through fn-gauges at
  snapshot time, so they are single-writer too).
* **Snapshots are taken under the registry lock** and return fresh
  plain-Python containers, never live objects. Readers (control
  threads, tests, paxtop) can hold and mutate a snapshot freely.

Wall honesty: counters whose name says they count *ticks* advance by
the wall tick increment (one per protocol-thread wakeup), never by
the fused substeps a dispatch ran.
"""

from __future__ import annotations

import threading
from bisect import bisect_right

#: default latency buckets (milliseconds) for per-tick wall histograms:
#: log-spaced from well under the dispatch floor (~0.3 ms) to the
#: multi-second first-compile stalls the runtime must make visible
TICK_MS_BUCKETS: tuple[float, ...] = (
    0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 250.0, 1000.0, 5000.0)


class Counter:
    """Monotonically increasing count. Single-writer; ``inc`` is one
    attribute add — no lock, no allocation."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (set or moved either way)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``observe`` is a bisect into
    preallocated integer buckets (no per-observation allocation).

    ``bounds`` are upper bucket edges; an implicit overflow bucket
    catches everything above the last edge. Percentiles are estimated
    by linear interpolation inside the winning bucket — exact enough
    for p50/p99 dashboards, and the raw ``counts``/``bounds`` ride
    every snapshot for consumers that want their own math.
    """

    __slots__ = ("name", "help", "bounds", "counts", "total", "sum")

    def __init__(self, name: str, help: str = "",
                 bounds: tuple[float, ...] = TICK_MS_BUCKETS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name}: bounds must be sorted "
                             f"and non-empty, got {bounds!r}")
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, x: float) -> None:
        self.counts[bisect_right(self.bounds, x)] += 1
        self.total += 1
        self.sum += x

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile, q in [0, 1]."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        acc = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = (self.bounds[i] if i < len(self.bounds)
                  else self.bounds[-1])  # overflow: clamp to last edge
            if c and acc + c >= target:
                return lo + (target - acc) / c * (hi - lo)
            acc += c
            lo = hi
        return self.bounds[-1]

    def as_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.total, "sum": self.sum,
                "p50": self.percentile(0.50), "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Named metrics for one replica/process.

    ``counter``/``gauge``/``histogram`` get-or-create (idempotent by
    name, so call sites can re-derive handles); ``fn_gauge`` registers
    a zero-arg callable evaluated at snapshot time — how the transport
    surfaces per-connection tallies without hot-path locking.
    """

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._fn_gauges: dict[str, object] = {}  # name -> callable

    # -- registration (get-or-create) --

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, help)
            return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, help)
            return g

    def histogram(self, name: str, help: str = "",
                  bounds: tuple[float, ...] = TICK_MS_BUCKETS) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, help, bounds)
            return h

    def fn_gauge(self, name: str, fn) -> None:
        with self._lock:
            self._fn_gauges[name] = fn

    # -- snapshots (fresh containers, never live objects) --

    def counters(self) -> dict:
        """Flat {name: value} over counters + gauges + fn-gauges — the
        control plane's ``stats`` shape. A FRESH dict per call: callers
        may mutate or serialize it while the owner keeps ticking."""
        with self._lock:
            out = {n: c.value for n, c in self._counters.items()}
            out.update({n: g.value for n, g in self._gauges.items()})
            fns = list(self._fn_gauges.items())
        for n, fn in fns:  # outside the lock: fn may take its own lock
            out[n] = fn()
        return out

    def snapshot(self) -> dict:
        """Full typed snapshot (JSON-serializable)."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = {n: h.as_dict() for n, h in self._hists.items()}
            fns = list(self._fn_gauges.items())
        for n, fn in fns:
            gauges[n] = fn()
        return {"namespace": self.namespace, "counters": counters,
                "gauges": gauges, "histograms": hists}
