"""Overhead guards of the flight recorder and paxtrace on the host.

The JAX package's ``tools/obs_smoke.py`` ``overhead_guard`` and
``trace_overhead_guard``, over the port's ``FlightRecorder``,
``MetricsRegistry`` and ``TraceSink``: the same loops, the same bound.
Each measures a loop with the instrumentation against the same loop
without it and returns the difference per tick (or per command) in
microseconds beside ``OVERHEAD_BOUND_S``. ``chip_smoke.py`` runs both
on the card machine's host and gates them. numpy and the standard
library only.
"""

from __future__ import annotations

import time

import numpy as np

from minpaxos_tpu_torch.obs.metrics import MetricsRegistry
from minpaxos_tpu_torch.obs.recorder import FlightRecorder
from minpaxos_tpu_torch.obs.trace import ST_DRAIN, TraceSink

#: the reference's bound (seconds per tick, and per command)
OVERHEAD_BOUND_S = 30e-6
N_ITERS = 20000


def _tick_body(x: float) -> float:
    """Stand-in per-tick host work, identical in both loops."""
    return x * 1.0000001 + 0.25


def overhead_guard(n_iters: int = N_ITERS) -> dict:
    """The recorder's and registry's cost per tick: two counters, two
    histogram observations and one 15-field recorder row (the
    pipelined runtime's write), against the bare loop."""
    reg = MetricsRegistry("guard")
    c_ticks = reg.counter("ticks")
    c_disp = reg.counter("dispatches")
    h_tick = reg.histogram("tick_wall_ms")
    h_step = reg.histogram("device_step_ms")
    rec = FlightRecorder(4096)
    for instrumented in (False, True):  # warm both paths
        x = 1.0
        for i in range(2000):
            x = _tick_body(x)
            if instrumented:
                c_ticks.inc(1)
                rec.record(i, i % 4, 1, 8, 8, i, 0, 5, 30, 270, 60, 20, 30, 10, i)
    x = 1.0
    t0 = time.perf_counter()
    for _ in range(n_iters):
        x = _tick_body(x)
    base_s = time.perf_counter() - t0
    x = 1.0
    t0 = time.perf_counter()
    for i in range(n_iters):
        x = _tick_body(x)
        c_ticks.inc(1)
        c_disp.inc()
        h_tick.observe(0.7)
        h_step.observe(0.4)
        rec.record(i, i % 4, 1, 8, 8, i, 0, 5, 30, 270, 60, 20, 30, 10, i)
    inst_s = time.perf_counter() - t0
    if c_ticks.value != n_iters + 2000 or rec.total != n_iters + 2000:
        raise AssertionError("the guard's loops did not run instrumented")
    per = (inst_s - base_s) / n_iters
    return {"us_per_tick": per * 1e6, "ticks": n_iters,
            "bound_us": OVERHEAD_BOUND_S * 1e6, "ok": per < OVERHEAD_BOUND_S}


def trace_overhead_guard(reps: int = 40) -> dict:
    """paxtrace's cost per command as the drain pays it: one vectorized
    sampling hash per 512-command batch plus span stamps for the
    sampled commands (1 in 16 at the default exponent), against the
    same loop with tracing off."""
    sink_on = TraceSink(enabled=True, sample_pow2=4, ring_capacity=8192)
    sink_off = TraceSink(enabled=False, sample_pow2=4)
    batches = [np.arange(i * 512, (i + 1) * 512, dtype=np.int64) for i in range(8)]
    n_cmds = 512 * len(batches)

    def run(sink) -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            for ids in batches:
                if sink.enabled:
                    sink.stamp_batch(ST_DRAIN, ids, 1, 2, aux=0)
        return time.perf_counter() - t0

    run(sink_on), run(sink_off)  # warm
    off_s = run(sink_off)
    on_s = run(sink_on)
    stamped = sink_on.spans_total()
    if not stamped:
        raise AssertionError("the guard's loop never stamped a span")
    per = (on_s - off_s) / (n_cmds * reps)
    return {"us_per_command": per * 1e6, "commands": n_cmds * reps,
            "spans_stamped": stamped, "bound_us": OVERHEAD_BOUND_S * 1e6,
            "ok": per < OVERHEAD_BOUND_S}
