"""paxtrace, the flight recorder and the merged Perfetto trace on the
port, held against the JAX package on the CPU.

The same seeded numpy inputs go through the port's ``obs/trace.py``,
``obs/recorder.py`` and ``obs/watch.py event_chrome_events`` and the
JAX package's: integers exactly, float stage sums to 1e-9. The cases
mirror the JAX package's ``tests/test_paxtrace.py`` (wire context,
sampling, span rings, anchors, the stage math, the reserved pids),
``tests/test_paxray.py`` (device rounds merged with host rows) and
``tests/test_obs.py`` (recorder rings, the four regimes, the
validator), plus the TRACE_CTX frame across both codecs and the port's
own resident telemetry rendered through both packages.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from minpaxos_tpu.obs import recorder as jrec
from minpaxos_tpu.obs import trace as jtr
from minpaxos_tpu.obs import watch as jwatch
from minpaxos_tpu.wire import codec as jcodec
from minpaxos_tpu.wire.messages import MsgKind as JKind
from minpaxos_tpu_torch.obs import recorder as rec
from minpaxos_tpu_torch.obs import trace as T
from minpaxos_tpu_torch.obs import watch as W
from minpaxos_tpu_torch.wire import codec
from minpaxos_tpu_torch.wire.messages import MsgKind, make_batch

torch.set_num_threads(1)

NS = 1_000_000  # ns per ms


def _ns(ms: float) -> int:
    return int(ms * NS)


# ------------------------------------------------------- constants


def test_names_and_layouts_equal_the_jax_modules():
    for name in ("ST_SEND", "ST_ORIGIN", "ST_DECODE", "ST_DRAIN", "ST_COMMIT",
                 "ST_EXEC", "ST_REPLY_SER", "ST_REPLY_RECV", "N_STAGES",
                 "STAGE_NAMES", "SP_TRACE", "SP_STAGE", "SP_T0", "SP_T1", "SP_AUX",
                 "N_SPAN_FIELDS", "DECOMP_STAGES", "DEFAULT_SAMPLE_POW2",
                 "_SELECT_ORDER", "_STALE_CHAIN_NS"):
        assert getattr(T, name) == getattr(jtr, name), name
    for name in ("SCHEMA_VERSION", "KIND_FULL", "KIND_FUSED", "KIND_NARROW",
                 "KIND_IDLE_SKIP", "KIND_NAMES", "N_FIELDS", "FIELD_NAMES",
                 "DEVICE_PID", "TRACE_PID", "WATCH_PID", "N_TEL_FIELDS",
                 "TEL_FIELD_NAMES", "_DISPATCH_PHASES", "_HOST_PHASES",
                 "_EVENT_PHASES"):
        assert getattr(rec, name) == getattr(jrec, name), name
    assert rec.SCHEMA_VERSION == 7 and rec.N_FIELDS == 18
    fields = [n for n in dir(jrec) if n.startswith("F_")]
    assert len(fields) == 18
    for name in fields:
        assert getattr(rec, name) == getattr(jrec, name), name
    assert T.TRACE_PID == rec.TRACE_PID  # the trace module's import


# ---------------------------------------------------------- sampling


@pytest.mark.parametrize("pow2", [0, 1, 4, 8])
def test_sampling_and_trace_ids_equal_jax(pow2):
    rng = np.random.default_rng(100 + pow2)
    ids = np.concatenate([np.arange(-512, 4096), rng.integers(-2**40, 2**40, 2000),
                          [0, -1, 2**31 - 1, -2**31, 2**62]]).astype(np.int64)
    np.testing.assert_array_equal(T.mix64(ids), jtr.mix64(ids))
    np.testing.assert_array_equal(T.sampled_mask(ids, pow2), jtr.sampled_mask(ids, pow2))
    np.testing.assert_array_equal(T.trace_id_for(ids), jtr.trace_id_for(ids))
    for i in ids[::97].tolist():
        assert T.mix64_scalar(i) == jtr.mix64_scalar(i) == int(T.mix64(i))
        assert T.is_sampled(i, pow2) == jtr.is_sampled(i, pow2)
        assert T.trace_id_for(i) == jtr.trace_id_for(i) != 0
    m = T.sampled_mask(ids, pow2)
    if pow2:
        assert 0.3 / 2 ** pow2 < m.mean() < 3.0 / 2 ** pow2
    else:
        assert m.all()


# ------------------------------------------------------- wire context


def test_trace_ctx_frame_crosses_both_codecs():
    """The port's TRACE_CTX frame decodes with the JAX codec and back,
    byte for byte; a stream with no ctx frame (a v1 client, or tracing
    off) decodes as before, and a ctx frame ahead of a PROPOSE decodes
    both kinds in order in either package."""
    ids = (np.arange(7, dtype=np.int32) * 13 - 20)
    frame = make_batch(MsgKind.TRACE_CTX, cmd_id=ids,
                       trace_id=T.trace_id_for(ids.astype(np.int64)),
                       origin_wall_ns=987_654_321_000)
    buf = codec.encode_frame(MsgKind.TRACE_CTX, frame)
    kind, rows, end = jcodec.decode_frame(buf)
    assert kind == JKind.TRACE_CTX and end == len(buf) and rows.dtype.itemsize == 20
    np.testing.assert_array_equal(rows["cmd_id"], ids)
    np.testing.assert_array_equal(rows["trace_id"], jtr.trace_id_for(ids.astype(np.int64)))
    assert (rows["origin_wall_ns"] == 987_654_321_000).all()
    assert jcodec.encode_frame(JKind.TRACE_CTX, rows) == buf
    kind2, rows2, _ = codec.decode_frame(jcodec.encode_frame(JKind.TRACE_CTX, rows))
    assert kind2 == MsgKind.TRACE_CTX and rows2.tobytes() == frame.tobytes()

    prop = make_batch(MsgKind.PROPOSE, cmd_id=np.arange(3, dtype=np.int32),
                      op=1, key=np.arange(3), val=7, timestamp=9)
    v1 = codec.encode_frame(MsgKind.PROPOSE, prop)
    for dec in (codec.StreamDecoder(), jcodec.StreamDecoder()):
        assert [int(k) for k, _ in dec.feed(v1)] == [int(MsgKind.PROPOSE)]
    for dec in (codec.StreamDecoder(), jcodec.StreamDecoder()):
        got = dec.feed(codec.encode_frame(MsgKind.TRACE_CTX, frame[:1]) + v1)
        assert [int(k) for k, _ in got] == [int(MsgKind.TRACE_CTX), int(MsgKind.PROPOSE)]


class _CapSock:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


def _bare_client(trace_pow2):
    """A port Client with no connection: propose() only."""
    from minpaxos_tpu_torch.obs.metrics import MetricsRegistry
    from minpaxos_tpu_torch.runtime.client import Client

    cli = Client.__new__(Client)
    cli.trace = None if trace_pow2 is None else T.TraceSink(sample_pow2=trace_pow2)
    cli._lock = threading.Lock()
    cli._outstanding = set()
    cli._c_proposed = MetricsRegistry("t").counter("proposed_rows")
    sock = _CapSock()
    cli.writer = codec.FrameWriter(sock)
    return cli, sock


def test_client_propose_is_byte_transparent_without_tracing():
    """Tracing off writes only the PROPOSE frame; ``trace_pow2=0`` writes
    a ctx frame first whose trace ids are the JAX package's, and stamps
    one SEND span per command."""
    cli, sock = _bare_client(None)
    cli.propose([1, 2], [1, 1], [42, 43], [7, 8])
    k0, rows0, end0 = jcodec.decode_frame(sock.data)
    assert int(k0) == int(MsgKind.PROPOSE) and end0 == len(sock.data)
    cli, sock = _bare_client(0)
    cli.propose([1, 2], [1, 1], [42, 43], [7, 8])
    k1, rows1, end = jcodec.decode_frame(sock.data)
    assert int(k1) == int(MsgKind.TRACE_CTX)
    assert rows1["trace_id"].tolist() == [jtr.trace_id_for(1), jtr.trace_id_for(2)]
    k2, rows2, _ = jcodec.decode_frame(sock.data, end)
    assert int(k2) == int(MsgKind.PROPOSE)
    assert rows2["cmd_id"].tolist() == rows0["cmd_id"].tolist() == [1, 2]
    c = cli.trace_collect()
    assert c["total"] == 2 and {r[T.SP_STAGE] for r in c["spans"]} == {T.ST_SEND}


# ---------------------------------------------------------- span rings


@pytest.mark.parametrize("cap,n", [(8, 20), (16, 16), (5, 3)])
def test_span_ring_wraparound_equals_jax(cap, n):
    rng = np.random.default_rng(cap * 31 + n)
    rows = rng.integers(-2**40, 2**40, (n, 5))
    a, b = T.SpanRing(cap), jtr.SpanRing(cap)
    for r in rows.tolist():
        a.record(*r)
        b.record(*r)
    np.testing.assert_array_equal(a.snapshot(), b.snapshot())
    assert (a.total, a.dropped) == (b.total, b.dropped) == (n, max(0, n - cap))
    np.testing.assert_array_equal(a.snapshot()[:, 0], rows[max(0, n - cap):, 0])
    with pytest.raises(ValueError):
        T.SpanRing(0)


def test_sink_per_thread_rings_and_collect():
    sink = T.TraceSink(enabled=True, sample_pow2=0, ring_capacity=16)
    sink.stamp(T.ST_DRAIN, 1, 10, 10)
    t = threading.Thread(target=lambda: sink.stamp(T.ST_EXEC, 1, 20, 20))
    t.start()
    t.join()
    assert len(sink._rings) == 2  # one ring per writer thread
    # a new thread adopts the dead thread's ring instead of leaking one
    t2 = threading.Thread(target=lambda: sink.stamp(T.ST_EXEC, 2, 30, 30))
    t2.start()
    t2.join()
    assert len(sink._rings) == 2
    assert sink.stamp_batch(T.ST_DECODE, np.arange(5), 40, 41) == 5
    c = sink.collect()
    assert c["total"] == 8 and c["dropped"] == 0
    assert sink.spans_total() == 8 and sink.spans_dropped() == 0
    assert {row[T.SP_STAGE] for row in c["spans"]} == {T.ST_DRAIN, T.ST_EXEC, T.ST_DECODE}
    assert c["anchor"]["mono_ns"] > 0 and c["anchor"]["wall_ns"] > 0
    json.dumps(c)
    # the same stamps through the JAX sink give the same rows
    js = jtr.TraceSink(enabled=True, sample_pow2=0, ring_capacity=16)
    js.stamp(T.ST_DRAIN, 1, 10, 10)
    js.stamp(T.ST_EXEC, 1, 20, 20)
    js.stamp(T.ST_EXEC, 2, 30, 30)
    js.stamp_batch(T.ST_DECODE, np.arange(5), 40, 41)
    assert sorted(map(tuple, js.collect()["spans"])) == sorted(map(tuple, c["spans"]))


def test_clock_anchor_and_alignment_equal_jax():
    a1 = T.clock_anchor()
    time.sleep(0.002)
    a2 = T.clock_anchor()
    assert a2["mono_ns"] > a1["mono_ns"] and a2["wall_ns"] >= a1["wall_ns"]
    ref = {"mono_ns": 1_000, "wall_ns": 10_000}
    skew = {"mono_ns": 1_000 - 5_000_000_000, "wall_ns": 10_000}
    spans = [[7, T.ST_DRAIN, 100 - 5_000_000_000, 100 - 5_000_000_000, 0]]
    out = T.align_collections([{"anchor": skew, "spans": spans}], ref_anchor=ref)
    assert out[0][T.SP_T0] == 100
    assert len(T.align_collections([{"anchor": ref, "spans": []}])) == 0
    rng = np.random.default_rng(5)
    colls = [{"anchor": {"mono_ns": int(rng.integers(1, 2**40)),
                         "wall_ns": int(rng.integers(2**50, 2**52))},
              "spans": rng.integers(0, 2**40, (int(rng.integers(0, 9)), 5)).tolist()}
             for _ in range(6)]
    colls.append({"spans": [[1, 2, 3, 4, 5]]})  # no anchor: no shift
    for ref_a in (None, ref):
        np.testing.assert_array_equal(T.align_collections(colls, ref_a),
                                      jtr.align_collections(colls, ref_a))


# ------------------------------------------------- decomposition math


def _chain(cmd, t0, commit_ms=2.0, exec_ms=0.5, out_ms=1.0):
    tid = T.trace_id_for(cmd)
    return [
        (tid, T.ST_SEND, t0, t0 + _ns(0.1), cmd),
        (tid, T.ST_DECODE, t0 + _ns(0.3), t0 + _ns(0.4), cmd),
        (tid, T.ST_DRAIN, t0 + _ns(0.9), t0 + _ns(0.9), 10),
        (tid, T.ST_COMMIT, t0 + _ns(0.9 + commit_ms), t0 + _ns(0.9 + commit_ms), 5),
        (tid, T.ST_EXEC, t0 + _ns(0.9 + commit_ms + exec_ms),
         t0 + _ns(0.9 + commit_ms + exec_ms), 12),
        (tid, T.ST_REPLY_SER, t0 + _ns(0.9 + commit_ms + exec_ms),
         t0 + _ns(1.0 + commit_ms + exec_ms), cmd),
        (tid, T.ST_REPLY_RECV, t0 + _ns(1.0 + commit_ms + exec_ms + out_ms),
         t0 + _ns(1.0 + commit_ms + exec_ms + out_ms), cmd),
    ]


def _random_spans(seed: int) -> np.ndarray:
    """Chains of many commands: complete ones (with and without the
    client's receipt, SEND or only the ORIGIN echo), partial ones,
    duplicated stages from a retry and from a reused cmd_id's newer
    life, backwards chains, spans of trace id 0, shuffled."""
    rng = np.random.default_rng(seed)
    rows = []
    for cmd in range(int(rng.integers(20, 60))):
        t0 = int(rng.integers(10**9, 10**10))
        ch = _chain(cmd, t0, commit_ms=float(rng.uniform(0.1, 80)),
                    exec_ms=float(rng.uniform(0, 5)), out_ms=float(rng.uniform(0, 3)))
        form = int(rng.integers(0, 7))
        if form == 1:
            ch = ch[:-1]  # no client receipt
        elif form == 2:
            tid = ch[0][0]
            ch = [(tid, T.ST_ORIGIN, ch[0][2], ch[0][2], cmd)] + ch[1:]
        elif form == 3:
            ch = ch[:int(rng.integers(1, 5))]  # partial
        elif form == 4:
            tid = ch[0][0]
            ch.append((tid, T.ST_SEND, t0 + _ns(3000), t0 + _ns(3000.1), cmd))
            ch.append((tid, T.ST_DECODE, t0 + _ns(3000.3), t0 + _ns(3000.4), cmd))
        elif form == 5:
            tid = ch[0][0]
            ch.append((tid, T.ST_COMMIT, t0 + _ns(500), t0 + _ns(500), 9))
        elif form == 6:
            tid = ch[0][0]
            ch[3] = (tid, T.ST_COMMIT, t0 - _ns(50), t0 - _ns(50), 5)  # backwards
        rows += ch
    rows.append((0, T.ST_DRAIN, 1, 1, 0))
    arr = np.array(rows, np.int64)
    return arr[rng.permutation(len(arr))]


def _same_decomp(a: list[dict], b: list[dict]) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert {k: v for k, v in x.items() if k != "stages"} == \
            {k: v for k, v in y.items() if k != "stages"}
        assert x["stages"].keys() == y["stages"].keys()
        for k in x["stages"]:
            assert abs(x["stages"][k] - y["stages"][k]) <= 1e-9
        assert abs(sum(x["stages"].values()) - x["total_ms"]) < 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stage_math_equals_jax(seed):
    spans = _random_spans(seed)
    chains = T.span_chains(spans)
    assert chains == jtr.span_chains(spans)
    decomp = T.stage_decomposition(chains)
    assert decomp, "no complete chain in the seeded spans"
    _same_decomp(decomp, jtr.stage_decomposition(chains))
    table = T.stage_table(decomp)
    assert table == jtr.stage_table(decomp)
    assert T.format_stage_table(table) == jtr.format_stage_table(table)
    assert T.span_events(decomp, chains) == jtr.span_events(decomp, chains)
    assert T.stage_table([]) == jtr.stage_table([])
    colls = [{"anchor": {"mono_ns": 10, "wall_ns": 10 + 7 * i},
              "spans": spans[i::3].tolist()} for i in range(3)]
    got, want = T.analyze_collections(colls), jtr.analyze_collections(colls)
    assert got[0] == want[0] and got[2] == want[2]
    _same_decomp(got[1], want[1])


def test_stage_decomposition_sums_to_end_to_end():
    spans = np.array(_chain(1, 10**9) + _chain(2, 2 * 10**9, commit_ms=40.0), np.int64)
    decomp = T.stage_decomposition(T.span_chains(spans))
    assert len(decomp) == 2
    for d in decomp:
        assert abs(sum(d["stages"].values()) - d["total_ms"]) < 1e-9
    tab = T.stage_table(decomp)
    assert tab["n_traced"] == 2 and tab["tail"]["worst_stage"] == "commit"
    assert "commit" in T.format_stage_table(tab)
    assert all(d["commit_dispatches"] == 2 for d in decomp)
    assert T.stage_decomposition(T.span_chains(np.array(_chain(3, 10**9)[:2], np.int64))) == []
    # a commit span from a newer life of a reused cmd_id does not splice
    rows = _chain(4, 10**9)
    rows.append((T.trace_id_for(4), T.ST_COMMIT, 10**9 + _ns(43.0), 10**9 + _ns(43.0), 5))
    mixed = T.stage_decomposition(T.span_chains(np.array(rows, np.int64)))
    assert len(mixed) == 1 and abs(mixed[0]["stages"]["commit"] - 2.0) < 1e-9
    # a deduped retry keeps its first attempt's start
    rows2 = _chain(5, 10**9)
    tid5 = T.trace_id_for(5)
    rows2.append((tid5, T.ST_SEND, 10**9 + _ns(3000.0), 10**9 + _ns(3000.1), 5))
    rows2.append((tid5, T.ST_DECODE, 10**9 + _ns(3000.3), 10**9 + _ns(3000.4), 5))
    retry = T.stage_decomposition(T.span_chains(np.array(rows2, np.int64)))
    assert len(retry) == 1 and abs(retry[0]["total_ms"] - 4.5) < 1e-9


# ---------------------------------------------------------- recorder


def _records(seed: int, n: int) -> list[tuple]:
    """Recorder rows of all four regimes, pipelined and serial, with
    and without chaos faults and coalescer fields."""
    rng = np.random.default_rng(seed)
    out, t = [], 5_000_000_000
    for i in range(n):
        kind = i % 4
        t += int(rng.integers(100_000, 5_000_000))
        out.append((t, kind, 3 if kind == rec.KIND_FUSED else (0 if kind == 3 else 1),
                    int(rng.integers(0, 600)), int(rng.integers(0, 900)), 100 + i,
                    int(rng.integers(0, 40)), int(rng.integers(0, 300)),
                    int(rng.integers(0, 900)), int(rng.integers(0, 9000)),
                    int(rng.integers(0, 500)) if i % 2 else 0,
                    int(rng.integers(0, 800)), int(rng.integers(0, 800)),
                    int(rng.integers(0, 300)),
                    t - int(rng.integers(0, 900_000)) if i % 5 else 0,
                    int(rng.integers(0, 3)) * i, int(rng.integers(0, 40)),
                    int(rng.integers(0, 2)) * i))
    return out


@pytest.mark.parametrize("cap,n,last", [(64, 16, None), (8, 20, None), (8, 20, 3),
                                        (16, 40, 1024)])
def test_flight_recorder_rows_and_events_equal_jax(cap, n, last):
    a, b = rec.FlightRecorder(cap), jrec.FlightRecorder(cap)
    for r in _records(cap + n, n):
        a.record(*r[:14], t_rb_ns=r[14], chaos_faults=r[15], coal_occ=r[16],
                 coal_wake=r[17])
        b.record(*r[:14], t_rb_ns=r[14], chaos_faults=r[15], coal_occ=r[16],
                 coal_wake=r[17])
    np.testing.assert_array_equal(a.snapshot(last), b.snapshot(last))
    assert a.snapshot().shape == (min(cap, n), 18) and a.total == n
    ev = a.to_events(pid=2, last=last)
    assert ev == b.to_events(pid=2, last=last)
    assert rec.validate_chrome_trace(rec.chrome_trace(ev)) == []
    json.dumps(rec.chrome_trace(ev))
    if n >= 16 and last is None:
        assert {e["args"]["kind"] for e in ev if e.get("cat") == "tick"} == set(rec.KIND_NAMES)
    with pytest.raises(ValueError):
        rec.FlightRecorder(0)


def test_recorder_two_tracks_and_counters():
    r = rec.FlightRecorder(64)
    t = 5_000_000_000
    for i, kind in enumerate([rec.KIND_FULL, rec.KIND_FUSED, rec.KIND_NARROW,
                              rec.KIND_IDLE_SKIP] * 4):
        t += 2_000_000
        r.record(t, kind, 3 if kind == rec.KIND_FUSED else 1, 8, 12, 100 + i, 2, 15,
                 30, 700, 250 if i % 2 else 0, 120, 90, 40)
    events = r.to_events(pid=2)
    names = {e["name"] for e in events}
    assert {"enqueue", "readback", "persist", "dispatch", "reply"} <= names
    phase_tid = {e["name"]: e["tid"] for e in events if e.get("cat") == "phase"}
    assert phase_tid["enqueue"] == 0 and phase_tid["persist"] == 1
    ticks = [e for e in events if e.get("cat") == "tick"]
    assert {e["args"]["overlap_us"] for e in ticks} == {0, 250}
    cs = [e for e in events if e["ph"] == "C"]
    assert any(e["name"] == "overlap_us" for e in cs)
    assert all(isinstance(v, int) for e in cs for v in e["args"].values())


# ------------------------------------------------------- validator


def _bad_traces() -> list:
    good = {"name": "tick:full", "cat": "tick", "ph": "X", "ts": 1.0, "dur": 1.0,
            "pid": 0, "tid": 0}
    span = {"name": "cmd:1", "cat": "paxtrace", "ph": "X", "ts": 1.0, "dur": 1.0,
            "pid": rec.TRACE_PID, "tid": 0, "args": {"trace_id": 3}}
    watch = {"name": "election", "cat": "paxwatch", "ph": "i", "ts": 1.0, "s": "g",
             "pid": rec.WATCH_PID, "tid": 0, "args": {"subject": 0}}
    devr = {"name": "round:steady", "cat": "device_round", "ph": "X", "ts": 1.0,
            "dur": 1.0, "pid": rec.DEVICE_PID, "tid": 0}
    stale = rec.chrome_trace([good])
    stale["otherData"]["paxmonSchemaVersion"] = 4
    return [
        rec.chrome_trace([good, span, watch, devr]),  # valid
        {"traceEvents": []},  # no stamp: valid
        [], {}, {"traceEvents": 3}, stale,
        {"traceEvents": [
            {"name": "x", "ph": "X", "ts": 1.0, "pid": 0, "tid": 0},  # no dur
            {"name": "", "ph": "X", "ts": 1.0, "dur": 1, "pid": 0, "tid": 0},
            {"name": "c", "ph": "C", "ts": 1.0, "pid": 0, "tid": 0,
             "args": {"v": "NaN-ish string"}},
            {"name": "y", "ph": "??", "ts": 1.0},
            {"name": "z", "ph": "X", "ts": "1", "dur": -1, "pid": 0.5, "tid": 0},
            7]},
        rec.chrome_trace([dict(good, pid=rec.DEVICE_PID)]),  # host on the device pid
        rec.chrome_trace([dict(devr, pid=3)]),  # device off its pid
        rec.chrome_trace([{"name": "device_frontier", "ph": "C", "ts": 1.0, "pid": 1,
                           "tid": 0, "args": {"device_frontier": 1}}]),
        rec.chrome_trace([dict(span, pid=3)]),  # a span off its pid
        rec.chrome_trace([dict(span, args={})]),  # a span with no trace id
        rec.chrome_trace([dict(good, pid=rec.TRACE_PID)]),  # squatting
        rec.chrome_trace([dict(watch, pid=3)]),
        rec.chrome_trace([dict(good, pid=rec.WATCH_PID)]),
    ]


@pytest.mark.parametrize("i", range(15))
def test_validate_chrome_trace_equals_jax(i):
    tr = _bad_traces()[i]
    errs = rec.validate_chrome_trace(tr)
    assert errs == jrec.validate_chrome_trace(tr)
    assert (errs == []) == (i in (0, 1))
    if i >= 7 and i != 11:  # 11: a span with no trace id
        assert any("reserved" in e for e in errs), errs


def test_chrome_trace_equals_jax():
    ev = rec.FlightRecorder(4)
    ev.record(10_000, 0, 1, 4, 4, 10, 0, 1, 2, 3, 0, 4, 5, 6, 9_000)
    events = ev.to_events(pid=1)
    assert rec.chrome_trace(events) == jrec.chrome_trace(events)
    assert rec.chrome_trace([])["otherData"]["paxmonSchemaVersion"] == 7


# ------------------------------------------- device rounds, journal


@pytest.fixture(scope="module")
def resident_run():
    """A small port ShardedCluster on the CPU (G=2 x R=5, W=64), three
    loaded 8-round dispatches and a drain through ResidentTimeline,
    the telemetry ring armed: its rows and dispatch log."""
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
    from minpaxos_tpu_torch.parallel.sharded import ResidentTimeline, ShardedCluster

    cfg = MinPaxosConfig(n_replicas=5, window=64, inbox=40, exec_batch=16, kv_pow2=10,
                         catchup_rows=8, recovery_rows=8)
    sc = ShardedCluster(cfg, 2, ext_rows=16, key_space=64, seed=3, device="cpu")
    sc.elect(0)
    sc.begin_resident(telemetry_rounds=64)
    tl = ResidentTimeline(sc)
    res = [tl.run_resident(8, 12) for _ in range(3)]
    for _ in range(3):
        res.append(tl.run_resident(8, 0))
    tel = sc.resident_telemetry()
    sc.end_resident()
    return tl, tel, res


def test_device_round_events_on_port_telemetry_equal_jax(resident_run):
    tl, tel, res = resident_run
    assert len(tel) == 48 and len(tl.log) == 6
    ev = rec.device_round_events(tel, tl.log, 2)
    assert ev == jrec.device_round_events(tel, tl.log, 2)
    dev = [e for e in ev if e.get("cat") == "device_round"]
    assert len(dev) == len(tel) and all(e["pid"] == rec.DEVICE_PID for e in dev)
    assert all(e["name"] == "round:steady" for e in dev)  # after the election
    fr = [e["args"]["device_frontier"] for e in ev if e.get("name") == "device_frontier"]
    assert fr[-1] == int(tel[:, rec.TEL_COMMITTED].sum())
    # the host rows: one per dispatch, the dispatch's committed total
    rows = tl.recorder.snapshot()
    assert rows[:, rec.F_FRONTIER].tolist() == [c for c, _ in res]
    assert (rows[:, rec.F_KIND] == rec.KIND_FUSED).all() and (rows[:, rec.F_K] == 8).all()
    merged = rec.chrome_trace(tl.events(tel, pid=3))
    assert rec.validate_chrome_trace(merged) == []
    assert jrec.validate_chrome_trace(merged) == []
    assert {e["pid"] for e in merged["traceEvents"]} == {3, rec.DEVICE_PID}


def test_device_round_events_skip_uncovered_rounds(resident_run):
    tl, tel, _ = resident_run
    # the log without its second dispatch: its rounds are skipped
    part = tl.log[:1] + tl.log[2:]
    ev = rec.device_round_events(tel, part, 2)
    assert ev == jrec.device_round_events(tel, part, 2)
    assert len([e for e in ev if e.get("cat") == "device_round"]) == len(tel) - 8
    # a raw ring readback (unwritten rows, unsorted) renders the same
    raw = np.concatenate([np.full((5, rec.N_TEL_FIELDS), -1, tel.dtype), tel[::-1]])
    assert rec.device_round_events(raw, tl.log, 2) == rec.device_round_events(tel, tl.log, 2)
    assert rec.device_round_events(tel[:1], [{"t0_ns": 0, "t1_ns": 1000,
                                              "round0": 10**6, "k": 2}], 2) == []


def test_event_chrome_events_equal_jax():
    j = W.EventJournal(capacity=16)
    j.record(W.EV_ELECTION, subject=0, value=5)
    j.record(W.EV_LEADER_CHANGE, subject=1, aux=0)
    j.record(W.EV_ALARM, subject=0, value=900, aux=W.DET_STALL)
    j.record(W.EV_ALARM_CLEAR, subject=0, aux=99)
    j.record(W.EV_CHAOS_INSTALL, subject=2, value=1009)
    rows = j.snapshot()
    extra = np.array([[0, 0, W.EV_ELECTION, 0, 0, 0, 0, 0],  # mono 0: skipped
                      [7, 8, 0, 0, 0, 0, 0, 0],  # kind 0: skipped
                      [9, 10, 200, 3, 1, 2, 3, 4]], np.int64)  # unknown kind
    rows = np.concatenate([rows, extra])
    for pid, tid in ((None, 0), (None, 2), (17, 1)):
        ev = W.event_chrome_events(rows, pid=pid, tid=tid)
        assert ev == jwatch.event_chrome_events(rows, pid=pid, tid=tid)
    events = W.event_chrome_events(j.snapshot(), tid=0)
    assert len(events) == 5 and all(e["pid"] == rec.WATCH_PID for e in events)
    assert events[2]["name"] == "alarm:frontier_stall"
    assert all(e["ph"] == "i" and e["cat"] == "paxwatch" for e in events)
    r = rec.FlightRecorder(8)
    r.record(10_000, 0, 1, 4, 4, 10, 0, 1, 2, 3, 0, 4, 5, 6, 9_000)
    assert rec.validate_chrome_trace(rec.chrome_trace(r.to_events(pid=0) + events)) == []


def test_overhead_guards_run_their_instrumented_loops():
    """The reference's two guards over the port's recorder, registry and
    sink (``chip_smoke.py`` gates them on the card machine's host): both
    loops run, spans are stamped, the bound is the reference's 30 us."""
    from minpaxos_tpu_torch.obs import guards

    g = guards.overhead_guard(n_iters=2000)
    assert g["ticks"] == 2000 and g["bound_us"] == 30.0 and "us_per_tick" in g
    t = guards.trace_overhead_guard(reps=2)
    assert t["commands"] == 2 * 8 * 512 and t["spans_stamped"] > 0
    # two runs (the warm one and the timed one) of two repetitions each
    assert t["spans_stamped"] == 2 * 2 * int(T.sampled_mask(np.arange(8 * 512), 4).sum())
