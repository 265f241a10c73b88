"""paxchaos on the port against the JAX package: schedules, fault plans,
the shim's per-frame decisions, the transport's gates and the model
checker's fault-plan projection, each equal to the reference's on the
same inputs (integer and dict equality, no tolerance)."""

from __future__ import annotations

import json
import os
import queue
import time

import numpy as np
import pytest
import torch

from minpaxos_tpu.chaos import ChaosShim as RefShim
from minpaxos_tpu.chaos import FaultPlan as RefPlan
from minpaxos_tpu.chaos.campaign import SCHEDULES as REF_SCHEDULES
from minpaxos_tpu.chaos.campaign import build_schedule as ref_schedule
from minpaxos_tpu_torch.chaos import ChaosShim, FaultPlan
from minpaxos_tpu_torch.chaos import shim as port_shim
from minpaxos_tpu_torch.chaos.campaign import (
    CRASH_SCHEDULES,
    SCHEDULE_SHAPES,
    SCHEDULES,
    STALL_SCHEDULES,
    STARVED_SCHEDULES,
    build_schedule,
)
from minpaxos_tpu_torch.runtime.transport import FROM_PEER, Transport
from minpaxos_tpu_torch.utils.netutil import free_ports
from minpaxos_tpu_torch.wire.messages import MsgKind, make_batch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(f for f in os.listdir(os.path.join(ROOT, "tests", "fixtures"))
                  if f.startswith("mc_") and f.endswith(".json"))


# ------------------------------------------------------------ schedules

def test_schedule_tables_equal_the_reference():
    from minpaxos_tpu.chaos import campaign as ref

    assert SCHEDULES == REF_SCHEDULES and len(SCHEDULES) == 11
    assert CRASH_SCHEDULES == ref.CRASH_SCHEDULES
    assert STALL_SCHEDULES == ref.STALL_SCHEDULES
    assert STARVED_SCHEDULES == ref.STARVED_SCHEDULES
    assert SCHEDULE_SHAPES == ref.SCHEDULE_SHAPES


@pytest.mark.parametrize("name", SCHEDULES)
def test_build_schedule_equals_the_reference(name):
    """Every schedule, seed and cluster size: the same event times, ops
    and plan dicts (whose seed drives every per-link decision)."""
    for seed in (42, 1009, 1234, 2003):
        for n in (3, 5):
            got = build_schedule(name, seed, n)
            assert got == ref_schedule(name, seed, n), (name, seed, n)
            assert json.dumps(got) == json.dumps(ref_schedule(name, seed, n))
            assert got and [t for t, _, _ in got] == sorted(t for t, _, _ in got)
    assert build_schedule(name, 1234, 3) != build_schedule(name, 1235, 3)
    with pytest.raises(ValueError):
        build_schedule("no_such_schedule", 1, 3)


# ----------------------------------------------------------------- plan

def test_fault_plan_roundtrip_and_validation():
    """The cases of the reference's plan test, each against the
    reference's own plan."""
    p = (FaultPlan(3, seed=7).isolate(0)
         .set_link(1, 2, drop=0.1, reorder=4, delay_s=0.01, jitter_s=0.02))
    r = (RefPlan(3, seed=7).isolate(0)
         .set_link(1, 2, drop=0.1, reorder=4, delay_s=0.01, jitter_s=0.02))
    d = p.to_dict()
    assert d == r.to_dict()
    assert FaultPlan.from_dict(d).to_dict() == d
    assert RefPlan.from_dict(d).to_dict() == FaultPlan.from_dict(r.to_dict()).to_dict()
    assert repr(p) == repr(r)
    assert not p.is_noop() and FaultPlan(3).is_noop()
    for bad in (dict(src=0, dst=0, block=True), dict(src=0, dst=3, block=True),
                dict(src=0, dst=1, drop=1.5), dict(src=0, dst=1, delay_s=100.0),
                dict(src=0, dst=1, reorder=-1)):
        kw = dict(bad)
        src, dst = kw.pop("src"), kw.pop("dst")
        with pytest.raises(ValueError):
            FaultPlan(3).set_link(src, dst, **kw)
        with pytest.raises(ValueError):
            RefPlan(3).set_link(src, dst, **kw)
    with pytest.raises(ValueError):
        FaultPlan(0)
    with pytest.raises(ValueError):
        FaultPlan(3).partition([1], [1])
    ow = FaultPlan(3).partition([1], [0], one_way=True)
    assert ow.link(1, 0).block and ow.link(0, 1) is None
    assert ow.to_dict() == RefPlan(3).partition([1], [0], one_way=True).to_dict()


# ----------------------------------------------------------------- shim

def _drain(q):
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


def _plans(seed):
    """(policy kwargs) families the shim is held to the reference on."""
    return [dict(drop=0.3, dup=0.2), dict(drop=0.4), dict(dup=1.0),
            dict(drop=0.05, dup=0.10, delay_s=0.004, jitter_s=0.008),
            dict(drop=0.10, reorder=4), dict(block=True)]


@pytest.mark.parametrize("seed", [3, 11, 1009, 2003])
def test_shim_decisions_equal_the_reference(seed):
    """The same plan and seed: frame for frame the same (drop, dup,
    delay) decision on every inbound link, 300 frames each."""
    rng = np.random.default_rng(seed)
    for pol in _plans(seed):
        for src in (1, 2):
            p_pol = dict(pol)
            if not p_pol.get("block"):
                p_pol["jitter_s"] = p_pol.get("jitter_s", float(rng.random()) * 0.01)
            port = ChaosShim(0, FaultPlan(3, seed=seed).set_link(src, 0, **p_pol),
                             queue.Queue())
            ref = RefShim(0, RefPlan(3, seed=seed).set_link(src, 0, **p_pol),
                          queue.Queue())
            try:
                assert set(port._in) == set(ref._in) == {src}
                a = [port._in[src].decide() for _ in range(300)]
                b = [ref._in[src].decide() for _ in range(300)]
                assert a == b, (seed, pol, src)
            finally:
                port.stop(flush=False)
                ref.stop(flush=False)


@pytest.mark.parametrize("pol", [dict(drop=0.4), dict(drop=0.3, dup=0.2), dict(dup=1.0),
                                 dict(block=True), dict(drop=0.1, reorder=4),
                                 dict(reorder=3, dup=0.3)])
def test_shim_delivered_frames_equal_the_reference(pol):
    """End to end through ingest: the delivered frames (which survive,
    which are doubled, in which order a reorder window releases them)
    and the fault tallies equal the reference shim's. 240 frames is a
    whole number of every reorder window, so no time flush runs."""
    for seed in (5, 6, 1009):
        got = []
        for shim_cls, plan_cls in ((ChaosShim, FaultPlan), (RefShim, RefPlan)):
            q = queue.Queue()
            sh = shim_cls(0, plan_cls(2, seed=seed).set_link(1, 0, **pol), q)
            for i in range(240):
                sh.ingest(1, int(MsgKind.ACCEPT), i)
            counts = sh.counts()
            sh.stop()
            got.append(([item[3] for item in _drain(q)], counts))
        assert got[0] == got[1], (pol, seed)
    assert got[0][0] != list(range(240)) or pol == {}


def test_shim_reorder_permutation_equals_the_reference():
    for seed in (3, 4, 2003):
        out = []
        for shim_cls, plan_cls in ((ChaosShim, FaultPlan), (RefShim, RefPlan)):
            q = queue.Queue()
            sh = shim_cls(0, plan_cls(2, seed=seed).set_link(1, 0, reorder=4), q)
            for i in range(12):  # three full windows: no time flush
                sh.ingest(1, int(MsgKind.ACCEPT), i)
            sh.stop()
            out.append([item[3] for item in _drain(q)])
        assert out[0] == out[1]
        assert sorted(out[0]) == list(range(12)) and out[0] != list(range(12))
    assert set(ChaosShim(0, FaultPlan(2, seed=3), queue.Queue()).counts()) == {
        "blocked_in", "dropped", "delayed", "duplicated", "reordered", "blocked_out"}


def test_shim_duplicate_delay_and_source_tag():
    import minpaxos_tpu.chaos.shim as ref_shim

    assert port_shim.FROM_PEER == ref_shim.FROM_PEER == FROM_PEER
    assert port_shim.TALLY_KEYS == ref_shim.TALLY_KEYS
    assert port_shim.REORDER_HOLD_S == ref_shim.REORDER_HOLD_S
    q = queue.Queue()
    sh = ChaosShim(0, FaultPlan(2, seed=9).set_link(1, 0, dup=1.0), q)
    for i in range(5):
        sh.ingest(1, int(MsgKind.ACCEPT), i)
    assert [item[3] for item in _drain(q)] == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
    assert sh.counts()["duplicated"] == 5
    sh.stop()
    # a delayed frame arrives later, through the pump thread
    q2 = queue.Queue()
    sh2 = ChaosShim(0, FaultPlan(2, seed=9).set_link(1, 0, delay_s=0.04), q2)
    t0 = time.monotonic()
    sh2.ingest(1, int(MsgKind.ACCEPT), "x")
    assert q2.get(timeout=2.0) == (FROM_PEER, 1, int(MsgKind.ACCEPT), "x")
    assert time.monotonic() - t0 >= 0.03
    assert sh2.counts()["delayed"] == 1
    sh2.stop()
    # a heal delivers what the shim still held
    q3 = queue.Queue()
    sh3 = ChaosShim(0, FaultPlan(2, seed=9).set_link(1, 0, delay_s=5.0), q3)
    sh3.ingest(1, int(MsgKind.ACCEPT), "held")
    sh3.stop()
    assert [item[3] for item in _drain(q3)] == ["held"]


# ------------------------------------------------------------ transport

def _transport_pair():
    addrs = [("127.0.0.1", p) for p in free_ports(2)]
    ta, tb = Transport(0, addrs), Transport(1, addrs)
    ta.listen()
    tb.listen()
    tb.connect_peers()  # 1 dials 0
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if ta.peer_alive(1) and tb.peer_alive(0):
            return ta, tb
        time.sleep(0.02)
    raise TimeoutError("transport pair never meshed")


def test_disabled_shim_is_byte_transparent():
    """No shim, a no-op plan's shim and a cleared shim deliver the exact
    bytes of the plain path; an inbound and an outbound block bite."""
    ta, tb = _transport_pair()
    try:
        frame = make_batch(MsgKind.ACCEPT, leader_id=1, inst=np.arange(4), ballot=17,
                           op=1, key=np.arange(4) * 3, val=np.arange(4) * 7,
                           cmd_id=np.arange(4), client_id=0, last_committed=-1)

        def send_and_recv():
            assert tb.send_peer(0, MsgKind.ACCEPT, frame)
            tb.flush_all()
            src, conn, kind, rows = ta.queue.get(timeout=5)
            assert (src, conn, kind) == (FROM_PEER, 1, MsgKind.ACCEPT)
            return rows.tobytes()

        base = send_and_recv()
        assert base == frame.tobytes()
        ta.set_chaos(ChaosShim(0, FaultPlan(2, seed=1), ta.queue))
        assert send_and_recv() == base
        ta.set_chaos(None)
        assert send_and_recv() == base
        assert ta.chaos_faults_total() == 0
        ta.set_chaos(ChaosShim(0, FaultPlan(2, seed=1).set_link(1, 0, block=True),
                               ta.queue))
        assert tb.send_peer(0, MsgKind.ACCEPT, frame)
        tb.flush_all()
        with pytest.raises(queue.Empty):
            ta.queue.get(timeout=0.4)
        assert ta.chaos.counts()["blocked_in"] == 1
        assert ta.chaos_faults_total() == 1
        # a heal folds the retired shim's faults in: the total stays
        ta.set_chaos(None)
        assert ta.chaos_faults_total() == 1
        tb.set_chaos(ChaosShim(1, FaultPlan(2, seed=1).set_link(1, 0, block=True),
                               tb.queue))
        frames_out = tb.peers[0].frames_out
        assert tb.send_peer(0, MsgKind.ACCEPT, frame)  # swallowed, reported sent
        assert tb.chaos.counts()["blocked_out"] == 1
        assert tb.peers[0].frames_out == frames_out
    finally:
        ta.stop()
        tb.stop()


def test_transport_gauges_and_peer_journal():
    from minpaxos_tpu_torch.obs.metrics import MetricsRegistry
    from minpaxos_tpu_torch.obs.watch import EventJournal

    addrs = [("127.0.0.1", p) for p in free_ports(2)]
    m = MetricsRegistry()
    ta, tb = Transport(0, addrs, metrics=m), Transport(1, addrs)
    ta.journal = EventJournal(capacity=16)
    try:
        ta.listen()
        tb.listen()
        tb.connect_peers()
        deadline = time.monotonic() + 5
        while not ta.peer_alive(1) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert m.snapshot()["gauges"]["chaos_injected"] == 0
        assert ta.journal.counts_by_kind() == {"peer_up": 1}
        tb.stop()
        while ta.peer_alive(1) and time.monotonic() < deadline + 5:
            time.sleep(0.02)
        time.sleep(0.1)
        assert ta.journal.counts_by_kind() == {"peer_up": 1, "peer_down": 1}
    finally:
        ta.stop()
        tb.stop()


# ------------------------------------------------------- fault plans

@pytest.mark.parametrize("fixture", FIXTURES)
def test_counterexample_faultplan_equals_the_reference(fixture):
    """Each committed counterexample projects onto the same chaos
    schedule as the JAX function's (or raises the same exception)."""
    from minpaxos_tpu.verify.mc import counterexample_faultplan as ref
    from minpaxos_tpu_torch.verify.mc import counterexample_faultplan as port

    ce = json.load(open(os.path.join(ROOT, "tests", "fixtures", fixture)))
    outs = []
    for fn, kw in ((ref, {}), (port, {"device": "cpu"})):
        try:
            outs.append(("ok", json.loads(json.dumps(fn(ce, **kw)))))
        except Exception as e:  # noqa: BLE001 - the type is compared
            outs.append(("raise", type(e).__name__))
    assert outs[0] == outs[1]
    if outs[0][0] == "ok":
        doc = outs[0][1]
        assert FaultPlan.from_dict(doc["plan"]).to_dict() == doc["plan"]
        assert [op for _, op, _ in doc["events"]] == ["install", "clear"]


def test_emit_faultplan_cli_prints_the_reference_plan(capsys):
    from minpaxos_tpu_torch.cli import mc as port_cli
    from minpaxos_tpu.verify.mc import counterexample_faultplan as ref

    path = os.path.join(ROOT, "tests", "fixtures", "mc_broken_quorum_minpaxos.json")
    assert port_cli.main(["--emit-faultplan", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out == json.dumps(ref(json.load(open(path))), indent=1) + "\n"
