"""paxwatch on the port against the JAX package: the event journal's
rings, anchor alignment, ``flatten_cluster_stats`` on a recorded fan-out
response, each detector, ``SLO.evaluate``, the watcher's raise/clear
edges and ``HealthSeries`` retention, on the cases of the reference's
own tests, each output equal to the reference function's on the same
sample series (dict and integer equality, no tolerance)."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from minpaxos_tpu.obs import watch as R
from minpaxos_tpu_torch.obs import watch as W

torch.set_num_threads(1)


# ----------------------------------------------------------- journal

def test_event_tables_equal_the_reference():
    for name in ("EVENT_NAMES", "EVENT_SEVERITY", "SEV_NAMES", "PHASE_KIND_NAMES",
                 "PHASE_KIND_IDS", "DETECTOR_NAMES", "DETECTOR_IDS",
                 "EVENT_FIELD_NAMES", "N_EVENT_FIELDS"):
        assert getattr(W, name) == getattr(R, name), name
    for name in dir(R):
        if name.startswith(("EV_", "SEV_", "DET_", "PHASE_")):
            assert getattr(W, name) == getattr(R, name), name


def test_event_ring_wraparound_keeps_newest():
    rings = [W.EventRing(capacity=4), R.EventRing(capacity=4)]
    for r in rings:
        for i in range(10):
            r.record(1000 + i, 2000 + i, W.EV_ELECTION, 0, i, 0, 0, 0)
    a, b = (r.snapshot() for r in rings)
    assert a.shape == (4, W.N_EVENT_FIELDS)
    assert a[:, W.EV_SUBJECT].tolist() == [6, 7, 8, 9]
    np.testing.assert_array_equal(a, b)
    assert rings[0].total == 10 and rings[0].dropped == rings[1].dropped == 6
    with pytest.raises(ValueError):
        W.EventRing(capacity=0)


def test_journal_per_thread_rings_and_counts():
    j = W.EventJournal(capacity=64)
    j.record(W.EV_ELECTION, subject=0)

    def other():
        j.record(W.EV_CLIENT_FAILOVER, subject=1)

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert j.events_total() == 2 and len(j._rings) == 2
    assert j.counts_by_kind() == {"election": 1, "client_failover": 1}
    rows = j.snapshot()
    assert rows.shape[0] == 2 and rows[0, W.EV_MONO] <= rows[1, W.EV_MONO]
    by_kind = {int(r[W.EV_KIND]): int(r[W.EV_SEV]) for r in rows}
    assert by_kind[W.EV_ELECTION] == W.SEV_INFO
    assert by_kind[W.EV_CLIENT_FAILOVER] == W.SEV_WARN
    # a dead writer's ring is adopted by the next new writer thread
    t2 = threading.Thread(target=other)
    t2.start()
    t2.join()
    assert len(j._rings) == 2 and j.events_total() == 3
    assert W.counts_by_kind(rows) == R.counts_by_kind(rows)
    c = j.collect()
    assert c["total"] == 3 and c["dropped"] == 0 and len(c["events"]) == 3
    assert set(c) == set(R.EventJournal().collect())
    # a small ring wraps: dropped counts the overwritten rows
    s = W.EventJournal(capacity=2)
    for _ in range(5):
        s.record(W.EV_PEER_UP, subject=1)
    assert s.events_total() == 5 and s.events_dropped() == 3


def test_journal_disabled_records_nothing():
    j = W.EventJournal(enabled=False)
    j.record(W.EV_FATAL, subject=0)
    assert j.events_total() == 0 and j.collect()["events"] == []


def test_align_event_collections_equals_the_reference():
    skew = 5_000_000_000
    wall0 = 1_700_000_000_000_000_000
    a = {"anchor": {"mono_ns": 100, "wall_ns": wall0},
         "events": [[50, wall0 - 50, W.EV_ELECTION, 0, 0, 0, 0, 0]]}
    b = {"anchor": {"mono_ns": 100 - skew, "wall_ns": wall0},
         "events": [[75 - skew, wall0 - 25, W.EV_CHAOS_INSTALL, 1, 1, 0, 0, 0]]}
    empty = {"anchor": None, "events": []}
    for cols in ([a, b], [b, a], [a, empty, b], [], [empty]):
        got = W.align_event_collections(cols)
        np.testing.assert_array_equal(got, R.align_event_collections(cols))
    rows = W.align_event_collections([a, b])
    assert rows[:, W.EV_KIND].tolist() == [W.EV_ELECTION, W.EV_CHAOS_INSTALL]
    assert rows[1, W.EV_MONO] - rows[0, W.EV_MONO] == 25
    ref = {"mono_ns": 0, "wall_ns": wall0}
    np.testing.assert_array_equal(W.align_event_collections([a, b], ref),
                                  R.align_event_collections([a, b], ref))


# ------------------------------------------------- synthetic series

def _resp(tip_by_rid: dict, leader=0, proposals=0, elections=None,
          executed=None, hist=None, dead=()):
    """A master stats fan-out response for one sample instant."""
    replicas = []
    for rid, fr in tip_by_rid.items():
        cnt = {"proposals": proposals if rid == leader else 0,
               "elections": (elections or {}).get(rid, 0)}
        mx = {"counters": cnt, "gauges": {}}
        if hist is not None:
            mx["histograms"] = {"tick_wall_ms": hist[rid]}
        if rid in dead:
            replicas.append({"id": rid, "ok": False, "error": "refused"})
            continue
        replicas.append({"id": rid, "ok": True, "frontier": fr,
                         "executed": (executed or {}).get(rid, fr),
                         "metrics": mx})
    return {"ok": True, "leader": leader, "replicas": replicas}


def _both(resps, dt=0.25, slo_ms=None):
    port = [W.flatten_cluster_stats(r, slo_ms=slo_ms, t_wall=i * dt)
            for i, r in enumerate(resps)]
    ref = [R.flatten_cluster_stats(r, slo_ms=slo_ms, t_wall=i * dt)
           for i, r in enumerate(resps)]
    assert port == ref
    return port


def _same(fn, samples, *args, **kw):
    a = getattr(W, fn)(samples, *args, **kw)
    assert a == getattr(R, fn)(samples, *args, **kw), fn
    return a


def test_flatten_cluster_stats_on_a_recorded_response():
    """A stats fan-out as the port's master returns it (metrics with
    counters, gauges and the tick-wall histogram; one dead replica)."""
    hist = {"bounds": [0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0],
            "counts": [0, 3, 40, 500, 200, 60, 7, 1, 2], "count": 813,
            "sum": 9120.5}
    resp = {"ok": True, "leader": 0, "alive": [True, True, False], "n": 3,
            "replicas": [
                {"ok": True, "id": 0, "protocol": "minpaxos", "device": "cpu",
                 "leader": 0, "frontier": 1534, "window_base": 1024,
                 "executed": 1530, "work_pending": False, "fatal": None,
                 "metrics": {"namespace": "replica0",
                             "counters": {"proposals": 1800,
                                          "proposals_rejected": 64,
                                          "elections": 1, "narrow_fallbacks": 0},
                             "gauges": {"chaos_injected": 219, "events": 12,
                                        "events_dropped": 0},
                             "histograms": {"tick_wall_ms": hist}}},
                {"ok": True, "id": 1, "frontier": 1500, "executed": 1498,
                 "metrics": {"counters": {"elections": 0},
                             "gauges": {"chaos_injected": 3, "events": 5},
                             "histograms": {"tick_wall_ms": hist}}},
                {"ok": False, "id": 2, "error": "ConnectionRefusedError()"}]}
    for slo in (None, 5.0, 50.0, 6000.0):
        a = W.flatten_cluster_stats(resp, slo_ms=slo, t_wall=12.5)
        assert a == R.flatten_cluster_stats(resp, slo_ms=slo, t_wall=12.5)
    a = W.flatten_cluster_stats(resp, t_wall=1.0)
    assert a["alive"] == 2 and a["tip"] == 1534
    assert a["in_flight"] == 1800 - 64 - 1535
    assert a["replicas"]["0"]["chaos_injected"] == 219
    assert a["replicas"]["2"]["frontier"] == -1


def test_stall_fires_and_boundary():
    frozen = _resp({0: 100, 1: 100, 2: 100}, proposals=165)
    samples = _both([frozen] * 6)
    a = _same("stall_alarm", samples, stall_s=1.0, slack_slots=8)
    assert a is not None and a["evidence"]["in_flight"] == 64
    assert _same("stall_alarm", samples[:4], stall_s=1.0) is None
    crawl = [_resp({0: 100 + 3 * i, 1: 100 + 3 * i, 2: 100 + 3 * i}, proposals=200)
             for i in range(6)]
    assert _same("stall_alarm", _both(crawl), stall_s=1.0, slack_slots=8) is None
    quiet = _resp({0: 100, 1: 100, 2: 100}, proposals=90)
    assert _same("stall_alarm", _both([quiet] * 6), stall_s=1.0) is None


def test_stall_attribution_minority_majority_starved_and_dead():
    lag1 = _resp({0: 500, 1: 500, 2: 380}, proposals=600)
    assert _same("stall_alarm", _both([lag1] * 6), stall_s=1.0)["subject"] == 2
    maj = _resp({0: 500, 1: 436, 2: 436}, proposals=600)
    a = _same("stall_alarm", _both([maj] * 6), stall_s=1.0)
    assert a["subject"] == 0 and "leader is cut off" in a["evidence"]["why"]
    lvl = _resp({0: 500, 1: 500, 2: 500}, proposals=600)
    assert _same("stall_alarm", _both([lvl] * 6), stall_s=1.0)["subject"] == 0
    # a starved minority while the tip moves on (the flex_partition
    # signature at N = 5)
    moving = [_resp({0: 100 + 40 * i, 1: 100 + 40 * i, 2: 100 + 40 * i,
                     3: 100, 4: 100}, proposals=400 + 40 * i) for i in range(6)]
    a = _same("stall_alarm", _both(moving), stall_s=1.0)
    assert a["subject"] in (3, 4) and "starved" in a["evidence"]["why"]
    # a dead follower across the whole window (crash schedules)
    dead = [_resp({0: 100 + 40 * i, 1: 100 + 40 * i, 2: 0}, proposals=400 + 40 * i,
                  dead=(2,)) for i in range(6)]
    a = _same("stall_alarm", _both(dead), stall_s=1.0)
    assert a["subject"] == 2 and a["evidence"]["dead"] == [2]


def test_churn_budget_boundary():
    def at(n_elections):
        resps = [_resp({0: 10 * i, 1: 10 * i, 2: 10 * i}, elections={1: 0})
                 for i in range(9)]
        for i, r in enumerate(resps):
            r["replicas"][1]["metrics"]["counters"]["elections"] = round(n_elections * i / 8)
        return _both(resps, dt=0.5)

    assert _same("churn_alarm", at(3), window_s=3.0, budget=3) is None
    a = _same("churn_alarm", at(6), window_s=3.0, budget=3)
    assert a is not None and a["subject"] == 1 and a["evidence"]["elections"] > 3


def test_backlog_growth_slope():
    resps = [_resp({0: 1000 + 200 * i, 1: 1000 + 200 * i, 2: 1000 + 200 * i},
                   executed={2: 1000 + 75 * i}) for i in range(9)]
    a = _same("backlog_alarm", _both(resps, dt=0.5), window_s=3.0, slope_per_s=200.0,
              min_backlog=64)
    assert a is not None and a["subject"] == 2 and a["evidence"]["slope_per_s"] > 200
    flat = [_resp({0: 1000, 1: 1000, 2: 1000}, executed={2: 900}) for _ in range(9)]
    assert _same("backlog_alarm", _both(flat, dt=0.5), window_s=3.0,
                 slope_per_s=200.0) is None


def test_burn_rate_math():
    bounds = [1.0, 10.0, 50.0, 100.0]

    def hist(total, bad):
        return {"bounds": bounds, "counts": [0, total - bad, 0, bad, 0], "count": total}

    def series(bad_per_k):
        resps = []
        for i in range(9):
            h = {rid: hist(1000 * i // 8, bad_per_k * i // 8) for rid in range(3)}
            resps.append(_resp({0: 10 * i, 1: 10 * i, 2: 10 * i}, hist=h))
        return _both(resps, dt=0.5, slo_ms=50.0)

    a = _same("burn_alarm", series(200), window_s=3.0, slo_ms=50.0, budget_frac=0.01,
              burn_x=10.0, min_ticks=50)
    assert a is not None and a["evidence"]["burn"] >= 15
    assert _same("burn_alarm", series(5), window_s=3.0, slo_ms=50.0, budget_frac=0.01,
                 burn_x=10.0, min_ticks=50) is None
    assert _same("burn_alarm", series(200)[:2], window_s=0.4, slo_ms=50.0,
                 min_ticks=5000) is None


@pytest.mark.parametrize("slo_ms,bad", [(10.0, 12), (6000.0, 8)])
def test_hist_bad_lower_edge_is_conservative(slo_ms, bad):
    h = {"bounds": [1.0, 10.0, 50.0], "counts": [1, 2, 4, 8], "count": 15}
    s = _both([_resp({0: 5}, hist={0: h})], slo_ms=slo_ms)[0]
    assert s["hist_bad"] == bad and s["hist_total"] == 15


def test_slo_evaluate_equals_the_reference():
    """SLO.evaluate over the series of every detector case, with the
    default SLO and the campaign's."""
    slos = [(W.SLO(), R.SLO()),
            (W.SLO(stall_s=0.6, stall_slack_slots=8, churn_window_s=5.0, churn_budget=4),
             R.SLO(stall_s=0.6, stall_slack_slots=8, churn_window_s=5.0, churn_budget=4))]
    rng = np.random.default_rng(15)
    series = []
    tips = np.zeros(3, int)
    for i in range(60):
        tips += rng.integers(0, 30, 3) * (i % 13 > 4)
        h = {rid: {"bounds": [1.0, 10.0, 50.0], "counts": [i, 3 * i, i // 2, i // 7],
                   "count": 4 * i + i // 2 + i // 7} for rid in range(3)}
        series.append(_resp({r: int(tips[r]) for r in range(3)},
                            proposals=int(tips.max()) + 20,
                            elections={1: i // 9}, executed={2: int(tips[2]) - i},
                            hist=h, dead=(2,) if 30 <= i < 40 else ()))
    for dt in (0.25, 0.5):
        samples = _both(series, dt=dt, slo_ms=50.0)
        for k in range(2, len(samples) + 1):
            for ws, rs in slos:
                assert ws.evaluate(samples[:k]) == rs.evaluate(samples[:k]), (dt, k)
    assert W.SLO() == W.SLO() and vars(W.SLO()) == vars(R.SLO())


def test_health_watcher_raise_and_clear_journaled():
    frozen = _resp({0: 100, 1: 100, 2: 100}, proposals=165)
    moving = [_resp({0: 100 + 50 * i, 1: 100 + 50 * i, 2: 100 + 50 * i},
                    proposals=165) for i in range(20)]
    ws = [W.HealthWatcher(slo=W.SLO(stall_s=1.0)), R.HealthWatcher(slo=R.SLO(stall_s=1.0))]
    t = 0.0
    for r in [frozen] * 6 + moving:
        got = [w.poll_once(r, t_wall=t) for w in ws]
        assert got[0] == got[1]
        t += 0.25
    w = ws[0]
    assert len(w.alarms) == 1 and w.alarms[0]["t_cleared"] is not None
    assert w.alarms == ws[1].alarms
    rows = w.journal.snapshot()
    assert rows[:, W.EV_KIND].tolist() == [W.EV_ALARM, W.EV_ALARM_CLEAR]
    assert all(int(r[W.EV_AUX]) == W.DET_STALL for r in rows)
    s = w.summary()
    assert s == ws[1].summary()
    assert s["alarm_counts"] == {"frontier_stall": 1}
    assert s["events"] == {"alarm": 1, "alarm_clear": 1}


def test_health_watcher_polls_and_counts_errors():
    calls = []

    def poll():
        calls.append(1)
        if len(calls) % 2:
            raise OSError("master unreachable")
        return _resp({0: 10, 1: 10, 2: 10})

    w = W.HealthWatcher(poll_fn=poll, interval_s=0.01)
    w.start()
    deadline = 200
    while len(calls) < 6 and deadline:
        deadline -= 1
        threading.Event().wait(0.01)
    w.stop()
    assert w.poll_errors >= 3 and len(w.samples) >= 2


# -------------------------------------------------------- retention

def test_health_series_long_run_stays_bounded(tmp_path):
    """A compressed two-day run of 1 Hz samples against a 256 KB bound,
    the port's series and the reference's side by side: the same coarse
    buckets, raw window and summary, and the file near its bound."""
    port = W.HealthSeries(str(tmp_path / "port.jsonl"), raw_keep_s=60.0, coarse_s=30.0,
                          max_bytes=256 << 10, max_coarse=64)
    ref = R.HealthSeries(str(tmp_path / "ref.jsonl"), raw_keep_s=60.0, coarse_s=30.0,
                         max_bytes=256 << 10, max_coarse=64)
    n = 60_000
    for i in range(n):
        s = {"t": float(i), "tip": i * 3, "in_flight": i % 7,
             "replicas": {"0": {"backlog": i % 11}}}
        port.append(s)
        ref.append(s)
    port.close()
    ref.close()
    assert (tmp_path / "port.jsonl").stat().st_size < (256 << 10) * 1.25
    assert port.appended == n and len(port.coarse) <= 64
    assert [(b["t0"], b["t1"], b["stats"]) for b in port.coarse] == [
        (b["t0"], b["t1"], b["stats"]) for b in ref.coarse]
    assert list(port._raw) == list(ref._raw)
    assert port.summary() == ref.summary()
    port.compact()
    port.close()
    doc = W.load_series(str(tmp_path / "port.jsonl"))
    ref.compact()
    ref.close()
    assert doc == R.load_series(str(tmp_path / "ref.jsonl"))
    assert len(doc["raw"]) == len(port._raw) and doc["raw"][-1]["tip"] == (n - 1) * 3


def test_health_series_coarse_percentiles_exact(tmp_path):
    series = [W.HealthSeries(str(tmp_path / "p.jsonl"), raw_keep_s=10.0, coarse_s=100.0),
              R.HealthSeries(str(tmp_path / "r.jsonl"), raw_keep_s=10.0, coarse_s=100.0)]
    for hs in series:
        for i in range(100):
            hs.append({"t": float(i), "x": float(i)})
        hs.append({"t": 1000.0, "x": 0.0})
        hs.close()
    st = series[0].coarse[0]["stats"]["x"]
    assert st == series[1].coarse[0]["stats"]["x"]
    arr = list(range(st["n"]))
    assert st["max"] == arr[-1]
    assert st["p50"] == arr[min(int(0.50 * len(arr)), len(arr) - 1)]
    assert st["p99"] == arr[min(int(0.99 * len(arr)), len(arr) - 1)]
    mem = W.HealthSeries()  # path None: memory only
    mem.append({"t": 1.0, "x": 2.0})
    assert mem.summary()["file_bytes"] == 0


def test_stall_verdict_window_join():
    """The campaign's live-stall verdict joins the watcher's alarms
    against the fired chaos events' wall marks, as the reference's."""
    from minpaxos_tpu.chaos.campaign import _stall_verdict as ref_verdict
    from minpaxos_tpu_torch.chaos.campaign import _stall_verdict

    class FakeWatcher:
        alarms = [{"detector": "frontier_stall", "subject": 0, "t_raised": 105.0,
                   "t_cleared": 108.2, "evidence": {"why": "x"}}]

    marks = [(5.0, 104.0, "install"), (9.0, 108.0, "clear")]
    for alarm, subject in ((dict(t_raised=105.0), 0), (dict(t_raised=90.0), 0),
                           (dict(t_raised=105.0, subject=2), 0),
                           (dict(t_raised=105.0, subject=4), frozenset({3, 4})),
                           (dict(t_cleared=None), 0)):
        FakeWatcher.alarms = [dict(FakeWatcher.alarms[0], **alarm)]
        v = _stall_verdict(FakeWatcher(), marks, expected_subject=subject)
        assert v == ref_verdict(FakeWatcher(), marks, expected_subject=subject)
    FakeWatcher.alarms = [{"detector": "frontier_stall", "subject": 0, "t_raised": 105.0,
                           "t_cleared": 108.2, "evidence": {"why": "x"}}]
    v = _stall_verdict(FakeWatcher(), marks, expected_subject=0)
    assert v["fired_in_window"] and v["attributed"] and v["cleared"]


def test_stalled_during_fault_equals_the_reference():
    from minpaxos_tpu.chaos.campaign import _stalled_during_fault as ref_fn
    from minpaxos_tpu_torch.chaos.campaign import _stalled_during_fault

    t = [0.05 * i for i in range(80)]
    marks = [(1.0, 101.0, "install"), (2.5, 102.5, "clear")]
    flat = {r: [min(i, 20) * 3 if i * 0.05 < 1.0 else 60 for i in range(80)]
            for r in range(3)}
    moving = {r: [i * 3 for i in range(80)] for r in range(3)}
    for samples in (flat, moving):
        for m in (marks, marks[:1], []):
            assert _stalled_during_fault(t, samples, m) == ref_fn(t, samples, m)
    assert _stalled_during_fault(t, flat, marks)
    assert not _stalled_during_fault(t, moving, marks)


def test_an_alarm_keeps_the_subject_it_was_raised_with():
    """The isolated-leader run's samples as the campaign's watcher took
    them on a loaded host (0.26 s apart): every frontier flat with
    commands in flight (the leader cut off: alarm on replica 0), then
    the heal, where the first sample catches the leader and replica 2
    past the next batch and replica 1 one batch behind (a starved
    minority for one poll), then every replica level. The leader's
    alarm keeps subject 0 and clears; replica 1's lag is an alarm of
    its own; the journal's raise and clear rows name the same replica;
    the campaign's verdict attributes the stall to the leader. (The JAX
    package's watcher relabels the leader's alarm to replica 1, so the
    verdict would not.)"""
    from minpaxos_tpu_torch.chaos.campaign import STALL_SLACK_SLOTS, _stall_verdict

    series = ([_resp({0: -1, 1: -1, 2: -1}), _resp({0: 63, 1: -1, 2: -1}, proposals=128)]
              + [_resp({0: 63, 1: 63, 2: 63}, proposals=128)] * 7
              + [_resp({0: 127, 1: 63, 2: 127}, proposals=150),
                 _resp({0: 149, 1: 127, 2: 127}, proposals=150),
                 _resp({0: 149, 1: 149, 2: 149}, proposals=210),
                 _resp({0: 209, 1: 209, 2: 209}, proposals=210)])
    slo = dict(stall_s=0.6, stall_slack_slots=STALL_SLACK_SLOTS, churn_window_s=5.0,
               churn_budget=4)
    w, ref = W.HealthWatcher(slo=W.SLO(**slo)), R.HealthWatcher(slo=R.SLO(**slo))
    for i, r in enumerate(series):
        w.poll_once(r, t_wall=100.0 + 0.26 * i)
        ref.poll_once(r, t_wall=100.0 + 0.26 * i)
    stall = [a for a in w.alarms if a["detector"] == "frontier_stall"]
    assert [a["subject"] for a in stall] == [0, 1]
    assert all(a["t_cleared"] is not None for a in stall)
    assert stall[0]["t_cleared"] == stall[1]["t_raised"]
    rows = w.journal.snapshot()
    raised = rows[rows[:, W.EV_KIND] == W.EV_ALARM][:, W.EV_SUBJECT].tolist()
    cleared = rows[rows[:, W.EV_KIND] == W.EV_ALARM_CLEAR][:, W.EV_SUBJECT].tolist()
    assert raised == cleared == [0, 1]
    marks = [(0.0, 100.45, "install"), (1.8, 102.1, "clear")]
    v = _stall_verdict(w, marks, expected_subject=0)
    assert v["fired_in_window"] and v["attributed"] and v["cleared"]
    # the reference relabelled its one alarm
    assert [a["subject"] for a in ref.alarms] == [1]
    assert not _stall_verdict(ref, marks, expected_subject=0)["attributed"]
