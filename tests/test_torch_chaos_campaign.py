"""paxchaos campaigns against a cluster of the port's replica servers on
the CPU: the reference's partition-the-leader scenario with its
assertions, the two smoke pairs, a crash-restart and the flexible-quorum
island, and a model-checker fault plan replayed on a live cluster. After every run the port's stable stores,
with the client's replies and the workload, pass both packages'
``check_cluster`` (``hold_to_reference``)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from minpaxos_tpu_torch.chaos.campaign import run_schedule
from tests.test_torch_serving import harness, hold_to_reference  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, name, seed, **kw):
    cap = {}
    r = run_schedule(name, seed, device="cpu", store_dir=str(tmp_path),
                     capture=cap, log=lambda *_: None, **kw)
    assert r["ok"], {k: r.get(k) for k in (
        "error", "acked", "expected", "faults_injected", "resumed_commits",
        "converged", "duplicates", "check", "watch", "cluster_events")}
    hold_to_reference(str(tmp_path), kw.get("n", 3), cap["replies"], cap["workload"])
    return r


def test_partition_leader_stalls_heals_converges(tmp_path):
    """The reference's scenario on a port cluster: the leader cut off
    from the majority mid-workload stalls progress, the partition
    injects real faults, and after the heal the cluster converges,
    resumes committing and passes every invariant."""
    r = _run(tmp_path, "isolated_leader", 42, ops_n=150)
    assert r["ok"], r
    assert r["stall_observed"], r
    assert r["faults_injected"] > 0, r
    assert r["resumed_commits"] and r["converged"], r
    assert r["check"]["ok"] and r["check"]["violations"] == [], r
    assert r["duplicates"] == 0 and r["acked"] == r["expected"] > 0, r
    # the live watcher raised the stall inside the fault window, named
    # the isolated leader, and cleared it after the heal
    stall = r["watch"]["stall"]
    assert stall["fired_in_window"] and stall["attributed"] and stall["cleared"]
    assert r["cluster_events"]["chaos_install"] >= 3


@pytest.mark.parametrize("seed,name", [(1009, "partition_heal"), (2003, "loss_reorder")])
def test_smoke_pairs(tmp_path, seed, name):
    """The smoke's (seed, schedule) pairs, at the smoke's load size."""
    r = _run(tmp_path, name, seed, ops_n=250)
    assert r["faults_injected"] > 0 and r["duplicates"] == 0
    assert r["acked"] == r["expected"] > 0
    kinds = r["cluster_events"]
    assert kinds.get("chaos_install", 0) >= 3 and kinds.get("chaos_clear", 0) >= 3


@pytest.mark.parametrize("name", ["crash_restart_heal", "flex_partition"])
def test_process_fault_and_flexible_quorum_schedules(tmp_path, name):
    """A follower killed and restarted from its durable store under load
    (the journals record its recovery), and the q2-sized island of the
    N = 5, (q1, q2) = (4, 2) cluster starved while the rest commits: the
    live watcher names the victim, and the stores hold."""
    from minpaxos_tpu_torch.chaos.campaign import SCHEDULE_SHAPES

    shape = SCHEDULE_SHAPES[name]
    r = _run(tmp_path, name, 1009, ops_n=250, n=shape.get("n", 3), q1=shape.get("q1", 0),
             q2=shape.get("q2", 0), durable=shape.get("durable", False),
             flags=shape.get("flags"))
    stall = r["watch"]["stall"]
    assert stall["fired_in_window"] and stall["attributed"] and stall["cleared"]
    if name == "crash_restart_heal":
        assert r["cluster_events"].get("recovery", 0) >= 1
        assert set(r["durability"]["log_bytes"]) == {"0", "1", "2"}
    else:
        assert r["q1"] == 4 and r["q2"] == 2


def test_faultplan_replay_of_a_counterexample(tmp_path):
    """The broken-quorum counterexample, projected by the port's
    ``counterexample_faultplan`` (as ``cli/chaos.py --plan-file`` does
    with a raw trace), blocks its links on a live cluster: faults are
    injected, the healed cluster commits and passes the checker."""
    from minpaxos_tpu_torch.verify.mc import counterexample_faultplan

    ce = json.load(open(os.path.join(ROOT, "tests", "fixtures",
                                     "mc_broken_quorum_minpaxos.json")))
    doc = counterexample_faultplan(ce, device="cpu")
    events = [tuple(e) for e in doc["events"]]
    r = _run(tmp_path, "mc_replay", 1009, ops_n=400, events=events)
    assert r["faults_injected"] > 0 and r["resumed_commits"]
    assert r["acked"] == r["expected"] > 0 and r["duplicates"] == 0


def test_chaos_cli_smoke_on_the_cpu(tmp_path, capsys):
    """``python -m minpaxos_tpu_torch.cli.chaos --smoke --device cpu``
    (in process): both pairs pass inside the smoke's budget."""
    from minpaxos_tpu_torch.cli import chaos

    out = tmp_path / "verdict.json"
    assert chaos.main(["--smoke", "--device", "cpu", "--json", str(out)]) == 0
    v = json.loads(out.read_text())
    assert v["ok"] and v["device"] == "cpu"
    assert [(r["seed"], r["schedule"]) for r in v["runs"]] == [
        (1009, "partition_heal"), (2003, "loss_reorder")]
    assert "[chaos] verdict:" in capsys.readouterr().out


def test_chaos_cli_refuses_a_missing_card():
    """The CLI defaults to the card and does not fall back to the CPU."""
    from minpaxos_tpu_torch.cli import chaos

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        chaos.main(["--smoke"])
    with pytest.raises(SystemExit):
        chaos.main(["--schedules", "no_such_schedule", "--device", "cpu"])


def test_live_stats_carry_every_watched_metric(harness):
    """Every metric the watcher reads is in a live port server's
    ``metrics.snapshot()`` under the name the JAX package's servers use,
    and one master ``stats`` fan-out flattens to a full health sample."""
    from minpaxos_tpu.obs.watch import flatten_cluster_stats as ref_flatten
    from minpaxos_tpu_torch.obs.watch import flatten_cluster_stats
    from minpaxos_tpu_torch.runtime.master import cluster_stats

    h = harness()
    mx = h.control(0, {"m": "stats"})["metrics"]
    for name in ("proposals", "proposals_rejected", "elections", "narrow_fallbacks"):
        assert name in mx["counters"], name
    for name in ("chaos_injected", "events", "events_dropped"):
        assert name in mx["gauges"], name
    hist = mx["histograms"]["tick_wall_ms"]
    assert {"bounds", "counts", "count"} <= set(hist)
    assert len(hist["counts"]) == len(hist["bounds"]) + 1
    resp = cluster_stats(("127.0.0.1", h.mport))
    sample = flatten_cluster_stats(resp, slo_ms=50.0, t_wall=1.0)
    assert sample == ref_flatten(resp, slo_ms=50.0, t_wall=1.0)
    assert sample["alive"] == 3 and sample["leader"] == 0
    assert sample["replicas"]["0"]["elections"] >= 1
    assert sample["replicas"]["0"]["events"] >= 1  # its election, at least
    assert sample["hist_total"] > 0
