"""paxtrace and the flight recorder on a live port cluster, on the CPU.

A master and three port replica servers (the ``tests/test_torch_serving.py``
harness, servers stepped on the CPU) with every command traced
(``trace_pow2 = 0``): the ``tracespans`` verb and the master's fan-out
give three collections which, with the client's, join into complete
chains whose stage sums equal their totals; the JAX package's client
traces through the same cluster (the wire is unchanged); the JAX
package's ``tools/tail.py`` and the port's ``cli/tail.py``, run as
subprocesses, agree, and both ``-dump-trace`` files pass both packages'
validators; the stores then pass both packages' ``check_cluster``.
Apart: ``trace=False`` is silent, ``recorder=False`` empties ``trace``
but not ``stats``, and ``cli/tail.py`` runs with torch and the JAX
package blocked.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from minpaxos_tpu.obs import recorder as jrec
from minpaxos_tpu_torch.obs import recorder as rec
from minpaxos_tpu_torch.obs import trace as T
from minpaxos_tpu_torch.runtime.client import Client
from minpaxos_tpu_torch.runtime.master import cluster_trace, cluster_tracespans
from minpaxos_tpu_torch.wire.messages import MsgKind
from tests.test_torch_serving import Harness, Workload, hold_to_reference

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OPS = 120
TOOLS = {"jax": [os.path.join(ROOT, "tools", "tail.py")],
         "port": ["-m", "minpaxos_tpu_torch.cli.tail"]}


def _tail(tool: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *TOOLS[tool], *args], capture_output=True,
                          text=True, timeout=120, cwd=ROOT, env=env)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The traced cluster after 120 checked PUTs from the port's client
    and 120 more from the JAX package's (cmd_ids 120..239), both with
    ``trace_pow2=0``. Yields (harness, store dir, workload, the port
    client's collection and replies, the JAX client's)."""
    from minpaxos_tpu.runtime.client import Client as JaxClient

    store = tmp_path_factory.mktemp("traced")
    h = Harness(store, durable=True, flags={"trace_pow2": 0})
    try:
        wl = Workload()
        ids = wl.add(N_OPS, seed=11)
        cli = Client(("127.0.0.1", h.mport), check=True, trace_pow2=0)
        st = wl.run(cli, ids, timeout_s=60)
        assert st["acked"] == N_OPS and st["duplicates"] == 0, st
        cli.close_conn()
        jids = wl.add(N_OPS, seed=12)
        jcli = JaxClient(("127.0.0.1", h.mport), check=True, trace_pow2=0)
        jst = jcli.run_partition(jids, *wl.table, timeout_s=60)
        assert jst["acked"] == N_OPS and jst["duplicates"] == 0, jst
        jcli.close_conn()
        yield dict(h=h, store=str(store), wl=wl, port=cli.trace_collect(),
                   jax=jcli.trace_collect(), replies={**cli.replies, **jcli.replies})
    finally:
        h.stop()


def _chains(colls, lo, hi):
    decomp = T.stage_decomposition(T.span_chains(T.align_collections(colls)))
    return [d for d in decomp if lo <= d["cmd_id"] < hi]


def test_tracespans_verb_and_fanout_give_complete_chains(traced):
    h = traced["h"]
    r = h.control(0, {"m": "tracespans"})
    assert r["ok"] and r["trace"]["enabled"] and r["trace"]["sample_pow2"] == 0
    assert r["trace"]["total"] > 0 and r["trace"]["anchor"]["mono_ns"] > 0
    st = h.control(0, {"m": "stats"})
    assert st["metrics"]["gauges"]["trace_spans"] >= r["trace"]["total"]
    assert st["metrics"]["gauges"]["trace_dropped"] == 0
    resp = cluster_tracespans(("127.0.0.1", h.mport))
    assert resp["ok"] and len(resp["replicas"]) == 3
    colls = [rr["trace"] for rr in resp["replicas"] if rr.get("ok")]
    assert len(colls) == 3
    decomp = _chains(colls + [traced["port"]], 0, N_OPS)
    assert len(decomp) >= 100, len(decomp)
    for d in decomp:
        assert abs(sum(d["stages"].values()) - d["total_ms"]) < 1e-9
        assert d["total_ms"] > 0 and d["stages"]["transport_out"] >= 0
    tab = T.stage_table(decomp)
    assert tab["n_traced"] == len(decomp)
    assert tab["tail"]["worst_stage"] in T.DECOMP_STAGES
    # cluster-only chains start at the replica's echo of the origin
    cluster_only = _chains(colls, 0, N_OPS)
    assert len(cluster_only) >= 100
    assert all(d["stages"]["transport_out"] == 0 for d in cluster_only)


def test_jax_client_traces_through_a_port_cluster(traced):
    """The JAX package's client's ctx frames and spans join the port
    servers' spans: the wire is unchanged."""
    resp = cluster_tracespans(("127.0.0.1", traced["h"].mport))
    colls = [rr["trace"] for rr in resp["replicas"] if rr.get("ok")]
    decomp = _chains(colls + [traced["jax"]], N_OPS, 2 * N_OPS)
    assert len(decomp) >= 100, len(decomp)
    for d in decomp:
        assert abs(sum(d["stages"].values()) - d["total_ms"]) < 1e-9


def test_multiclient_traces_every_connection(traced):
    """``MultiClient(trace_pow2=)`` gives each connection its own sink;
    ``trace_collect`` returns one collection per connection."""
    from minpaxos_tpu_torch.runtime.client import MultiClient

    mc = MultiClient(("127.0.0.1", traced["h"].mport), check=True, trace_pow2=0)
    try:
        assert all(c.trace is not None and c.trace.sample_pow2 == 0 for c in mc.clients)
        colls = mc.trace_collect()
        assert len(colls) == 3 and all(c["enabled"] and c["total"] == 0 for c in colls)
    finally:
        mc.close()
    plain = MultiClient(("127.0.0.1", traced["h"].mport), check=True)
    try:
        assert plain.trace_collect() == []
    finally:
        plain.close()


def test_trace_verb_and_fanout_merge_the_recorders(traced):
    h = traced["h"]
    r = h.control(1, {"m": "trace", "last": 64})
    assert r["ok"] and r["recorder"] is True
    ticks = [e for e in r["events"] if e.get("cat") == "tick"]
    assert 0 < len(ticks) <= 64 and all(e["pid"] == 1 for e in ticks)
    assert {e["name"] for e in r["events"] if e.get("cat") == "phase"} >= {
        "enqueue", "readback", "persist", "dispatch", "reply"}
    watch = [e for e in r["events"] if e.get("cat") == "paxwatch"]
    assert watch and all(e["pid"] == rec.WATCH_PID and e["tid"] == 1 for e in watch)
    merged = cluster_trace(("127.0.0.1", h.mport), last=256)["trace"]
    assert rec.validate_chrome_trace(merged) == []
    assert jrec.validate_chrome_trace(merged) == []
    assert {0, 1, 2} <= {e["pid"] for e in merged["traceEvents"]}
    # the rows a dispatch recorded carry the rows it drained
    rows = h.servers[0].recorder.snapshot()
    assert rows[:, rec.F_ROWS_IN].sum() >= N_OPS
    assert set(rows[:, rec.F_KIND].tolist()) <= {rec.KIND_FULL, rec.KIND_FUSED,
                                                 rec.KIND_NARROW, rec.KIND_IDLE_SKIP}


def test_both_tail_tools_agree(traced):
    h = traced["h"]
    payloads = {}
    for tool in TOOLS:
        out = _tail(tool, "-mport", str(h.mport), "--once", "--json")
        assert out.returncode == 0, (tool, out.stderr)
        payloads[tool] = json.loads(out.stdout)
    jt, pt = payloads["jax"]["stage_table"], payloads["port"]["stage_table"]
    assert pt["n_traced"] == jt["n_traced"] >= 200
    assert list(pt["stages"]) == list(jt["stages"]) == list(T.DECOMP_STAGES)
    assert pt["tail"]["worst_stage"] in T.DECOMP_STAGES
    text = _tail("port", "-mport", str(h.mport))
    assert text.returncode == 0 and "paxtrace stage decomposition" in text.stdout


@pytest.mark.parametrize("tool", ["jax", "port"])
def test_dump_trace_files_validate_in_both_packages(traced, tool, tmp_path):
    path = tmp_path / f"{tool}.json"
    out = _tail(tool, "-mport", str(traced["h"].mport), "-dump-trace", str(path),
                "-last", "256")
    assert out.returncode == 0, out.stderr
    merged = json.loads(path.read_text())
    assert rec.validate_chrome_trace(merged) == []
    assert jrec.validate_chrome_trace(merged) == []
    pids = {e["pid"] for e in merged["traceEvents"]}
    assert {0, 1, 2, rec.TRACE_PID, rec.WATCH_PID} <= pids


def test_tail_runs_with_torch_and_the_jax_package_blocked(traced, tmp_path):
    """``cli/tail.py`` imports neither: run in a subprocess with both
    blocked, on the cluster's saved collections and on the live cluster."""
    resp = cluster_tracespans(("127.0.0.1", traced["h"].mport))
    spans = tmp_path / "spans.json"
    spans.write_text(json.dumps([rr["trace"] for rr in resp["replicas"]]))
    for args in (["-spans-file", str(spans), "--json"],
                 ["-mport", str(traced["h"].mport), "--json"]):
        code = (
            "import sys, runpy, json\n"
            "for m in ('torch', 'jax', 'minpaxos_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['tail'] + {args!r}\n"
            "try:\n"
            "    runpy.run_module('minpaxos_tpu_torch.cli.tail', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "loaded = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "                ('torch', 'jax', 'minpaxos_tpu') and sys.modules[m] is not None)\n"
            "print(json.dumps(loaded))\n")
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=120, cwd=ROOT, env=env)
        assert out.returncode == 0, out.stderr
        first, last = out.stdout.strip().splitlines()[0], out.stdout.strip().splitlines()[-1]
        assert json.loads(first)["stage_table"]["n_traced"] >= 100
        assert json.loads(last) == []


def test_stores_hold_to_the_reference(traced):
    """Last in this file: the traced cluster stopped, its stores with
    both clients' replies pass both packages' check_cluster."""
    h = traced["h"]
    h.wait(lambda: min(s.snapshot["frontier"] for s in h.servers.values())
           >= max(s.snapshot.get("crt_inst", 0) for s in h.servers.values()) - 1,
           30, "cluster never settled")
    h.stop()
    hold_to_reference(traced["store"], 3, traced["replies"], traced["wl"].table)


class _KindCounter:
    """Wraps a FrameWriter: counts the frames written per kind."""

    def __init__(self, writer):
        self.writer, self.kinds = writer, []

    def write(self, kind, rows):
        self.kinds.append(int(kind))
        self.writer.write(kind, rows)

    def flush(self):
        self.writer.flush()


def test_notrace_is_silent(tmp_path):
    """``trace=False`` (``-notrace``): no spans, ``tracespans`` ok and
    empty, and a client without tracing sends no ctx frame."""
    h = Harness(tmp_path, flags={"trace": False})
    try:
        cli = Client(("127.0.0.1", h.mport), check=True)
        cli.connect(0)
        cli.writer = _KindCounter(cli.writer)
        wl = Workload()
        ids = wl.add(40, seed=2)
        assert wl.run(cli, ids, timeout_s=60)["acked"] == 40
        assert cli.writer.kinds and set(cli.writer.kinds) == {int(MsgKind.PROPOSE)}
        assert cli.trace_collect() is None
        cli.close_conn()
        for i in range(3):
            r = h.control(i, {"m": "tracespans"})
            assert r["ok"] and r["trace"]["enabled"] is False
            assert r["trace"]["total"] == 0 and r["trace"]["spans"] == []
            assert h.servers[i].stats["trace_spans"] == 0
        # the recorder stays on
        assert h.control(0, {"m": "trace"})["events"]
    finally:
        h.stop()


def test_norecorder_disables_trace_not_stats(tmp_path):
    h = Harness(tmp_path, flags={"recorder": False})
    try:
        cli = h.client()
        ops, keys, vals = (np.full(20, 1, np.int64), np.arange(20, dtype=np.int64),
                           np.arange(20, dtype=np.int64) + 5)
        assert cli.run_workload(ops, keys, vals, timeout_s=60)["acked"] == 20
        cli.close_conn()
        r = h.control(0, {"m": "trace"})
        assert r == {"ok": True, "id": 0, "recorder": False, "events": []}
        st = h.control(0, {"m": "stats"})
        assert st["ok"] and st["metrics"]["counters"]["dispatches"] > 0
        assert st["metrics"]["histograms"]["tick_wall_ms"]["count"] > 0
        merged = cluster_trace(("127.0.0.1", h.mport))
        assert merged["ok"] and merged["trace"]["traceEvents"] == []
    finally:
        h.stop()
