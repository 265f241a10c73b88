"""The soak harness's load side against a cluster of the port's replica
servers on the CPU (the port's ``ChaosCluster`` at ``campaign_config``'s
shape): ``ClientSwarm``'s closed-loop sessions through the ingress
coalescer, the sharded open-loop ``OpenLoopSwarm``, and the JAX
package's ``ClientSwarm`` over the shared wire. Every command is acked
exactly once, and both packages' ``check_cluster`` hold the stores
afterwards. The mirrors of ``tests/test_swarm.py`` and
``tests/test_soak.py``'s swarm leg, with their sizes and deadlines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from minpaxos_tpu_torch.chaos.campaign import ChaosCluster
from minpaxos_tpu_torch.runtime.client import ClientSwarm, gen_workload
from minpaxos_tpu_torch.soak.profiles import ArrivalSpec
from tests.test_torch_serving import hold_to_reference

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _settle_and_stop(c: ChaosCluster) -> None:
    """Every replica has committed every slot any of them has seen,
    then the cluster stops (its stores closed)."""
    def lag():
        fr = [s.snapshot["frontier"] for s in c.servers.values()]
        return max(fr) - min(fr)

    deadline = time.monotonic() + 30
    while lag() and time.monotonic() < deadline:
        time.sleep(0.05)
    c.stop()


def _parked(server, timeout_s: float = 10.0) -> None:
    """Until ``server``'s tick loop has idled twice (its idle fast path
    answered two timer wakeups): it then sits parked on the ingress
    queue, and a burst of proposes wakes it. Straight after the boot
    the leader may not have idled yet."""
    n0 = server.stats["idle_skips"]
    deadline = time.monotonic() + timeout_s
    while server.stats["idle_skips"] < n0 + 2 and time.monotonic() < deadline:
        time.sleep(0.01)


def _run_swarm(tmp_path, swarm_cls, sessions: int, ops_per_session: int,
               timeout_s: float) -> dict:
    """One swarm against a fresh port cluster, from a parked leader; the
    leader's coalescer evidence; every command in both packages'
    invariants (each acked command committed, nothing invented)."""
    c = ChaosCluster(n=3, store_dir=str(tmp_path), device="cpu")
    try:
        _parked(c.servers[0])
        n = sessions * ops_per_session
        wl = gen_workload(n, key_range=1000, seed=3)
        swarm = swarm_cls(c.maddr, sessions=sessions)
        try:
            res = swarm.run(*wl, ops_per_session, timeout_s=timeout_s)
        finally:
            swarm.close()
        res["leader_stats"] = c.servers[0].stats
        res["hist"] = (c.servers[0].metrics.snapshot().get("histograms")
                       or {}).get("coalesce_batch_rows")
    finally:
        _settle_and_stop(c)
    if res["acked"] == res["sent"]:
        replies = {i: {"val": None} for i in range(n)}  # every command a PUT
        hold_to_reference(str(tmp_path), 3, replies, wl)
    return res


def _exactly_once_with_coalescing(res, n):
    assert res["acked"] == res["sent"] == n, res
    assert res["dead_sessions"] == 0, res
    assert len(res["lat_ms_sorted"]) == n
    assert res["leader_stats"].get("coalesce_wakeups", 0) > 0, res["leader_stats"]
    assert res["hist"] and res["hist"]["count"] > 0, res["hist"]


def test_swarm_64_sessions_exactly_once(tmp_path):
    """64 concurrent closed-loop sessions of the port's ClientSwarm:
    256 of 256 acked, the leader's coalescer woke for them and drained
    multi-row batches."""
    res = _run_swarm(tmp_path, ClientSwarm, 64, 4, 60.0)
    _exactly_once_with_coalescing(res, 256)


def test_reference_swarm_drives_a_port_cluster(tmp_path):
    """The JAX package's ClientSwarm over the shared wire against the
    port's servers: the same exactly-once and coalescing evidence."""
    from minpaxos_tpu.runtime.client import ClientSwarm as RefSwarm

    res = _run_swarm(tmp_path, RefSwarm, 64, 4, 60.0)
    _exactly_once_with_coalescing(res, 256)


@pytest.mark.slow
def test_swarm_1k_sessions_bounded_queueing(tmp_path):
    """1024 concurrent sessions: overload may engage the admission gate
    (counted rejects + client retransmits), but every command is still
    acked exactly once."""
    res = _run_swarm(tmp_path, ClientSwarm, 1024, 2, 180.0)
    assert res["acked"] == res["sent"] == 2048, res
    assert res["dead_sessions"] == 0, res
    assert res["leader_stats"].get("coalesce_wakeups", 0) > 0, res["leader_stats"]


def test_open_loop_swarm_exactly_once(tmp_path):
    """2 worker processes x 8 sessions of seeded open-loop traffic: every
    injected command acked exactly once across shards after the drain
    (0 lost), each in the log as the shard's schedule made it, and the
    stores hold under both packages' invariants."""
    import chip_smoke

    from minpaxos_tpu_torch.soak.swarm import OpenLoopSwarm, phase_rows

    arrival = ArrivalSpec(rate_hz=150.0, duration_s=3.0)
    c = ChaosCluster(n=3, store_dir=str(tmp_path), device="cpu")
    swarm = None
    try:
        swarm = OpenLoopSwarm(c.maddr, sessions=16, shards=2, retransmit_s=0.5,
                              trace_pow2=None)
        swarm.start()
        res = swarm.run_phase("mixed", arrival, seed=11)
        assert res["sent"] > 200, res  # open loop: ~450 expected
        drain = swarm.drain(20.0)
        final = swarm.stop()
        swarm = None
        assert final["lost"] == 0, (res, drain, final)
        assert final["acked_unique"] == final["sent_unique"] > 0, final
        assert final["dead_sessions"] == 0, final
    finally:
        if swarm is not None:
            swarm.kill()
        _settle_and_stop(c)
    hold_to_reference(str(tmp_path), 3)
    tables = [rows[1:] for rows in phase_rows("mixed", arrival, 11, 2)]
    assert sum(len(t[0]) for t in tables) == final["sent_unique"]
    from minpaxos_tpu_torch.runtime.stable import StableStore

    store = StableStore(str(tmp_path / "stable-store-replica0"), sync=False)
    try:
        log = chip_smoke.swarm_log_check(store.read_range(0, store.committed_prefix()),
                                         tables)
    finally:
        store.close()
    assert log["swarm_unmatched"] == 0, log
    assert log["swarm_commands"] == final["sent_unique"], log


def test_phase_schedule_is_the_references():
    """What the port's shards inject in a phase (``phase_rows``) is what
    the JAX package's shards compute from the same (profile, arrival,
    seed, shards): its swarm's per-shard rate and seed, then its
    ``arrival_times`` and ``profile_rows``."""
    from minpaxos_tpu.soak import profiles as ref
    from minpaxos_tpu_torch.soak.swarm import phase_rows

    arrival = ArrivalSpec(rate_hz=300.0, duration_s=12.0, burst_x=9.0,
                          burst_t0_frac=0.2, burst_t1_frac=0.45)
    for shards in (1, 2, 8):
        got = phase_rows("write_storm", arrival.to_dict(), 25, shards)
        assert len(got) == shards
        for sh, rows in enumerate(got):
            spec = ref.ArrivalSpec.from_dict({**arrival.to_dict(),
                                              "rate_hz": arrival.rate_hz / shards})
            seed = 25 * 131 + sh
            offs = ref.arrival_times(spec, seed)
            want = (offs, *ref.profile_rows(ref.PROFILES["write_storm"], len(offs),
                                            seed ^ 0x9E3779B9))
            for g, w in zip(rows, want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


_WORKER = """
import json, sys

from minpaxos_tpu_torch.soak.swarm import OpenLoopSwarm

if __name__ == "__main__":
    swarm = OpenLoopSwarm(("127.0.0.1", int(sys.argv[1])), sessions=4, shards=1,
                          retransmit_s=0.5)
    swarm.start(timeout_s=60)
    res = swarm.run_phase("uniform", {"rate_hz": 40.0, "duration_s": 1.0}, 5)
    swarm.drain(20.0)
    final = swarm.stop()
    print(json.dumps({"sent": res["sent"], "acked": final["acked_unique"],
                      "lost": final["lost"]}))
"""


def test_a_shard_worker_imports_no_torch_jax_or_reference(tmp_path):
    """A spawned shard worker runs with torch, jax and minpaxos_tpu
    unimportable: a driver script that cannot import them either starts
    one worker against a live port cluster, which connects, injects a
    phase and drains it with nothing lost. (spawn starts the worker
    with this module's import path and, by ``soak/swarm.py``'s guard,
    not with the driver's ``__main__``.)"""
    blocked = tmp_path / "blocked"
    for name in ("torch", "jax", "minpaxos_tpu"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in the swarm worker')\n")
    driver = tmp_path / "driver.py"
    driver.write_text(_WORKER)
    (tmp_path / "stores").mkdir()
    c = ChaosCluster(n=3, store_dir=str(tmp_path / "stores"), device="cpu")
    try:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocked), ROOT]))
        out = subprocess.run([sys.executable, str(driver), str(c.mport)],
                             capture_output=True, text=True, timeout=120, env=env,
                             cwd=str(tmp_path))
    finally:
        _settle_and_stop(c)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["lost"] == 0 and res["acked"] == res["sent"] > 0, res


def test_the_spawn_guard_restores_the_parents_main():
    """``_spawn_main_here`` names the swarm module to spawn only while
    workers start, and leaves ``__main__`` as it found it."""
    from minpaxos_tpu_torch.soak import swarm

    main = sys.modules["__main__"]
    had = "__spec__" in vars(main)
    before = getattr(main, "__spec__", None)
    with swarm._spawn_main_here():
        assert main.__spec__.name == "minpaxos_tpu_torch.soak.swarm"
    assert ("__spec__" in vars(main)) == had
    assert getattr(main, "__spec__", None) is before


def test_client_connections_share_one_reader_thread(tmp_path):
    """A server reads every client connection in one selector loop, not
    a thread per connection: 256 open sessions add no thread to the
    process (a host that limits a process's threads ended the leader of
    a 4,096-session swarm). Each session still gets its reply."""
    import socket

    c = ChaosCluster(n=3, store_dir=str(tmp_path), device="cpu")
    socks = []
    lock = threading.Lock()
    host, port = c.addrs[0]

    def dial(k):
        for _ in range(k):
            s = socket.create_connection((host, port), timeout=10)
            s.sendall(bytes([120]))  # HANDSHAKE_CLIENT
            with lock:
                socks.append(s)

    switch = sys.getswitchinterval()
    try:
        _parked(c.servers[0])
        before = threading.active_count()
        # 16 dialers at once, thread switches forced often: every
        # registration races the selector loop's reads
        sys.setswitchinterval(1e-5)
        dialers = [threading.Thread(target=dial, args=(16,)) for _ in range(16)]
        for t in dialers:
            t.start()
        for t in dialers:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in dialers)
        sys.setswitchinterval(switch)
        deadline = time.monotonic() + 10
        while (len(c.servers[0].transport.clients) < 256
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert len(c.servers[0].transport.clients) == 256
        time.sleep(0.2)  # the handshake threads end
        assert threading.active_count() - before < 8, threading.active_count() - before
    finally:
        sys.setswitchinterval(switch)
        for s in socks:
            s.close()
        _settle_and_stop(c)
    (tmp_path / "swarm").mkdir()
    res = _run_swarm(tmp_path / "swarm", ClientSwarm, 256, 1, 60.0)
    assert res["acked"] == res["sent"] == 256, res
