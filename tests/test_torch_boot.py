"""A port cluster's boot election: a prepare round that takes longer
than the leader's re-prepare interval, and peers that started first.

Replica 0 elects itself at boot and, while it stays unprepared, runs the
prepare round again at a fresh ballot. Each new ballot makes the replies
to the last one stale, so a round trip longer than that interval must
not restart the round forever: three or five servers stepping in one
loaded process (the chaos campaign's clusters under a parallel test
run) take that long. Here every peer link delays each frame with the
chaos shim, which makes the round trip slow on purpose. And the boot
waits for the peers' links on that condition, not on its 15 s clock:
peers that started before replica 0 listened had their one dial
refused.
"""

from __future__ import annotations

import time

import pytest
import torch

from minpaxos_tpu_torch.chaos import ChaosShim, FaultPlan
from minpaxos_tpu_torch.chaos.campaign import campaign_config
from minpaxos_tpu_torch.runtime.client import Client, gen_workload
from minpaxos_tpu_torch.runtime.master import Master, _rpc
from minpaxos_tpu_torch.runtime.replica import ReplicaServer, RuntimeFlags
from minpaxos_tpu_torch.utils.netutil import CONTROL_OFFSET, free_ports

torch.set_num_threads(1)

# the campaign's boot deadline (chaos/campaign.py ChaosCluster)
BOOT_S = 20.0


@pytest.mark.parametrize("n,q1,q2,delay_s", [(3, 0, 0, 0.4), (5, 4, 2, 0.3)])
def test_boot_prepares_when_the_round_trip_outlasts_the_retry(n, q1, q2, delay_s, tmp_path):
    """Every peer frame delayed ``delay_s``: a PREPARE and its replies
    take at least twice that, more than the 0.5 s before the first
    re-prepare. The leader still prepares within the boot deadline and
    the cluster then commits checked PUTs through the same slow links."""
    mport = free_ports(1)[0]
    addrs = [("127.0.0.1", p) for p in free_ports(n, sibling_offset=CONTROL_OFFSET)]
    master = Master("127.0.0.1", mport, n, ping_s=0.3)
    master.start()
    servers = []
    try:
        for i, (host, port) in enumerate(addrs):
            assert _rpc(("127.0.0.1", mport), {"m": "register", "addr": host,
                                                "port": port})["id"] == i
        plan = FaultPlan(n, seed=7)
        for a in range(n):
            for b in range(n):
                if a != b:
                    plan.set_link(a, b, delay_s=delay_s)
        cfg = campaign_config(n, q1, q2)
        for i in range(n):
            s = ReplicaServer(i, addrs, cfg, RuntimeFlags(tick_s=0.001, device="cpu",
                                                           store_dir=str(tmp_path)))
            s.transport.set_chaos(ChaosShim(i, plan, s.queue))
            servers.append(s)
        t0 = time.monotonic()
        for s in servers:
            s.start()
        while not servers[0].snapshot["prepared"]:
            assert time.monotonic() - t0 < BOOT_S, (
                f"leader not prepared within {BOOT_S} s: "
                f"{servers[0].stats['elections']} elections")
            time.sleep(0.05)
        cli = Client(("127.0.0.1", mport), check=True)
        ops, keys, vals = gen_workload(40, seed=3)
        st = cli.run_workload(ops, keys, vals, batch=20, timeout_s=60)
        cli.close_conn()
        assert st["acked"] == 40 and st["duplicates"] == 0, st
    finally:
        for s in servers:
            s.transport.set_chaos(None)  # its delay pump thread ends
            s.stop()
        master.stop()


def test_boot_election_dials_peers_that_started_first(tmp_path):
    """Replica 0 starts listening after its peers: their one dial at
    start was refused. Its boot wait dials them itself, so the leader
    prepares at once instead of after the 15 s peer wait runs out (the
    server processes of one deployment start in any order)."""
    mport = free_ports(1)[0]
    addrs = [("127.0.0.1", p) for p in free_ports(3, sibling_offset=CONTROL_OFFSET)]
    master = Master("127.0.0.1", mport, 3, ping_s=0.3)
    master.start()
    servers = []
    try:
        for i, (host, port) in enumerate(addrs):
            assert _rpc(("127.0.0.1", mport), {"m": "register", "addr": host,
                                                "port": port})["id"] == i
        cfg = campaign_config(3)
        servers = [ReplicaServer(i, addrs, cfg, RuntimeFlags(tick_s=0.001, device="cpu",
                                                             store_dir=str(tmp_path)))
                   for i in range(3)]
        servers[2].start()
        servers[1].start()
        assert not servers[1].transport.peer_alive(0)  # its dial was refused
        t0 = time.monotonic()
        servers[0].start()
        while not servers[0].snapshot["prepared"]:
            assert time.monotonic() - t0 < 10.0, "leader not prepared within 10 s"
            time.sleep(0.05)
        assert all(servers[0].transport.peer_alive(q) for q in (1, 2))
    finally:
        for s in servers:
            s.stop()
        master.stop()
