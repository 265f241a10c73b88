"""Seeded chaos campaigns: boot a cluster, hurt the network, check it.

A *schedule* is a deterministic list of timed chaos events —
``(t_offset_s, "install"|"clear", plan_dict)`` — built from a name and
a seed by :func:`build_schedule`: same (name, seed, n) always yields
byte-identical events (the RNG stream is keyed by ``[seed,
crc32(name)]``, never the wall clock), and the plan's own network
decisions are keyed by a sub-seed drawn from the same stream. A
failing campaign therefore replays exactly from the seed it prints.

The port's copy of the JAX package's ``chaos/campaign.py``: the same
schedules, byte for byte, run against a cluster of the port's
``ReplicaServer``s, each stepping on ``device`` (the card unless the
caller asks for the CPU).

The runner boots a REAL in-process cluster (master + N ReplicaServer
threads + TCP sockets, one process, one card), drives closed-loop
load from a ``-check`` client while applying the schedule through the
master's ``cluster_chaos`` fan-out — the exact
path an operator uses against a live deployment — then heals, proves
the cluster still commits, waits for convergence, and runs the
invariant checker (verify/invariants.py, the same predicate suite the
paxmc bounded model checker proves exhaustively at small bounds) over
the quiesced stores.

Used by ``python -m minpaxos_tpu_torch.cli.chaos``, ``chip_smoke.py``'s
``chaos`` phase and the port's campaign tests.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
import zlib

import numpy as np

# the campaign certifies the SAME predicates the bounded model checker
# (verify/mc.py) explores exhaustively — one invariant catalogue, two
# provers (VERIFY.md)
from minpaxos_tpu_torch.chaos.plan import FaultPlan
from minpaxos_tpu_torch.obs.watch import SLO, HealthWatcher
from minpaxos_tpu_torch.verify.invariants import check_cluster

#: committed-frontier sample cadence during load (drives the
#: monotonicity check and the stall detector)
SAMPLE_S = 0.05

#: slots of post-install frontier advance still attributable to
#: in-flight traffic when judging "progress stalled"
STALL_SLACK_SLOTS = 8


# --------------------------------------------------------- schedules

def _rng_for(name: str, seed: int) -> np.random.Generator:
    # crc32, not hash(): schedule identity must survive PYTHONHASHSEED
    return np.random.default_rng([int(seed), zlib.crc32(name.encode())])


def build_schedule(name: str, seed: int, n: int) -> list[tuple]:
    """Deterministic timed chaos events for one named schedule."""
    rng = _rng_for(name, seed)
    sub = int(rng.integers(1 << 30))  # the plan's network-decision seed

    def plan() -> FaultPlan:
        return FaultPlan(n, seed=sub)

    events: list[tuple] = []
    if name == "partition_heal":
        victim = int(rng.integers(1, n))  # a follower: progress continues
        t0 = 0.2 + float(rng.random()) * 0.2
        dur = 0.8 + float(rng.random()) * 0.7
        events = [(t0, "install", plan().isolate(victim).to_dict()),
                  (t0 + dur, "clear", None)]
    elif name == "isolated_leader":
        t0 = 0.25 + float(rng.random()) * 0.15
        dur = 1.2 + float(rng.random()) * 0.6
        events = [(t0, "install", plan().isolate(0).to_dict()),
                  (t0 + dur, "clear", None)]
    elif name == "flap":
        # a link pair that flips up and down: the dial/backoff and
        # retry machinery's worst case
        a = int(rng.integers(0, n))
        b = int((a + 1 + rng.integers(0, n - 1)) % n)
        t = 0.2
        for _ in range(int(rng.integers(3, 6))):
            period = 0.2 + float(rng.random()) * 0.2
            events.append((t, "install",
                           plan().partition([a], [b]).to_dict()))
            events.append((t + period, "clear", None))
            t += 2 * period
    elif name == "loss_reorder":
        dur = 2.5 + float(rng.random())
        events = [(0.0, "install",
                   plan().all_links(drop=0.10, reorder=4).to_dict()),
                  (dur, "clear", None)]
    elif name == "one_way":
        src = int(rng.integers(0, n))
        dst = int((src + 1 + rng.integers(0, n - 1)) % n)
        t0 = 0.2
        dur = 1.0 + float(rng.random()) * 0.8
        events = [(t0, "install",
                   plan().partition([src], [dst], one_way=True).to_dict()),
                  (t0 + dur, "clear", None)]
    elif name == "delay_jitter":
        dur = 2.0 + float(rng.random())
        events = [(0.0, "install",
                   plan().all_links(delay_s=0.01,
                                    jitter_s=0.03).to_dict()),
                  (dur, "clear", None)]
    elif name == "dup_storm":
        dur = 2.0 + float(rng.random())
        events = [(0.0, "install", plan().all_links(dup=0.30).to_dict()),
                  (dur, "clear", None)]
    elif name == "mixed":
        dur = 2.5 + float(rng.random())
        events = [(0.0, "install",
                   plan().all_links(drop=0.05, dup=0.10, delay_s=0.004,
                                    jitter_s=0.008,
                                    reorder=3).to_dict()),
                  (dur, "clear", None)]
    elif name == "crash_restart_heal":
        # kill a FOLLOWER process mid-load (buffered store bytes lost,
        # kernel-reached bytes kept — stable.crash()), leave it dead
        # long enough for the paxwatch dead-replica stall alarm to
        # raise, then restart it on the SAME dirs: it must recover from
        # snapshot + redo suffix, catch up over the wire, and converge
        # byte-identical (the checker's slot-agreement over quiesced
        # stores). Ops "kill"/"restart" are process faults the runner
        # applies directly to the in-process cluster — no network shim.
        victim = int(rng.integers(1, n))
        t0 = 0.3 + float(rng.random()) * 0.2
        # the corpse must stay down long enough for the dead-replica
        # stall detector to see a full stall window of silence (0.6 s
        # SLO window + the master's 0.3 s ping cadence + poll jitter)
        down = 1.5 + float(rng.random()) * 0.5
        events = [(t0, "kill", {"rid": victim}),
                  (t0 + down, "restart", {"rid": victim})]
    elif name == "torn_snapshot_recovery":
        # same crash/restart arc, but the victim's store file is
        # damaged while it is down — the tail torn off (a crash mid
        # write) or one byte flipped (media corruption): replay must
        # truncate/CRC-skip the damage, fall back to the previous
        # snapshot where needed, and the replica still converges
        victim = int(rng.integers(1, n))
        t0 = 0.3 + float(rng.random()) * 0.2
        down = 1.5 + float(rng.random()) * 0.5  # see crash_restart_heal
        mode = "tear" if rng.random() < 0.5 else "bitflip"
        events = [(t0, "kill", {"rid": victim}),
                  (t0 + down * 0.5, "tear",
                   {"rid": victim, "mode": mode,
                    "nbytes": int(rng.integers(16, 512))}),
                  (t0 + down, "restart", {"rid": victim})]
    elif name == "flex_partition":
        # the flexible-quorum non-intersection probe: cut
        # off EXACTLY the q2-sized minority {n-2, n-1} under load. The
        # quorum certificate (q1 + q2 > n) says the majority side keeps
        # committing (it still holds a phase-2 quorum) while the island
        # can neither commit (no leader inside) nor elect one (q1
        # requires replicas it cannot reach) — no split-brain, just a
        # starved minority the paxwatch stall detector must name.
        t0 = 0.25 + float(rng.random()) * 0.15
        dur = 1.2 + float(rng.random()) * 0.5
        island = [n - 2, n - 1]
        rest = list(range(n - 2))
        events = [(t0, "install",
                   plan().partition(rest, island).to_dict()),
                  (t0 + dur, "clear", None)]
    else:
        raise ValueError(f"unknown schedule {name!r}")
    return events


SCHEDULES = ("partition_heal", "isolated_leader", "flap", "loss_reorder",
             "one_way", "delay_jitter", "dup_storm", "mixed",
             "flex_partition", "crash_restart_heal",
             "torn_snapshot_recovery")

#: schedules whose faults are PROCESS faults (kill/tear/restart applied
#: by the runner to the in-process cluster, not network shims via the
#: master fan-out): the fault count comes from the runner's own event
#: tally and the chaos_install journal floor does not apply
CRASH_SCHEDULES = frozenset({"crash_restart_heal",
                             "torn_snapshot_recovery"})

#: schedules whose fault makes commit progress IMPOSSIBLE while
#: installed (leader cut off from every quorum): the runner verifies
#: the stall instead of expecting mid-fault progress
STALL_SCHEDULES = frozenset({"isolated_leader"})

#: schedules where the fault starves a strict MINORITY while the
#: cluster keeps committing: the runner asserts the paxwatch
#: frontier-stall alarm fired LIVE naming a starved replica (and
#: cleared after heal) instead of a global stall
STARVED_SCHEDULES = frozenset({"flex_partition"})

#: schedules that require a specific cluster shape — run_campaign
#: applies these per-run overrides (n and the flexible quorum pair)
#: regardless of the campaign-wide defaults. flex_partition probes the
#: certified N=5 (q1=4, q2=2) point: the smallest shipped config where
#: the phase-2 quorum is a strict minority (quorum_golden.py)
SCHEDULE_SHAPES: dict[str, dict] = {
    "flex_partition": {"n": 5, "q1": 4, "q2": 2},
    # crash schedules need durable stores to recover from, and a small
    # snapshot threshold so the few-second run actually checkpoints
    # and truncates (the 8 MiB default would never trigger)
    "crash_restart_heal": {"durable": True,
                           "flags": {"snap_every_bytes": 32768}},
    "torn_snapshot_recovery": {"durable": True,
                               "flags": {"snap_every_bytes": 32768}},
}


# ---------------------------------------------------------- cluster

def campaign_config(n: int = 3, q1: int = 0, q2: int = 0):
    """The campaign cluster's MinPaxosConfig (the reference campaign's
    shape; ``chip_smoke.py`` holds the kernels to their twins at it)."""
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig

    return MinPaxosConfig(
        n_replicas=n, window=1 << 10, inbox=1024, exec_batch=512,
        kv_pow2=12, catchup_rows=64, recovery_rows=64, q1=q1, q2=q2)


class ChaosCluster:
    """In-process master + N replicas on fresh localhost ports, every
    replica's step on ``device`` (the card unless the caller asks for
    the CPU; nothing falls back on its own).

    The replicas of one process share its current CUDA stream, so their
    launches run on the card in the order they were made: the kernels'
    per-process caches (K4 insert's scratch, K7's launch layouts) rely on
    that, and ``ReplicaServer.crash`` drains the stream before a dead
    server's tensors can be reused."""

    def __init__(self, n: int = 3, store_dir: str | None = None,
                 durable: bool = False, tick_s: float = 0.001,
                 q1: int = 0, q2: int = 0,
                 flags: dict | None = None, device: str = "cuda"):
        # late imports: chaos/__init__ stays importable without torch's
        # runtime modules
        from minpaxos_tpu_torch.runtime.master import Master, _rpc
        from minpaxos_tpu_torch.runtime.replica import ReplicaServer, RuntimeFlags
        from minpaxos_tpu_torch.utils.netutil import CONTROL_OFFSET, free_ports
        from minpaxos_tpu_torch.verify.quorum import validate_config_quorums

        self.n = n
        self._tmp = None
        if store_dir is None:
            self._tmp = store_dir = tempfile.mkdtemp(prefix="paxchaos-")
        self.store_dir = store_dir
        self.mport = free_ports(1)[0]
        self.maddr = ("127.0.0.1", self.mport)
        self.addrs = [("127.0.0.1", p) for p in
                      free_ports(n, sibling_offset=CONTROL_OFFSET)]
        self.master = Master("127.0.0.1", self.mport, n, ping_s=0.3)
        self.master.start()
        self.servers: dict[int, "ReplicaServer"] = {}
        # a partial boot (a raced port bind, a replica raising in
        # start) must tear down whatever came up before re-raising:
        # run_campaign records the run as crashed and keeps going, and
        # a leaked master + replica threads would degrade every later
        # run of the campaign
        try:
            # one register RPC per replica, in id order (ids follow
            # registration order); register_with_master would block each
            # caller until the membership is full
            for i, (host, port) in enumerate(self.addrs):
                resp = _rpc(self.maddr, {"m": "register", "addr": host,
                                         "port": port})
                if not resp.get("ok") or resp.get("id") != i:
                    raise RuntimeError(f"registration of replica {i} "
                                       f"failed: {resp}")
            self.cfg = campaign_config(n, q1, q2)
            # certify intersection BEFORE the replicas boot: a chaos
            # harness must never drive a split-brain-capable cluster
            validate_config_quorums(self.cfg)
            # extra RuntimeFlags fields (a schedule's shape, e.g. the
            # crash schedules' snapshot threshold)
            self._mk_flags = lambda: RuntimeFlags(
                durable=durable, store_dir=store_dir, tick_s=tick_s,
                device=device, **(flags or {}))
            for i in range(n):
                s = ReplicaServer(i, self.addrs, self.cfg,
                                  self._mk_flags())
                s.start()
                self.servers[i] = s
            # "prepared" is leader state (replica 0 owns the initial
            # phase 1; followers never set it) — wait for it, loudly
            deadline = time.monotonic() + 20
            while not self.servers[0].snapshot["prepared"]:
                if time.monotonic() > deadline:
                    # fail loud: driving load into an unprepared
                    # cluster surfaces later as a bogus chaos failure
                    # (acked != expected) and sends the operator
                    # replaying a seed that chases a boot problem
                    raise TimeoutError(
                        "leader not prepared within 20 s of boot")
                time.sleep(0.05)
        except BaseException:
            self.stop()
            raise

    def kill(self, rid: int) -> None:
        """Crash one replica process: buffered (userspace) store bytes
        are LOST, kernel-reached bytes survive — possibly torn
        (StableStore.crash) — and the sockets drop without goodbye.
        The server object stays in ``servers`` so stop() still reaps
        its threads if the schedule never restarts it."""
        self.servers[rid].crash()

    def restart(self, rid: int) -> None:
        """Boot a FRESH ReplicaServer on the victim's ports and store
        dir — the crash-recovery path: replay snapshot + redo suffix
        from disk, then catch up the rest over the wire. The master
        kept the (host, port) registration; its ping loop sees the
        replica alive again once the listener is back (transport's
        bind retries cover the TIME_WAIT window)."""
        from minpaxos_tpu_torch.runtime.replica import ReplicaServer

        self.servers[rid].stop()  # idempotent after crash()
        s = ReplicaServer(rid, self.addrs, self.cfg, self._mk_flags())
        s.start()
        # single-key assignment, never a pop: the sampler thread
        # iterates this dict concurrently and must not see it resize
        self.servers[rid] = s

    def store_path(self, rid: int) -> str:
        # mirror of the ReplicaServer's own naming (runtime/replica.py)
        return f"{self.store_dir}/stable-store-replica{rid}"

    def tear_store(self, rid: int, mode: str = "tear",
                   nbytes: int = 64) -> None:
        """Damage a DEAD replica's store file: ``tear`` cuts the last
        ``nbytes`` off (a crash mid-append/mid-snapshot), ``bitflip``
        flips one bit ``nbytes`` before EOF (media corruption a CRC
        must catch). Only meaningful between kill() and restart()."""
        path = self.store_path(rid)
        size = os.path.getsize(path)
        if mode == "bitflip":
            off = max(8, size - max(int(nbytes), 1))
            with open(path, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0x40]))
        else:
            with open(path, "r+b") as f:
                f.truncate(max(8, size - int(nbytes)))

    def stores(self) -> dict[int, object]:
        return {i: s.store for i, s in self.servers.items()}

    def frontiers(self) -> dict[int, int]:
        return {i: s.snapshot["frontier"]
                for i, s in self.servers.items()}

    def client(self, backoff_seed: int | None = None):
        from minpaxos_tpu_torch.runtime.client import Client

        return Client(self.maddr, check=True, backoff_seed=backoff_seed)

    def stop(self) -> None:
        for s in self.servers.values():
            s.stop()
        self.master.stop()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)


# ---------------------------------------------------------- runner

def run_schedule(name: str, seed: int, n: int = 3, ops_n: int = 400,
                 timeout_s: float = 60.0, log=print,
                 events: list[tuple] | None = None,
                 q1: int = 0, q2: int = 0, durable: bool = False,
                 flags: dict | None = None, device: str = "cuda",
                 store_dir: str | None = None,
                 capture: dict | None = None) -> dict:
    """One schedule end-to-end; returns a JSON-able result dict whose
    ``ok`` is the conjunction of load completion, exactly-once replies,
    real fault injection (> 0), post-heal commit resumption,
    convergence, and the invariant checker (+ the stall proof for
    STALL_SCHEDULES). ``ops_n`` sizes the load chunks; total proposed
    volume is however many chunks fit before the last fault event.

    ``events`` overrides the named schedule with an explicit timed
    event list — the paxmc counterexample-replay path (``cli/mc.py
    --emit-faultplan`` -> ``cli/chaos.py --plan-file``), where the
    fault pattern comes from a model-checker trace rather than a
    seeded generator.

    ``device`` is every replica's step device. ``store_dir`` keeps the
    replicas' stable stores there (else a temporary directory, removed
    at the end), and ``capture``, when given, receives the client's
    ``replies`` and the ``workload`` table (ops, keys, vals), so a
    caller can hold the stores to a checker of its own afterwards."""
    from minpaxos_tpu_torch.runtime.client import gen_workload
    from minpaxos_tpu_torch.runtime.master import cluster_chaos

    custom_events = events is not None
    if events is None:
        events = build_schedule(name, seed, n)
    t_wall = time.monotonic()
    result = {"schedule": name, "seed": seed, "ok": False, "events":
              [(round(t, 3), op) for t, op, _ in events]}
    if q1 or q2:
        result["q1"], result["q2"] = q1, q2
    watcher: HealthWatcher | None = None
    samples: dict[int, list[int]] = {i: [] for i in range(n)}
    sample_t: list[float] = []
    stop_sampling = threading.Event()
    # the cluster is the last thing built OUTSIDE the try: everything
    # after it (client construction can time out on a busy host) runs
    # under the finally that stops it — a leaked master + N replica
    # threads would degrade every later run of the campaign
    cluster = ChaosCluster(n=n, store_dir=store_dir, q1=q1, q2=q2,
                           durable=durable, flags=flags, device=device)
    cli = None
    # process-fault targets (kill/restart/tear ride the event list as
    # runner-applied ops, not master fan-outs)
    victims = frozenset(p["rid"] for _, op, p in events if op == "kill")

    def sampler():
        while not stop_sampling.is_set():
            sample_t.append(time.monotonic())
            for i, f in cluster.frontiers().items():
                samples[i].append(f)
            time.sleep(SAMPLE_S)

    # ONE big workload pool covers the whole schedule: the loader keeps
    # proposing ``chunk``-sized slices until the LAST chaos event has
    # fired, so the faults always land on live traffic (a fixed-size
    # closed loop can finish before the first event on a fast host —
    # and a fault nobody was talking through injects nothing). Global
    # cmd_id = pool index, so the linearizability checker replays load
    # + resume against one reply book without id aliasing.
    chunk = max(50, min(ops_n, 200))
    resume_n = 60
    pool_n = max(ops_n, 200 * chunk)  # never exhausted before stop_load
    ops, keys, vals = gen_workload(pool_n + resume_n, conflict_pct=20,
                                   key_range=900, write_pct=70, seed=seed)
    chunk_stats: list[dict] = []
    stop_load = threading.Event()

    def load():
        lo = 0
        while not stop_load.is_set() and lo + chunk <= pool_n:
            chunk_stats.append(cli.run_partition(
                np.arange(lo, lo + chunk), ops, keys, vals, batch=64,
                timeout_s=timeout_s))
            lo += chunk

    try:
        cli = cluster.client(backoff_seed=seed)
        smp = threading.Thread(target=sampler, daemon=True)
        smp.start()
        # paxwatch rides along on EVERY schedule: the live detector
        # loop polling the real master stats fan-out, as an operator's
        # watcher polls a deployment. For the stall
        # schedules its frontier-stall alarm is part of the verdict
        # (detected AND attributed live, not just checked post-hoc).
        from minpaxos_tpu_torch.runtime.master import cluster_stats

        watcher = HealthWatcher(
            poll_fn=lambda: cluster_stats(cluster.maddr, timeout_s=5.0),
            slo=SLO(stall_s=0.6, stall_slack_slots=STALL_SLACK_SLOTS,
                    churn_window_s=5.0, churn_budget=4),
            interval_s=0.25)
        watcher.start()
        t0 = time.monotonic()
        t0_wall = time.time()
        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        # (mono, wall, op) per fired chaos event: the ground-truth
        # fault timeline the stall-detector assertion compares against
        # (wall joins the watcher's samples, mono the frontier samples)
        fault_marks: list[tuple[float, float, str]] = []
        kills = 0
        for t_off, op, plan in events:
            delay = t0 + t_off - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if op in ("kill", "tear", "restart"):
                # process faults: applied by the runner to the
                # in-process cluster itself — there is no network shim
                # and no master fan-out to drive them through
                rid = plan["rid"]
                if op == "kill":
                    cluster.kill(rid)
                    kills += 1
                elif op == "tear":
                    cluster.tear_store(rid, mode=plan.get("mode", "tear"),
                                       nbytes=plan.get("nbytes", 64))
                else:
                    cluster.restart(rid)
                fault_marks.append((time.monotonic(), time.time(), op))
                continue
            r = cluster_chaos(cluster.maddr, op=op, plan=plan)
            fault_marks.append((time.monotonic(), time.time(), op))
            if not r.get("ok"):
                result["error"] = f"chaos fan-out failed: {r}"
                return result
        time.sleep(0.2)  # let one more chunk straddle the final event
        stop_load.set()
        loader.join(timeout=timeout_s + 15)
        # belt and braces: ALWAYS end healed, whatever the schedule said
        heal = cluster_chaos(cluster.maddr, op="clear")
        if not heal.get("ok"):
            # an unacknowledged clear can leave a shim installed while
            # the run reports itself healed — and its partial stanzas
            # would undercount faults_injected below
            result["error"] = f"final heal fan-out failed: {heal}"
            return result
        # kills are faults too: a crash-only schedule injects nothing
        # through the network shims, so the shim counters alone would
        # (wrongly) read as "no fault ever landed"
        result["faults_injected"] = kills + sum(
            r.get("faults_total", 0) for r in heal.get("replicas", []))
        if loader.is_alive():
            result["error"] = "load thread never finished"
            return result
        # the cluster must RESUME committing after the last heal
        resume = cli.run_partition(np.arange(pool_n, pool_n + resume_n),
                                   ops, keys, vals, batch=64,
                                   timeout_s=30.0)
        result["resumed_commits"] = resume["acked"] == resume_n
        # convergence: every replica reaches the same frontier
        deadline = time.monotonic() + 30
        converged = False
        while time.monotonic() < deadline and not converged:
            fr = cluster.frontiers()
            converged = len(set(fr.values())) == 1 and min(fr.values()) >= 0
            if not converged:
                time.sleep(0.1)
        result["converged"] = converged
        stop_sampling.set()
        smp.join(timeout=2.0)
        # the watcher outlives the resume leg on purpose: a raised
        # stall alarm must be observed CLEARING once commits resume.
        # Every schedule with a live stall verdict gets a short grace
        # (the reference gives it to the crash schedules only): an alarm
        # clears one poll AFTER the cluster catches up, and convergence
        # can land between polls. On the port a resume batch can take
        # longer to commit than the SLO's stall window, so the resume
        # leg itself can raise an alarm that clears only then.
        if name in CRASH_SCHEDULES | STALL_SCHEDULES | STARVED_SCHEDULES:
            grace = time.monotonic() + 3.0
            while time.monotonic() < grace and any(
                    a["t_cleared"] is None for a in watcher.alarms
                    if a["detector"] == "frontier_stall"):
                time.sleep(0.1)
        watcher.stop()
        result["fault_timeline"] = [
            {"t_rel_s": round(tm - t0, 3), "wall_s": tw, "op": op}
            for tm, tw, op in fault_marks]
        result["watch"] = watcher.summary()
        result["watch"]["poll_errors"] = watcher.poll_errors
        if name in STALL_SCHEDULES:
            result["watch"]["stall"] = _stall_verdict(
                watcher, fault_marks, expected_subject=0)
        elif name in STARVED_SCHEDULES:
            # the partitioned island {n-2, n-1} is the starved side:
            # the alarm must name one of ITS replicas, live
            result["watch"]["stall"] = _stall_verdict(
                watcher, fault_marks,
                expected_subject=frozenset({n - 2, n - 1}))
        elif name in CRASH_SCHEDULES:
            # the dead replica's frontier goes dark while the cluster
            # keeps committing: the stall alarm must NAME the corpse
            # while it is down and CLEAR once the restart catches up
            result["watch"]["stall"] = _stall_verdict(
                watcher, fault_marks, expected_subject=victims)
        result["client_events"] = cli.journal.counts_by_kind()
        # cluster-wide EVENTS fan-out: the journals must show the
        # fault-plan installs/clears this schedule just drove
        from minpaxos_tpu_torch.runtime.master import cluster_events

        ev_resp = cluster_events(cluster.maddr)
        from minpaxos_tpu_torch.obs.watch import (
            align_event_collections,
            counts_by_kind,
        )

        aligned = align_event_collections(
            [r["journal"] for r in ev_resp.get("replicas", [])
             if r.get("ok") and r.get("journal")])
        kinds = counts_by_kind(aligned)
        result["cluster_events"] = kinds
        if durable:
            # the durability scorecard: did snapshots happen, how much
            # log did truncation free, how long did crash recovery take,
            # where did disk end up
            from minpaxos_tpu_torch.obs.watch import (
                EV_AUX, EV_KIND, EV_RECOVERY, EV_TRUNCATE, EV_VALUE)

            trunc = aligned[aligned[:, EV_KIND] == EV_TRUNCATE]
            rec = aligned[aligned[:, EV_KIND] == EV_RECOVERY]
            result["durability"] = {
                "snapshots": int(kinds.get("snapshot", 0)),
                "truncations": int(trunc.shape[0]),
                "bytes_freed": int(trunc[:, EV_VALUE].sum()),
                "recovery_ms_max": (int(rec[:, EV_AUX].max())
                                    if len(rec) else 0),
                "log_bytes": {str(i): int(s.store.log_bytes())
                              for i, s in cluster.servers.items()},
                "store_base": {str(i): int(s.store.base)
                               for i, s in cluster.servers.items()},
            }
        time.sleep(0.3)  # quiesce: no in-flight appends under the checker
        with cli._lock:
            replies = dict(cli.replies)
        if capture is not None:
            capture["replies"] = replies
            capture["workload"] = (ops, keys, vals)
        # a crashed replica legitimately REGRESSES its observed
        # frontier across the restart (sync=False loses the buffered
        # tail; it re-earns those slots over the wire), so its sample
        # series is exempt from the monotonicity check — the survivors'
        # series still are checked, and slot agreement over the
        # quiesced stores still covers the victim byte-for-byte
        mono_samples = {i: s for i, s in samples.items()
                        if i not in victims}
        report = check_cluster(
            cluster.stores(), frontier_samples=mono_samples,
            replies=replies, workload=(ops, keys, vals))
        result["check"] = report.to_dict()
        result["acked"] = sum(st["acked"] for st in chunk_stats)
        result["expected"] = sum(st["sent"] for st in chunk_stats)
        result["duplicates"] = cli.dup_replies
        result["client_metrics"] = cli.metrics.counters()
        if name in STALL_SCHEDULES:
            result["stall_observed"] = _stalled_during_fault(
                sample_t, samples, fault_marks)
        stall_live = True
        if (name in STALL_SCHEDULES or name in STARVED_SCHEDULES
                or name in CRASH_SCHEDULES):
            sv = result["watch"]["stall"]
            stall_live = (sv["fired_in_window"] and sv["attributed"]
                          and sv["cleared"])
        # the chaos_install journal floor only applies when the
        # schedule actually drove a fan-out install — crash schedules
        # inject process faults the shims never see
        has_install = any(op == "install" for _, op, _ in events)
        result["ok"] = (report.ok and converged
                        and result["resumed_commits"]
                        and result["expected"] > 0
                        and result["acked"] == result["expected"]
                        and result["faults_injected"] > 0
                        and result["duplicates"] == 0
                        and result.get("stall_observed", True)
                        and (not has_install
                             or kinds.get("chaos_install", 0) >= n)
                        and stall_live)
        return result
    finally:
        stop_sampling.set()
        stop_load.set()
        if watcher is not None:
            watcher.stop()
        if cli is not None:
            cli._done = True
            cli.close_conn()
        cluster.stop()
        result["wall_s"] = round(time.monotonic() - t_wall, 2)
        if not result["ok"]:
            if custom_events:
                # events-override runs (paxmc replays) have no named
                # schedule to hand to --schedules; the reproduction
                # recipe is the plan file itself
                log(f"[paxchaos] schedule {name} seed {seed} FAILED — "
                    f"replay with: python -m minpaxos_tpu_torch.cli.chaos "
                    f"--plan-file "
                    f"<the same plan/trace file> --seeds {seed}")
            else:
                log(f"[paxchaos] schedule {name} seed {seed} FAILED — "
                    f"replay with: python -m minpaxos_tpu_torch.cli.chaos "
                    f"--schedules {name} "
                    f"--seeds {seed}")


def _stall_verdict(watcher: HealthWatcher,
                   fault_marks: list[tuple[float, float, str]],
                   expected_subject) -> dict:
    """The live-detection verdict for a stall schedule: did the
    frontier-stall alarm RAISE inside the installed-fault window
    (wall-clock ground truth from the fired chaos events), did it
    name the isolated replica, and did it CLEAR once the cluster
    healed and resumed committing. This is the closed loop the paxwatch
    layer exists for — the same stall the offline checker proves from
    frontier samples, detected and attributed while it was happening.

    ``expected_subject`` is a replica id, or a set of ids when any
    member of a partitioned group is a correct attribution (the
    flex_partition island)."""
    if not isinstance(expected_subject, (set, frozenset)):
        expected_subject = frozenset({expected_subject})
    # a kill opens a fault window the way an install does; a restart
    # closes one the way a clear does (crash schedules)
    installs = [tw for _, tw, op in fault_marks
                if op in ("install", "kill")]
    clears = [tw for _, tw, op in fault_marks
              if op in ("clear", "restart")]
    stall = [a for a in watcher.alarms
             if a["detector"] == "frontier_stall"]
    lo = installs[0] if installs else float("inf")
    hi = (clears[0] if clears else float("inf")) + 1.0
    in_win = [a for a in stall if lo <= a["t_raised"] <= hi]
    return {
        "fired_in_window": bool(in_win),
        "attributed": any(a["subject"] in expected_subject
                          for a in in_win),
        "cleared": bool(stall) and all(a["t_cleared"] is not None
                                       for a in stall),
        "n_alarms": len(stall),
        "window_wall": [lo, hi],
        "alarms": [{"t_raised": a["t_raised"],
                    "t_cleared": a["t_cleared"],
                    "subject": a["subject"],
                    "evidence": a["evidence"]} for a in stall],
    }


def _stalled_during_fault(sample_t: list[float],
                          samples: dict[int, list[int]],
                          fault_marks: list[tuple[float, float, str]]
                          ) -> bool:
    """True when commit progress stopped while the fault was installed
    (after a short settle for in-flight traffic). Offline twin of the
    live _stall_verdict, from the campaign's own frontier samples."""
    installs = [tm for tm, _, op in fault_marks if op == "install"]
    clears = [tm for tm, _, op in fault_marks if op == "clear"]
    if not installs or not clears:
        return False
    lo, hi = installs[0] + 0.4, clears[0]
    idx = [i for i, t in enumerate(sample_t) if lo <= t <= hi]
    if len(idx) < 2:
        return False
    advances = [seq[idx[-1]] - seq[idx[0]]
                for seq in samples.values() if len(seq) > idx[-1]]
    return bool(advances) and max(advances) <= STALL_SLACK_SLOTS


def run_campaign(schedules: list[str], seeds: list[int], n: int = 3,
                 ops_n: int = 400, budget_s: float | None = None,
                 pairs: list[tuple[int, str]] | None = None,
                 log=print, device: str = "cuda") -> dict:
    """Every (schedule, seed) pair — the full product, or an explicit
    ``pairs`` list [(seed, name), ...] (the CI smoke pairs each fixed
    seed with one schedule to fit its budget) — one fresh cluster
    each, every replica stepping on ``device``. The budget clock starts
    AFTER the first run completes: the first cluster boot pays the
    process's one-time costs (the kernels' libraries loading, the
    allocator warming), which are not a campaign property. Returns the
    aggregate JSON verdict."""
    results: list[dict] = []
    ok = True
    t_budget = None
    if pairs is None:
        pairs = [(seed, name) for seed in seeds for name in schedules]
    for i, (seed, name) in enumerate(pairs):
        shape = SCHEDULE_SHAPES.get(name, {})
        log(f"[paxchaos] schedule {name} seed {seed}"
            + (f" shape {shape}" if shape else "") + " ...")
        try:
            r = run_schedule(name, seed, n=shape.get("n", n),
                             ops_n=ops_n, log=log,
                             q1=shape.get("q1", 0),
                             q2=shape.get("q2", 0),
                             durable=shape.get("durable", False),
                             flags=shape.get("flags"), device=device)
        except Exception as e:  # noqa: BLE001
            # a crashed run must become a seeded failure verdict, not
            # abort the remaining schedules of a CI campaign
            r = {"schedule": name, "seed": seed, "ok": False,
                 "error": f"crashed: {e!r}"}
        if t_budget is None:
            t_budget = time.monotonic()  # first run covered the warm-up
        results.append(r)
        ok = ok and r["ok"]
        w = r.get("watch") or {}
        stall = w.get("stall") or {}
        log(f"[paxchaos]   -> {'ok' if r['ok'] else 'FAIL'} "
            f"acked={r.get('acked')}/{r.get('expected')} "
            f"faults={r.get('faults_injected')} "
            f"alarms={w.get('alarm_counts', {})}"
            + (f" stall_live={stall.get('fired_in_window')}"
               f"/subject_ok={stall.get('attributed')}"
               f"/cleared={stall.get('cleared')}" if stall else "")
            + f" wall={r.get('wall_s')}s")
        remaining = len(pairs) - i - 1
        if (budget_s is not None and remaining
                and time.monotonic() - t_budget > budget_s):
            ok = False
            results.append({"ok": False, "error":
                            f"budget {budget_s}s exceeded with "
                            f"{remaining} runs left"})
            break
    verdict = {"ok": ok, "schedules": schedules, "seeds": seeds,
               "runs": results}
    failed = [r for r in results if not r.get("ok")]
    if failed:
        log(f"[paxchaos] CAMPAIGN FAILED ({len(failed)} run(s)); seeds "
            f"to replay: "
            f"{sorted({r.get('seed') for r in failed if 'seed' in r})}")
    return verdict
