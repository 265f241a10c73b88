"""Sharded-Paxos on one card: G independent groups x R replicas, batched.

The port of the JAX package's ``parallel/sharded.py``. On one card the
shard axis is simply part of the batch axis (B = G * R, group major), so
there is no mesh: every function here is the cluster round over all
groups at once.

* ``sharded_run_resident`` is the measured loop: k rounds per dispatch
  with the workload made on the card (K8, ops/workload.py), the per-slot
  inject ring, the latency histogram and the paxray telemetry ring kept
  on the card (K9, ops/resident.py: one launch a round, plus one before
  the dispatch's first step), optional zero-width drain sub-steps, and
  nothing read back but the two totals the last launch writes, in one
  copy per dispatch.
* ``sharded_run`` is the host-in-the-loop form: k rounds that return
  the cursor replica's [k, G] (committed_upto, crt_inst) histories.

The loops update the ring, histogram and telemetry buffers in place
(the JAX loop donates them).
"""

from __future__ import annotations

import numpy as np
import torch

from minpaxos_tpu_torch.device import resolve_device
from minpaxos_tpu_torch.models.cluster import (
    ClusterState,
    cluster_step_impl,
    init_cluster,
)
from minpaxos_tpu_torch.models.mencius import init_mencius, mencius_step_impl
from minpaxos_tpu_torch.models.minpaxos import (
    MinPaxosConfig,
    MsgBatch,
    become_leader,
    init_replica,
    replica_step_impl,
)
from minpaxos_tpu_torch.obs.recorder import N_TEL_FIELDS, telemetry_valid_rows
from minpaxos_tpu_torch.ops.resident import (
    write_totals,
    new_scratch,
    round_close,
    round_open,
    totals_of,
)
from minpaxos_tpu_torch.ops.util import I32, argmin_first
from minpaxos_tpu_torch.ops.workload import propose_batch

#: round-latency histogram bins: exact integer latencies 1..511, last
#: bin = overflow
LATENCY_BINS = 512


def init_sharded(cfg: MinPaxosConfig, n_shards: int, device="cuda",
                 init_fn=init_replica) -> ClusterState:
    return init_cluster(cfg, n_shards, device, init_fn)


def elect_all(cfg: MinPaxosConfig, ss: ClusterState, leader: int) -> ClusterState:
    """become_leader for ``leader`` in every group, and its PREPARE row
    deposited into each peer's pending inbox at the first free row (row
    with the smallest kind, first on ties — kind 0 if any)."""
    g, r = ss.alive.shape
    dev = ss.alive.device
    which = (torch.arange(r, device=dev) == leader).repeat(g)
    states, prep = become_leader(cfg, ss.states, which)
    free = argmin_first(ss.pending.kind)  # [B]
    is_peer = ~which
    idx = torch.where(is_peer, free, ss.pending.kind.shape[1] - 1)[:, None]
    lead_rows = torch.arange(g, device=dev) * r + leader

    def put(colm, pcol):
        v = pcol[lead_rows, 0].repeat_interleave(r)  # the group leader's row
        v = torch.where(is_peer, v, torch.gather(colm, 1, idx)[:, 0])
        return colm.scatter(1, idx, v[:, None])

    pending = type(ss.pending)(*[put(c, p) for c, p in zip(ss.pending, prep)])
    return ClusterState(states, pending, ss.alive)


def set_alive(cfg: MinPaxosConfig, ss: ClusterState, replica: int, value: bool):
    """Fault injection across all groups: flip one replica's alive bit."""
    alive = ss.alive.clone()
    alive[:, replica] = value
    return ss._replace(alive=alive)


def commit_totals(cfg: MinPaxosConfig, ss: ClusterState):
    """(total committed instances across groups at replica 0's view, min
    committed_upto, max committed_upto), as 0-d tensors."""
    upto = ss.states.committed_upto.view(ss.alive.shape)[:, 0]
    return (upto + 1).sum(), upto.min(), upto.max()


def shard_cursors(cfg: MinPaxosConfig, leader: int, ss: ClusterState):
    """Per-group (committed_upto, crt_inst) at the leader replica, [G]."""
    shape = ss.alive.shape
    return (ss.states.committed_upto.view(shape)[:, leader],
            ss.states.crt_inst.view(shape)[:, leader])


def sharded_step(cfg: MinPaxosConfig, ss: ClusterState, ext: MsgBatch,
                 step_impl=replica_step_impl):
    """One synchronous round for every group: (ss', exec results, client
    rows, client mask)."""
    return cluster_step_impl(cfg, ss, ext, step_impl)


def make_propose_ext(cfg: MinPaxosConfig, n_shards: int, ext_rows: int, count: int,
                     leader: int, round_idx: int, seed: int = 0,
                     key_space: int = 1 << 20, device=None) -> MsgBatch:
    """The round's device-made workload: ``count`` PUT rows per group,
    addressed to ``leader`` (every replica when < 0)."""
    return propose_batch(cfg.n_replicas, n_shards, ext_rows, count, leader,
                         round_idx, seed, key_space, device=device)


def _drain_ext(ext: MsgBatch) -> MsgBatch:
    """The drain sub-steps' ext batch: zero-WIDTH, not zero-filled, so
    the step runs at the inbox capacity alone."""
    return MsgBatch(*[x[:, :0] for x in ext])


def sharded_run(cfg: MinPaxosConfig, n_shards: int, ext_rows: int, k_rounds: int,
                ss: ClusterState, n_proposals: int, leader: int, round0: int,
                seed: int = 0, step_impl=replica_step_impl,
                key_space: int = 1 << 20, substeps: int = 1):
    """k protocol rounds, each the round's step plus ``substeps`` - 1
    drain sub-steps; returns (ss', uptos [k, G], crts [k, G]), the
    cursor replica's committed_upto and crt_inst after every round."""
    r = cfg.n_replicas
    dev = ss.alive.device
    cursor_rep = max(leader, 0)
    uptos, crts = [], []
    for t in range(k_rounds):
        ext = propose_batch(r, n_shards, ext_rows, n_proposals, leader, round0 + t,
                            seed, key_space, device=dev)
        ss, _, _, _ = cluster_step_impl(cfg, ss, ext, step_impl)
        for _ in range(substeps - 1):
            ss, _, _, _ = cluster_step_impl(cfg, ss, _drain_ext(ext), step_impl)
        uptos.append(ss.states.committed_upto.view(n_shards, r)[:, cursor_rep])
        crts.append(ss.states.crt_inst.view(n_shards, r)[:, cursor_rep])
    return ss, torch.stack(uptos), torch.stack(crts)


def _resident_rounds(cfg: MinPaxosConfig, n_shards: int, ext_rows: int,
                     k_rounds: int, ss: ClusterState, inject_round: torch.Tensor,
                     lat_hist: torch.Tensor, telemetry: torch.Tensor,
                     n_proposals: int, leader: int, round0: int, seed: int,
                     step_impl, key_space: int, substeps: int, tel_base: int):
    """``sharded_run_resident``'s loop: returns (ss', inject_round',
    lat_hist', telemetry', totals) with ``totals`` the [2] int32
    (committed_total, in_flight) that the last round's K9 launch wrote.

    K9 launches once a round: ``round_open`` before the first step, then
    each round's ``round_close``, which opens the next round (nothing
    writes the states or the pending inboxes between the two) and, on
    the last round, writes the totals. With the ring armed a drain
    sub-step's ``round_open`` adds its deliveries to the round's
    inbox_rows and inbox_hwm."""
    r = cfg.n_replicas
    dev = inject_round.device
    cursor_rep = max(leader, 0)
    tel_on = telemetry.shape[0] > 0
    scratch = new_scratch(n_shards, dev)  # K9's cursor snapshot + row terms
    injected = n_shards * n_proposals * (1 if leader >= 0 else r)
    if k_rounds == 0:
        write_totals(scratch, ss.states, cursor_rep, n_shards)
    else:
        round_open(scratch, ss.states, ss.pending.kind, cursor_rep, n_shards,
                   n_proposals, leader, True, tel_on, round0)
    for t in range(k_rounds):
        rnd = round0 + t
        ext = propose_batch(r, n_shards, ext_rows, n_proposals, leader, rnd, seed,
                            key_space, device=dev)
        ss, _, _, _ = cluster_step_impl(cfg, ss, ext, step_impl)
        for _ in range(substeps - 1):
            if tel_on:  # drain deliveries count into inbox_rows / inbox_hwm
                round_open(scratch, ss.states, ss.pending.kind, cursor_rep,
                           n_shards, 0, leader, False, True, rnd)
            ss, _, _, _ = cluster_step_impl(cfg, ss, _drain_ext(ext), step_impl)
        last = t == k_rounds - 1
        round_close(scratch, inject_round, lat_hist, telemetry, ss.states,
                    cursor_rep, rnd, tel_base, injected,
                    None if last else ss.pending.kind, n_proposals, leader, last)
    return ss, inject_round, lat_hist, telemetry, totals_of(scratch)


def sharded_run_resident(cfg: MinPaxosConfig, n_shards: int, ext_rows: int,
                         k_rounds: int, ss: ClusterState, inject_round: torch.Tensor,
                         lat_hist: torch.Tensor, telemetry: torch.Tensor,
                         n_proposals: int, leader: int, round0: int, seed: int = 0,
                         step_impl=replica_step_impl, key_space: int = 1 << 20,
                         substeps: int = 1, tel_base: int = 0):
    """k rounds with nothing read back: returns (ss', inject_round',
    lat_hist', telemetry', committed_total, in_flight), the last two 0-d
    int32 tensors. ``step_impl`` is the replica step (Mencius:
    mencius_step_impl, with ``leader`` -1 so every owner gets the
    round's proposals; the cursors are then read at replica 0).

    ``inject_round`` [G, W]: for each in-flight slot (ring position
    slot % W), the round it was assigned (-1 = before the measured
    window, excluded from the sample). ``lat_hist`` [bins]: committed
    slots per exact integer round latency (same round = 1), last bin =
    overflow. ``telemetry`` [rows, N_TEL_FIELDS]: one row per round
    (obs/recorder.py layout) at ``(round - tel_base) mod rows``; a
    zero-row buffer switches the telemetry off, and its reads and
    writes are then skipped. ``substeps`` - 1 zero-width drain
    sub-steps follow each round's step. The three buffers are updated
    in place."""
    *out, totals = _resident_rounds(cfg, n_shards, ext_rows, k_rounds, ss,
                                    inject_round, lat_hist, telemetry, n_proposals,
                                    leader, round0, seed, step_impl, key_space,
                                    substeps, tel_base)
    return (*out, totals[0], totals[1])


class ShardedCluster:
    """Host wrapper: boot -> elect -> device-made proposals -> rounds.
    ``protocol`` is "minpaxos" (classic too, by its config flag) or
    "mencius" (no elections: every owner serves the proposals).
    ``device`` defaults to the card and raises without one."""

    def __init__(self, cfg: MinPaxosConfig, n_shards: int, ext_rows: int = 512,
                 key_space: int = 1 << 20, seed: int = 0, device="cuda",
                 protocol: str = "minpaxos"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_shards = n_shards
        self.ext_rows = ext_rows
        self.seed = seed
        self.key_space = key_space
        self.protocol = protocol
        if protocol == "mencius":
            init_fn, self._step_impl = init_mencius, mencius_step_impl
            self.leader = -1  # multi-leader: proposals go to every owner
        else:
            init_fn, self._step_impl = init_replica, replica_step_impl
            self.leader = 0
        self.ss = init_sharded(cfg, n_shards, self.device, init_fn)
        self._seed = 0  # round counter: the workload stream's position
        self._inject_round = None
        self._lat_hist = None
        self._telemetry = None
        self._tel_base = 0

    def elect(self, leader: int = 0) -> None:
        if self.protocol == "mencius":
            raise ValueError("mencius has no elections (rotating ownership)")
        self.ss = elect_all(self.cfg, self.ss, leader)
        self.leader = leader
        self.step(0)  # deliver PREPAREs
        self.step(0)  # deliver replies -> leader prepared

    def step(self, n_proposals: int) -> None:
        ext = make_propose_ext(self.cfg, self.n_shards, self.ext_rows,
                               min(n_proposals, self.ext_rows), self.leader,
                               self._seed, self.seed, self.key_space, self.device)
        self._seed += 1
        self.ss, _, _, _ = sharded_step(self.cfg, self.ss, ext, self._step_impl)

    def committed(self) -> tuple[int, int, int]:
        tot, lo, hi = commit_totals(self.cfg, self.ss)
        return int(tot), int(lo), int(hi)

    def run_fused(self, k_rounds: int, n_proposals: int, substeps: int = 1):
        """k rounds with the host in the loop: returns the cursor
        replica's per-round histories (numpy [k, G] committed_upto and
        crt_inst), read back after the k rounds."""
        self.ss, uptos, crts = sharded_run(
            self.cfg, self.n_shards, self.ext_rows, k_rounds, self.ss,
            min(n_proposals, self.ext_rows), self.leader, self._seed, self.seed,
            self._step_impl, self.key_space, substeps)
        self._seed += k_rounds
        return uptos.cpu().numpy(), crts.cpu().numpy()

    def begin_resident(self, lat_bins: int = LATENCY_BINS,
                       telemetry_rounds: int = 0) -> None:
        """Arm the resident loop's bookkeeping: a fresh inject ring (all
        -1), a zeroed latency histogram and, when ``telemetry_rounds`` >
        0, the telemetry ring (round column -1 = never written; 0 rows
        switch it off). Ring rows count from the round counter at
        arming, so a re-armed ring restarts at row 0."""
        dev = self.device
        self._inject_round = torch.full((self.n_shards, self.cfg.window), -1,
                                        dtype=I32, device=dev)
        self._lat_hist = torch.zeros(lat_bins, dtype=I32, device=dev)
        self._telemetry = torch.full((telemetry_rounds, N_TEL_FIELDS), -1,
                                     dtype=I32, device=dev)
        self._tel_base = self._seed

    def run_resident(self, k_rounds: int, n_proposals: int,
                     substeps: int = 1) -> tuple[int, int]:
        """k rounds, fully on the card; returns (committed_total,
        in_flight) — the only per-dispatch readback."""
        (self.ss, self._inject_round, self._lat_hist, self._telemetry,
         totals) = _resident_rounds(
            self.cfg, self.n_shards, self.ext_rows, k_rounds, self.ss,
            self._inject_round, self._lat_hist, self._telemetry,
            min(n_proposals, self.ext_rows), self.leader, self._seed, self.seed,
            self._step_impl, self.key_space, substeps, self._tel_base)
        self._seed += k_rounds
        committed, in_flight = totals.tolist()  # one device-to-host copy
        return committed, in_flight

    def resident_hist(self) -> np.ndarray:
        """The latency histogram, without disarming (a post-window read)."""
        return self._lat_hist.cpu().numpy()

    def resident_telemetry(self) -> np.ndarray:
        """The telemetry ring's written rows sorted by round ([n,
        N_TEL_FIELDS] numpy, obs/recorder.py layout). A post-window
        read: call it before ``end_resident``, which disarms the ring."""
        return telemetry_valid_rows(self._telemetry.cpu().numpy())

    def end_resident(self) -> np.ndarray:
        """The post-window readback: the latency histogram; disarms the
        bookkeeping, the telemetry ring included."""
        hist = self._lat_hist.cpu().numpy()
        self._inject_round = None
        self._lat_hist = None
        self._telemetry = None
        return hist

    def kill(self, replica: int) -> None:
        self.ss = set_alive(self.cfg, self.ss, replica, False)

    def revive(self, replica: int) -> None:
        self.ss = set_alive(self.cfg, self.ss, replica, True)
