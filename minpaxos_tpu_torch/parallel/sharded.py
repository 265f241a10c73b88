"""Sharded-Paxos on one card: G independent groups x R replicas, batched.

The port of the JAX package's ``parallel/sharded.py``. On one card the
shard axis is simply part of the batch axis (B = G * R, group major), so
there is no mesh: every function here is the cluster round over all
groups at once. ``sharded_run_resident`` is the measured loop: k rounds
per dispatch with the workload made on the card (ops/workload.py), the
per-slot inject ring and the latency histogram kept on the card, and
nothing read back but two scalars per dispatch. The telemetry ring of
the JAX loop is not ported (its off switch, a zero-row buffer, is the
only form here).
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
    become_leader,
    init_replica,
    replica_step_impl,
)
from minpaxos_tpu_torch.ops.util import I32, argmin_first
from minpaxos_tpu_torch.ops.workload import (
    assemble_batch,
    propose_batch,
    workload_lanes,
)

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


def sharded_run_resident(cfg: MinPaxosConfig, n_shards: int, ext_rows: int,
                         k_rounds: int, ss: ClusterState, inject_round: torch.Tensor,
                         lat_hist: torch.Tensor, n_proposals: int, leader: int,
                         round0: int, seed: int = 0, key_space: int = 1 << 20,
                         step_impl=replica_step_impl):
    """k rounds with nothing read back: returns (ss', inject_round',
    lat_hist', committed_total, in_flight), the last two 0-d tensors.
    ``step_impl`` is the replica step (Mencius: mencius_step_impl, with
    ``leader`` -1 so every owner gets the round's proposals; the
    cursors are then read at replica 0).

    ``inject_round`` [G, W]: for each in-flight slot (ring position
    slot % W), the round it was assigned (-1 = before the measured
    window, excluded from the sample). ``lat_hist`` [bins]: committed
    slots per exact integer round latency (same round = 1), last bin =
    overflow. Both are updated in place and returned."""
    w = cfg.window
    r = cfg.n_replicas
    dev = inject_round.device
    cursor_rep = max(leader, 0)
    pos = torch.arange(w, dtype=I32, device=dev)[None, :]
    ts = torch.arange(k_rounds, dtype=torch.int64, device=dev)
    keys, vals = workload_lanes(n_shards, ext_rows, round0 + ts, seed,
                                key_space, device=dev)
    inj, hist = inject_round, lat_hist
    nb = hist.shape[0]
    for t in range(k_rounds):
        rnd = round0 + t
        upto = ss.states.committed_upto.view(n_shards, r)
        crt = ss.states.crt_inst.view(n_shards, r)
        u_prev = upto[:, cursor_rep].clone()
        c_prev = crt[:, cursor_rep].clone()
        ext = assemble_batch(r, n_shards, ext_rows, n_proposals, leader, rnd,
                             keys[t], vals[t])
        ss, _, _, _ = cluster_step_impl(cfg, ss, ext, step_impl)
        u_new = ss.states.committed_upto.view(n_shards, r)[:, cursor_rep]
        c_new = ss.states.crt_inst.view(n_shards, r)[:, cursor_rep]
        cp = c_prev[:, None]
        slot = cp + torch.remainder(pos - cp, w)
        inj = torch.where(slot < c_new[:, None], rnd, inj)
        up = u_prev[:, None] + 1
        cslot = up + torch.remainder(pos - up, w)
        sampled = (cslot <= u_new[:, None]) & (inj >= 0)
        bins = (rnd - inj).clamp(0, nb - 1)
        hist.scatter_add_(0, bins.reshape(-1).long(), sampled.reshape(-1).to(hist.dtype))
    inject_round.copy_(inj)
    upto = ss.states.committed_upto.view(n_shards, r)[:, cursor_rep]
    crt = ss.states.crt_inst.view(n_shards, r)[:, cursor_rep]
    return ss, inject_round, hist, (upto + 1).sum(), (crt - 1 - upto).sum()


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

    def elect(self, leader: int = 0) -> None:
        if self.protocol == "mencius":
            raise ValueError("mencius has no elections (rotating ownership)")
        self.ss = elect_all(self.cfg, self.ss, leader)
        self.leader = leader
        self.step(0)  # deliver PREPAREs
        self.step(0)  # deliver replies -> leader prepared

    def step(self, n_proposals: int) -> None:
        ext = propose_batch(self.cfg.n_replicas, self.n_shards, self.ext_rows,
                            min(n_proposals, self.ext_rows), self.leader,
                            self._seed, self.seed, self.key_space, self.device)
        self._seed += 1
        self.ss, _, _, _ = cluster_step_impl(self.cfg, self.ss, ext, self._step_impl)

    def committed(self) -> tuple[int, int, int]:
        tot, lo, hi = commit_totals(self.cfg, self.ss)
        return int(tot), int(lo), int(hi)

    def begin_resident(self, lat_bins: int = LATENCY_BINS) -> None:
        """Arm the resident loop's bookkeeping: a fresh inject ring (all
        -1) and a zeroed latency histogram."""
        self._inject_round = torch.full((self.n_shards, self.cfg.window), -1,
                                        dtype=I32, device=self.device)
        self._lat_hist = torch.zeros(lat_bins, dtype=I32, device=self.device)

    def run_resident(self, k_rounds: int, n_proposals: int) -> tuple[int, int]:
        """k rounds, fully on the card; returns (committed_total,
        in_flight) — the only per-dispatch readback."""
        (self.ss, self._inject_round, self._lat_hist, committed,
         in_flight) = sharded_run_resident(
            self.cfg, self.n_shards, self.ext_rows, k_rounds, self.ss,
            self._inject_round, self._lat_hist, min(n_proposals, self.ext_rows),
            self.leader, self._seed, self.seed, self.key_space, self._step_impl)
        self._seed += k_rounds
        return int(committed), int(in_flight)

    def end_resident(self) -> np.ndarray:
        """The post-window readback: the latency histogram; disarms."""
        hist = self._lat_hist.cpu().numpy()
        self._inject_round = None
        self._lat_hist = None
        return hist

    def kill(self, replica: int) -> None:
        self.ss = set_alive(self.cfg, self.ss, replica, False)

    def revive(self, replica: int) -> None:
        self.ss = set_alive(self.cfg, self.ss, replica, True)
