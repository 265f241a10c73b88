"""Pod-mode cluster: every replica of every group on the card, one step.

The port of the JAX package's ``models/cluster.py``. The replica states
of G groups x R replicas are one batched ReplicaState (B = G * R, group
major); one round delivers each replica's inbox (routed pending rows +
host-injected ext rows), runs the batched protocol step, and routes the
new outboxes through the K1 fabric (ops/segscatter.py). A dead replica
is a mask: its rows are dropped and its inbox is silenced.

``Cluster`` is the host wrapper for one group (G = 1): elect, kill,
revive, propose, step, and the exactly-once reply collection, with its
own copies of the reply-key helpers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from minpaxos_tpu_torch.device import resolve_device
from minpaxos_tpu_torch.models.minpaxos import (
    ExecResult,
    MinPaxosConfig,
    MsgBatch,
    ReplicaState,
    become_leader,
    concat_rows,
    from_numpy_state as _state_from_numpy,
    init_replica,
    replica_step_impl,
    state_leaves,
    to_numpy_state as _state_to_numpy,
)
from minpaxos_tpu_torch.ops.packed import join_i64, split_i64
from minpaxos_tpu_torch.ops.segscatter import prefix_pack_plan, route
from minpaxos_tpu_torch.ops.util import I32
from minpaxos_tpu_torch.wire.messages import MsgKind


class ClusterState(NamedTuple):
    states: ReplicaState  # batched, B = G * R (group major)
    pending: MsgBatch  # [B, inbox] routed but undelivered rows
    alive: torch.Tensor  # bool[G, R] failure-injection mask


def validate_config_quorums(cfg: MinPaxosConfig) -> None:
    """Refuse thresholds the kernels must not run: phase-1 and phase-2
    quorums that do not intersect (q1 + q2 <= n), and fast paths other
    than the unanimous minpaxos form."""
    n, q1, q2 = cfg.n_replicas, cfg.quorum1, cfg.quorum2
    if not (1 <= q1 <= n and 1 <= q2 <= n) or q1 + q2 <= n:
        raise ValueError(f"non-intersecting quorum config n={n}, q1={q1}, q2={q2}")
    if cfg.fast_path:
        if cfg.explicit_commit:
            raise ValueError("fast_path supports the minpaxos kernel only")
        if cfg.quorum_fast != n:
            raise ValueError(f"fast_path needs q_fast == n ({n})")


def init_cluster(cfg: MinPaxosConfig, n_groups: int, device="cuda",
                 init_fn=init_replica) -> ClusterState:
    """G groups of fresh replica states (``init_fn``: init_replica, or
    models/mencius.py init_mencius), empty inboxes, all alive."""
    dev = resolve_device(device)
    r = cfg.n_replicas
    b = n_groups * r
    me = torch.arange(r, dtype=I32, device=dev).repeat(n_groups)
    return ClusterState(
        states=init_fn(cfg, me, dev),
        pending=MsgBatch.empty(b, cfg.inbox, dev),
        alive=torch.ones((n_groups, r), dtype=torch.bool, device=dev),
    )


def _route_segmented(cfg: MinPaxosConfig, out_msgs: MsgBatch, dst: torch.Tensor,
                     alive: torch.Tensor, capacity: int) -> MsgBatch:
    """Pool each group's outboxes and route them (K1): [B, m] -> [B, cap]."""
    g, r = alive.shape
    b, m = out_msgs.kind.shape
    cols = out_msgs.stacked().view(12, g, r * m)
    inbox, _ = route(cols, dst.reshape(g, r * m), alive, m, capacity)
    return MsgBatch.from_stacked(inbox.view(12, b, capacity))


def _deliver_inbox(cfg: MinPaxosConfig, pending: MsgBatch, ext: MsgBatch,
                   alive: torch.Tensor) -> MsgBatch:
    """Merge routed pending rows + host-injected ext rows into the inbox
    the step consumes; dead replicas see silence. With
    ``cfg.compact_inbox`` > 0 live rows pack to a prefix of that many
    rows (order kept, overflow dropped)."""
    inbox = concat_rows(pending, ext)
    inbox = inbox._replace(kind=torch.where(alive.reshape(-1, 1), inbox.kind, 0))
    cap = cfg.compact_inbox
    if cap and inbox.kind.shape[-1] > cap:
        win, hit = prefix_pack_plan(inbox.kind != 0, cap)
        winc = torch.where(hit, win, 0)
        inbox = MsgBatch(*[torch.where(hit, torch.gather(c, 1, winc), 0)
                           for c in inbox])
    return inbox


def cluster_step_impl(cfg: MinPaxosConfig, cs: ClusterState, ext: MsgBatch,
                      step_impl=replica_step_impl):
    """One synchronous round for every group: deliver pending + ext
    ([B, Mext]), step all replicas, route the new outboxes. Returns
    (state', exec results [B, E], client-bound rows, client mask).
    Routing is the segmented fabric (K1); the JAX package's dense
    fabric exists only as its byte-equality reference and is not
    ported."""
    if cfg.route_fabric != "segmented":
        raise ValueError(f"route_fabric={cfg.route_fabric!r}: the port routes "
                         "with the segmented fabric only")
    cfg = cfg._replace(gate_exec=False)
    inbox = _deliver_inbox(cfg, cs.pending, ext, cs.alive)
    states, outbox, execr = step_impl(cfg, cs.states, inbox)
    pending = _route_segmented(cfg, outbox.msgs, outbox.dst, cs.alive, cfg.inbox)
    client_mask = (outbox.dst == -2) & (outbox.msgs.kind != 0)
    return ClusterState(states, pending, cs.alive), execr, outbox.msgs, client_mask


# ---- state carried across from / to the JAX package (as numpy) ----

def from_numpy_state(tree, device="cuda") -> ClusterState:
    """A JAX ClusterState given as numpy arrays ([R, ...] for one
    cluster, [G, R, ...] for sharded) -> the port's ClusterState. States
    with a ``crt_own`` field are Mencius states."""
    from minpaxos_tpu_torch.models.mencius import MenciusState

    dev = resolve_device(device)
    cls = MenciusState if hasattr(tree.states, "crt_own") else ReplicaState
    alive = np.asarray(tree.alive)
    g_r = (1,) + alive.shape if alive.ndim == 1 else alive.shape
    b = int(np.prod(g_r))
    pending = MsgBatch(*[
        torch.from_numpy(np.array(getattr(tree.pending, f)).reshape(b, -1)).to(dev)
        for f in MsgBatch._fields])
    return ClusterState(
        states=_state_from_numpy(tree.states, dev, cls),
        pending=pending,
        alive=torch.from_numpy(alive.reshape(g_r).copy()).to(dev),
    )


def to_numpy_state(cs: ClusterState, single: bool | None = None) -> ClusterState:
    """The port's ClusterState -> numpy in the JAX layout and dtypes:
    [R, ...] leaves for one group (``single``, the default when G == 1),
    [G, R, ...] otherwise."""
    g, r = cs.alive.shape
    if single is None:
        single = g == 1
    lead = (r,) if single else (g, r)
    pend = MsgBatch(*[np.ascontiguousarray(
        c.detach().cpu().numpy().reshape(lead + (-1,))) for c in cs.pending])
    alive = cs.alive.detach().cpu().numpy().reshape(lead)
    return ClusterState(_state_to_numpy(cs.states, lead), pend, alive)


def numpy_leaves(cs: ClusterState) -> list:
    """Leaves of a ClusterState in the JAX ``tree_leaves((states,
    pending, alive))`` order, as numpy in the JAX dtypes — what the
    golden digests hash."""
    n = to_numpy_state(cs)
    return state_leaves(n.states) + list(n.pending) + [n.alive]


# ---- host-side reply collection ----

def pack_reply_key(client_id, cmd_id) -> np.ndarray:
    """(client_id, cmd_id) -> one i64 key, vectorized."""
    return (np.asarray(client_id, np.int64) << 32) | (
        np.asarray(cmd_id, np.int64) & 0xFFFFFFFF)


class KeyBuf:
    """Append-only packed-key buffer with amortized-doubling growth and
    a sorted snapshot for vectorized membership checks."""

    __slots__ = ("_arr", "_n", "_sorted", "_sorted_n")

    def __init__(self) -> None:
        self._arr = np.empty(256, np.int64)
        self._n = 0
        self._sorted = self._arr[:0]
        self._sorted_n = 0

    def append(self, keys) -> None:
        keys = np.atleast_1d(keys)
        need = self._n + len(keys)
        if need > len(self._arr):
            arr = np.empty(max(2 * len(self._arr), need), np.int64)
            arr[: self._n] = self._arr[: self._n]
            self._arr = arr
        self._arr[self._n : need] = keys
        self._n = need

    def contains(self, keys: np.ndarray) -> np.ndarray:
        if self._sorted_n != self._n:
            self._sorted = np.sort(self._arr[: self._n])
            self._sorted_n = self._n
        v = self._sorted
        if not len(v):
            return np.zeros(len(np.atleast_1d(keys)), bool)
        pos = np.searchsorted(v, keys)
        return v[np.minimum(pos, len(v) - 1)] == keys


def collect_exec_replies(cl, execr: ExecResult, *, drop_skip_fills: bool = False,
                         record_inst: bool = True) -> None:
    """Host side of the client reply: one transfer per field, a
    vectorized prefilter against the replica's proposed keys, then the
    per-row reply dict (exactly-once: re-executions log as
    duplicates). ``drop_skip_fills`` also drops Mencius SKIP fills (op 0,
    cmd_id 0); ``record_inst`` adds each reply's slot, exec_lo + row
    (meaningless under Mencius's out-of-order execution)."""
    counts = execr.count.cpu().numpy()
    e_vhi, e_vlo = execr.val_hi.cpu().numpy(), execr.val_lo.cpu().numpy()
    e_found, e_op = execr.found.cpu().numpy(), execr.op.cpu().numpy()
    e_cid, e_mid = execr.client_id.cpu().numpy(), execr.cmd_id.cpu().numpy()
    e_lo = execr.lo.cpu().numpy()
    for rep in range(cl.cfg.n_replicas):
        n = int(counts[rep])
        if not n:
            continue
        keys = cl._prop_keys.get(rep)
        if keys is None:
            continue
        cid_n, mid_n, op_n = e_cid[rep][:n], e_mid[rep][:n], e_op[rep][:n]
        cand = cid_n >= 0  # no-op fills carry client -1
        if drop_skip_fills:
            cand &= ~((op_n == 0) & (mid_n == 0))
        if not cand.any():
            continue
        cand &= keys.contains(pack_reply_key(cid_n, mid_n))
        idx = np.nonzero(cand)[0]
        if not idx.size:
            continue
        vals = join_i64(e_vhi[rep][idx], e_vlo[rep][idx])
        founds, ops = e_found[rep][idx], op_n[idx]
        for j, i in enumerate(idx):
            cid, mid = int(cid_n[i]), int(mid_n[i])
            if cl._proposed_at.get((cid, mid)) != rep:
                continue
            rep_row = dict(ok=True, value=int(vals[j]), found=bool(founds[j]),
                           op=int(ops[j]))
            if record_inst:
                rep_row["inst"] = int(e_lo[rep]) + int(i)
            if (cid, mid) in cl.replies:
                cl.reply_log.append(dict(duplicate=True, client_id=cid, cmd_id=mid))
            cl.replies[(cid, mid)] = rep_row
            cl.reply_log.append(dict(duplicate=False, client_id=cid, cmd_id=mid,
                                     **rep_row))


class Cluster:
    """Host wrapper for one group: boot, propose, crash, recover.

    ``device`` defaults to the card; ``device="cpu"`` runs the plain
    PyTorch path."""

    def __init__(self, cfg: MinPaxosConfig, ext_rows: int = 1024, device="cuda",
                 init_fn=init_replica):
        validate_config_quorums(cfg)
        self.cfg = cfg
        self.ext_rows = ext_rows
        self.device = resolve_device(device)
        self.cs = init_cluster(cfg, 1, self.device, init_fn)
        self._ext_queue: list[tuple[int, dict]] = []
        self.replies: dict[tuple[int, int], dict] = {}
        self.reply_log: list[dict] = []
        self._proposed_at: dict[tuple[int, int], int] = {}
        self._prop_keys: dict[int, KeyBuf] = {}

    @property
    def leader(self) -> int:
        """Leader per the highest-ballot alive replica."""
        alive = self.cs.alive[0].cpu().numpy()
        ballots = self.cs.states.default_ballot.cpu().numpy()
        leaders = self.cs.states.leader_id.cpu().numpy()
        cand = np.where(alive, ballots, -(2 ** 31))
        return int(leaders[int(np.argmax(cand))])

    def elect(self, replica: int) -> None:
        """Run a real Prepare round: ext PREPARE rows to every peer."""
        which = torch.zeros(self.cfg.n_replicas, dtype=torch.bool, device=self.device)
        which[replica] = True
        states, prep = become_leader(self.cfg, self.cs.states, which)
        self.cs = self.cs._replace(states=states)
        row = {f: getattr(prep, f)[replica].cpu().numpy() for f in MsgBatch._fields}
        for peer in range(self.cfg.n_replicas):
            if peer != replica:
                self._ext_queue.append((peer, row))

    def _set_alive(self, replica: int, value: bool) -> None:
        alive = self.cs.alive.clone()
        alive[0, replica] = value
        self.cs = self.cs._replace(alive=alive)

    def kill(self, replica: int) -> None:
        self._set_alive(replica, False)

    def revive(self, replica: int) -> None:
        self._set_alive(replica, True)

    def propose(self, ops, keys, vals, cmd_ids, client_id: int, to: int | None = None):
        """Queue client PROPOSE rows for ``to`` (default: the leader;
        -1 broadcasts to every replica), chunked by ``ext_rows``."""
        broadcast = to == -1
        if broadcast:
            to = self.leader
        else:
            to = self.leader if to is None else to
        if to < 0:
            raise ValueError("no known leader; call elect() first or pass to=")
        ops = np.asarray(ops, dtype=np.int32)
        k_hi, k_lo = split_i64(np.asarray(keys))
        v_hi, v_lo = split_i64(np.asarray(vals))
        n = len(ops)
        rows = dict(
            kind=np.full(n, int(MsgKind.PROPOSE), np.int32),
            src=np.full(n, -1, np.int32),
            ballot=np.zeros(n, np.int32),
            inst=np.zeros(n, np.int32),
            last_committed=np.zeros(n, np.int32),
            op=ops,
            key_hi=k_hi.astype(np.int32),
            key_lo=k_lo.astype(np.int32),
            val_hi=v_hi.astype(np.int32),
            val_lo=v_lo.astype(np.int32),
            cmd_id=np.asarray(cmd_ids, dtype=np.int32),
            client_id=np.full(n, client_id, np.int32),
        )
        for mid in np.asarray(cmd_ids, dtype=np.int64):
            self._proposed_at[(client_id, int(mid))] = to
        self._prop_keys.setdefault(to, KeyBuf()).append(
            pack_reply_key(client_id, cmd_ids))
        targets = range(self.cfg.n_replicas) if broadcast else (to,)
        for tgt in targets:
            for lo in range(0, n, self.ext_rows):
                self._ext_queue.append(
                    (tgt, {f: v[lo : lo + self.ext_rows] for f, v in rows.items()}))

    def _drain_ext(self) -> MsgBatch:
        r, m = self.cfg.n_replicas, self.ext_rows
        cols = {f: np.zeros((r, m), np.int32) for f in MsgBatch._fields}
        fill = [0] * r
        rest = []
        for to, arrs in self._ext_queue:
            n = np.atleast_1d(arrs["kind"]).shape[0]
            if fill[to] + n > m:
                rest.append((to, arrs))
                continue
            sl = slice(fill[to], fill[to] + n)
            for f in MsgBatch._fields:
                cols[f][to, sl] = arrs[f]
            fill[to] += n
        self._ext_queue = rest
        return MsgBatch(**{f: torch.from_numpy(cols[f]).to(self.device)
                           for f in MsgBatch._fields})

    def step(self) -> None:
        """One cluster round + host-side reply collection."""
        ext = self._drain_ext()
        self.cs, execr, crows, cmask = cluster_step_impl(self.cfg, self.cs, ext)
        collect_exec_replies(self, execr)
        self._collect_client_rows(crows, cmask)

    def run(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def _collect_client_rows(self, crows: MsgBatch, cmask) -> None:
        cmask = cmask.cpu().numpy()
        if not cmask.any():
            return
        kinds = crows.kind.cpu().numpy()
        sel = cmask & (kinds == int(MsgKind.PROPOSE_REPLY))
        if not sel.any():
            return
        cids = crows.client_id.cpu().numpy()[sel]
        mids = crows.cmd_id.cpu().numpy()[sel]
        leaders = crows.ballot.cpu().numpy()[sel]
        for cid, mid, ldr in zip(cids, mids, leaders):
            self.reply_log.append(dict(duplicate=False, client_id=int(cid),
                                       cmd_id=int(mid), ok=False, leader=int(ldr)))
