"""MinPaxos (global-ballot stable-leader Multi-Paxos), batched over replicas.

The port of the JAX package's ``models/minpaxos.py``. There, one
``replica_step_impl`` advances ONE replica and is ``vmap``-ed over the
replica and shard axes; here every function takes an explicit leading
batch axis B (groups x replicas, flattened): per-replica scalars are
[B] tensors, per-slot arrays [B, S], message batches [B, M]. The
sections, their order and their predicates follow the JAX step line by
line (section numbers in the comments match it), so the state after a
step equals the JAX state leaf for leaf.

Differences of form, not of result:

* ``x[idx]`` is ``torch.gather`` along dim 1; indices JAX would clamp
  are clipped explicitly.
* ``.at[t].max(v, mode="drop")`` scatters into [B, S+1] through the K2
  kernel (ops/winner.py), the last column being the sink.
* votes/pvotes are uint16 bit masks in the JAX state; the port carries
  them as int32 (torch on the CPU has no uint16 shifts or popcount) and
  exports uint16 (``to_numpy_state``).
* Only the ``gate_exec=False`` form of the execute section exists: it is
  what every pod/sharded composition runs, and the gated form computes
  the same result.
* The window slide is a gather at (i + shift) % S with a per-replica
  shift, not ``torch.roll``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from minpaxos_tpu_torch.ops.ackruns import (
    compress_ack_runs,
    range_vote_bits,
    scatter_vote_bits,
)
from minpaxos_tpu_torch.ops.kvstore import KVState, kv_apply_batch, kv_init
from minpaxos_tpu_torch.ops.scan import commit_frontier
from minpaxos_tpu_torch.ops.util import (
    I32,
    argmax_first,
    argmin_first,
    col,
    floordiv,
    masked_max,
    popcount,
    take,
)
from minpaxos_tpu_torch.ops.winner import scatter_max
from minpaxos_tpu_torch.wire.messages import (
    ACCEPTED,
    COMMITTED,
    EXECUTED,
    NONE,
    MsgKind,
)

NO_BALLOT = -1
U8 = torch.uint8


def make_ballot(counter, replica_id):
    """(counter << 4) | id; caps replicas at 16."""
    return counter * 16 + replica_id


class MinPaxosConfig(NamedTuple):
    """Static protocol parameters (the JAX config's fields, same order
    and defaults; see its field notes)."""

    n_replicas: int = 3
    window: int = 1 << 16
    inbox: int = 4096
    exec_batch: int = 4096
    kv_pow2: int = 16
    catchup_rows: int = 64
    recovery_rows: int = 256
    noop_delay: int = 8
    slide_window: bool = True
    retention: int = -1
    gate_exec: bool = True
    gossip_ticks: int = 1
    route_fabric: str = "segmented"
    compact_inbox: int = 0
    explicit_commit: bool = False
    q1: int = 0
    q2: int = 0
    fast_path: bool = False
    q_fast: int = 0

    @property
    def quorum1(self) -> int:
        return self.q1 or self.n_replicas // 2 + 1

    @property
    def quorum2(self) -> int:
        return self.q2 or self.n_replicas // 2 + 1

    @property
    def quorum_fast(self) -> int:
        return self.q_fast or self.n_replicas


class MsgBatch(NamedTuple):
    """Struct-of-arrays message batch, int32 [B, M] per column; kind 0
    rows are padding."""

    kind: torch.Tensor
    src: torch.Tensor
    ballot: torch.Tensor
    inst: torch.Tensor
    last_committed: torch.Tensor
    op: torch.Tensor
    key_hi: torch.Tensor
    key_lo: torch.Tensor
    val_hi: torch.Tensor
    val_lo: torch.Tensor
    cmd_id: torch.Tensor
    client_id: torch.Tensor

    @staticmethod
    def empty(b: int, m: int, device) -> "MsgBatch":
        return MsgBatch(*[torch.zeros((b, m), dtype=I32, device=device)
                          for _ in range(12)])

    def stacked(self) -> torch.Tensor:
        """The 12 columns as one int32 [12, *shape] tensor."""
        return torch.stack(list(self))

    @staticmethod
    def from_stacked(x: torch.Tensor) -> "MsgBatch":
        return MsgBatch(*x.unbind(0))


class Outbox(NamedTuple):
    """Per-input-row responses (row i derived from inbox row i), then the
    appended sweep / gossip / catch-up / retry rows. dst -1 broadcasts,
    >= 0 unicasts, -2 goes to the client. ``acked`` is bool[B, M_in]."""

    msgs: MsgBatch
    dst: torch.Tensor
    acked: torch.Tensor


class ExecResult(NamedTuple):
    """Newly executed slots this step: lo/count [B], the rest [B, E]."""

    lo: torch.Tensor
    count: torch.Tensor
    val_hi: torch.Tensor
    val_lo: torch.Tensor
    found: torch.Tensor
    op: torch.Tensor
    cmd_id: torch.Tensor
    client_id: torch.Tensor


class ReplicaState(NamedTuple):
    """Everything the replicas own, batched over B. Field order and
    dtypes follow the JAX ReplicaState (the golden digests hash the
    leaves in this order), except votes/pvotes: int32 here, uint16
    there."""

    ballot: torch.Tensor  # i32[B, S]
    status: torch.Tensor  # u8[B, S]
    op: torch.Tensor  # u8[B, S]
    key_hi: torch.Tensor
    key_lo: torch.Tensor
    val_hi: torch.Tensor
    val_lo: torch.Tensor
    cmd_id: torch.Tensor
    client_id: torch.Tensor
    votes: torch.Tensor  # i32[B, S] bit mask (u16 in the JAX state)
    me: torch.Tensor  # i32[B]
    window_base: torch.Tensor
    crt_inst: torch.Tensor
    committed_upto: torch.Tensor
    executed_upto: torch.Tensor
    default_ballot: torch.Tensor
    max_recv_ballot: torch.Tensor
    leader_id: torch.Tensor
    prepared: torch.Tensor  # bool[B]
    prepare_oks: torch.Tensor  # bool[B, R]
    peer_commits: torch.Tensor  # i32[B, R]
    tick: torch.Tensor
    stall_ticks: torch.Tensor
    pvotes: torch.Tensor  # i32[B, S] bit mask (u16 in the JAX state)
    rec_cursor: torch.Tensor
    tenure_start: torch.Tensor
    gossip_upto: torch.Tensor
    kv: KVState


def init_replica(cfg: MinPaxosConfig, me, device="cuda") -> ReplicaState:
    """Fresh states for replicas ``me`` (a sequence of replica ids, one
    per batch row)."""
    from minpaxos_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    me = torch.as_tensor(me, dtype=I32, device=dev).reshape(-1)
    b, s, r = me.shape[0], cfg.window, cfg.n_replicas

    def zs(dtype=I32):
        return torch.zeros((b, s), dtype=dtype, device=dev)

    def sc(v):
        return torch.full((b,), v, dtype=I32, device=dev)

    return ReplicaState(
        ballot=torch.full((b, s), NO_BALLOT, dtype=I32, device=dev),
        status=zs(U8), op=zs(U8), key_hi=zs(), key_lo=zs(), val_hi=zs(),
        val_lo=zs(), cmd_id=zs(), client_id=zs(), votes=zs(),
        me=me.clone(), window_base=sc(0), crt_inst=sc(0), committed_upto=sc(-1),
        executed_upto=sc(-1), default_ballot=sc(NO_BALLOT),
        max_recv_ballot=sc(NO_BALLOT), leader_id=sc(-1),
        prepared=torch.zeros(b, dtype=torch.bool, device=dev),
        prepare_oks=torch.zeros((b, r), dtype=torch.bool, device=dev),
        peer_commits=torch.full((b, r), -1, dtype=I32, device=dev),
        tick=sc(0), stall_ticks=sc(0), pvotes=zs(), rec_cursor=sc(0),
        tenure_start=sc(0), gossip_upto=sc(-1),
        kv=kv_init(cfg.kv_pow2, b, dev),
    )


def become_leader(cfg: MinPaxosConfig, state: ReplicaState,
                  which: torch.Tensor) -> tuple[ReplicaState, MsgBatch]:
    """Start an election on the rows where ``which`` (bool[B]): bump to a
    fresh unique ballot and emit a broadcast PREPARE row ([B, 1]; kind 0
    on the other rows)."""
    b = which.shape[0]
    dev = which.device
    counter = floordiv(state.max_recv_ballot, 16) + 1
    new_ballot = make_ballot(counter, state.me).to(I32)
    w = which

    def sel(new, old):
        mask = w if old.dim() == 1 else w.view(-1, *([1] * (old.dim() - 1)))
        return torch.where(mask, new, old)

    oks = torch.nn.functional.one_hot(state.me.long(), cfg.n_replicas).bool()
    state = state._replace(
        default_ballot=sel(new_ballot, state.default_ballot),
        max_recv_ballot=sel(torch.maximum(state.max_recv_ballot, new_ballot),
                            state.max_recv_ballot),
        leader_id=sel(state.me, state.leader_id),
        prepared=sel(torch.zeros_like(state.prepared), state.prepared),
        prepare_oks=sel(oks, state.prepare_oks),
        pvotes=sel(torch.zeros_like(state.pvotes), state.pvotes),
        rec_cursor=sel(state.committed_upto + 1, state.rec_cursor),
        tenure_start=sel(state.crt_inst, state.tenure_start),
    )
    out = MsgBatch.empty(b, 1, dev)
    out = out._replace(
        kind=torch.where(w, int(MsgKind.PREPARE), 0).to(I32)[:, None],
        src=torch.where(w, state.me, 0)[:, None],
        ballot=torch.where(w, new_ballot, 0)[:, None],
        last_committed=torch.where(w, state.committed_upto, 0)[:, None],
    )
    return state, out


def concat_rows(a: MsgBatch, b: MsgBatch) -> MsgBatch:
    return MsgBatch(*[torch.cat([x, y], dim=-1) for x, y in zip(a, b)])


def _rel(window_base, inst, window: int):
    """Absolute instance -> window index; out-of-window -> ``window``."""
    rel = inst - col(window_base)
    ok = (rel >= 0) & (rel < window)
    return torch.where(ok, rel, window), ok


def replica_step_impl(cfg: MinPaxosConfig, state: ReplicaState, inbox: MsgBatch,
                      tick_inc: int = 1) -> tuple[ReplicaState, Outbox, ExecResult]:
    """Advance every replica of the batch by one message batch each
    (inbox [B, M]). Pure except for the K4 insert on CUDA, which updates
    ``state.kv`` in place (ops/kvstore.py)."""
    S, R = cfg.window, cfg.n_replicas
    B, M = inbox.kind.shape
    dev = inbox.kind.device
    quorum1 = cfg.quorum1
    quorum2 = cfg.quorum_fast if cfg.fast_path else cfg.quorum2
    st = SimpleNamespace(**state._asdict())
    k = inbox.kind
    is_prep = k == int(MsgKind.PREPARE)
    is_prep_reply = k == int(MsgKind.PREPARE_REPLY)
    is_accept = k == int(MsgKind.ACCEPT)
    is_accept_reply = k == int(MsgKind.ACCEPT_REPLY)
    is_commit = k == int(MsgKind.COMMIT)
    is_cshort = k == int(MsgKind.COMMIT_SHORT)
    is_propose = k == int(MsgKind.PROPOSE)

    def is_leader():
        return st.leader_id == st.me

    def where(c, a, b):
        return torch.where(c, a, b)

    out = SimpleNamespace(**MsgBatch.empty(B, M, dev)._asdict())
    dst = torch.full((B, M), -1, dtype=I32, device=dev)

    # ---- 1. PREPARE ----
    prep_b = where(is_prep, inbox.ballot, NO_BALLOT)
    prep_ballot = prep_b.amax(1)
    any_prep = is_prep.any(1)
    prep_src = take(inbox.src, argmax_first(prep_b))
    adopt = any_prep & (prep_ballot > st.default_ballot)
    st.default_ballot = where(adopt, prep_ballot, st.default_ballot)
    st.leader_id = where(adopt, prep_src, st.leader_id)
    st.prepared = where(adopt, False, st.prepared)
    st.max_recv_ballot = torch.maximum(st.max_recv_ballot, prep_ballot)
    prep_ok = is_prep & (inbox.ballot >= col(st.default_ballot))
    out.kind = where(is_prep, int(MsgKind.PREPARE_REPLY), out.kind)
    out.src = where(is_prep, col(st.me), out.src)
    out.ballot = where(is_prep, col(st.default_ballot), out.ballot)
    out.inst = where(is_prep, col(st.crt_inst), out.inst)
    out.last_committed = where(is_prep, col(st.committed_upto), out.last_committed)
    out.op = where(is_prep, prep_ok.to(I32), out.op)
    dst = where(is_prep, inbox.src, dst)

    # ---- 1c. PREPARE_INST_REPLY (value adoption + pvotes) ----
    is_pir = k == int(MsgKind.PREPARE_INST_REPLY)
    me_bit = torch.bitwise_left_shift(torch.ones_like(st.me), st.me)
    src_bit = torch.bitwise_left_shift(torch.ones_like(inbox.src),
                                       inbox.src.clamp(0, R - 1))
    rows_m = torch.arange(M, dtype=I32, device=dev).expand(B, M)
    rel_i, in_win_i = _rel(st.window_base, inbox.inst, S)
    rel_i_safe = rel_i.clamp(max=S - 1)

    def at_rel(a):
        return take(a, rel_i_safe)

    pv_ok = (is_pir & col(is_leader())
             & (inbox.last_committed == col(st.default_ballot)) & in_win_i)
    st.pvotes = st.pvotes | scatter_vote_bits(S, rel_i, inbox.src, pv_ok, R)
    pir_ok = (pv_ok & (at_rel(st.status) < COMMITTED)
              & (inbox.ballot > at_rel(st.ballot)))
    vb_max = scatter_max(S, rel_i, inbox.ballot, pir_ok, NO_BALLOT)
    pir_win = pir_ok & (inbox.ballot == take(vb_max, rel_i_safe))
    hit_v = vb_max[:, :S] > NO_BALLOT
    ballot1 = where(hit_v, vb_max[:, :S], st.ballot)

    # ---- 2. ACCEPT ----
    acc_b = where(is_accept, inbox.ballot, NO_BALLOT)
    acc_max_ballot = acc_b.amax(1)
    deposed = acc_max_ballot > st.default_ballot
    acc_max_src = take(inbox.src, argmax_first(acc_b))
    st.leader_id = where(deposed, acc_max_src, st.leader_id)
    st.prepared = where(deposed, False, st.prepared)
    acc_pre = (is_accept & in_win_i
               & (inbox.ballot >= col(st.default_ballot))
               & (inbox.ballot >= take(ballot1, rel_i_safe))
               & (at_rel(st.status) < COMMITTED))
    ab_max = scatter_max(S, rel_i, inbox.ballot, acc_pre, NO_BALLOT)
    acc_ok = acc_pre & (inbox.ballot == take(ab_max, rel_i_safe))

    # ---- fused slot write A (PIR + ACCEPT), key = section * M + row ----
    okA = pir_win | acc_ok
    keyA = scatter_max(S, rel_i, where(acc_ok, M + rows_m, rows_m), okA, -1)[:, :S]
    hitA = keyA >= 0
    secA_acc = keyA >= M
    rowA = torch.remainder(keyA, M)

    def atA(a):
        return take(a, rowA)

    st.ballot = where(hitA, atA(inbox.ballot), st.ballot)
    st.status = where(hitA, ACCEPTED, st.status)
    st.op = where(hitA, atA(inbox.op).to(U8), st.op)
    st.key_hi = where(hitA, atA(inbox.key_hi), st.key_hi)
    st.key_lo = where(hitA, atA(inbox.key_lo), st.key_lo)
    st.val_hi = where(hitA, atA(inbox.val_hi), st.val_hi)
    st.val_lo = where(hitA, atA(inbox.val_lo), st.val_lo)
    st.cmd_id = where(hitA, atA(inbox.cmd_id), st.cmd_id)
    st.client_id = where(hitA, atA(inbox.client_id), st.client_id)
    st.votes = where(hitA, where(secA_acc, atA(src_bit), col(me_bit)), st.votes)
    st.default_ballot = torch.maximum(st.default_ballot, acc_max_ballot)
    st.max_recv_ballot = torch.maximum(st.max_recv_ballot, acc_max_ballot)
    st.crt_inst = torch.maximum(
        st.crt_inst,
        torch.maximum(masked_max(inbox.inst, pir_ok, -1),
                      masked_max(inbox.inst, acc_ok, -1)) + 1)
    acc_com_match = (
        is_accept & in_win_i
        & (at_rel(st.status) >= COMMITTED)
        & (at_rel(st.op).to(I32) == inbox.op)
        & (at_rel(st.key_hi) == inbox.key_hi)
        & (at_rel(st.key_lo) == inbox.key_lo)
        & (at_rel(st.val_hi) == inbox.val_hi)
        & (at_rel(st.val_lo) == inbox.val_lo)
        & (at_rel(st.cmd_id) == inbox.cmd_id)
        & (at_rel(st.client_id) == inbox.client_id))
    ack_ok_row = acc_ok | acc_com_match
    run_start, run_len = compress_ack_runs(is_accept, inbox.src, inbox.inst,
                                           ack_ok_row)
    out.kind = where(is_accept,
                     where(run_start, int(MsgKind.ACCEPT_REPLY), 0).to(I32),
                     out.kind)
    out.src = where(is_accept, col(st.me), out.src)
    out.inst = where(is_accept, inbox.inst, out.inst)
    out.ballot = where(is_accept, col(st.default_ballot), out.ballot)
    out.op = where(is_accept, ack_ok_row.to(I32), out.op)
    out.cmd_id = where(is_accept, run_len, out.cmd_id)
    out.last_committed = where(is_accept, col(st.committed_upto), out.last_committed)
    dst = where(is_accept, inbox.src, dst)
    committish = ((is_commit | is_cshort) if cfg.explicit_commit
                  else (is_accept | is_commit | is_cshort))
    lc = masked_max(inbox.last_committed,
                    committish & (inbox.ballot >= col(st.default_ballot)), -1)

    # ---- 2b. PREPARE_INST (answer phase 1 truthfully) ----
    is_pinst = k == int(MsgKind.PREPARE_INST)
    pi_answer = (is_pinst & (inbox.ballot >= col(st.default_ballot))
                 & (in_win_i | (inbox.inst >= col(st.crt_inst))))
    pi_com = pi_answer & in_win_i & (at_rel(st.status) >= COMMITTED)
    pi_occ = pi_answer & ~pi_com & in_win_i & (at_rel(st.status) >= ACCEPTED)
    pi_val = pi_com | pi_occ
    out.kind = where(pi_com, int(MsgKind.COMMIT),
                     where(pi_answer & ~pi_com, int(MsgKind.PREPARE_INST_REPLY),
                           out.kind))
    out.src = where(pi_answer, col(st.me), out.src)
    out.inst = where(pi_answer, inbox.inst, out.inst)
    out.ballot = where(pi_val, at_rel(st.ballot),
                       where(pi_answer, NO_BALLOT, out.ballot))
    out.last_committed = where(pi_com, col(st.committed_upto),
                               where(pi_answer, inbox.ballot, out.last_committed))
    out.op = where(pi_val, at_rel(st.op).to(I32), where(pi_answer, 0, out.op))
    for f in ("key_hi", "key_lo", "val_hi", "val_lo", "cmd_id", "client_id"):
        setattr(out, f, where(pi_val, at_rel(getattr(st, f)), getattr(out, f)))
    dst = where(pi_answer, inbox.src, dst)
    st.crt_inst = torch.maximum(st.crt_inst, masked_max(inbox.inst, is_pinst, -1) + 1)

    # ---- 3. COMMIT rows ----
    com_mask = is_commit | is_cshort
    com_any = com_mask.any(1)
    com_b = where(com_mask, inbox.ballot, NO_BALLOT)
    com_bal = com_b.amax(1)
    com_src = take(inbox.src, argmax_first(com_b))
    adopt_com = com_any & (st.leader_id < 0) & (com_bal >= st.default_ballot)
    st.leader_id = where(adopt_com, com_src, st.leader_id)
    com_ok = is_commit & in_win_i
    st.crt_inst = torch.maximum(st.crt_inst, masked_max(inbox.inst, com_ok, -1) + 1)

    # ---- 4. PREPARE_REPLY ----
    pr_ok = (is_prep_reply & (inbox.ballot == col(st.default_ballot))
             & (inbox.op > 0) & col(is_leader()))
    pr_idx = torch.where(inbox.src < 0, inbox.src + R, inbox.src)  # JAX wraps
    pr_idx = where(pr_ok & (pr_idx >= 0) & (pr_idx < R), pr_idx, R)
    oks = torch.zeros((B, R + 1), dtype=torch.bool, device=dev)
    oks.scatter_(1, pr_idx.long(), torch.ones_like(pr_ok))
    st.prepare_oks = st.prepare_oks | oks[:, :R]
    st.max_recv_ballot = torch.maximum(
        st.max_recv_ballot, masked_max(inbox.ballot, is_prep_reply, NO_BALLOT))
    st.crt_inst = torch.maximum(st.crt_inst, masked_max(inbox.inst, pr_ok, -1))
    st.tenure_start = where(st.prepared, st.tenure_start, st.crt_inst)
    st.prepared = st.prepared | (is_leader()
                                 & (st.prepare_oks.sum(1) >= quorum1))

    # ---- 5. PROPOSE ----
    can_serve = is_leader() & st.prepared
    if cfg.fast_path:
        can_fast = (~is_leader()) & (st.leader_id >= 0) & (st.default_ballot > NO_BALLOT)
        prop = is_propose & col(can_serve | can_fast)
    else:
        prop = is_propose & col(can_serve)
    slot_off = torch.cumsum(prop.to(I32), 1, dtype=I32) - 1
    slots = col(st.crt_inst) + slot_off
    rel_p = slots - col(st.window_base)
    fits = prop & (rel_p >= 0) & (rel_p < S)

    # ---- fused slot write B (COMMIT + PROPOSE) ----
    okB = com_ok | fits
    keyB = scatter_max(S, where(fits, rel_p, rel_i),
                       where(fits, M + rows_m, rows_m), okB, -1)[:, :S]
    hitB = keyB >= 0
    secB_prop = keyB >= M
    rowB = torch.remainder(keyB, M)

    def atB(a):
        return take(a, rowB)

    st.ballot = where(hitB, where(secB_prop, col(st.default_ballot),
                                  atB(inbox.ballot)), st.ballot)
    st.status = where(hitB, where(secB_prop,
                                  ACCEPTED,
                                  st.status.clamp(min=COMMITTED)), st.status)
    st.op = where(hitB, atB(inbox.op).to(U8), st.op)
    for f in ("key_hi", "key_lo", "val_hi", "val_lo", "cmd_id", "client_id"):
        setattr(st, f, where(hitB, atB(getattr(inbox, f)), getattr(st, f)))
    st.votes = where(hitB & secB_prop, col(me_bit), st.votes)
    st.crt_inst = st.crt_inst + fits.sum(1, dtype=I32)
    reject = is_propose & ~fits
    out.kind = where(fits, int(MsgKind.ACCEPT),
                     where(reject, int(MsgKind.PROPOSE_REPLY), out.kind))
    out.src = where(is_propose, col(st.me), out.src)
    out.inst = where(fits, slots, out.inst)
    out.ballot = where(fits, col(st.default_ballot),
                       where(reject, col(st.leader_id), out.ballot))
    out.last_committed = where(fits, col(st.committed_upto), out.last_committed)
    out.op = where(fits, inbox.op, where(reject, 0, out.op))
    for f in ("key_hi", "key_lo", "val_hi", "val_lo", "cmd_id", "client_id"):
        setattr(out, f, where(is_propose, getattr(inbox, f), getattr(out, f)))
    dst = where(fits, -1, where(reject, -2, dst))
    if cfg.fast_path:
        fastrow = fits & col(~is_leader())
        out.kind = where(fastrow, int(MsgKind.ACCEPT_REPLY), out.kind)
        out.op = where(fastrow, 2, out.op)
        out.cmd_id = where(fastrow, 1, out.cmd_id)
        out.val_hi = where(fastrow, 0, out.val_hi)
        out.val_lo = where(fastrow, inbox.cmd_id, out.val_lo)
        dst = where(fastrow, col(st.leader_id), dst)

    # ---- 6. ACCEPT_REPLY (range acks -> votes) ----
    ar_ok = (is_accept_reply & (inbox.op > 0) & col(is_leader())
             & (inbox.ballot == col(st.default_ballot)))
    if cfg.fast_path:
        ar_rel = inbox.inst - col(st.window_base)
        ar_safe = ar_rel.clamp(0, S - 1)
        fast_match = ((ar_rel >= 0) & (ar_rel < S)
                      & (take(st.status, ar_safe) >= ACCEPTED)
                      & (take(st.ballot, ar_safe) == col(st.default_ballot))
                      & (take(st.cmd_id, ar_safe) == inbox.val_lo)
                      & (take(st.client_id, ar_safe) == inbox.client_id))
        ar_ok = ar_ok & ((inbox.op != 2) | fast_match)
    vote_bits = range_vote_bits(ar_ok, inbox.src, inbox.inst, inbox.cmd_id,
                                st.window_base, S, R)
    reply_src = where(is_accept_reply | is_prep_reply, inbox.src.clamp(0, R - 1), R)
    pc_seen = scatter_max(R, reply_src, inbox.last_committed,
                          torch.ones_like(is_prep), -(2 ** 30))
    replied = pc_seen[:, :R] > -(2 ** 30)
    st.votes = st.votes | vote_bits
    st.max_recv_ballot = torch.maximum(
        st.max_recv_ballot, masked_max(inbox.ballot, is_accept_reply, NO_BALLOT))
    st.peer_commits = where(replied, pc_seen[:, :R], st.peer_commits)

    # ---- 7. commit scan ----
    sidx = torch.arange(S, dtype=I32, device=dev)[None, :]
    idx_abs = col(st.window_base) + sidx
    n_votes = popcount(st.votes)
    status_acc = st.status == ACCEPTED
    if cfg.explicit_commit:
        leader_commit = col(is_leader()) & status_acc & (n_votes >= quorum2)
    else:
        leader_commit = (col(is_leader()) & status_acc & (n_votes >= quorum2)
                         & (st.ballot == col(st.default_ballot)))
    follower_commit = (status_acc & (idx_abs <= col(lc))
                       & (st.ballot == col(st.default_ballot)))
    st.status = where(leader_commit | follower_commit,
                      COMMITTED, st.status)
    start_rel = st.committed_upto + 1 - st.window_base
    frontier_rel = commit_frontier(st.status >= COMMITTED, start_rel)
    old_upto = st.committed_upto
    st.committed_upto = torch.maximum(st.committed_upto,
                                      frontier_rel + st.window_base)

    # ---- 7b. frontier gossip + stall tracking ----
    advanced = st.committed_upto > old_upto
    in_flight = st.crt_inst - 1 > st.committed_upto
    st.tick = st.tick + tick_inc
    st.stall_ticks = where(is_leader() & st.prepared & in_flight & ~advanced,
                           st.stall_ticks + tick_inc, 0)
    if cfg.gossip_ticks > 1:
        cadence = torch.remainder(st.tick, cfg.gossip_ticks) == 0
    else:
        cadence = torch.ones(B, dtype=torch.bool, device=dev)
    behind = st.committed_upto > st.gossip_upto
    if cfg.explicit_commit:
        lead_adv = is_leader() & st.prepared & (st.committed_upto >= 0)
    else:
        lead_adv = is_leader() & st.prepared & cadence & behind
    got_committy = (is_accept | is_commit | is_cshort | is_pir).any(1)
    fol_report = (~is_leader()) & (st.leader_id >= 0) & (got_committy | (cadence & behind))
    st.gossip_upto = where(lead_adv | fol_report, st.committed_upto, st.gossip_upto)
    fb = MsgBatch.empty(B, 1, dev)._replace(
        kind=where(lead_adv, int(MsgKind.COMMIT_SHORT),
                   where(fol_report, int(MsgKind.ACCEPT_REPLY), 0)).to(I32)[:, None],
        src=col(st.me).clone(),
        ballot=col(st.default_ballot).clone(),
        inst=col(st.committed_upto.clamp(min=0)),
        last_committed=col(st.committed_upto).clone(),
    )
    fb_dst = where(lead_adv, -1, st.leader_id.clamp(0, R - 1)).to(I32)[:, None]

    # ---- 7c. catch-up ----
    K = cfg.catchup_rows
    kix = torch.arange(K, dtype=I32, device=dev)[None, :]
    rix = torch.arange(R, dtype=I32, device=dev)[None, :]
    pc_masked = where(rix == col(st.me), 2 ** 30, st.peer_commits)
    worst = argmin_first(pc_masked).to(I32)
    rr = torch.remainder(floordiv(st.tick, 2), R)
    peer = where(torch.remainder(st.tick, 2) == 0, worst, rr).to(I32)
    pc_peer = take(st.peer_commits, peer)
    lagging = pc_peer < st.committed_upto
    do_cu = is_leader() & st.prepared & (peer != st.me) & lagging
    cu_slots = col(pc_peer) + 1 + kix
    cu_rel = cu_slots - col(st.window_base)
    cu_ok = col(do_cu) & (cu_slots <= col(st.committed_upto)) & (cu_rel >= 0) & (cu_rel < S)
    cu_rel_safe = cu_rel.clamp(0, S - 1)

    def rows_from(rel_safe, kind_mask, inst, n):
        return MsgBatch(
            kind=where(kind_mask, int(MsgKind.ACCEPT), 0).to(I32),
            src=col(st.me).expand(B, n).clone(),
            ballot=col(st.default_ballot).expand(B, n).clone(),
            inst=inst,
            last_committed=col(st.committed_upto).expand(B, n).clone(),
            op=take(st.op, rel_safe).to(I32),
            key_hi=take(st.key_hi, rel_safe),
            key_lo=take(st.key_lo, rel_safe),
            val_hi=take(st.val_hi, rel_safe),
            val_lo=take(st.val_lo, rel_safe),
            cmd_id=take(st.cmd_id, rel_safe),
            client_id=take(st.client_id, rel_safe),
        )

    cu = rows_from(cu_rel_safe, cu_ok, cu_slots, K)

    # ---- 7d. in-flight retry + gap no-op fill ----
    do_rt = is_leader() & st.prepared & (st.stall_ticks >= 4)
    rt_slots = col(st.committed_upto) + 1 + kix
    rt_rel = rt_slots - col(st.window_base)
    rt_rel_safe = rt_rel.clamp(0, S - 1)
    rt_in = col(do_rt) & (rt_slots < col(st.crt_inst)) & (rt_rel >= 0) & (rt_rel < S)
    st_rt = take(st.status, rt_rel_safe)
    rt_empty = rt_in & (st_rt == NONE)
    pv_cnt = popcount(take(st.pvotes, rt_rel_safe))
    noop_fill = rt_empty & (pv_cnt >= quorum1)
    own_ballot = take(st.ballot, rt_rel_safe) == col(st.default_ballot)
    settled = (pv_cnt >= quorum1) | (st_rt >= COMMITTED)
    rt_ok = rt_in & (((st_rt >= ACCEPTED) & (own_ballot | settled)) | noop_fill)
    bump = rt_ok & (take(st.ballot, rt_rel_safe) != col(st.default_ballot))
    rt_row = sidx - rt_rel[:, :1]
    rt_row_safe = rt_row.clamp(0, K - 1)
    in_rt = (rt_row >= 0) & (rt_row < K)
    hit_b = in_rt & take(bump, rt_row_safe)
    hit_n = in_rt & take(noop_fill, rt_row_safe)
    st.ballot = where(hit_b, col(st.default_ballot), st.ballot)
    st.status = where(hit_n, ACCEPTED, st.status)
    st.op = where(hit_n, 0, st.op)
    st.cmd_id = where(hit_n, 0, st.cmd_id)
    st.client_id = where(hit_n, -1, st.client_id)
    st.votes = where(hit_b, col(me_bit), st.votes)
    rt = rows_from(rt_rel_safe, rt_ok, rt_slots, K)

    # ---- 7e. per-instance phase-1 sweep ----
    K2 = cfg.recovery_rows
    sweep_on = is_leader() & st.prepared
    limit = torch.minimum(st.crt_inst, st.tenure_start)
    done = st.rec_cursor >= limit
    rescan = sweep_on & done & in_flight & (st.stall_ticks >= cfg.noop_delay)
    eff_limit = where(rescan, st.crt_inst, limit)
    cursor = where(rescan, st.committed_upto + 1, st.rec_cursor)
    cursor = torch.maximum(cursor, st.committed_upto + 1)
    pi_slots = col(cursor) + torch.arange(K2, dtype=I32, device=dev)[None, :]
    pi_rel = pi_slots - col(st.window_base)
    pi_row = sidx - pi_rel[:, :1]
    pi_ok = col(sweep_on) & (pi_slots < col(eff_limit)) & (pi_rel >= 0) & (pi_rel < S)
    pi = MsgBatch.empty(B, K2, dev)._replace(
        kind=where(pi_ok, int(MsgKind.PREPARE_INST), 0).to(I32),
        src=col(st.me).expand(B, K2).clone(),
        ballot=col(st.default_ballot).expand(B, K2).clone(),
        inst=pi_slots,
    )
    pi_hit = (pi_row >= 0) & (pi_row < K2) & take(pi_ok, pi_row.clamp(0, K2 - 1))
    st.pvotes = st.pvotes | where(pi_hit, col(me_bit), 0)
    st.rec_cursor = where(sweep_on, torch.minimum(cursor + K2, eff_limit), cursor)

    msgs = concat_rows(concat_rows(concat_rows(concat_rows(
        MsgBatch(**vars(out)), pi), fb), cu), rt)
    dst = torch.cat([
        dst,
        torch.full((B, K2), -1, dtype=I32, device=dev),
        fb_dst,
        col(peer).expand(B, K),
        torch.full((B, K), -1, dtype=I32, device=dev),
    ], 1)

    # ---- 8. execute (the gate_exec=False form) ----
    E = cfg.exec_batch
    eix = torch.arange(E, dtype=I32, device=dev)[None, :]
    avail = st.committed_upto - st.executed_upto
    n_exec = avail.clamp(0, E)
    exec_lo = st.executed_upto + 1
    rel_e = col(exec_lo - st.window_base) + eix
    evalid = eix < col(n_exec)
    rel_e_safe = rel_e.clamp(0, S - 1)
    op_e = where(evalid, take(st.op, rel_e_safe).to(I32), 0)
    kv, o_hi, o_lo, o_found = kv_apply_batch(
        st.kv, op_e, take(st.key_hi, rel_e_safe), take(st.key_lo, rel_e_safe),
        take(st.val_hi, rel_e_safe), take(st.val_lo, rel_e_safe), evalid)
    st.kv = kv
    st.executed_upto = st.executed_upto + n_exec
    ex_lo = rel_e[:, :1]
    st.status = where((sidx >= ex_lo) & (sidx < ex_lo + col(n_exec)),
                      EXECUTED, st.status)
    execr = ExecResult(
        lo=exec_lo, count=n_exec, val_hi=o_hi, val_lo=o_lo, found=o_found,
        op=op_e,
        cmd_id=where(evalid, take(st.cmd_id, rel_e_safe), 0),
        client_id=where(evalid, take(st.client_id, rel_e_safe), 0),
    )

    # ---- 9. window slide ----
    if cfg.slide_window:
        retention = cfg.retention if cfg.retention >= 0 else S // 2
        target = st.executed_upto + 1 - retention
        shift = (target - st.window_base).clamp(0, S)
        gone = sidx >= col(S - shift)
        src_ix = torch.remainder(sidx + col(shift), S)

        def slide(a, fill):
            return where(gone, fill, take(a, src_ix))

        st.ballot = slide(st.ballot, NO_BALLOT)
        st.status = slide(st.status, NONE)
        for f in ("op", "key_hi", "key_lo", "val_hi", "val_lo", "cmd_id",
                  "client_id", "votes", "pvotes"):
            setattr(st, f, slide(getattr(st, f), 0))
        st.window_base = st.window_base + shift
    return (ReplicaState(**vars(st)), Outbox(msgs=msgs, dst=dst, acked=ack_ok_row),
            execr)


# ---- state carried across from / to the JAX package (as numpy) ----

_U16_FIELDS = ("votes", "pvotes")
_KV_FIELDS = KVState._fields


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def from_numpy_state(tree, device="cuda", cls=None):
    """A JAX replica state (ReplicaState, or MenciusState when ``cls``
    says so) given as numpy arrays (leading axes [R] or [G, R],
    flattened here to B) -> the port's state of type ``cls`` (default
    ReplicaState), leaf for leaf. votes/pvotes widen from uint16 to
    int32."""
    from minpaxos_tpu_torch.device import resolve_device

    cls = ReplicaState if cls is None else cls
    dev = resolve_device(device)
    me = np.asarray(_field(tree, "me"))
    lead = me.shape
    b = int(np.prod(lead)) if lead else 1

    def conv(x, name):
        x = np.array(x)  # a writable copy
        x = x.reshape((b,) + x.shape[len(lead):])
        if name in _U16_FIELDS:
            x = x.astype(np.int32)
        return torch.from_numpy(x).to(dev)

    kv_tree = _field(tree, "kv")
    kv = KVState(*[conv(_field(kv_tree, f), f) for f in _KV_FIELDS])
    vals = {f: conv(_field(tree, f), f) for f in cls._fields if f != "kv"}
    return cls(**vals, kv=kv)


def to_numpy_state(state, lead_shape=None):
    """The port's state (ReplicaState or MenciusState) -> the same
    NamedTuple of numpy arrays in the JAX layout and dtypes
    (votes/pvotes as uint16), leading axis reshaped to ``lead_shape``
    (e.g. (R,) or (G, R)); leaves in JAX tree order."""

    def conv(t, name):
        x = t.detach().cpu().numpy()
        if name in _U16_FIELDS:
            x = x.astype(np.uint16)
        if lead_shape is not None:
            x = x.reshape(tuple(lead_shape) + x.shape[1:])
        return np.array(x, order="C")  # keeps 0-d leaves 0-d

    cls = type(state)
    kv = KVState(*[conv(getattr(state.kv, f), f) for f in _KV_FIELDS])
    vals = {f: conv(getattr(state, f), f) for f in cls._fields if f != "kv"}
    return cls(**vals, kv=kv)


def state_leaves(state) -> list:
    """Leaves of a (numpy) replica state in JAX tree_leaves order."""
    out = []
    for f in type(state)._fields:
        v = getattr(state, f)
        if f == "kv":
            out.extend(v)
        else:
            out.append(v)
    return out
