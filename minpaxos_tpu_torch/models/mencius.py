"""Mencius (rotating-ownership multi-leader consensus), batched over replicas.

The port of the JAX package's ``models/mencius.py``. Replica r owns the
log slots i with i % R == r and proposes into them directly at ballot 0;
a replica that sees peers run ahead cedes its untouched owned slots as
no-ops (SKIP); owners commit their slots at a vote majority and
broadcast COMMIT rows; the frontier is the contiguous committed prefix
over all owners' slots; when it stalls on a dead owner's slot, the
owner's successor runs per-instance phase 1 at a takeover ballot and
no-op fills or re-drives the blocked range; committed slots above the
frontier execute early when no earlier slot of their key is unfinished.

As in ``models/minpaxos.py``, every function takes an explicit leading
batch axis B (groups x replicas): per-replica scalars are [B], per-slot
arrays [B, S], message batches [B, M]. The twelve sections follow the
JAX step line by line (the section numbers in the comments match it),
so a step leaves the state equal to the JAX state leaf for leaf. The
differences of form are those of ``models/minpaxos.py``, plus:

* votes/pvotes are int32 here (uint16 in the JAX state); popcounts are
  the int32 SWAR ``popcount``.
* the slot writes of steps 1, 2, 6 and 7b are one ``gather_rows`` each
  (ops/winner.py, the K10 kernel) for the winner that K2's
  ``slot_winner`` (or step 1's searchsorted) picked.
* step 11's slot choice (window lexsort, poison scan, gap barrier,
  ranks) is kernel K6 (``ops/mencius_exec.py``); its result feeds the
  KV engine (K3 + K4) through the same gathers as the JAX step.
* only the ``gate_exec=False`` form of step 11 exists (every pod and
  sharded composition runs it; the gated form computes the same).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from minpaxos_tpu_torch.ops.ackruns import (
    compress_ack_runs,
    range_vote_bits,
    scatter_vote_bits,
)
from minpaxos_tpu_torch.ops.kvstore import KVState, kv_apply_batch, kv_init
from minpaxos_tpu_torch.ops.mencius_exec import exec_select
from minpaxos_tpu_torch.ops.scan import advance_frontier
from minpaxos_tpu_torch.ops.util import (
    I32,
    argmin_first,
    col,
    cumsum32,
    floordiv,
    masked_max,
    popcount,
    take,
)
from minpaxos_tpu_torch.ops.winner import (
    BAL_CONST,
    BAL_ROW,
    ST_ACCEPTED,
    ST_COMMIT,
    V_KEEP,
    V_ME,
    SlotMode,
    gather_rows,
    scatter_max,
    slot_winner,
)
from minpaxos_tpu_torch.models.cluster import (
    Cluster,
    cluster_step_impl,
    collect_exec_replies,
)
from minpaxos_tpu_torch.models.minpaxos import (
    ExecResult,
    MinPaxosConfig,
    MsgBatch,
    NO_BALLOT,
    Outbox,
    U8,
    _rel,
    concat_rows,
    make_ballot,
    set_slot_cols,
    slot_cols,
)
from minpaxos_tpu_torch.wire.messages import (
    ACCEPTED,
    COMMITTED,
    EXECUTED,
    NONE,
    MsgKind,
)

_BIG = 2 ** 30
_INT32_MIN = -(2 ** 31)


class MenciusState(NamedTuple):
    """Every Mencius replica's device state, batched over B. Field order
    and dtypes follow the JAX MenciusState (the golden digests hash the
    leaves in this order), except votes/pvotes: int32 here, uint16
    there."""

    ballot: torch.Tensor  # i32[B, S]: 0 = owner ballot, > 0 takeover
    status: torch.Tensor  # u8[B, S]
    op: torch.Tensor  # u8[B, S]
    key_hi: torch.Tensor
    key_lo: torch.Tensor
    val_hi: torch.Tensor
    val_lo: torch.Tensor
    cmd_id: torch.Tensor
    client_id: torch.Tensor
    votes: torch.Tensor  # i32[B, S] acks for my driven slots
    pvotes: torch.Tensor  # i32[B, S] takeover phase-1 answers
    executed: torch.Tensor  # bool[B, S] out-of-order exec tracking
    me: torch.Tensor  # i32[B]
    window_base: torch.Tensor
    crt_own: torch.Tensor  # next owned slot to propose into
    crt_inst: torch.Tensor  # max slot seen + 1 (any owner)
    committed_upto: torch.Tensor  # the blocking frontier
    executed_upto: torch.Tensor  # contiguous executed prefix
    commit_sent: torch.Tensor  # own slots <= this had commits broadcast
    takeover_ballot: torch.Tensor  # current takeover ballot or -1
    tk_anchor: torch.Tensor  # first slot of my latest takeover span or -1
    max_recv_ballot: torch.Tensor
    tick: torch.Tensor
    stall_ticks: torch.Tensor
    peer_commits: torch.Tensor  # i32[B, R] last frontier reported per peer
    kv: KVState


def init_mencius(cfg: MinPaxosConfig, me, device="cuda") -> MenciusState:
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

    return MenciusState(
        ballot=torch.full((b, s), NO_BALLOT, dtype=I32, device=dev),
        status=zs(U8), op=zs(U8), key_hi=zs(), key_lo=zs(), val_hi=zs(),
        val_lo=zs(), cmd_id=zs(), client_id=zs(), votes=zs(), pvotes=zs(),
        executed=zs(torch.bool), me=me.clone(), window_base=sc(0),
        crt_own=me.clone(), crt_inst=sc(0), committed_upto=sc(-1),
        executed_upto=sc(-1), commit_sent=sc(-1), takeover_ballot=sc(NO_BALLOT),
        tk_anchor=sc(-1), max_recv_ballot=sc(0), tick=sc(0), stall_ticks=sc(0),
        peer_commits=torch.full((b, r), -1, dtype=I32, device=dev),
        kv=kv_init(cfg.kv_pow2, b, dev),
    )


_COLS = ("key_hi", "key_lo", "val_hi", "val_lo", "cmd_id", "client_id")


def mencius_step_impl(cfg: MinPaxosConfig, state: MenciusState, inbox: MsgBatch,
                      tick_inc: int = 1) -> tuple[MenciusState, Outbox, ExecResult]:
    """Advance every replica of the batch by one message batch each
    (inbox [B, M]). Pure except for the K4 insert on CUDA, which updates
    ``state.kv`` in place (ops/kvstore.py)."""
    S, R = cfg.window, cfg.n_replicas
    B, M = inbox.kind.shape
    dev = inbox.kind.device
    quorum1, quorum2 = cfg.quorum1, cfg.quorum2
    st = SimpleNamespace(**state._asdict())
    me = st.me
    k = inbox.kind
    idx = torch.arange(S, dtype=I32, device=dev)[None, :]
    idx_abs = col(st.window_base) + idx
    own_mask = torch.remainder(idx_abs, R) == col(me)
    is_propose = k == int(MsgKind.PROPOSE)
    is_accept = k == int(MsgKind.ACCEPT)
    is_areply = k == int(MsgKind.ACCEPT_REPLY)
    is_skip = k == int(MsgKind.SKIP)
    is_commit = k == int(MsgKind.COMMIT)
    is_pinst = k == int(MsgKind.PREPARE_INST)
    is_pir = k == int(MsgKind.PREPARE_INST_REPLY)
    where = torch.where

    out = SimpleNamespace(**MsgBatch.empty(B, M, dev)._asdict())
    dst = torch.full((B, M), -1, dtype=I32, device=dev)

    def write_rows(win, hit, mode):
        """Columns of the winning rows into the window (K10 gather_rows)."""
        set_slot_cols(st, gather_rows(mode, win, hit, inbox, slot_cols(st), me,
                                      n_replicas=R))

    # ---- 1. PROPOSE into my owned slots ----
    csum_p = cumsum32(is_propose.to(I32), 1)
    slots_p = col(st.crt_own) + R * (csum_p - 1)
    rel_p = slots_p - col(st.window_base)
    fits = is_propose & (rel_p >= 0) & (rel_p < S)
    me_bit = torch.bitwise_left_shift(torch.ones_like(me), me)
    off_p = idx_abs - col(st.crt_own)
    rank_p = floordiv(off_p, R)
    hit_p = ((off_p >= 0) & (torch.remainder(off_p, R) == 0)
             & (rank_p < csum_p[:, -1:]))
    win_p = torch.searchsorted(csum_p, (rank_p.clamp(0, M - 1) + 1).contiguous(),
                               out_int32=True)
    win_p = where(hit_p, win_p, -1)
    # ballot 0, ACCEPTED, the owner's own vote
    write_rows(win_p, hit_p, SlotMode(BAL_CONST, ST_ACCEPTED, V_ME))
    n_prop = fits.sum(1, dtype=I32)
    st.crt_inst = torch.maximum(st.crt_inst, st.crt_own + R * n_prop - R + 1)
    st.crt_own = st.crt_own + R * n_prop
    reject = is_propose & ~fits
    out.kind = where(fits, int(MsgKind.ACCEPT),
                     where(reject, int(MsgKind.PROPOSE_REPLY), out.kind)).to(I32)
    out.src = where(is_propose, col(me), out.src)
    out.inst = where(fits, slots_p, out.inst)
    out.ballot = where(fits, 0, where(reject, col(me), out.ballot))
    out.op = where(fits, inbox.op, where(reject, 0, out.op))
    for f in _COLS:
        setattr(out, f, where(is_propose, getattr(inbox, f), getattr(out, f)))
    out.last_committed = where(fits, col(st.committed_upto), out.last_committed)
    dst = where(fits, -1, where(reject, -2, dst))

    # ---- 2. ACCEPT from other owners ----
    rel_a, in_win = _rel(st.window_base, inbox.inst, S)
    rel_safe = rel_a.clamp(max=S - 1)

    def at(a):
        return take(a, rel_safe)

    owner_ok = torch.remainder(inbox.inst, R) == inbox.src
    plausible = owner_ok | (inbox.ballot > 0)
    acc_pre = (is_accept & in_win & plausible
               & (inbox.ballot >= at(st.ballot))
               & (at(st.status) < COMMITTED))
    ab_max = scatter_max(S, rel_a, inbox.ballot, acc_pre, NO_BALLOT)
    acc_ok = acc_pre & (inbox.ballot == take(ab_max, rel_safe))
    win_a, hit_a = slot_winner(S, rel_a, acc_ok)
    write_rows(win_a, hit_a, SlotMode(BAL_ROW, ST_ACCEPTED, V_KEEP))
    st.crt_inst = torch.maximum(
        st.crt_inst, masked_max(inbox.inst, is_accept & plausible, -1) + 1)
    st.max_recv_ballot = torch.maximum(st.max_recv_ballot,
                                       masked_max(inbox.ballot, is_accept, 0))
    acc_dup_ok = (
        is_accept & in_win
        & (at(st.status) >= COMMITTED)
        & (at(st.op).to(I32) == inbox.op)
        & (at(st.key_hi) == inbox.key_hi)
        & (at(st.key_lo) == inbox.key_lo)
        & (at(st.val_hi) == inbox.val_hi)
        & (at(st.val_lo) == inbox.val_lo)
        & (at(st.cmd_id) == inbox.cmd_id)
        & (at(st.client_id) == inbox.client_id))
    ack_ok_row = acc_ok | acc_dup_ok
    run_start, run_len = compress_ack_runs(is_accept, inbox.src, inbox.inst,
                                           ack_ok_row, ballot=inbox.ballot,
                                           stride=R)
    out.kind = where(is_accept,
                     where(run_start, int(MsgKind.ACCEPT_REPLY), 0).to(I32),
                     out.kind)
    out.src = where(is_accept, col(me), out.src)
    out.inst = where(is_accept, inbox.inst, out.inst)
    out.ballot = where(is_accept, inbox.ballot, out.ballot)
    out.op = where(is_accept, ack_ok_row.to(I32), out.op)
    out.cmd_id = where(is_accept, run_len, out.cmd_id)
    out.last_committed = where(is_accept, col(st.committed_upto), out.last_committed)
    dst = where(is_accept, inbox.src, dst)

    # ---- 3. skip-cede ----
    horizon = torch.maximum(masked_max(inbox.inst, is_accept & acc_ok, -1) + 1,
                            st.committed_upto + 1)
    cede = (own_mask & (idx_abs >= col(st.crt_own)) & (idx_abs < col(horizon))
            & (st.status == NONE))
    any_cede = cede.any(1)

    def noop(mask):
        st.status = where(mask, COMMITTED, st.status)
        st.ballot = where(mask, 0, st.ballot)
        st.op = where(mask, 0, st.op)
        st.cmd_id = where(mask, 0, st.cmd_id)
        st.client_id = where(mask, -1, st.client_id)

    noop(cede)
    st.crt_own = where(any_cede, horizon + torch.remainder(me - horizon, R),
                       st.crt_own)
    skip_row = MsgBatch.empty(B, 1, dev)._replace(
        kind=where(any_cede, int(MsgKind.SKIP), 0).to(I32)[:, None],
        src=col(me).clone(),
        inst=col((st.crt_own - R).clamp(min=0)),
        last_committed=col(where(cede, idx_abs, _BIG).amin(1).clamp(min=0)),
    )

    # ---- 4. SKIP rows from peers ----
    skip_src = where(is_skip, inbox.src.clamp(0, R - 1), R).long()
    starts = torch.full((B, R + 1), _BIG, dtype=I32, device=dev).scatter_reduce_(
        1, skip_src, inbox.last_committed, reduce="amin", include_self=True)
    ends = scatter_max(R, skip_src.to(I32), inbox.inst, is_skip, -1)
    owner_of = torch.remainder(idx_abs, R)
    skipped = ((idx_abs >= take(starts, owner_of)) & (idx_abs <= take(ends, owner_of))
               & (st.status < COMMITTED))
    noop(skipped)
    st.crt_inst = torch.maximum(st.crt_inst, masked_max(inbox.inst, is_skip, -1) + 1)

    # ---- 5. ACCEPT_REPLY vote counting (range acks, my driven slots) ----
    ar_ok = is_areply & (inbox.op > 0)
    drv_slot = own_mask | ((st.ballot > 0) & (torch.remainder(st.ballot, 16) == col(me)))
    st.votes = range_vote_bits(ar_ok, inbox.src, inbox.inst, inbox.cmd_id,
                               st.window_base, S, R, stride=R, into=st.votes,
                               mask=drv_slot)
    rep_row = (is_accept | is_areply | is_commit) & (inbox.src >= 0)
    rep_src = where(rep_row, inbox.src.clamp(0, R - 1), R)
    pc_seen = scatter_max(R, rep_src, inbox.last_committed, torch.ones_like(rep_row),
                          -_BIG)
    replied = pc_seen[:, :R] > -_BIG
    st.peer_commits = where(replied, pc_seen[:, :R], st.peer_commits)

    # ---- 6. COMMIT rows ----
    com_ok = is_commit & in_win
    win_c, hit_c = slot_winner(S, rel_a, com_ok)
    # a COMMIT never downgrades the status
    write_rows(win_c, hit_c, SlotMode(BAL_ROW, ST_COMMIT, V_KEEP))
    st.crt_inst = torch.maximum(
        st.crt_inst,
        masked_max(torch.maximum(inbox.inst, inbox.last_committed), is_commit, -1) + 1)

    # ---- 7a. answer PREPARE_INST ----
    pi_answer = is_pinst & (in_win | (inbox.inst >= col(st.crt_inst)))
    pi_com = pi_answer & in_win & (at(st.status) >= COMMITTED)
    pi_occ = pi_answer & ~pi_com & in_win & (at(st.status) >= ACCEPTED)
    pi_val = pi_com | pi_occ
    prom = pi_answer & ~pi_com & in_win & (inbox.ballot > at(st.ballot))
    st.ballot = torch.maximum(
        st.ballot, scatter_max(S, rel_a, inbox.ballot, prom, _INT32_MIN)[:, :S])
    out.kind = where(pi_com, int(MsgKind.COMMIT),
                     where(pi_answer & ~pi_com, int(MsgKind.PREPARE_INST_REPLY),
                           out.kind)).to(I32)
    out.src = where(pi_answer, col(me), out.src)
    out.inst = where(pi_answer, inbox.inst, out.inst)
    out.ballot = where(pi_val, at(st.ballot), where(pi_answer, NO_BALLOT, out.ballot))
    out.last_committed = where(pi_com, col(st.committed_upto),
                               where(pi_answer, inbox.ballot, out.last_committed))
    out.op = where(pi_val, at(st.op).to(I32), where(pi_answer, 0, out.op))
    for f in _COLS:
        setattr(out, f, where(pi_val, at(getattr(st, f)), getattr(out, f)))
    dst = where(pi_answer, inbox.src, dst)

    # ---- 7b. PREPARE_INST_REPLY answers to my takeover ----
    pv_ok = is_pir & (inbox.last_committed == col(st.takeover_ballot)) & in_win
    st.pvotes = scatter_vote_bits(S, rel_a, inbox.src, pv_ok, R, into=st.pvotes)
    pir_ok = (pv_ok & (at(st.status) < COMMITTED) & (inbox.ballot > NO_BALLOT)
              & (inbox.ballot > at(st.ballot)))
    vb_max = scatter_max(S, rel_a, inbox.ballot, pir_ok, NO_BALLOT)
    pir_win = pir_ok & (inbox.ballot == take(vb_max, rel_safe))
    win_v, hit_v = slot_winner(S, rel_a, pir_win)
    # adopted values are ACCEPTED with the taker's own vote
    write_rows(win_v, hit_v, SlotMode(BAL_ROW, ST_ACCEPTED, V_ME))

    # ---- 8. commit scan: my driven slots at a majority, frontier ----
    n_votes = popcount(st.votes)
    driven_by_me = own_mask | ((st.ballot > 0)
                               & (torch.remainder(st.ballot, 16) == col(me)))
    my_commit = driven_by_me & (st.status == ACCEPTED) & (n_votes >= quorum2)
    st.status = where(my_commit, COMMITTED, st.status)
    old_upto = st.committed_upto
    st.committed_upto = advance_frontier(st.status, COMMITTED, st.committed_upto,
                                         st.window_base)
    advanced = st.committed_upto > old_upto
    in_flight = st.crt_inst - 1 > st.committed_upto
    st.tick = st.tick + tick_inc
    st.stall_ticks = where(in_flight & ~advanced, st.stall_ticks + tick_inc, 0)

    def rows_at(slots, ok, kind, ballot=None):
        """Outbox rows carrying the window content at ``slots`` [B, n]."""
        n = slots.shape[1]
        safe = (slots - col(st.window_base)).clamp(0, S - 1)
        return MsgBatch(
            kind=where(ok, int(kind), 0).to(I32),
            src=col(me).expand(B, n).clone(),
            ballot=take(st.ballot, safe) if ballot is None else col(ballot).expand(B, n).clone(),
            inst=slots,
            last_committed=col(st.committed_upto).expand(B, n).clone(),
            op=take(st.op, safe).to(I32),
            **{f: take(getattr(st, f), safe) for f in _COLS})

    def in_window(slots):
        rel = slots - col(st.window_base)
        safe = rel.clamp(0, S - 1)
        return (rel >= 0) & (rel < S), safe

    # ---- 9. chunked COMMIT broadcast of my own committed slots ----
    K1 = cfg.catchup_rows
    kix = torch.arange(K1, dtype=I32, device=dev)[None, :]
    st.commit_sent = torch.maximum(st.commit_sent, st.window_base - 1)
    cb0 = st.commit_sent + 1
    cb0 = cb0 + torch.remainder(me - cb0, R)
    cb_slots = col(cb0) + R * kix
    ok_w, safe = in_window(cb_slots)
    cb_ok = ok_w & (take(st.status, safe) >= COMMITTED)
    cb = rows_at(cb_slots, cb_ok, MsgKind.COMMIT)
    pending_first = argmin_first(cb_ok.to(I32)).to(I32)
    n_resolved = where(cb_ok.all(1), K1, pending_first)
    st.commit_sent = torch.maximum(st.commit_sent, cb0 + R * n_resolved - R)

    # 9b. takeover-commit announce from my episode's anchor
    K2b = cfg.recovery_rows
    ta_slots = col(st.tk_anchor) + torch.arange(K2b, dtype=I32, device=dev)[None, :]
    ok_w, safe = in_window(ta_slots)
    ta_bal = take(st.ballot, safe)
    ta_ok = (col(st.tk_anchor >= 0) & ok_w & (take(st.status, safe) >= COMMITTED)
             & (ta_bal > 0) & (torch.remainder(ta_bal, 16) == col(me)))
    ta = rows_at(ta_slots, ta_ok, MsgKind.COMMIT)

    # 9c. own-slot accept retry after 4 stalled steps
    K3 = cfg.catchup_rows
    rt_slots = col(st.committed_upto) + 1 + torch.arange(K3, dtype=I32, device=dev)[None, :]
    ok_w, safe = in_window(rt_slots)
    rt_ok = (col(st.stall_ticks >= 4) & ok_w & (rt_slots < col(st.crt_inst))
             & take(driven_by_me, safe) & (take(st.status, safe) == ACCEPTED)
             & (take(n_votes, safe) < quorum2))
    rt = rows_at(rt_slots, rt_ok, MsgKind.ACCEPT)

    # 9d. frontier catch-up to one lagging peer (worst / round-robin)
    K4 = cfg.catchup_rows
    rix = torch.arange(R, dtype=I32, device=dev)[None, :]
    worst = argmin_first(where(rix == col(me), _BIG, st.peer_commits)).to(I32)
    rr_peer = torch.remainder(floordiv(st.tick, 2), R)
    cu_peer = where(torch.remainder(st.tick, 2) == 0, worst, rr_peer).to(I32)
    pc_peer = take(st.peer_commits, cu_peer)
    do_cu = (cu_peer != me) & (pc_peer < st.committed_upto)
    cu_slots = col(pc_peer) + 1 + torch.arange(K4, dtype=I32, device=dev)[None, :]
    ok_w, safe = in_window(cu_slots)
    cu_ok = (col(do_cu) & (cu_slots <= col(st.committed_upto)) & ok_w
             & (take(st.status, safe) >= COMMITTED))
    cu = rows_at(cu_slots, cu_ok, MsgKind.COMMIT)

    # ---- 10. takeover driver: the successor sweeps the blocked range ----
    blocking = st.committed_upto + 1
    i_am_successor = torch.remainder(torch.remainder(blocking, R) + 1, R) == me
    do_tk = in_flight & ((i_am_successor & (st.stall_ticks >= cfg.noop_delay))
                         | (st.stall_ticks >= (4 + me) * cfg.noop_delay))
    new_tb = make_ballot(floordiv(st.max_recv_ballot, 16) + 1, me).to(I32)
    fresh = do_tk & (st.takeover_ballot < 0)
    tb = where(fresh, new_tb, st.takeover_ballot)
    st.takeover_ballot = tb
    st.max_recv_ballot = torch.maximum(st.max_recv_ballot, tb)
    st.pvotes = where(col(fresh), 0, st.pvotes)
    st.tk_anchor = where(fresh, blocking, st.tk_anchor)
    K2 = cfg.recovery_rows
    tk_slots = col(blocking) + torch.arange(K2, dtype=I32, device=dev)[None, :]
    tk_rel = tk_slots - col(st.window_base)
    tk_ok = col(do_tk) & (tk_slots < col(st.crt_inst)) & (tk_rel >= 0) & (tk_rel < S)
    tk = MsgBatch.empty(B, K2, dev)._replace(
        kind=where(tk_ok, int(MsgKind.PREPARE_INST), 0).to(I32),
        src=col(me).expand(B, K2).clone(),
        ballot=col(tb).expand(B, K2).clone(),
        inst=tk_slots)
    tk_row = idx - tk_rel[:, :1]
    st.pvotes = st.pvotes | where(
        (tk_row >= 0) & (tk_row < K2) & take(tk_ok, tk_row.clamp(0, K2 - 1)),
        col(me_bit), 0)
    pv_cnt = popcount(st.pvotes)
    in_tk_span = ((idx_abs >= col(blocking)) & (idx_abs < col(blocking) + K2)
                  & (idx_abs < col(st.crt_inst)))
    fill = col(do_tk) & in_tk_span & (st.status == NONE) & (pv_cnt >= quorum1)
    st.status = where(fill, ACCEPTED, st.status)
    st.ballot = where(fill, col(tb), st.ballot)
    st.op = where(fill, 0, st.op)
    st.cmd_id = where(fill, 0, st.cmd_id)
    st.client_id = where(fill, -1, st.client_id)
    st.votes = where(fill, col(me_bit), st.votes)
    redrive = (col(do_tk) & in_tk_span & (st.status == ACCEPTED)
               & ((st.ballot == col(tb)) | (pv_cnt >= quorum1)))
    bump = redrive & (st.ballot != col(tb))
    st.ballot = where(bump, col(tb), st.ballot)
    st.votes = where(bump, col(me_bit), st.votes)
    _, safe = in_window(tk_slots)
    rd = rows_at(tk_slots, tk_ok & take(redrive, safe), MsgKind.ACCEPT, ballot=tb)
    st.takeover_ballot = where(advanced, NO_BALLOT, st.takeover_ballot)

    msgs = MsgBatch(**vars(out))
    for extra in (skip_row, cb, ta, rt, cu, tk, rd):
        msgs = concat_rows(msgs, extra)

    def fill_dst(n, v=-1):
        return torch.full((B, n), v, dtype=I32, device=dev)

    dst = torch.cat([dst, fill_dst(1), fill_dst(K1), fill_dst(K2b), fill_dst(K3),
                     col(cu_peer).expand(B, K4), fill_dst(K2), fill_dst(K2)], 1)

    # ---- 11. conflict-aware out-of-order execution ----
    E = cfg.exec_batch
    exec_lo = st.executed_upto + 1
    slot_of, newly_exec = exec_select(
        st.key_hi, st.key_lo, st.status, st.op, st.executed, st.window_base,
        st.committed_upto, st.executed_upto, E)
    evalid = slot_of < S
    slot_safe = slot_of.clamp(0, S - 1)
    op_e = where(evalid, take(st.op, slot_safe).to(I32), 0)
    kv, o_hi, o_lo, o_found = kv_apply_batch(
        st.kv, op_e, take(st.key_hi, slot_safe), take(st.key_lo, slot_safe),
        take(st.val_hi, slot_safe), take(st.val_lo, slot_safe), evalid)
    st.kv = kv
    st.executed = st.executed | newly_exec
    st.status = where(newly_exec, EXECUTED, st.status)
    st.executed_upto = advance_frontier(st.status, EXECUTED, st.executed_upto,
                                        st.window_base, executed=st.executed)
    execr = ExecResult(
        lo=exec_lo, count=evalid.sum(1, dtype=I32), val_hi=o_hi, val_lo=o_lo,
        found=o_found, op=op_e,
        cmd_id=where(evalid, take(st.cmd_id, slot_safe), 0),
        client_id=where(evalid, take(st.client_id, slot_safe), 0))

    # ---- 12. window slide ----
    if cfg.slide_window:
        retention = cfg.retention if cfg.retention >= 0 else S // 2
        shift = (st.executed_upto + 1 - retention - st.window_base).clamp(0, S)
        gone = idx >= col(S - shift)
        src_ix = torch.remainder(idx + col(shift), S)

        def slide(a, fill):
            return where(gone, fill, take(a, src_ix))

        st.ballot = slide(st.ballot, NO_BALLOT)
        st.status = slide(st.status, NONE)
        for f in ("op",) + _COLS + ("votes", "pvotes"):
            setattr(st, f, slide(getattr(st, f), 0))
        st.executed = slide(st.executed, False)
        st.window_base = st.window_base + shift
    return (MenciusState(**vars(st)), Outbox(msgs=msgs, dst=dst, acked=ack_ok_row),
            execr)


class MenciusCluster(Cluster):
    """Pod-mode Mencius for one group: R multi-leader replicas on the
    card. Every replica serves proposals into its own slots from boot,
    so there is no leader and no election: ``propose`` needs ``to``.
    ``device`` defaults to the card; ``device="cpu"`` runs the plain
    PyTorch path."""

    def __init__(self, cfg: MinPaxosConfig, ext_rows: int = 1024, device="cuda"):
        super().__init__(cfg, ext_rows, device, init_fn=init_mencius)

    @property
    def leader(self) -> int:
        raise ValueError("mencius has no leader: pass propose(..., to=owner)")

    def elect(self, replica: int) -> None:
        raise ValueError("mencius has no elections (rotating ownership)")

    def step(self) -> None:
        """One cluster round + host-side reply collection (SKIP fills
        dropped, no per-reply slot: execution is out of order)."""
        ext = self._drain_ext()
        self.cs, execr, _, _ = cluster_step_impl(self.cfg, self.cs, ext,
                                                 mencius_step_impl)
        collect_exec_replies(self, execr, drop_skip_fills=True, record_inst=False)
