"""The resident loop's per-round bookkeeping (kernel K9).

Around each round's cluster step, ``parallel/sharded.py
sharded_run_resident`` keeps three device buffers: the per-group inject
ring ``inj`` [G, W] (the round each in-flight slot was assigned), the
latency histogram ``hist`` [bins] and, when armed, the paxray telemetry
ring ``tel`` [rows, N_TEL_FIELDS]. ``round_open`` runs before the step
(and before each drain sub-step when the ring is armed) and
``round_close`` after it; both work on one int32 ``scratch`` per loop
(``new_scratch``):

    [u_prev (G) | c_prev (G) | e_prev (G) | acc (8)]

acc = inbox_rows, inbox_hwm, committed, in_flight, assigned, claim,
prepared, ticket; ``round_close`` zeroes it once it wrote the row. On a
CUDA tensor each is one launch of ``kernels/csrc/resident.cu``; on the
CPU the plain twins below update the same buffers in place. The
cursors are read at replica ``cursor_rep`` of every group.
"""

from __future__ import annotations

import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.telemetry import telemetry_row
from minpaxos_tpu_torch.ops.util import I32

N_ACC = 8


def new_scratch(n_shards: int, device) -> torch.Tensor:
    return torch.zeros(3 * n_shards + N_ACC, dtype=I32, device=device)


def _ext_live(n_replicas: int, n_proposals: int, leader: int, device):
    rep = torch.arange(n_replicas, device=device)
    return torch.where((rep == leader) | (leader < 0), n_proposals, 0).to(I32)


def _round_open_plain(scratch, states, pending_kind, cursor_rep, n_shards,
                      n_proposals, leader, first, tel_on):
    g = n_shards
    r = states.committed_upto.shape[0] // g
    if first:
        for i, x in enumerate((states.committed_upto, states.crt_inst,
                               states.executed_upto)):
            scratch[i * g:(i + 1) * g] = x.view(g, r)[:, cursor_rep]
    if tel_on:
        live = (pending_kind != 0).sum(1, dtype=I32).view(g, r)
        ext = _ext_live(r, n_proposals if first else 0, leader, scratch.device)
        acc = scratch[3 * g:]
        acc[0] += live.sum(dtype=I32)
        acc[1] = torch.maximum(acc[1], (live + ext[None, :]).max())
    return scratch


@K.kernel("round_open")
def _round_open_kernel(scratch, states, pending_kind, cursor_rep, n_shards,
                       n_proposals, leader, first, tel_on):
    b = states.committed_upto.shape[0]
    args = [K.cuda_arg(x, I32, "round_open")
            for x in (states.committed_upto, states.crt_inst, states.executed_upto,
                      pending_kind)]
    K.cuda_arg(scratch, I32, "round_open scratch")
    f_ = K.fn("resident", "mp_round_open",
              [K.P] * 5 + [K.I] * 8 + [K.P])
    rc = f_(K.ptr(scratch), *map(K.ptr, args), n_shards, b // n_shards,
            args[3].shape[1], cursor_rep, int(first), int(tel_on), n_proposals,
            leader, K.stream(scratch))
    K.check("resident", rc, "round_open")
    _round_open_kernel.launches += 1
    return scratch


def round_open(scratch, states, pending_kind, cursor_rep: int, n_shards: int,
               n_proposals: int, leader: int, first: bool, tel_on: bool):
    """Before a step: with ``first`` (the round's step), snapshot the
    cursor replica's committed_upto / crt_inst / executed_upto of every
    group into ``scratch``; with ``tel_on``, add the live pending rows
    of every replica into inbox_rows and their max, plus the replica's
    injected rows on the round's step (``n_proposals`` where it is the
    leader, or every replica when ``leader`` < 0), into inbox_hwm."""
    if not (first or tel_on):
        return scratch
    if K.on_cpu(scratch, pending_kind):
        return _round_open_plain(scratch, states, pending_kind, cursor_rep,
                                 n_shards, n_proposals, leader, first, tel_on)
    return _round_open_kernel(scratch, states, pending_kind, cursor_rep,
                              n_shards, n_proposals, leader, first, tel_on)


def _round_close_plain(scratch, inj, hist, tel, states, cursor_rep, rnd,
                       tel_base, injected):
    g, w = inj.shape
    r = states.committed_upto.shape[0] // g
    u_prev, c_prev, e_prev = scratch[:g], scratch[g:2 * g], scratch[2 * g:3 * g]
    u_new = states.committed_upto.view(g, r)[:, cursor_rep]
    c_new = states.crt_inst.view(g, r)[:, cursor_rep]
    pos = torch.arange(w, dtype=I32, device=inj.device)[None, :]
    cp = c_prev[:, None]
    slot = cp + torch.remainder(pos - cp, w)
    inj.copy_(torch.where(slot < c_new[:, None], rnd, inj))
    up = u_prev[:, None] + 1
    cslot = up + torch.remainder(pos - up, w)
    sampled = (cslot <= u_new[:, None]) & (inj >= 0)
    bins = (rnd - inj).clamp(0, hist.shape[0] - 1)
    hist.scatter_add_(0, bins.reshape(-1).long(), sampled.reshape(-1).to(hist.dtype))
    if tel.shape[0]:
        prepared = getattr(states, "prepared", None)
        prep = (prepared.view(g, r)[:, cursor_rep].sum(dtype=I32)
                if prepared is not None else g)
        e_new = states.executed_upto.view(g, r)[:, cursor_rep]
        acc = scratch[3 * g:]
        tel[(rnd - tel_base) % tel.shape[0]] = telemetry_row(
            rnd, (u_new - u_prev).sum(), (c_new - 1 - u_new).sum(),
            (c_new - c_prev).sum(), injected, acc[0], (e_new - e_prev).sum(),
            prep, acc[1], device=inj.device)
        acc.zero_()
    return inj, hist, tel


@K.kernel("round_close")
def _round_close_kernel(scratch, inj, hist, tel, states, cursor_rep, rnd,
                        tel_base, injected):
    g, w = inj.shape
    b = states.committed_upto.shape[0]
    for t, what in ((scratch, "scratch"), (inj, "inject ring"), (hist, "histogram"),
                    (tel, "telemetry ring")):
        if K.cuda_arg(t, I32, f"round_close {what}") is not t:
            raise ValueError(f"round_close: the {what} must be contiguous")
    cur = [K.cuda_arg(x, I32, "round_close cursors")
           for x in (states.committed_upto, states.crt_inst, states.executed_upto)]
    prepared = getattr(states, "prepared", None)
    prep = (K.cuda_arg(prepared, torch.bool, "round_close prepared")
            if prepared is not None else None)
    f_ = K.fn("resident", "mp_round_close",
              [K.P] * 8 + [K.I] * 9 + [K.P])
    rc = f_(K.ptr(scratch), K.ptr(inj), K.ptr(hist),
            K.ptr(tel) if tel.shape[0] else None, *map(K.ptr, cur),
            K.ptr(prep) if prep is not None else None, g, b // g, w, hist.shape[0],
            tel.shape[0], cursor_rep, rnd, tel_base, injected, K.stream(inj))
    K.check("resident", rc, "round_close")
    _round_close_kernel.launches += 1
    return inj, hist, tel


def round_close(scratch, inj, hist, tel, states, cursor_rep: int, rnd: int,
                tel_base: int, injected: int):
    """After the round's step (and its drain sub-steps): stamp ``rnd``
    on the ring positions assigned this round, add the slots committed
    this round to ``hist`` by their latency, and, when ``tel`` has rows,
    write the round's telemetry row at ``(rnd - tel_base) mod rows``.
    ``inj``, ``hist`` and ``tel`` are updated in place and returned."""
    if K.on_cpu(scratch, inj, hist, tel):
        return _round_close_plain(scratch, inj, hist, tel, states, cursor_rep,
                                  rnd, tel_base, injected)
    return _round_close_kernel(scratch, inj, hist, tel, states, cursor_rep, rnd,
                               tel_base, injected)
