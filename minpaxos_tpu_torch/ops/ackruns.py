"""Run-length ack compression and range vote coverage.

The batched PyTorch form of the JAX package's ``ops/ackruns.py``: a
replica acking a contiguous run of ACCEPT rows emits one reply row whose
cmd_id carries the run length, and the leader turns each range into
per-slot votes with a per-sender difference array and a prefix sum.
Emitter and consumer must agree on the stride. Plain PyTorch in this
slice (a kernel is queued); masked scatters go to an explicit sink
column instead of JAX's ``mode="drop"``.
"""

from __future__ import annotations

import torch

from minpaxos_tpu_torch.ops.util import I32, cumsum32, floordiv


def _shift1(x: torch.Tensor, fill) -> torch.Tensor:
    """x shifted right by one row along the last axis, fill at row 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], 1)


def compress_ack_runs(is_accept, src, inst, ok, ballot=None, stride: int = 1):
    """Split ACCEPT rows into maximal stride-``stride`` runs; returns
    (run_start bool[B, M], run_len i32[B, M]) with the total run length
    at every row of the run."""
    b, m = is_accept.shape
    same_prev = (
        _shift1(is_accept, False)
        & (_shift1(src, -7) == src)
        & (_shift1(ok, False) == ok)
        & (_shift1(inst, -7) + stride == inst))
    if ballot is not None:
        same_prev = same_prev & (_shift1(ballot, -7) == ballot)
    run_start = is_accept & ~same_prev
    rid = cumsum32(run_start.to(I32), 1) - 1
    run_len = torch.zeros((b, m + 1), dtype=I32, device=is_accept.device)
    run_len.scatter_add_(1, torch.where(is_accept, rid, m).long(),
                         torch.ones_like(rid))
    return run_start, torch.gather(run_len, 1, rid.clamp(0, m).long())


def range_vote_coverage(valid, src, inst, count, window_base, window: int,
                        n_replicas: int, stride: int = 1):
    """Per-slot vote coverage bool[B, S, R] from range-ack rows: each
    valid row acks ``count`` instances from ``inst`` spaced ``stride``
    apart, clipped to the window [window_base, window_base + S)."""
    s, r = window, n_replicas
    b = valid.shape[0]
    dev = valid.device
    cnt = count.clamp(min=1)
    src_c = src.clamp(0, r - 1)
    wb = window_base[:, None]
    if stride == 1:
        lo_rel = (inst - wb).clamp(0, s)
        hi_rel = (inst + cnt - wb).clamp(0, s)
        vrow = valid & (hi_rel > lo_rel)
        plane = torch.where(vrow, src_c, r) * (s + 1)
        vd = torch.zeros((b, (r + 1) * (s + 1)), dtype=I32, device=dev)
        one = torch.ones_like(inst)
        vd.scatter_add_(1, (plane + torch.where(vrow, lo_rel, s)).long(), one)
        vd.scatter_add_(1, (plane + torch.where(vrow, hi_rel, s)).long(), -one)
        vd = vd.view(b, r + 1, s + 1)[:, :r]
        return (torch.cumsum(vd, -1)[..., :s] > 0).transpose(1, 2)
    d = stride
    nrk = s // d + 2
    rel = inst - wb
    j0 = torch.where(rel < 0, floordiv(-rel + d - 1, d), 0)
    lo_rel = rel + j0 * d
    phase = torch.remainder(lo_rel, d)
    lo_rank = floordiv(lo_rel, d)
    rank_hi = torch.minimum(lo_rank + (cnt - 1 - j0), floordiv(s - 1 - phase, d))
    vrow = valid & (cnt > j0) & (lo_rel < s) & (rank_hi >= lo_rank)
    np_, nr_ = r * d, nrk + 1
    plane = torch.where(vrow, src_c * d + phase, np_) * nr_
    vd = torch.zeros((b, (np_ + 1) * nr_), dtype=I32, device=dev)
    one = torch.ones_like(inst)
    vd.scatter_add_(1, (plane + torch.where(vrow, lo_rank, nrk)).long(), one)
    vd.scatter_add_(1, (plane + torch.where(vrow, rank_hi + 1, nrk)).long(), -one)
    cov = torch.cumsum(vd.view(b, np_ + 1, nr_)[:, :np_], -1)[..., :nrk] > 0
    rel_ix = torch.arange(s, device=dev)
    cov = cov.reshape(b, r, d * nrk)[:, :, torch.remainder(rel_ix, d) * nrk + rel_ix // d]
    return cov.transpose(1, 2)


def pack_vote_bits(cov: torch.Tensor) -> torch.Tensor:
    """bool[B, S, R] -> int32[B, S] bit mask (bit r = replica r voted).
    The JAX state keeps these as uint16; the port carries int32 and
    exports uint16 (models/minpaxos.py to_numpy_state)."""
    r = cov.shape[-1]
    w = torch.bitwise_left_shift(
        torch.ones(r, dtype=I32, device=cov.device),
        torch.arange(r, dtype=I32, device=cov.device))
    return (cov.to(I32) * w).sum(-1, dtype=I32)


def scatter_vote_bits(size: int, idx, src, valid, n_replicas: int) -> torch.Tensor:
    """OR-delta int32[B, size]: bit src[b, i] set at slot idx[b, i] for
    every valid row; safe under duplicates and many senders per slot."""
    r = n_replicas
    b = idx.shape[0]
    d = torch.zeros((b, (r + 1) * (size + 1)), dtype=torch.bool, device=idx.device)
    row = torch.where(valid, src.clamp(0, r - 1), r)
    colm = torch.where(valid & (idx >= 0) & (idx <= size), idx, size)
    d.scatter_(1, (row * (size + 1) + colm).long(),
               torch.ones_like(valid))
    plane = d.view(b, r + 1, size + 1)[:, :r, :size]
    return pack_vote_bits(plane.transpose(1, 2))
