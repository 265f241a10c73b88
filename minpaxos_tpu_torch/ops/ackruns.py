"""Run-length ack compression and range vote coverage (kernel K5).

The batched PyTorch form of the JAX package's ``ops/ackruns.py``: a
replica acking a contiguous run of ACCEPT rows emits one reply row whose
cmd_id carries the run length, and the leader turns each range into
per-slot votes with a per-sender difference array and a prefix sum.
Emitter and consumer must agree on the stride (1 for MinPaxos and
classic, R for Mencius, whose owners drive every R-th slot).

On CUDA tensors ``compress_ack_runs``, ``range_vote_bits`` (coverage and
packing fused: the [B, S, R] bool plane never reaches device memory) and
``scatter_vote_bits`` launch ``kernels/csrc/ackruns.cu``; on the CPU they
run the plain versions below, where masked scatters go to an explicit
sink column instead of JAX's ``mode="drop"``.
"""

from __future__ import annotations

import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.util import I32, cumsum32, floordiv


def _shift1(x: torch.Tensor, fill) -> torch.Tensor:
    """x shifted right by one row along the last axis, fill at row 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], 1)


def _compress_plain(is_accept, src, inst, ok, ballot, stride):
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


@K.kernel("ack_runs")
def _compress_kernel(is_accept, src, inst, ok, ballot, stride):
    a = K.cuda_arg(is_accept, torch.bool, "ack_runs is_accept")
    s = K.cuda_arg(src, I32, "ack_runs src")
    i = K.cuda_arg(inst, I32, "ack_runs inst")
    o = K.cuda_arg(ok, torch.bool, "ack_runs ok")
    bal = None if ballot is None else K.cuda_arg(ballot, I32, "ack_runs ballot")
    if not all(t.shape == a.shape for t in (s, i, o) + ((bal,) if bal is not None else ())):
        raise ValueError("ack_runs: every input must share one [B, M] shape")
    b, m = a.shape
    run_start = torch.empty((b, m), dtype=torch.bool, device=a.device)
    run_len = torch.empty((b, m), dtype=I32, device=a.device)
    f_ = K.fn("ackruns", "mp_compress_ack_runs",
              [K.P] * 7 + [K.L, K.I, K.I, K.P])
    rc = f_(K.ptr(a), K.ptr(s), K.ptr(i), K.ptr(o),
            K.ptr(bal) if bal is not None else K.P(None),
            K.ptr(run_start), K.ptr(run_len), b, m, int(stride), K.stream(a))
    K.check("ackruns", rc, "ack_runs")
    _compress_kernel.launches += 1
    return run_start, run_len


def compress_ack_runs(is_accept, src, inst, ok, ballot=None, stride: int = 1):
    """Split ACCEPT rows into maximal stride-``stride`` runs; returns
    (run_start bool[B, M], run_len i32[B, M]). A row continues the run
    of the row before it when both are ACCEPTs with the same sender, ok
    flag and (when given) ballot, ``stride`` instances apart. run_len
    at every row is the length of the run its running start count
    points to (run 0 for rows before the first run)."""
    extra = () if ballot is None else (ballot,)
    if K.on_cpu(is_accept, src, inst, ok, *extra):
        return _compress_plain(is_accept, src, inst, ok, ballot, stride)
    return _compress_kernel(is_accept, src, inst, ok, ballot, stride)


def range_vote_coverage(valid, src, inst, count, window_base, window: int,
                        n_replicas: int, stride: int = 1):
    """Per-slot vote coverage bool[B, S, R] from range-ack rows: each
    valid row acks ``count`` instances from ``inst`` spaced ``stride``
    apart, clipped to the window [window_base, window_base + S). Plain
    PyTorch; the kernel computes it packed (``range_vote_bits``)."""
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


@K.kernel("vote_bits")
def _vote_bits_kernel(valid, src, inst, count, window_base, window, n_replicas,
                      stride):
    v = K.cuda_arg(valid, torch.bool, "vote_bits valid")
    s = K.cuda_arg(src, I32, "vote_bits src")
    i = K.cuda_arg(inst, I32, "vote_bits inst")
    c = K.cuda_arg(count, I32, "vote_bits count")
    wb = K.cuda_arg(window_base, I32, "vote_bits window_base")
    if not (v.shape == s.shape == i.shape == c.shape) or v.dim() != 2 \
            or wb.shape != (v.shape[0],):
        raise ValueError("vote_bits: rows must share one [B, M] shape and "
                         "window_base be [B]")
    b, m = v.shape
    out = torch.empty((b, window), dtype=I32, device=v.device)
    f_ = K.fn("ackruns", "mp_range_vote_bits",
              [K.P] * 6 + [K.L, K.I, K.I, K.I, K.I, K.P])
    rc = f_(K.ptr(v), K.ptr(s), K.ptr(i), K.ptr(c), K.ptr(wb), K.ptr(out), b, m,
            int(window), int(n_replicas), int(stride), K.stream(v))
    K.check("ackruns", rc, "vote_bits")
    _vote_bits_kernel.launches += 1
    return out


def range_vote_bits(valid, src, inst, count, window_base, window: int,
                    n_replicas: int, stride: int = 1) -> torch.Tensor:
    """``pack_vote_bits(range_vote_coverage(...))``: int32[B, S] masks,
    bit r set where a valid row from replica r covers the slot."""
    if K.on_cpu(valid, src, inst, count, window_base):
        return pack_vote_bits(range_vote_coverage(
            valid, src, inst, count, window_base, window, n_replicas, stride))
    return _vote_bits_kernel(valid, src, inst, count, window_base, window,
                             n_replicas, stride)


def _scatter_vote_bits_plain(size, idx, src, valid, n_replicas):
    r = n_replicas
    b = idx.shape[0]
    d = torch.zeros((b, (r + 1) * (size + 1)), dtype=torch.bool, device=idx.device)
    row = torch.where(valid, src.clamp(0, r - 1), r)
    colm = torch.where(valid & (idx >= 0) & (idx <= size), idx, size)
    d.scatter_(1, (row * (size + 1) + colm).long(),
               torch.ones_like(valid))
    plane = d.view(b, r + 1, size + 1)[:, :r, :size]
    return pack_vote_bits(plane.transpose(1, 2))


@K.kernel("scatter_vote_bits")
def _scatter_vote_bits_kernel(size, idx, src, valid, n_replicas):
    t = K.cuda_arg(idx, I32, "scatter_vote_bits idx")
    s = K.cuda_arg(src, I32, "scatter_vote_bits src")
    v = K.cuda_arg(valid, torch.bool, "scatter_vote_bits valid")
    if not (t.shape == s.shape == v.shape) or t.dim() != 2:
        raise ValueError("scatter_vote_bits: idx, src, valid must share a [B, M] shape")
    b, m = t.shape
    out = torch.empty((b, size), dtype=I32, device=t.device)
    f_ = K.fn("ackruns", "mp_scatter_vote_bits",
              [K.P] * 4 + [K.L, K.I, K.I, K.I, K.P])
    rc = f_(K.ptr(t), K.ptr(s), K.ptr(v), K.ptr(out), b, m, int(size),
            int(n_replicas), K.stream(t))
    K.check("ackruns", rc, "scatter_vote_bits")
    _scatter_vote_bits_kernel.launches += 1
    return out


def scatter_vote_bits(size: int, idx, src, valid, n_replicas: int) -> torch.Tensor:
    """OR-delta int32[B, size]: bit src[b, i] set at slot idx[b, i] for
    every valid row; safe under duplicates and many senders per slot."""
    if K.on_cpu(idx, src, valid):
        return _scatter_vote_bits_plain(size, idx, src, valid, n_replicas)
    return _scatter_vote_bits_kernel(size, idx, src, valid, n_replicas)
