"""Run-length ack compression and range vote coverage (kernel K5).

The batched PyTorch form of the JAX package's ``ops/ackruns.py``: a
replica acking a contiguous run of ACCEPT rows emits one reply row whose
cmd_id carries the run length, and the leader turns each range into
per-slot votes with a per-sender difference array and a prefix sum.
Emitter and consumer must agree on the stride (1 for MinPaxos and
classic, R for Mencius, whose owners drive every R-th slot).

On CUDA tensors ``compress_ack_runs``, ``range_vote_bits`` (coverage,
packing and the OR into the votes table fused: the [B, S, R] bool plane
never reaches device memory) and ``scatter_vote_bits`` (with the OR
into the pvotes table fused) launch
``kernels/csrc/ackruns.cu``; on the CPU they run the plain versions
below, where masked scatters go to an explicit sink column instead of
JAX's ``mode="drop"``. ``ack_families`` and ``pvote_families`` make the
seeded input families that the tests and ``chip_smoke.py`` hold the
kernels to.
"""

from __future__ import annotations

import numpy as np
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


def _vote_bits_plain(valid, src, inst, count, window_base, window, n_replicas,
                     stride, into, mask):
    bits = pack_vote_bits(range_vote_coverage(
        valid, src, inst, count, window_base, window, n_replicas, stride))
    if mask is not None:
        bits = torch.where(mask, bits, 0)
    return bits if into is None else into | bits


@K.kernel("vote_bits")
def _vote_bits_kernel(valid, src, inst, count, window_base, window, n_replicas,
                      stride, into=None, mask=None):
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
    into = None if into is None else K.cuda_arg(into, I32, "vote_bits into")
    mask = None if mask is None else K.cuda_arg(mask, torch.bool, "vote_bits mask")
    if any(t is not None and t.shape != (b, window) for t in (into, mask)):
        raise ValueError(f"vote_bits: into and mask must be [{b}, {window}]")
    out = torch.empty((b, window), dtype=I32, device=v.device)
    f_ = K.fn("ackruns", "mp_range_vote_bits",
              [K.P] * 8 + [K.L, K.I, K.I, K.I, K.I, K.P])
    rc = f_(K.ptr(v), K.ptr(s), K.ptr(i), K.ptr(c), K.ptr(wb),
            K.P(None) if into is None else K.ptr(into),
            K.P(None) if mask is None else K.ptr(mask), K.ptr(out), b, m,
            int(window), int(n_replicas), int(stride), K.stream(v))
    K.check("ackruns", rc, "vote_bits")
    _vote_bits_kernel.launches += 1
    return out


def range_vote_bits(valid, src, inst, count, window_base, window: int,
                    n_replicas: int, stride: int = 1, *, into=None,
                    mask=None) -> torch.Tensor:
    """``pack_vote_bits(range_vote_coverage(...))``: int32[B, S] masks,
    bit r set where a valid row from replica r covers the slot. With
    ``into`` (an int32[B, S] votes table) a new table ``into | bits``;
    with ``mask`` (bool[B, S]) the bits only where it is set:
    ``into | where(mask, bits, 0)``. ``into`` itself is not changed."""
    extra = tuple(t for t in (into, mask) if t is not None)
    if K.on_cpu(valid, src, inst, count, window_base, *extra):
        return _vote_bits_plain(valid, src, inst, count, window_base, window,
                                n_replicas, stride, into, mask)
    return _vote_bits_kernel(valid, src, inst, count, window_base, window,
                             n_replicas, stride, into, mask)


def _scatter_vote_bits_plain(size, idx, src, valid, n_replicas, into=None):
    r = n_replicas
    b = idx.shape[0]
    d = torch.zeros((b, (r + 1) * (size + 1)), dtype=torch.bool, device=idx.device)
    row = torch.where(valid, src.clamp(0, r - 1), r)
    # JAX's scatter counts an index in [-size, 0) from the end and drops
    # any other outside [0, size)
    t = torch.where(idx < 0, idx + size, idx)
    colm = torch.where(valid & (t >= 0) & (t <= size), t, size)
    d.scatter_(1, (row * (size + 1) + colm).long(),
               torch.ones_like(valid))
    plane = d.view(b, r + 1, size + 1)[:, :r, :size]
    bits = pack_vote_bits(plane.transpose(1, 2))
    return bits if into is None else into | bits


@K.kernel("scatter_vote_bits")
def _scatter_vote_bits_kernel(size, idx, src, valid, n_replicas, into=None):
    t = K.cuda_arg(idx, I32, "scatter_vote_bits idx")
    s = K.cuda_arg(src, I32, "scatter_vote_bits src")
    v = K.cuda_arg(valid, torch.bool, "scatter_vote_bits valid")
    if not (t.shape == s.shape == v.shape) or t.dim() != 2:
        raise ValueError("scatter_vote_bits: idx, src, valid must share a [B, M] shape")
    b, m = t.shape
    into = None if into is None else K.cuda_arg(into, I32, "scatter_vote_bits into")
    if into is not None and into.shape != (b, size):
        raise ValueError(f"scatter_vote_bits: into must be [{b}, {size}]")
    out = torch.empty((b, size), dtype=I32, device=t.device)
    f_ = K.fn("ackruns", "mp_scatter_vote_bits",
              [K.P] * 5 + [K.L, K.I, K.I, K.I, K.P])
    rc = f_(K.ptr(t), K.ptr(s), K.ptr(v), K.P(None) if into is None else K.ptr(into),
            K.ptr(out), b, m, int(size), int(n_replicas), K.stream(t))
    K.check("ackruns", rc, "scatter_vote_bits")
    _scatter_vote_bits_kernel.launches += 1
    return out


def scatter_vote_bits(size: int, idx, src, valid, n_replicas: int,
                      into=None) -> torch.Tensor:
    """OR-delta int32[B, size]: bit src[b, i] set at slot idx[b, i] for
    every valid row; safe under duplicates and many senders per slot. An
    index in [-size, 0) counts from the end (as JAX's scatter takes it);
    any other outside [0, size) is dropped. With ``into`` (an int32[B,
    size] pvotes table) a new table ``into | bits``; ``into`` itself is
    not changed."""
    extra = () if into is None else (into,)
    if K.on_cpu(idx, src, valid, *extra):
        return _scatter_vote_bits_plain(size, idx, src, valid, n_replicas, into)
    return _scatter_vote_bits_kernel(size, idx, src, valid, n_replicas, into)


PVOTE_FAMILIES = ("no_valid", "random", "prepare", "edges")


def pvote_families(rng, b: int, m: int, s: int, r: int, names=None) -> dict:
    """``scatter_vote_bits`` input families as numpy, drawn from the numpy
    generator ``rng``: each is (idx, src, valid, into) for ``b`` batch
    rows of ``m`` inbox rows into a window of ``s`` slots of ``r``
    replicas' bits. ``no_valid``: no valid row (the steady state of every
    path: PREPARE_INST_REPLY arrives only in an election or a takeover).
    ``random``: 30% of the rows valid, slots anywhere in the window.
    ``prepare``: every row of every batch row valid, as after a prepare:
    a run of slots, each named by every sender, a (slot, sender) pair
    repeated, and 5 senders on one slot of each row. ``edges``: 30% valid, slots at -2, s and s + 3 (and every
    other index in [-s - 3, s + 3]), senders outside [0, r - 1].
    ``names`` picks some families (all by default); the CPU oracle test,
    the card tests and ``chip_smoke.py`` share them."""
    i32 = np.int32
    out = {}
    for name in names or PVOTE_FAMILIES:
        idx = rng.integers(0, s, (b, m)).astype(i32)
        src = rng.integers(0, r, (b, m)).astype(i32)
        valid = rng.random((b, m)) < 0.3
        if name == "no_valid":
            valid[:] = False
        elif name == "prepare":
            valid[:] = True
            start = rng.integers(0, max(s - m // r, 1), (b, 1))
            idx = (start + np.arange(m)[None, :] // r).clip(0, s - 1).astype(i32)
            src = np.broadcast_to(np.arange(m) % r, (b, m)).astype(i32).copy()
            hot = rng.integers(0, s, b).astype(i32)
            k = min(5, m)
            idx[:, :k] = hot[:, None]
            src[:, :k] = (np.arange(k) % r)[None, :]
            # the same (slot, sender) three times over
            idx[:, k + 1:k + 3] = idx[:, k:k + 1]
            src[:, k + 1:k + 3] = src[:, k:k + 1]
        elif name == "edges":
            pick = rng.integers(0, 4, (b, m))
            far = rng.integers(-s - 3, s + 4, (b, m))
            idx = np.select([pick == 0, pick == 1, pick == 2],
                            [np.full((b, m), -2), np.full((b, m), s),
                             np.full((b, m), s + 3)], far).astype(i32)
            src = rng.integers(-3, r + 3, (b, m)).astype(i32)
        out[name] = (idx, src, valid, rng.integers(0, 1 << r, (b, s)).astype(i32))
    return out


ACK_FAMILIES = ("random", "leader_only", "one_long_run", "no_accept",
                "run_at_last_row", "rows_before_first_run", "full_window",
                "ranges_past_both_window_edges")


def ack_families(rng, b: int, m: int, s: int, r: int, stride: int,
                 names=None) -> dict:
    """K5 input families as numpy, drawn from the numpy generator ``rng``:
    ``b`` batch rows (groups of ``r`` replicas) of ``m`` inbox rows, a
    window of ``s`` slots, runs and ranges ``stride`` instances apart.
    Each family is a dict: ``runs`` = (is_accept, src, inst, ok, ballot)
    for ``compress_ack_runs`` (ballot None at stride 1), ``votes`` =
    (valid, src, inst, count, window_base) for ``range_vote_bits``,
    ``into`` an int32[b, s] votes table and ``mask`` a bool[b, s] mask
    for its fused form. A round's run is 512 rows at stride 1 (MinPaxos's
    p) and 64 at stride ``r`` (Mencius's p per owner), cut to ``m``.

    ``random``: ``chip_smoke.py``'s compare data (ACCEPT bursts, a quarter
    of the rows valid acks of up to 64). ``leader_only``: the main path's
    shape: every follower row (``row % r != 0``) holds the leader's one
    run; only the leader rows hold valid acks, a few long ranges from
    every follower. ``one_long_run``: one run per row at stride 1; at
    stride ``r`` every row ACCEPT with runs cut every 64 rows by a ballot
    change alone; one long range per row. ``no_accept``: no ACCEPT row and
    no valid ack. ``run_at_last_row``: a run through row m - 1, and a
    range ending at the window's last slot in the last row.
    ``rows_before_first_run``: the first rows of every row (up to half)
    are no ACCEPT and no valid ack. ``full_window``: one run over every
    row, and every row a valid ack covering the whole window (every
    sender covers every slot, every phase at stride ``r``).
    ``ranges_past_both_window_edges``: ranges that start below the window
    and end past it, mixed with ranges over one edge. ``names`` picks
    some families (all by default); the card tests, the CPU oracle test
    and ``chip_smoke.py`` share them."""
    d = stride
    run = min(512 if d == 1 else 64, m)
    rows = np.arange(m)[None, :]
    i32 = np.int32

    def runs_random():
        is_acc = rng.random((b, m)) < 0.8
        src = np.repeat(rng.integers(0, r, (b, m // 8 + 1)), 8, 1)[:, :m].astype(i32)
        step = np.where(rng.random((b, m)) < 0.85, d, rng.integers(1, 2 * r, (b, m)))
        inst = (np.cumsum(step, 1) + rng.integers(0, s, (b, 1))).astype(i32)
        ok = rng.random((b, m)) < 0.9
        bal = rng.integers(0, 2, (b, m)).astype(i32) if d > 1 else None
        return [is_acc, src, inst, ok, bal]

    def votes_random(p_valid=0.25):
        valid = rng.random((b, m)) < p_valid
        src = np.repeat(rng.integers(0, r, (b, m // 8 + 1)), 8, 1)[:, :m].astype(i32)
        wb = rng.integers(0, 1 << 20, b).astype(i32)
        inst = (wb[:, None] + rng.integers(-64, s + 64, (b, m))).astype(i32)
        count = rng.integers(0, 64, (b, m)).astype(i32)
        return [valid, src, inst, count, wb]

    def one_run(starts, length, on):
        """is_accept, src, inst, ok, ballot of one run per selected row."""
        pos = rows - starts[:, None]
        is_acc = (pos >= 0) & (pos < length[:, None]) & on[:, None]
        inst = (rng.integers(0, 1 << 20, (b, 1)) + d * pos).astype(i32)
        src = np.broadcast_to(rng.integers(0, r, (b, 1)), (b, m)).astype(i32)
        bal = np.full((b, m), 17, i32) if d > 1 else None
        return [is_acc, src, inst, np.ones((b, m), bool), bal]

    def leader_only():
        follower = np.arange(b) % r != 0
        runs = one_run(rng.integers(0, m - run + 1, b), np.full(b, run), follower)
        runs[1][:] = 0  # the leader, replica 0 of its group, sends the run
        votes = votes_random(0.0)
        k = min(3 * (r - 1), m)
        pos = np.argsort(rng.random((b, m)), 1)[:, :k]
        j = np.arange(k)[None, :]
        lead = (np.arange(b) % r == 0)[:, None]
        np.put_along_axis(votes[0], pos, np.broadcast_to(lead, (b, k)), 1)
        np.put_along_axis(votes[1], pos, np.broadcast_to(j % max(r - 1, 1) + 1, (b, k))
                          .astype(i32) % r, 1)
        off = (j // max(r - 1, 1)) * run * d + rng.integers(-d, d + 1, (b, k))
        np.put_along_axis(votes[2], pos, (votes[4][:, None] + off).astype(i32), 1)
        np.put_along_axis(votes[3], pos, np.full((b, k), run, i32), 1)
        return runs, votes

    def one_long_run():
        if d == 1:
            runs = one_run(rng.integers(0, m - run + 1, b), np.full(b, run), np.ones(b, bool))
        else:
            runs = one_run(np.zeros(b, int), np.full(b, m), np.ones(b, bool))
            runs[4] = np.broadcast_to(17 + 16 * ((rows // 64) % 2), (b, m)).astype(i32)
        votes = votes_random(0.0)
        at = rng.integers(0, m, b)
        votes[0][np.arange(b), at] = True
        votes[2][np.arange(b), at] = votes[4] + rng.integers(-d, s // 2, b).astype(i32)
        votes[3][np.arange(b), at] = run
        return runs, votes

    def no_accept():
        runs = runs_random()
        runs[0][:] = False
        return runs, votes_random(0.0)

    def run_at_last_row():
        runs = runs_random()
        length = rng.integers(1, run + 1, b)
        tail = one_run(m - length, length, np.ones(b, bool))
        for x, y in zip(runs, tail):
            if x is not None:
                x[tail[0]] = y[tail[0]]
        votes = votes_random()
        cnt = rng.integers(1, 64, b)
        votes[0][:, -1] = True
        votes[3][:, -1] = cnt
        # the range's last instance is the window's last slot of its phase
        votes[2][:, -1] = (votes[4] + s - 1 - d * (cnt - 1)).astype(i32)
        return runs, votes

    def rows_before_first_run():
        runs, votes = runs_random(), votes_random()
        lead = rows < rng.integers(1, max(m // 2, 1) + 1, (b, 1))
        runs[0][lead] = False
        votes[0][lead] = False
        return runs, votes

    def full_window():
        runs = one_run(np.zeros(b, int), np.full(b, m), np.ones(b, bool))
        votes = votes_random(1.0)
        votes[1] = np.broadcast_to(rows % r, (b, m)).astype(i32)
        votes[2] = (votes[4][:, None] + (rows // r) % d).astype(i32)
        votes[3] = np.full((b, m), s, i32)
        return runs, votes

    def ranges_past_both_window_edges():
        votes = votes_random(0.5)
        below = rng.integers(1, 3 * d + 40, (b, m))
        both = rng.random((b, m)) < 0.5
        votes[2] = np.where(both, votes[4][:, None] - below, votes[2]).astype(i32)
        span = (s + d - 1) // d + 3 * d + 40
        votes[3] = np.where(both, span + rng.integers(0, 64, (b, m)),
                            rng.integers(s // (2 * d), span, (b, m))).astype(i32)
        return runs_random(), votes

    make = {"random": lambda: (runs_random(), votes_random()), "leader_only": leader_only,
            "one_long_run": one_long_run, "no_accept": no_accept,
            "run_at_last_row": run_at_last_row, "rows_before_first_run": rows_before_first_run,
            "full_window": full_window,
            "ranges_past_both_window_edges": ranges_past_both_window_edges}
    out = {}
    for name in ACK_FAMILIES:
        if names is not None and name not in names:
            continue
        runs, votes = make[name]()
        out[name] = dict(runs=tuple(None if x is None else np.ascontiguousarray(x) for x in runs),
                         votes=tuple(np.ascontiguousarray(x) for x in votes),
                         into=rng.integers(0, 1 << r, (b, s)).astype(i32),
                         mask=rng.random((b, s)) < 0.5)
    return out
