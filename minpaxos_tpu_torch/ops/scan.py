"""Scan primitives of the consensus step (kernel K3).

- ``commit_frontier``: the prefix-AND over the committed window that
  gives the contiguous committed frontier (ops/scan.py of the JAX
  package, a cumulative pass there).
- ``advance_frontier``: a step's whole frontier update (the operand
  status >= threshold [| executed], the start, the scan and the max
  with the old frontier) in one launch; the steps call it in place of
  ``commit_frontier`` and the eager ops around it.
- ``segmented_scan_max`` / ``exclusive_segmented_scan_max``: the
  segmented max-scan of the JAX package's KV engine (a
  ``lax.associative_scan`` there; PyTorch has no counterpart).
- ``kv_segments``: the KV apply's whole segment work on its key-sorted
  rows (the JAX package's ops/kvstore.py:270-308: segment starts from
  rolled keys, the exclusive scan for each row's last earlier write, the
  reversed scan for each key's final writer) in one launch. The apply
  calls it in place of the three scans.

All take a leading batch axis and scan along the last one. On a CUDA
tensor they launch ``kernels/csrc/scan.cu``; on the CPU they run the
plain version below.
"""

from __future__ import annotations

import numpy as np
import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.util import I32

INT32_MIN = -(2 ** 31)


def _segmented_scan_max_plain(values, seg_start):
    """Hillis-Steele scan of the monoid (r_a, v_a).(r_b, v_b) =
    (r_a | r_b, v_b if r_b else max(v_a, v_b)); log2(n) steps."""
    f = seg_start.bool()
    v = values
    n = v.shape[-1]
    d = 1
    while d < n:
        pv = torch.cat([torch.full_like(v[..., :d], INT32_MIN), v[..., :-d]], -1)
        pf = torch.cat([torch.zeros_like(f[..., :d]), f[..., :-d]], -1)
        v = torch.where(f, v, torch.maximum(pv, v))
        f = f | pf
        d *= 2
    return v


def _exclusive_plain(values, seg_start, identity):
    inc = _segmented_scan_max_plain(values, seg_start)
    ident = torch.full_like(inc[..., :1], identity)
    shifted = torch.cat([ident, inc[..., :-1]], -1)
    return torch.where(seg_start.bool(), ident, shifted)


@K.kernel("seg_scan_max")
def _seg_scan_kernel(values, seg_start, exclusive: bool, identity: int):
    v = K.cuda_arg(values, I32, "seg_scan_max values")
    f = K.cuda_arg(seg_start, torch.bool, "seg_scan_max seg_start")
    n = v.shape[-1]
    rows = v.numel() // n if n else 0
    out = torch.empty_like(v)
    f_ = K.fn("scan", "mp_seg_scan_max",
              [K.P, K.P, K.P, K.L, K.I, K.I, K.I, K.P])
    rc = f_(K.ptr(v), K.ptr(f), K.ptr(out), rows, n, int(exclusive),
            int(identity), K.stream(v))
    K.check("scan", rc, "seg_scan_max")
    _seg_scan_kernel.launches += 1
    return out


def segmented_scan_max(values: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive max-scan along the last axis that restarts at every
    True in ``seg_start``."""
    if K.on_cpu(values, seg_start):
        return _segmented_scan_max_plain(values, seg_start)
    return _seg_scan_kernel(values, seg_start, False, 0)


def exclusive_segmented_scan_max(values, seg_start, identity: int):
    """out[i] = max of values in i's segment before i, or ``identity``
    if i is first in its segment."""
    if K.on_cpu(values, seg_start):
        return _exclusive_plain(values, seg_start, identity)
    return _seg_scan_kernel(values, seg_start, True, identity)


def _kv_segments_plain(s_khi, s_klo, s_valid, s_write):
    """The JAX apply's composition (ops/kvstore.py:270-308), batched:
    segment starts from rolled keys, the exclusive max-scan of write
    positions, and the inclusive one reversed through flips."""
    e = s_khi.shape[-1]
    pos = torch.arange(e, dtype=I32, device=s_khi.device).expand_as(s_khi)
    seg_start = ((pos == 0) | (s_khi != torch.roll(s_khi, 1, 1))
                 | (s_klo != torch.roll(s_klo, 1, 1))
                 | (s_valid != torch.roll(s_valid, 1, 1)))
    wpos = torch.where(s_write, pos, -1)
    prev_w = _exclusive_plain(wpos, seg_start, -1)
    seg_max_w = _segmented_scan_max_plain(wpos, seg_start)
    seg_end = torch.roll(seg_start, -1, 1)
    seg_end[:, -1] = True
    seg_total = _segmented_scan_max_plain(seg_max_w.flip(1), seg_end.flip(1)).flip(1)
    return prev_w, s_write & (pos == seg_total)


@K.kernel("kv_segments")
def _kv_segments_kernel(s_khi, s_klo, s_valid, s_write):
    hi = K.cuda_arg(s_khi, I32, "kv_segments key_hi")
    lo = K.cuda_arg(s_klo, I32, "kv_segments key_lo")
    ok = K.cuda_arg(s_valid, torch.bool, "kv_segments valid")
    wr = K.cuda_arg(s_write, torch.bool, "kv_segments write")
    b, e = hi.shape
    prev_w = torch.empty((b, e), dtype=I32, device=hi.device)
    final = torch.empty((b, e), dtype=torch.bool, device=hi.device)
    f_ = K.fn("scan", "mp_kv_segments", [K.P] * 6 + [K.L, K.I, K.P])
    rc = f_(K.ptr(hi), K.ptr(lo), K.ptr(ok), K.ptr(wr), K.ptr(prev_w), K.ptr(final),
            b, e, K.stream(hi))
    K.check("scan", rc, "kv_segments")
    _kv_segments_kernel.launches += 1
    return prev_w, final


def kv_segments(s_khi, s_klo, s_valid, s_write):
    """The KV apply's segments over [B, E] rows sorted by key (segments:
    runs of equal (key_hi, key_lo, valid)). Returns ``prev_w`` int32
    (the position of the last write before each row in its segment, -1
    if none) and ``is_final_writer`` bool (a write with no later write
    in its segment)."""
    if K.on_cpu(s_khi, s_klo, s_valid, s_write):
        return _kv_segments_plain(s_khi, s_klo, s_valid, s_write)
    return _kv_segments_kernel(s_khi, s_klo, s_valid, s_write)


SEGMENT_FAMILIES = ("distinct", "one_key", "put_get_delete_runs", "invalid_between",
                    "apply_sorted")


def segment_families(rng, b: int, e: int, names=None) -> dict:
    """``kv_segments`` input families as numpy, drawn from the numpy
    generator ``rng``: each is (key_hi, key_lo, valid, write), [b, e].
    ``distinct``: every key different (every row its own segment).
    ``one_key``: one key for the whole row, writes at random.
    ``put_get_delete_runs``: runs of one key of 1 to 40 rows, each row a
    write (PUT or DELETE) or a GET. ``invalid_between``: one key, valid
    and invalid rows interleaved (valid changes start segments).
    ``apply_sorted``: what the apply hands over: commands on 64 keys
    (key_hi 0 or 1), 90% valid, 70% writes, sorted by key with invalid
    rows last, as ``ops/kvstore.py sort_order`` sorts them. ``names``
    picks some families (all by default); the CPU oracle test, the card
    tests and ``chip_smoke.py`` share them."""
    i32 = np.int32
    out = {}
    for name in names or SEGMENT_FAMILIES:
        if name == "distinct":
            hi = rng.integers(-3, 3, (b, e)).astype(i32)
            lo = np.broadcast_to(np.arange(e, dtype=i32) * 7 - 100, (b, e)).copy()
            ok = rng.random((b, e)) < 0.95
            wr = ok & (rng.random((b, e)) < 0.6)
        elif name == "one_key":
            hi = np.zeros((b, e), i32)
            lo = np.full((b, e), 12345, i32)
            ok = np.ones((b, e), bool)
            wr = rng.random((b, e)) < 0.5
        elif name == "put_get_delete_runs":
            hi = np.zeros((b, e), i32)
            lo = np.cumsum(rng.random((b, e)) < 1 / 20, 1).astype(i32)
            ok = np.ones((b, e), bool)
            wr = rng.random((b, e)) < 2 / 3
        elif name == "invalid_between":
            hi = np.full((b, e), -1, i32)
            lo = np.full((b, e), 77, i32)
            ok = rng.random((b, e)) < 0.6
            wr = ok & (rng.random((b, e)) < 0.5)
        else:
            hi = rng.integers(0, 2, (b, e)).astype(i32)
            lo = rng.integers(0, 32, (b, e)).astype(i32)
            ok = rng.random((b, e)) < 0.9
            wr = ok & (rng.random((b, e)) < 0.7)
            big = 2 ** 31 - 1
            comp = ((np.where(ok, hi, big).astype(np.int64) << 32)
                    + np.where(ok, lo, big).astype(np.int64) + 2 ** 31)
            order = np.argsort(comp, 1, kind="stable")
            hi, lo, ok, wr = (np.take_along_axis(x, order, 1) for x in (hi, lo, ok, wr))
        out[name] = (hi, lo, ok, wr)
    return out


def _commit_frontier_plain(committed, start):
    """The JAX formulation, per row: largest f with committed[start..f]
    all True, else start - 1."""
    n = committed.shape[-1]
    idx = torch.arange(n, device=committed.device, dtype=I32)[None, :]
    ge = idx >= start[:, None]
    run = torch.cumsum(torch.where(ge, (~committed).to(I32), 0), -1)
    ok = committed & ge & (run == 0)
    mx = torch.where(ok, idx, -1).amax(-1)
    return torch.where(ok.any(-1), mx, start - 1).to(I32)


@K.kernel("commit_frontier")
def _commit_frontier_kernel(committed, start):
    c = K.cuda_arg(committed, torch.bool, "commit_frontier committed")
    s = K.cuda_arg(start, I32, "commit_frontier start")
    rows, n = c.shape
    out = torch.empty(rows, dtype=I32, device=c.device)
    f_ = K.fn("scan", "mp_commit_frontier", [K.P, K.P, K.P, K.L, K.I, K.P])
    rc = f_(K.ptr(c), K.ptr(s), K.ptr(out), rows, n, K.stream(c))
    K.check("scan", rc, "commit_frontier")
    _commit_frontier_kernel.launches += 1
    return out


def commit_frontier(committed: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Per row of a [B, S] bool window: the largest f such that
    committed[start..f] is all True; start - 1 if committed[start] is
    False. ``start`` is [B] int32."""
    if K.on_cpu(committed, start):
        return _commit_frontier_plain(committed, start)
    return _commit_frontier_kernel(committed, start)


def _advance_frontier_plain(status, threshold, upto, window_base, executed=None):
    """The steps' frontier update as they composed it before the fusion
    (JAX models/minpaxos.py:900-904)."""
    done = status >= threshold
    if executed is not None:
        done = executed | done
    rel = _commit_frontier_plain(done, upto + 1 - window_base)
    return torch.maximum(upto, rel + window_base)


@K.kernel("advance_frontier")
def _advance_frontier_kernel(status, threshold, upto, window_base, executed=None):
    st = K.cuda_arg(status, torch.uint8, "advance_frontier status")
    up = K.cuda_arg(upto, I32, "advance_frontier upto")
    wb = K.cuda_arg(window_base, I32, "advance_frontier window_base")
    ex = None if executed is None else K.cuda_arg(executed, torch.bool,
                                                  "advance_frontier executed")
    rows, n = st.shape
    if up.shape != (rows,) or wb.shape != (rows,) or (ex is not None and ex.shape != st.shape):
        raise ValueError("advance_frontier: status (and executed) [B, S], upto and "
                         "window_base [B]")
    out = torch.empty(rows, dtype=I32, device=st.device)
    f_ = K.fn("scan", "mp_advance_frontier", [K.P, K.P, K.I, K.P, K.P, K.P, K.L, K.I, K.P])
    rc = f_(K.ptr(st), K.P(None) if ex is None else K.ptr(ex), int(threshold), K.ptr(up),
            K.ptr(wb), K.ptr(out), rows, n, K.stream(st))
    K.check("scan", rc, "advance_frontier")
    _advance_frontier_kernel.launches += 1
    return out


def advance_frontier(status: torch.Tensor, threshold: int, upto: torch.Tensor,
                     window_base: torch.Tensor, executed=None) -> torch.Tensor:
    """A step's frontier update in one call: a new int32 [B] tensor
    ``max(upto, commit_frontier(status >= threshold [| executed],
    upto + 1 - window_base) + window_base)``, for a u8 [B, S] status
    window (and a bool [B, S] ``executed``). ``upto`` is not changed."""
    extra = () if executed is None else (executed,)
    if K.on_cpu(status, upto, window_base, *extra):
        return _advance_frontier_plain(status, threshold, upto, window_base, executed)
    return _advance_frontier_kernel(status, threshold, upto, window_base, executed)


FRONTIER_FAMILIES = ("path", "gap_at_start", "no_gap", "start_negative",
                     "start_past_window", "unaligned_start", "executed")


def frontier_families(rng, b: int, s: int, names=None) -> dict:
    """``advance_frontier`` input families as numpy, drawn from the numpy
    generator ``rng``: each is (status u8, upto, window_base, executed
    bool) for ``b`` batch rows of a window of ``s`` slots; ``start`` =
    upto + 1 - window_base. Status values are NONE..EXECUTED (0..5).
    ``path``: a run of done slots (COMMITTED or EXECUTED) of up to twice
    512 from a start in the window's first half, then a gap, as a
    MinPaxos round leaves it. ``gap_at_start``: the slot at the start is
    not done. ``no_gap``: every slot from the start to the window's end
    done. ``start_negative``: the start below slot 0. ``start_past_window``:
    the start at s or beyond. ``unaligned_start``: starts off every
    16-byte boundary, runs ending on and off them. ``executed``:
    a run of any status, executed wherever the status is below
    EXECUTED, so the ``executed`` form's run goes on where
    ``status >= EXECUTED`` alone stops. ``names`` picks some families (all by default); the CPU oracle
    test, the card tests and ``chip_smoke.py`` share them."""
    i32 = np.int32
    out = {}
    ix = np.arange(s)[None, :]
    for name in names or FRONTIER_FAMILIES:
        status = rng.integers(0, 6, (b, s)).astype(np.uint8)
        executed = (status == 5) | (rng.random((b, s)) < 0.05)
        wb = rng.integers(0, 1 << 20, b).astype(i32)
        start = rng.integers(0, max(s // 2, 1), b)
        run = rng.integers(0, 1024 + 1, b)
        if name == "start_negative":
            start = rng.integers(-40, 0, b)
        elif name == "start_past_window":
            start = s + rng.integers(0, 40, b)
            start[::3] = s
        elif name == "unaligned_start":
            start = 16 * rng.integers(0, max(s // 32, 1), b) + rng.integers(1, 16, b)
            run = 16 * rng.integers(0, 8, b) + rng.integers(0, 2, b) * rng.integers(1, 16, b)
        elif name == "no_gap":
            run = np.full(b, s)
        elif name == "gap_at_start":
            run = np.zeros(b, np.int64)
        elif name == "executed":
            run = rng.integers(0, 256 + 1, b)
        lo = np.maximum(start, 0)[:, None]
        inrun = (ix >= lo) & (ix < lo + run[:, None])
        status = np.where(inrun, rng.integers(4, 6, (b, s)), status).astype(np.uint8)
        if name == "executed":
            # the run: every status, each slot below EXECUTED executed
            status = np.where(inrun, rng.integers(0, 6, (b, s)), status).astype(np.uint8)
            executed = executed | (inrun & (status < 5))
        gap = (lo + run[:, None]) == ix
        status = np.where(gap, rng.integers(0, 4, (b, s)), status).astype(np.uint8)
        executed = np.where(gap, False, executed)
        upto = (wb + start - 1).astype(i32)
        out[name] = (status, upto, wb, executed)
    return out
