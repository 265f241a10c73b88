"""Keyed slot winners (kernel K2) and the step's slot writes (kernel K10).

The step's slot-writing sections pick ONE winning inbox row per window
slot with a single scatter-max of a key (row index, or section * M +
row) into a [B, size + 1] array whose last column is the sink for
masked rows, then gather every column at the winner. On a CUDA tensor
``scatter_max`` launches ``kernels/csrc/winner.cu`` (K2); on the CPU it
runs the plain ``scatter_reduce_`` below.

``slot_write`` is the keyed winner and all ten slot columns in one
pass (MinPaxos's fused writes A and B), ``gather_rows`` the same
writer for a given winner (Mencius's writes): on a CUDA tensor one
launch of ``kernels/csrc/slotwrite.cu`` (K10) each, on the CPU the
plain twins, which are the scatter-max + gather + select chains the
step ran before. Both write out of place: every column comes back as a
fresh tensor (votes is returned as it was when no section writes it).
A section's ``SlotMode`` says how it writes ballot, status and votes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.util import I32
from minpaxos_tpu_torch.wire.messages import ACCEPTED, COMMITTED

# the window columns a slot write fills, in the state's field order
SLOT_COLS = ("ballot", "status", "op", "key_hi", "key_lo", "val_hi", "val_lo",
             "cmd_id", "client_id", "votes")
# the inbox columns it reads
IN_COLS = ("ballot", "op", "key_hi", "key_lo", "val_hi", "val_lo", "cmd_id",
           "client_id", "src")

BAL_ROW, BAL_CONST = 0, 1  # the row's ballot / the per-replica constant
ST_ACCEPTED, ST_COMMIT = 0, 1  # ACCEPTED / max(status, COMMITTED)
V_KEEP, V_ME, V_SRC = 0, 1, 2  # kept / 1 << me / 1 << clip(src[row], 0, R-1)


class SlotMode(NamedTuple):
    ballot: int
    status: int
    votes: int


# models/minpaxos.py fused write A: section 0 PIR, section 1 ACCEPT
WRITE_A = (SlotMode(BAL_ROW, ST_ACCEPTED, V_ME), SlotMode(BAL_ROW, ST_ACCEPTED, V_SRC))
# fused write B: section 0 COMMIT, section 1 PROPOSE (default_ballot)
WRITE_B = (SlotMode(BAL_ROW, ST_COMMIT, V_KEEP), SlotMode(BAL_CONST, ST_ACCEPTED, V_ME))


def _targets(size, tgt, ok):
    return torch.where(ok & (tgt >= 0) & (tgt <= size), tgt, size)


def _scatter_max_plain(size, tgt, val, ok, fill):
    b = tgt.shape[0]
    out = torch.full((b, size + 1), fill, dtype=I32, device=tgt.device)
    return out.scatter_reduce_(1, _targets(size, tgt, ok).long(),
                               val.to(I32), reduce="amax", include_self=True)


@K.kernel("scatter_max")
def _scatter_max_kernel(size, tgt, val, ok, fill):
    t = K.cuda_arg(tgt, I32, "scatter_max tgt")
    v = K.cuda_arg(val, I32, "scatter_max val")
    o = K.cuda_arg(ok, torch.bool, "scatter_max ok")
    if not (t.shape == v.shape == o.shape) or t.dim() != 2:
        raise ValueError("scatter_max: tgt, val, ok must share a [B, M] shape")
    b, m = t.shape
    out = torch.empty((b, size + 1), dtype=I32, device=t.device)
    f_ = K.fn("winner", "mp_scatter_max",
              [K.P, K.P, K.P, K.P, K.L, K.I, K.I, K.I, K.P])
    rc = f_(K.ptr(t), K.ptr(v), K.ptr(o), K.ptr(out), b, m, size, int(fill),
            K.stream(t))
    K.check("winner", rc, "scatter_max")
    _scatter_max_kernel.launches += 1
    return out


def scatter_max(size: int, tgt: torch.Tensor, val: torch.Tensor,
                ok: torch.Tensor, fill: int) -> torch.Tensor:
    """[B, size + 1] int32: out[b, s] = max(fill, val[b, i] for rows i
    with ok[b, i] and tgt[b, i] == s). Masked and out-of-range rows go
    to column ``size`` (the sink), which callers slice off — the
    batched form of JAX's ``.at[where(ok, tgt, size)].max(val,
    mode="drop")``."""
    if K.on_cpu(tgt, val, ok):
        return _scatter_max_plain(size, tgt, val, ok, fill)
    return _scatter_max_kernel(size, tgt, val, ok, fill)


def slot_winner(size: int, rel: torch.Tensor, ok: torch.Tensor):
    """Per-slot winning row: win[b, s] = max row index among rows with
    ``ok`` targeting slot ``rel`` (-1 if none), plus the ``hit`` mask."""
    b, m = ok.shape
    rows = torch.arange(m, dtype=I32, device=ok.device).expand(b, m)
    win = scatter_max(size, rel, rows, ok, -1)[:, :size]
    return win, win >= 0


def gather_row(win, hit, col, old):
    """new[b, s] = col[b, win[b, s]] where hit else old[b, s]."""
    picked = torch.gather(col, 1, win.clamp(min=0).long())
    return torch.where(hit, picked.to(old.dtype), old)


def _write_plain(modes, hit, sec, row, inbox, old, me, const_ballot, n_replicas):
    """The slot columns with each hit slot filled from inbox row ``row``
    by its section's mode (``sec`` picks modes[1] where True)."""
    me_bit = torch.bitwise_left_shift(torch.ones_like(me), me)[:, None]
    cb = const_ballot[:, None] if const_ballot is not None else 0

    def at(c):
        return torch.gather(c, 1, row.long())

    def by_mode(f):
        vals = [f(m) for m in modes]
        return vals[0] if len(vals) == 1 else torch.where(sec, vals[1], vals[0])

    ballot, status, op = old[0], old[1], old[2]
    new = [torch.where(hit, by_mode(lambda m: cb if m.ballot else at(inbox.ballot)),
                       ballot),
           torch.where(hit, by_mode(lambda m: status.clamp(min=COMMITTED)
                                    if m.status else torch.full_like(status, ACCEPTED)),
                       status),
           gather_row(row, hit, inbox.op, op)]
    new += [gather_row(row, hit, getattr(inbox, f), o)
            for f, o in zip(IN_COLS[2:8], old[3:9])]
    votes = old[9]
    if any(m.votes for m in modes):
        src_bit = torch.bitwise_left_shift(torch.ones_like(inbox.src),
                                           inbox.src.clamp(0, n_replicas - 1))

        def vote(m):
            return (votes if m.votes == V_KEEP
                    else me_bit.expand_as(votes) if m.votes == V_ME else at(src_bit))

        votes = torch.where(hit, by_mode(vote), votes)
    return tuple(new) + (votes,)


def _slot_write_plain(modes, size, tgt, sec, ok, inbox, old, me, const_ballot,
                      n_replicas):
    m = tgt.shape[1]
    rows = torch.arange(m, dtype=I32, device=tgt.device).expand_as(tgt)
    key = _scatter_max_plain(size, tgt, torch.where(sec, m + rows, rows), ok, -1)[:, :size]
    return _write_plain(modes, key >= 0, key >= m, torch.remainder(key, m), inbox, old,
                        me, const_ballot, n_replicas)


def _gather_rows_plain(mode, win, hit, inbox, old, me, const_ballot, n_replicas):
    return _write_plain((mode,), hit, None, win.clamp(min=0), inbox, old, me,
                        const_ballot, n_replicas)


class _Col(ctypes.Structure):
    """slotwrite.cu ``SwCol``: a [B] or [B, N] int32 / one-byte tensor by
    pointer and element strides."""

    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("si", ctypes.c_longlong), ("dt", ctypes.c_int)]


class _Args(ctypes.Structure):
    """slotwrite.cu ``SwArgs``."""

    _fields_ = [("in_", _Col * len(IN_COLS)), ("old", _Col * len(SLOT_COLS)),
                ("out", ctypes.c_void_p * len(SLOT_COLS)),
                ("me", _Col), ("cball", _Col), ("tgt", _Col), ("sec", _Col),
                ("ok", _Col), ("win", _Col), ("hit", _Col),
                ("bal", ctypes.c_int * 2), ("st", ctypes.c_int * 2),
                ("vt", ctypes.c_int * 2),
                ("B", ctypes.c_int), ("M", ctypes.c_int), ("S", ctypes.c_int),
                ("R", ctypes.c_int), ("gather", ctypes.c_int)]


_DT = {torch.int32: 0, torch.uint8: 1, torch.bool: 1}


def _col(t: torch.Tensor | None) -> _Col:
    if t is None:
        return _Col(None, 0, 0, 0)
    if t.device.type != "cuda":
        raise RuntimeError(f"slot write: expected a CUDA tensor, got {t.device}")
    if t.dtype not in _DT:
        raise TypeError(f"slot write: unsupported dtype {t.dtype}")
    return _Col(t.data_ptr(), t.stride(0), t.stride(1) if t.dim() > 1 else 0,
                _DT[t.dtype])


def _launch(modes, b, m, s, inbox, old, me, const_ballot, n_replicas, tgt=None,
            sec=None, ok=None, win=None, hit=None):
    if any(o.shape != (b, s) for o in old) or any(
            getattr(inbox, f).shape != (b, m) for f in IN_COLS):
        raise ValueError("slot write: state columns must be [B, S], inbox [B, M]")
    keep_votes = not any(md.votes for md in modes)
    new = [torch.empty((b, s), dtype=o.dtype, device=o.device) for o in old[:9]]
    new.append(old[9] if keep_votes else torch.empty_like(old[9], memory_format=torch.contiguous_format))
    a = _Args()
    for i, f in enumerate(IN_COLS):
        a.in_[i] = _col(getattr(inbox, f))
    for i, (o, n) in enumerate(zip(old, new)):
        a.old[i] = _col(o)
        a.out[i] = None if (i == 9 and keep_votes) else n.data_ptr()
    a.me, a.cball = _col(me), _col(const_ballot)
    a.tgt, a.sec, a.ok, a.win, a.hit = map(_col, (tgt, sec, ok, win, hit))
    two = list(modes) * (2 // len(modes))
    a.bal = (ctypes.c_int * 2)(*[md.ballot for md in two])
    a.st = (ctypes.c_int * 2)(*[md.status for md in two])
    a.vt = (ctypes.c_int * 2)(*[md.votes for md in two])
    a.B, a.M, a.S, a.R, a.gather = b, m, s, n_replicas, int(win is not None)
    f_ = K.fn("slotwrite", "mp_slot_write", [ctypes.POINTER(_Args), K.P])
    K.check("slotwrite", f_(ctypes.byref(a), K.stream(me)), "slot write")
    return tuple(new)


@K.kernel("slot_write")
def _slot_write_kernel(modes, size, tgt, sec, ok, inbox, old, me, const_ballot,
                       n_replicas):
    b, m = tgt.shape
    if sec.shape != (b, m) or ok.shape != (b, m) or tgt.dtype != I32:
        raise ValueError("slot_write: tgt (int32), sec and ok must share a [B, M] shape")
    new = _launch(modes, b, m, size, inbox, old, me, const_ballot, n_replicas,
                  tgt=tgt, sec=sec, ok=ok)
    _slot_write_kernel.launches += 1
    return new


@K.kernel("gather_rows")
def _gather_rows_kernel(mode, win, hit, inbox, old, me, const_ballot, n_replicas):
    b, s = win.shape
    if hit.shape != (b, s) or win.dtype != I32:
        raise ValueError("gather_rows: win (int32) and hit must share a [B, S] shape")
    new = _launch((mode,), b, inbox.kind.shape[1], s, inbox, old, me, const_ballot,
                  n_replicas, win=win, hit=hit)
    _gather_rows_kernel.launches += 1
    return new


def slot_write(modes, size: int, tgt, sec, ok, inbox, old, me, const_ballot=None, *,
               n_replicas: int):
    """The keyed winner and the slot write in one pass. Per slot s of the
    [B, size] window, key[b, s] = max over rows i with ``ok`` and
    ``tgt`` == s of (M + i where ``sec`` else i), -1 where none; a hit
    slot takes every column from its winner's row by the mode of the
    winner's section (``modes[1]`` for a key >= M). ``old``: the ten
    SLOT_COLS tensors; ``me`` [B]; ``const_ballot`` [B] for a BAL_CONST
    section (None reads 0); ``n_replicas`` bounds a V_SRC sender.
    Returns the new SLOT_COLS."""
    if K.on_cpu(tgt, sec, ok, *old):
        return _slot_write_plain(modes, size, tgt, sec, ok, inbox, old, me,
                                 const_ballot, n_replicas)
    return _slot_write_kernel(modes, size, tgt, sec, ok, inbox, old, me,
                              const_ballot, n_replicas)


def gather_rows(mode: SlotMode, win, hit, inbox, old, me, const_ballot=None, *,
                n_replicas: int):
    """The slot write for a given winner: slot s takes row ``win[b, s]``
    where ``hit[b, s]``, by ``mode``. Returns the new SLOT_COLS."""
    if K.on_cpu(win, hit, *old):
        return _gather_rows_plain(mode, win, hit, inbox, old, me, const_ballot,
                                  n_replicas)
    return _gather_rows_kernel(mode, win, hit, inbox, old, me, const_ballot,
                               n_replicas)
