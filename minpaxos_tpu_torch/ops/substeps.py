"""Fused multi-tick device steps and their packed outputs (kernel K7).

The port of the JAX package's ``ops/substeps.py``, used by the TCP
serving runtime (runtime/replica.py):

* ``scan_ticks`` runs k protocol substeps per dispatch as a host loop:
  substep 0 takes the real inbox (``tick_inc=1``), substeps 1..k-1 an
  empty one (``tick_inc=0``). After every substep, ``pack_outputs``
  writes everything the host reads into row i of one preallocated
  int32 buffer ``[k, B, W]``, so the host reads all k substeps back in
  one device-to-host copy.
* ``pack_outputs`` is that packing: per replica one int32 row

      [14 * Mout | 6 * E | N_SCAL | R]

  — the 12 outbox ``MsgBatch`` columns, ``dst`` and the per-inbox-row
  ``acked`` mask zero-padded to the outbox length; the 6 exec columns;
  the scalar vector (layout below, three of its entries from
  ``_anchors``); and the state's ``peer_commits`` vector, which the
  leader's beyond-window catch-up reads. The first three parts are
  exactly the JAX package's ``[14, M]``, ``[6, E]`` and ``[N_SCAL]``
  arrays. On a CUDA tensor one launch of K7
  (``kernels/csrc/substeps.cu``) writes the whole row; on the CPU the
  plain twin below casts, pads and concatenates.
* ``narrow_view`` / ``merge_view`` run the substeps on a ``narrow``-slot
  view of a larger window at a host offset: ``Tensor.narrow`` on the
  slot axis, and a ``copy_`` back. The slot fields are a fixed name
  list (``SLOT_FIELDS``), not a shape test: in the batched ``[B, S]``
  state a ``[B, R]`` leaf would match a shape test whenever R equals
  the window.
"""

from __future__ import annotations

import ctypes

import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.util import I32, take
from minpaxos_tpu_torch.wire.messages import COMMITTED

# Scalar-vector layout (the host indexes by these names).
(SCAL_FRONTIER, SCAL_WINDOW_BASE, SCAL_CRT_INST, SCAL_KV_DROPPED,
 SCAL_EXEC_LO, SCAL_EXEC_COUNT, SCAL_LEADER, SCAL_PREPARED,
 SCAL_EXECUTED, SCAL_LOW_ANCHOR, SCAL_HIGH_ANCHOR,
 SCAL_WORK_PENDING) = range(12)
N_SCAL = 12
SCAL_NAMES = ("frontier", "window_base", "crt_inst", "kv_dropped",
              "exec_lo", "exec_count", "leader", "prepared", "executed",
              "low_anchor", "high_anchor", "work_pending")
assert len(SCAL_NAMES) == N_SCAL

# outbox columns in the packed row: the 12 MsgBatch columns, dst, acked
N_OUT_COLS = 14
# exec columns: val_hi, val_lo, found, op, cmd_id, client_id
EXEC_COLS = ("val_hi", "val_lo", "found", "op", "cmd_id", "client_id")

# per-slot window fields of both state types (ReplicaState, MenciusState)
SLOT_FIELDS = ("ballot", "status", "op", "key_hi", "key_lo", "val_hi",
               "val_lo", "cmd_id", "client_id", "votes", "pvotes",
               "executed")

_BIG = 2 ** 30


def row_width(m_out: int, exec_batch: int, n_replicas: int) -> int:
    """Ints per replica in one substep's packed row."""
    return N_OUT_COLS * m_out + len(EXEC_COLS) * exec_batch + N_SCAL + n_replicas


def unpack(rows, exec_batch: int, n_replicas: int):
    """Split packed rows ``[k, W]`` (one replica, numpy or torch) into
    (out_mats [k, 14, Mout], exec_mats [k, 6, E], scals [k, N_SCAL],
    peer_commits [k, R]) views."""
    k, w = rows.shape
    m_out = (w - len(EXEC_COLS) * exec_batch - N_SCAL - n_replicas) // N_OUT_COLS
    a = N_OUT_COLS * m_out
    b = a + len(EXEC_COLS) * exec_batch
    c = b + N_SCAL
    return (rows[:, :a].reshape(k, N_OUT_COLS, m_out),
            rows[:, a:b].reshape(k, len(EXEC_COLS), exec_batch),
            rows[:, b:c], rows[:, c:])


def _is_mencius(state) -> bool:
    return not hasattr(state, "leader_id")


def _anchors(state):
    """(low_anchor, high_anchor, work_pending), each int32 [B], for a
    post-step state: the lowest absolute slot the next empty-inbox step
    could touch, one past the highest, and whether such a step would do
    anything at all (the idle fast path's bit). The MinPaxos/classic
    form keys on ``leader_id``, the Mencius form on ``commit_sent``."""
    exec_edge = state.executed_upto + 1
    frontier = state.committed_upto
    lo = torch.minimum(exec_edge, frontier + 1)
    backlog = frontier > state.executed_upto
    b, r = state.peer_commits.shape
    ids = torch.arange(r, dtype=I32, device=frontier.device)[None, :]
    pc = torch.where(ids == state.me[:, None], _BIG, state.peer_commits)
    pc_min = pc.amin(1)
    peer_lag = pc_min < frontier
    in_flight = state.crt_inst - 1 > frontier
    if not _is_mencius(state):
        is_leader = state.leader_id == state.me
        serving = is_leader & state.prepared
        lo = torch.where(serving & peer_lag, torch.minimum(lo, pc_min + 1), lo)
        hi = state.crt_inst
        behind_gossip = frontier > state.gossip_upto
        pending = (backlog | behind_gossip
                   | (is_leader & (in_flight | ~state.prepared | peer_lag)))
    else:
        s = state.status.shape[1]
        lo = torch.where(peer_lag, torch.minimum(lo, pc_min + 1), lo)
        lo = torch.minimum(lo, state.commit_sent + 1)
        lo = torch.where(state.tk_anchor >= 0,
                         torch.minimum(lo, state.tk_anchor), lo)
        hi = torch.maximum(state.crt_inst, state.crt_own)
        # unannounced own commit: the broadcast cursor stops at the
        # first unresolved own slot (jnp.mod: a floor mod)
        nxt = state.commit_sent + 1
        nxt = nxt + torch.remainder(state.me - nxt, r)
        rel = nxt - state.window_base
        pending_cb = ((rel >= 0) & (rel < s)
                      & (take(state.status, rel.clamp(0, s - 1)) >= COMMITTED))
        pending = backlog | in_flight | peer_lag | pending_cb
    return lo.to(I32), hi.to(I32), pending.to(I32)


def _scalar_columns(state, execr, report_base):
    b = state.me.shape[0]
    dev = state.me.device
    if _is_mencius(state):
        leader = torch.full((b,), -1, dtype=I32, device=dev)
        prepared = torch.ones(b, dtype=I32, device=dev)
    else:
        leader, prepared = state.leader_id, state.prepared.to(I32)
    low, high, pending = _anchors(state)
    return [state.committed_upto, report_base, state.crt_inst,
            state.kv.dropped, execr.lo, execr.count, leader, prepared,
            state.executed_upto, low, high, pending]


def _pack_plain(state, outbox, execr, out, report_base):
    """The plain twin: cast, pad, concatenate, copy into ``out``."""
    m = outbox.msgs
    b, m_out = m.kind.shape
    ack = torch.zeros((b, m_out), dtype=I32, device=m.kind.device)
    ack[:, :outbox.acked.shape[1]] = outbox.acked.to(I32)
    out_mat = torch.stack([c.to(I32) for c in m] + [outbox.dst.to(I32), ack], 1)
    exec_mat = torch.stack([getattr(execr, c).to(I32) for c in EXEC_COLS], 1)
    scal = torch.stack([x.to(I32) for x in _scalar_columns(state, execr, report_base)], 1)
    out.copy_(torch.cat([out_mat.reshape(b, -1), exec_mat.reshape(b, -1), scal,
                         state.peer_commits.to(I32)], 1))
    return out


class _Col(ctypes.Structure):
    """substeps.cu ``MpCol``: a [B] or [B, N] int32/1-byte tensor by
    pointer and element strides; ``len`` valid entries along N (reads
    past it give 0); a null pointer reads the default."""

    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("si", ctypes.c_longlong), ("dt", ctypes.c_int),
                ("len", ctypes.c_int)]


class _PackArgs(ctypes.Structure):
    """substeps.cu ``MpPackArgs``."""

    _fields_ = [("out", _Col * N_OUT_COLS), ("ex", _Col * len(EXEC_COLS)),
                ("sc", _Col * 9), ("me", _Col), ("pc", _Col),
                ("crt_inst", _Col), ("crt_own", _Col), ("commit_sent", _Col),
                ("tk_anchor", _Col), ("wbase", _Col), ("status", _Col),
                ("leader_id", _Col), ("prepared", _Col), ("gossip", _Col),
                ("committed", _Col), ("executed", _Col),
                ("R", ctypes.c_int), ("S", ctypes.c_int), ("mencius", ctypes.c_int)]


_DT = {torch.int32: 0, torch.uint8: 1, torch.bool: 1}


def _col(t: torch.Tensor | None, n: int = 1) -> _Col:
    if t is None:
        return _Col(None, 0, 0, 0, 0)
    if t.device.type != "cuda":
        raise RuntimeError(f"pack_outputs: expected a CUDA tensor, got {t.device}")
    if t.dtype not in _DT:
        raise TypeError(f"pack_outputs: unsupported dtype {t.dtype}")
    si = t.stride(1) if t.dim() > 1 else 0
    length = t.shape[1] if t.dim() > 1 else 1
    return _Col(t.data_ptr(), t.stride(0), si, _DT[t.dtype], min(length, n) if n else length)


@K.kernel("pack_outputs")
def _pack_kernel(state, outbox, execr, out, report_base):
    m = outbox.msgs
    b, m_out = m.kind.shape
    e = execr.val_hi.shape[1]
    r = state.peer_commits.shape[1]
    w = row_width(m_out, e, r)
    if out.dtype != I32 or out.shape != (b, w) or not out.is_contiguous():
        raise ValueError(f"pack_outputs: out must be contiguous int32 [{b}, {w}]")
    a = _PackArgs()
    for i, t in enumerate(list(m) + [outbox.dst, outbox.acked]):
        a.out[i] = _col(t, m_out)
    for i, c in enumerate(EXEC_COLS):
        a.ex[i] = _col(getattr(execr, c), e)
    men = _is_mencius(state)
    sc = [state.committed_upto, report_base, state.crt_inst, state.kv.dropped,
          execr.lo, execr.count, None if men else state.leader_id,
          None if men else state.prepared, state.executed_upto]
    for i, t in enumerate(sc):
        a.sc[i] = _col(t)
    a.me, a.pc = _col(state.me), _col(state.peer_commits, r)
    a.crt_inst, a.committed, a.executed = (
        _col(state.crt_inst), _col(state.committed_upto), _col(state.executed_upto))
    if men:
        a.crt_own, a.commit_sent = _col(state.crt_own), _col(state.commit_sent)
        a.tk_anchor, a.wbase = _col(state.tk_anchor), _col(state.window_base)
        a.status = _col(state.status, state.status.shape[1])
    else:
        a.leader_id, a.prepared = _col(state.leader_id), _col(state.prepared)
        a.gossip = _col(state.gossip_upto)
    a.R, a.S, a.mencius = r, state.status.shape[1] if men else 1, int(men)
    f_ = K.fn("substeps", "mp_pack_outputs",
              [K.P, K.P, K.I, K.I, K.I, K.I, K.P])
    rc = f_(ctypes.cast(ctypes.pointer(a), ctypes.c_void_p), K.ptr(out), b, m_out,
            e, w, K.stream(out))
    K.check("substeps", rc, "pack_outputs")
    _pack_kernel.launches += 1
    return out


def pack_outputs(state, outbox, execr, out: torch.Tensor | None = None,
                 report_base: torch.Tensor | None = None) -> torch.Tensor:
    """Pack one substep's host reads into ``out`` (int32 [B, W], see the
    module docstring; allocated when None) and return it.
    ``report_base`` is the window base the scalar vector reports (the
    full state's under a narrow view; default the state's own)."""
    m = outbox.msgs
    b, m_out = m.kind.shape
    w = row_width(m_out, execr.val_hi.shape[1], state.peer_commits.shape[1])
    if out is None:
        out = torch.empty((b, w), dtype=I32, device=m.kind.device)
    base = state.window_base if report_base is None else report_base
    if K.on_cpu(out, m.kind, state.committed_upto):
        return _pack_plain(state, outbox, execr, out, base)
    return _pack_kernel(state, outbox, execr, out, base)


def _empty_like(inbox):
    return type(inbox)(*[torch.zeros_like(c) for c in inbox])


def scan_ticks(cfg, state, inbox, step_impl, k: int, alloc=None,
               report_base: torch.Tensor | None = None):
    """k protocol substeps: the real inbox feeds substep 0
    (tick_inc=1), substeps 1..k-1 run with empty inboxes (tick_inc=0).
    Returns (state', packed int32 [k, B, W]); ``alloc(k, B, W)`` gives
    the buffer (default a fresh tensor)."""
    buf = None
    empty = None
    for i in range(k):
        if i == 0:
            state, outbox, execr = step_impl(cfg, state, inbox)
        else:
            if empty is None:
                empty = _empty_like(inbox)
            state, outbox, execr = step_impl(cfg, state, empty, 0)
        if buf is None:
            b, m_out = outbox.msgs.kind.shape
            w = row_width(m_out, execr.val_hi.shape[1], state.peer_commits.shape[1])
            buf = (alloc(k, b, w) if alloc is not None else
                   torch.empty((k, b, w), dtype=I32, device=outbox.msgs.kind.device))
        pack_outputs(state, outbox, execr, buf[i], report_base)
    return state, buf


def narrow_view(state, off: int, narrow: int):
    """A ``narrow``-slot view of the window at offset ``off`` (absolute
    base window_base + off): every slot field narrowed in place (no
    copy), window_base moved. Returns (view state, slot field names).
    The caller guarantees every slot the step could touch lies inside
    the view and runs it with ``slide_window=False``."""
    fields = tuple(f for f in SLOT_FIELDS if f in state._fields)
    upd = {f: getattr(state, f).narrow(1, off, narrow) for f in fields}
    upd["window_base"] = state.window_base + off
    return state._replace(**upd), fields


def merge_view(full, view, off: int, fields):
    """Write a stepped narrow view back into the full-window state: slot
    fields by ``copy_`` into ``full``'s tensors at ``off`` (in place);
    every other field adopts the view's value, except window_base,
    which keeps the full state's (the view ran with the slide off)."""
    narrow = getattr(view, fields[0]).shape[1]
    for f in fields:
        getattr(full, f).narrow(1, off, narrow).copy_(getattr(view, f))
    upd = {n: getattr(view, n) for n in view._fields
           if n not in fields and n != "window_base"}
    return full._replace(**upd)
