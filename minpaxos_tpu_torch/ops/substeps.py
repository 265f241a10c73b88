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

  K7 runs once per substep on the serving path, where the host is the
  bottleneck, and at B = 1 it moves about 200 KB, so what bounds it is
  the launch floor (the least time any launch takes) and its host
  issue, not bytes. Its launch takes two parameter blocks: the layout
  (``PackLayout``: per source its dtype code, strides and valid length,
  plus R, S and the Mencius flag), built once per ``layout_key`` (every
  source's and ``out``'s dtype, device, shape and strides) and cached,
  and the sources' data pointers, the only thing written per launch.
  A source that is not on ``out``'s CUDA device raises.
* ``narrow_view`` / ``merge_view`` run the substeps on a ``narrow``-slot
  view of a larger window at a host offset: ``Tensor.narrow`` on the
  slot axis, and a ``copy_`` back. The slot fields are a fixed name
  list (``SLOT_FIELDS``), not a shape test: in the batched ``[B, S]``
  state a ``[B, R]`` leaf would match a shape test whenever R equals
  the window.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
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


# Source slots of K7's launch (substeps.cu): the 14 outbox columns, the
# 6 exec columns, the nine reported scalars (SCAL_FRONTIER .. SCAL_EXECUTED),
# then what the anchors read.
N_COLS = N_OUT_COLS + len(EXEC_COLS)
SRC_PEER_COMMITS, SRC_STATUS = 34, 35
N_SRC = 36
_DT = {torch.int32: 0, torch.uint8: 1, torch.bool: 1}
_MAX_LAYOUTS = 64


def pack_sources(state, outbox, execr, report_base) -> tuple:
    """K7's source tensors in slot order; None where the protocol has no
    such field (MinPaxos: the four Mencius anchor scalars and status;
    Mencius: leader_id and prepared, which the kernel reads as -1 and 1)."""
    men = _is_mencius(state)
    return (*outbox.msgs, outbox.dst, outbox.acked,
            *[getattr(execr, c) for c in EXEC_COLS],
            state.committed_upto, report_base, state.crt_inst, state.kv.dropped,
            execr.lo, execr.count,
            None if men else state.leader_id, None if men else state.prepared,
            state.executed_upto, state.me,
            state.commit_sent if men else state.gossip_upto,
            state.tk_anchor if men else None, state.crt_own if men else None,
            state.window_base if men else None,
            state.peer_commits, state.status if men else None)


class PackLayout(ctypes.Structure):
    """substeps.cu ``MpPackLayout``: per source slot its element strides
    along the replica axis (``sb``) and the column (``si``), its valid
    length (reads past it give 0; 0 means no source) and dtype code
    (1: one byte); the row's shape, R, S and the Mencius flag."""

    _fields_ = [("sb", ctypes.c_longlong * N_SRC), ("si", ctypes.c_longlong * N_SRC),
                ("len", ctypes.c_int * N_SRC), ("dt", ctypes.c_int * N_SRC),
                ("B", ctypes.c_int), ("Mout", ctypes.c_int), ("E", ctypes.c_int),
                ("W", ctypes.c_int), ("R", ctypes.c_int), ("S", ctypes.c_int),
                ("mencius", ctypes.c_int)]


def layout_key(srcs, out) -> tuple:
    """What a layout depends on: every source's and ``out``'s dtype,
    device, shape and strides."""
    return tuple([None if t is None else (t.dtype, t.device, t.shape, t.stride())
                  for t in (*srcs, out)])


def pack_layout(srcs, out) -> PackLayout:
    """The launch layout of ``srcs`` (``pack_sources``) into ``out``.
    Reads only metadata, so it runs for tensors on any device."""
    b, m_out = srcs[0].shape
    e = srcs[N_OUT_COLS].shape[1]
    r = srcs[SRC_PEER_COMMITS].shape[1]
    status = srcs[SRC_STATUS]
    w = row_width(m_out, e, r)
    if out.dtype != I32 or out.shape != (b, w) or not out.is_contiguous():
        raise ValueError(f"pack_outputs: out must be contiguous int32 [{b}, {w}]")
    lay = PackLayout(B=b, Mout=m_out, E=e, W=w, R=r, mencius=int(status is not None),
                     S=1 if status is None else status.shape[1])
    for i, t in enumerate(srcs):
        if t is None:
            continue
        if t.dtype not in _DT:
            raise TypeError(f"pack_outputs: unsupported dtype {t.dtype}")
        if t.dim() not in (1, 2) or t.shape[0] != b:
            raise ValueError(f"pack_outputs: source {i} has shape {tuple(t.shape)}, "
                             f"expected [{b}] or [{b}, N]")
        n = t.shape[1] if t.dim() == 2 else 1
        lay.len[i] = min(n, m_out) if i < N_OUT_COLS else (min(n, e) if i < N_COLS else n)
        lay.sb[i] = t.stride(0)
        lay.si[i] = t.stride(1) if t.dim() == 2 else 0
        lay.dt[i] = _DT[t.dtype]
    return lay


class _Launcher:
    """K7's host launch. A layout is built once per ``layout_key`` and
    cached with its pointer array; a launch writes only the data
    pointers and calls the kernel (looked up once)."""

    def __init__(self):
        self.layouts = {}
        self.fn = None
        self.lock = threading.Lock()

    def entry(self, srcs, out):
        """(layout, pointer array, their addresses) of ``srcs`` into
        ``out``; raises for a tensor that is not on ``out``'s CUDA device."""
        key = layout_key(srcs, out)
        hit = self.layouts.get(key)
        if hit is None:
            lay = pack_layout(srcs, out)
            for t in (out, *srcs):
                if t is not None and (t.device.type != "cuda" or t.device != out.device):
                    raise RuntimeError(f"pack_outputs: expected a CUDA tensor on "
                                       f"{out.device}, got {t.device}")
            if len(self.layouts) >= _MAX_LAYOUTS:
                self.layouts.clear()
            ptrs = (ctypes.c_void_p * N_SRC)()
            hit = self.layouts[key] = (lay, ptrs, ctypes.addressof(lay),
                                       ctypes.addressof(ptrs))
        return hit

    def __call__(self, srcs, out) -> None:
        _, ptrs, lay_at, ptrs_at = self.entry(srcs, out)
        if self.fn is None:
            self.fn = K.fn("substeps", "mp_pack_outputs", [K.P, K.P, K.P, K.P])
        # threads share the cached pointer array (every replica server
        # of a process): it is filled and launched under the lock, and
        # the launch copies the layout and the pointers into the
        # kernel's parameters, so nothing of them outlives the call
        with self.lock:
            ptrs[:] = [None if t is None else t.data_ptr() for t in srcs]
            rc = self.fn(lay_at, ptrs_at, out.data_ptr(), K.stream(out))
        if rc:
            K.check("substeps", rc, "pack_outputs")


_launch = _Launcher()


@K.kernel("pack_outputs")
def _pack_kernel(state, outbox, execr, out, report_base):
    _launch(pack_sources(state, outbox, execr, report_base), out)
    _pack_kernel.launches += 1
    return out


def pack_outputs(state, outbox, execr, out: torch.Tensor | None = None,
                 report_base: torch.Tensor | None = None) -> torch.Tensor:
    """Pack one substep's host reads into ``out`` (int32 [B, W], see the
    module docstring; allocated when None) and return it.
    ``report_base`` is the window base the scalar vector reports (the
    full state's under a narrow view; default the state's own)."""
    m = outbox.msgs
    if out is None:
        b, m_out = m.kind.shape
        w = row_width(m_out, execr.val_hi.shape[1], state.peer_commits.shape[1])
        out = torch.empty((b, w), dtype=I32, device=m.kind.device)
    base = state.window_base if report_base is None else report_base
    if K.on_cpu(out, m.kind, state.committed_upto):
        return _pack_plain(state, outbox, execr, out, base)
    return _pack_kernel(state, outbox, execr, out, base)


PACK_CASES = ("minpaxos", "mencius", "mencius_edges")
# the status the mencius_edges rows find at rel, in turn
_STATUS_EDGES = (COMMITTED, COMMITTED - 1, COMMITTED + 1)


def pack_cases(rng, b: int, s: int, r: int, m_out: int, m_in: int, e: int,
               names=None) -> dict:
    """K7 inputs as numpy, drawn from the numpy generator ``rng``, by
    case: ``b`` replicas' state scalars (int32 [b]; ``peer_commits``
    [b, r], ``status`` uint8 [b, s]), random outbox columns (``msgs``
    int32 [12, b, m_out], ``dst``, ``acked`` bool [b, m_in]) and exec
    columns (``exec_<field>`` of ExecResult, ``found`` bool).

    ``minpaxos`` / ``mencius``: random scalars in the two anchor forms.
    ``mencius_edges``: Mencius rows whose only pending term is the
    unannounced-commit test (no backlog, nothing in flight, no peer
    lag): row i finds rel = nxt - window_base at -7, -1, 0, 1, s - 1, s
    or s + 5 in turn (below the window, its first and last slot, at and
    past its end) and, where rel lies in the window, status
    ``_STATUS_EDGES[i // 7 % 3]`` there (exactly COMMITTED, one below,
    one above); tk_anchor is -1 on two rows in three."""
    i32 = np.int32

    def ri(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(i32)

    out = {}
    for name in names or PACK_CASES:
        fr = ri(100, 5000, b)
        c = dict(committed_upto=fr, window_base=fr - ri(0, 300, b),
                 crt_inst=fr + ri(-2, 40, b), executed_upto=fr - ri(0, 30, b),
                 me=ri(0, r, b), peer_commits=fr[:, None] + ri(-600, 3, (b, r)),
                 kv_dropped=ri(0, 2, b))
        if name == "minpaxos":
            c.update(leader_id=ri(0, r, b), prepared=rng.random(b) < 0.5,
                     gossip_upto=fr - ri(-1, 3, b))
        elif name == "mencius":
            c.update(status=ri(0, 6, (b, s)).astype(np.uint8),
                     commit_sent=fr - ri(-3, 20, b),
                     tk_anchor=np.where(rng.random(b) < 0.5, fr - ri(0, 50, b), -1).astype(i32),
                     crt_own=fr + ri(-5, 60, b))
        else:
            rows = np.arange(b)
            cs = fr - ri(0, 20, b)
            nxt = cs + 1 + (c["me"] - cs - 1) % r  # a floor mod, as jnp.mod
            edges = np.array([-7, -1, 0, 1, s - 1, s, s + 5], i32)
            rel = edges[rows % len(edges)]
            status = ri(0, COMMITTED, (b, s)).astype(np.uint8)
            hit = (rel >= 0) & (rel < s)
            status[rows[hit], rel[hit]] = np.array(_STATUS_EDGES, np.uint8)[
                rows[hit] // len(edges) % len(_STATUS_EDGES)]
            c.update(executed_upto=fr, crt_inst=fr + 1 - ri(0, 3, b),
                     peer_commits=fr[:, None] + ri(0, 3, (b, r)), commit_sent=cs,
                     window_base=(nxt - rel).astype(i32), status=status,
                     tk_anchor=np.where(rows % 3 == 0, fr - ri(0, 50, b), -1).astype(i32),
                     crt_own=fr + ri(-5, 60, b))
        c.update(msgs=ri(-3, 1 << 20, (12, b, m_out)), dst=ri(-2, r, (b, m_out)),
                 acked=rng.random((b, m_in)) < 0.5,
                 exec_lo=ri(0, 100, b), exec_count=ri(0, e, b),
                 exec_val_hi=ri(-5, 5, (b, e)), exec_val_lo=ri(-5, 5, (b, e)),
                 exec_found=rng.random((b, e)) < 0.5, exec_op=ri(0, 4, (b, e)),
                 exec_cmd_id=ri(0, 1 << 20, (b, e)), exec_client_id=ri(-1, 9, (b, e)))
        out[name] = c
    return out


def pack_case_tensors(case: dict, device):
    """(state, Outbox, ExecResult) on ``device`` from a ``pack_cases``
    case; the state is a namespace of the fields K7 reads (``kv.dropped``
    included), without ``leader_id`` in the Mencius forms."""
    from types import SimpleNamespace

    from minpaxos_tpu_torch.models.minpaxos import ExecResult, MsgBatch, Outbox

    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    st = SimpleNamespace(kv=SimpleNamespace(dropped=t.pop("kv_dropped")),
                         **{k: v for k, v in t.items()
                            if k not in ("msgs", "dst", "acked") and not k.startswith("exec_")})
    ob = Outbox(MsgBatch(*t["msgs"].unbind(0)), t["dst"], t["acked"])
    ex = ExecResult(*[t[f"exec_{f}"] for f in ExecResult._fields])
    return st, ob, ex


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
