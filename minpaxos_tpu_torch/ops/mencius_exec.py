"""Mencius's conflict-aware out-of-order exec selector (kernel K6).

The front half of the JAX package's ``models/mencius.py``
``_exec_pipeline``: which window slots of each replica execute this
step. They are the in-order prefix [executed_upto + 1, committed_upto]
(at most E), and every committed slot above the frontier that lies below
the first gap (a NONE slot, whose future key is unknown) and that no
earlier slot of the same key poisons. A slot poisons the later slots of
its key when it is live (ACCEPTED or COMMITTED), not executed and not in
the prefix, or when it is an uncommitted PUT/DELETE. In slot order, the
first E of these get a rank.

On CUDA tensors ``exec_select`` launches ``kernels/csrc/mencius_exec.cu``;
on the CPU it runs the plain version below: a stable sort by (key_hi,
key_lo, slot) — ``jnp.lexsort``'s order — and two running maxima over
the sorted window in place of the segmented scan (the last poisoned
position before a slot against the start of its key's segment).
"""

from __future__ import annotations

import numpy as np
import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.kvstore import sort_order
from minpaxos_tpu_torch.ops.util import I32, col, cumsum32
from minpaxos_tpu_torch.wire.messages import ACCEPTED, COMMITTED, EXECUTED, NONE, Op


def _exec_select_plain(key_hi, key_lo, status, op, executed, window_base,
                       committed_upto, executed_upto, exec_batch: int):
    b, s = status.shape
    e = exec_batch
    dev = status.device
    idx = torch.arange(s, dtype=I32, device=dev)[None, :]
    idx_abs = col(window_base) + idx
    rel_e0 = col(executed_upto + 1 - window_base)
    n_inorder = col((committed_upto - executed_upto).clamp(0, e))
    in_prefix = (idx >= rel_e0) & (idx < rel_e0 + n_inorder)
    order = sort_order(key_hi, key_lo, torch.ones_like(executed))

    def g(x):
        return torch.gather(x, 1, order)

    s_hi, s_lo, s_st, s_op = g(key_hi), g(key_lo), g(status), g(op)
    pos = idx.expand(b, s)
    seg_start = torch.ones_like(executed)
    seg_start[:, 1:] = (s_hi[:, 1:] != s_hi[:, :-1]) | (s_lo[:, 1:] != s_lo[:, :-1])
    live = (s_st >= ACCEPTED) & (s_st < EXECUTED)
    unc_write = (s_st == ACCEPTED) & ((s_op == int(Op.PUT)) | (s_op == int(Op.DELETE)))
    not_done = live & ~g(executed) & ~g(in_prefix)
    poison = torch.where(not_done | unc_write, pos, -1)
    last_poison = torch.cummax(poison, 1).values
    before = torch.cat([torch.full_like(last_poison[:, :1], -1), last_poison[:, :-1]], 1)
    seg_pos = torch.cummax(torch.where(seg_start, pos, -1), 1).values
    clear = torch.empty_like(executed).scatter_(1, order, before < seg_pos)
    first_gap = torch.where((idx_abs > col(committed_upto)) & (status == NONE),
                            idx_abs, 2 ** 30).amin(1)
    ooo = ((status == COMMITTED) & ~executed & ~in_prefix
           & (idx_abs > col(committed_upto)) & (idx_abs < col(first_gap)) & clear)
    want = (in_prefix & ~executed) | ooo
    rank = cumsum32(want.to(I32), 1) - 1
    take = want & (rank < e)
    slot_of = torch.full((b, e + 1), s, dtype=I32, device=dev)
    slot_of.scatter_(1, torch.where(take, rank, e).long(), idx.expand(b, s))
    slot_of[:, e] = s
    return slot_of[:, :e].contiguous(), take


@K.kernel("exec_select")
def _exec_select_kernel(key_hi, key_lo, status, op, executed, window_base,
                        committed_upto, executed_upto, exec_batch: int):
    hi = K.cuda_arg(key_hi, I32, "exec_select key_hi")
    lo = K.cuda_arg(key_lo, I32, "exec_select key_lo")
    st = K.cuda_arg(status, torch.uint8, "exec_select status")
    o = K.cuda_arg(op, torch.uint8, "exec_select op")
    ex = K.cuda_arg(executed, torch.bool, "exec_select executed")
    wb = K.cuda_arg(window_base, I32, "exec_select window_base")
    cu = K.cuda_arg(committed_upto, I32, "exec_select committed_upto")
    eu = K.cuda_arg(executed_upto, I32, "exec_select executed_upto")
    b, s = st.shape
    if not all(t.shape == (b, s) for t in (hi, lo, o, ex)) or \
            not all(t.shape == (b,) for t in (wb, cu, eu)):
        raise ValueError("exec_select: window columns must be [B, S], cursors [B]")
    slot_of = torch.empty((b, exec_batch), dtype=I32, device=st.device)
    newly = torch.empty((b, s), dtype=torch.bool, device=st.device)
    f_ = K.fn("mencius_exec", "mp_exec_select",
              [K.P] * 10 + [K.L, K.I, K.I, K.P])
    rc = f_(K.ptr(hi), K.ptr(lo), K.ptr(st), K.ptr(o), K.ptr(ex), K.ptr(wb),
            K.ptr(cu), K.ptr(eu), K.ptr(slot_of), K.ptr(newly), b, s,
            int(exec_batch), K.stream(st))
    K.check("mencius_exec", rc, "exec_select")
    _exec_select_kernel.launches += 1
    return slot_of, newly


def exec_select(key_hi, key_lo, status, op, executed, window_base,
                committed_upto, executed_upto, exec_batch: int):
    """(slot_of i32[B, E], newly_exec bool[B, S]): the window index of
    each exec rank (S past the last) and the slots that got a rank.
    Window columns are [B, S] (status and op uint8), cursors [B]."""
    if K.on_cpu(key_hi, key_lo, status, op, executed, window_base,
                committed_upto, executed_upto):
        return _exec_select_plain(key_hi, key_lo, status, op, executed,
                                  window_base, committed_upto, executed_upto,
                                  exec_batch)
    return _exec_select_kernel(key_hi, key_lo, status, op, executed, window_base,
                               committed_upto, executed_upto, exec_batch)


def exec_families(rng, b: int, s: int, e: int, names=None) -> dict:
    """K6 input families as numpy (key_hi, key_lo, status, op, executed,
    window_base, committed_upto, executed_upto) for a [b, s] window and
    exec budget e, drawn from the numpy generator ``rng``: ``random``
    (duplicate keys, NONE gaps, uncommitted writes); ``one_key`` (every
    slot the key (-1, -1)); ``distinct_keys``; ``gap_at_slot_0`` (the
    frontier below the window and its first slot NONE); ``no_gap`` (no
    NONE slot); ``frontier_past_window`` (committed_upto beyond the
    window's end); ``budget_binds`` (no gap, mostly committed, prefix and
    candidates past e). ``names`` picks some families (all by default);
    the card tests, the CPU oracle test and ``chip_smoke.py`` share
    these windows."""
    st_codes = np.array([0, 3, 4, 4, 4, 5], np.uint8)

    def status(p):
        return st_codes[rng.choice(6, (b, s), p=p)]

    def base(st):
        key_hi = rng.integers(-1, 1, (b, s)).astype(np.int32)
        key_lo = rng.integers(-3, 4 + s // 16, (b, s)).astype(np.int32)
        op = rng.integers(0, 4, (b, s)).astype(np.uint8)
        executed = (st == 5) | (rng.random((b, s)) < 0.05)
        wb = rng.integers(-5, 100, b).astype(np.int32)
        eu = (wb + rng.integers(-2, 10, b)).astype(np.int32)
        cu = (eu + rng.integers(-2, s // 2, b)).astype(np.int32)
        return [key_hi, key_lo, st, op, executed, wb, cu, eu]

    mix = [0.05, 0.15, 0.25, 0.25, 0.2, 0.1]
    no_none = [0.0, 0.1, 0.3, 0.3, 0.2, 0.1]

    def one_key():
        x = base(status(mix))
        x[0], x[1] = np.full((b, s), -1, np.int32), np.full((b, s), -1, np.int32)
        return x

    def distinct_keys():
        x = base(status(mix))
        x[1] = (np.arange(s, dtype=np.int32)[None, :] * 7 + rng.integers(0, 1000, (b, 1))
                ).astype(np.int32)
        return x

    def gap_at_slot_0():
        x = base(status(mix))
        x[2][:, 0] = 0
        x[6] = (x[5] - rng.integers(1, 4, b)).astype(np.int32)
        x[7] = (x[6] - rng.integers(0, 3, b)).astype(np.int32)
        return x

    def frontier_past_window():
        x = base(status(mix))
        x[6] = (x[5] + s + rng.integers(0, 9, b)).astype(np.int32)
        return x

    def budget_binds():
        x = base(status([0.0, 0.05, 0.4, 0.4, 0.1, 0.05]))
        x[7] = (x[5] + rng.integers(-1, 3, b)).astype(np.int32)
        x[6] = (x[7] + rng.integers(0, 2 * e + 2, b)).astype(np.int32)
        return x

    make = {"random": lambda: base(status(mix)), "one_key": one_key,
            "distinct_keys": distinct_keys, "gap_at_slot_0": gap_at_slot_0,
            "no_gap": lambda: base(status(no_none)),
            "frontier_past_window": frontier_past_window, "budget_binds": budget_binds}
    return {n: f() for n, f in make.items() if names is None or n in names}
