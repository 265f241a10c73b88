"""Keyed slot-winner scatter-max (kernel K2) and the column gathers.

The step's slot-writing sections pick ONE winning inbox row per window
slot with a single scatter-max of a key (row index, or section * M +
row) into a [B, size + 1] array whose last column is the sink for
masked rows, then gather every column at the winner. On a CUDA tensor
``scatter_max`` launches ``kernels/csrc/winner.cu``; on the CPU it runs
the plain ``scatter_reduce_`` below. The column gathers stay
``torch.gather`` + ``where`` in this slice.
"""

from __future__ import annotations

import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.util import I32


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
