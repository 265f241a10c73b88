"""Routing fabric: pooled outbox rows -> per-destination inboxes (kernel K1).

Per group, the R replicas' outbox rows are pooled (N = R * m rows, row
i sent by replica i // m). A row lands in destination d's inbox iff it
is live (kind != 0) from a live sender and either broadcasts (dst -1)
from another replica or unicasts to d (d != sender); dead destinations
receive nothing. Rows keep pooled order; rows beyond the inbox capacity
are dropped (legal message loss); unfilled slots are zero.

``route`` does the plan and the 12-column gather at once: on a CUDA
tensor it launches ``kernels/csrc/route.cu``; on the CPU it runs the
plain ``route_plan`` (one segment-prefix-sum + searchsorted winner, the
JAX package's ops/segscatter.py) and ``gather_rows``.
``prefix_pack_plan`` is the one-destination case used by inbox
compaction (off on the main path), plain PyTorch.
"""

from __future__ import annotations

import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.util import I32

__all__ = ["route", "route_plan", "gather_rows", "prefix_pack_plan"]


def route_plan(kind: torch.Tensor, fdst: torch.Tensor, alive: torch.Tensor,
               m_out: int, capacity: int):
    """Plan over [G, N] pooled rows (alive [G, R]): win[g, d, s] = pooled
    row filling slot s of destination d's inbox, hit = slot filled."""
    g, n = kind.shape
    r = alive.shape[1]
    dev = kind.device
    src_rep = torch.arange(n, device=dev) // m_out  # [N]
    live = (kind != 0) & torch.gather(alive, 1, src_rep.expand(g, n))
    isbc = live & (fdst == -1)
    isun = live & (fdst >= 0) & (fdst < r) & (fdst != src_rep)
    dests = torch.arange(r, device=dev)[None, :, None]  # [1, R, 1]
    destined = (((isbc[:, None, :] & (src_rep[None, None, :] != dests))
                 | (isun[:, None, :] & (fdst[:, None, :] == dests)))
                & alive[:, :, None])  # [G, R, N]
    cnt = torch.cumsum(destined, dim=-1)  # int64
    want = torch.arange(1, capacity + 1, device=dev).expand(g, r, capacity)
    win = torch.searchsorted(cnt, want.contiguous())
    return win, win < n


def gather_rows(cols: torch.Tensor, win: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """cols [12, G, N] -> [12, G, R, capacity]: the planned inboxes;
    unfilled slots are zero."""
    c, g, n = cols.shape
    _, r, cap = win.shape
    winc = torch.where(hit, win, 0)
    picked = torch.gather(cols[:, :, None, :].expand(c, g, r, n), 3,
                          winc[None].expand(c, g, r, cap))
    return torch.where(hit[None], picked, 0)


@K.kernel("route")
def _route_kernel(cols, dst, alive, m_out: int, capacity: int):
    cc = K.cuda_arg(cols, I32, "route cols")
    dd = K.cuda_arg(dst, I32, "route dst")
    al = K.cuda_arg(alive, torch.bool, "route alive")
    ncol, g, n = cc.shape
    r = al.shape[1]
    if ncol != 12 or dd.shape != (g, n) or n != r * m_out:
        raise ValueError(f"route: bad shapes cols {tuple(cc.shape)} dst "
                         f"{tuple(dd.shape)} alive {tuple(al.shape)}")
    out = torch.empty((ncol, g, r, capacity), dtype=I32, device=cc.device)
    hit = torch.empty((g, r, capacity), dtype=torch.bool, device=cc.device)
    f_ = K.fn("route", "mp_route", [K.P] * 5 + [K.I] * 4 + [K.P])
    rc = f_(K.ptr(cc), K.ptr(dd), K.ptr(al), K.ptr(out), K.ptr(hit), g, r,
            m_out, capacity, K.stream(cc))
    K.check("route", rc, "route")
    _route_kernel.launches += 1
    return out, hit


def route(cols: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
          m_out: int, capacity: int):
    """Route pooled rows: cols int32[12, G, N] (N = R * m_out, the
    MsgBatch columns in field order), dst int32[G, N], alive bool[G, R]
    -> (inboxes int32[12, G, R, capacity], hit bool[G, R, capacity])."""
    if K.on_cpu(cols, dst, alive):
        win, hit = route_plan(cols[0], dst, alive, m_out, capacity)
        return gather_rows(cols, win, hit), hit
    return _route_kernel(cols, dst, alive, m_out, capacity)


def prefix_pack_plan(live: torch.Tensor, capacity: int):
    """[B, n] compaction plan: pack rows where ``live`` to a prefix of a
    ``capacity``-row buffer (order kept, overflow dropped). Returns
    (win, hit) like ``route_plan`` for one destination."""
    b, n = live.shape
    cnt = torch.cumsum(live, dim=-1)
    want = torch.arange(1, capacity + 1, device=live.device).expand(b, capacity)
    win = torch.searchsorted(cnt, want.contiguous())
    return win, win < n
