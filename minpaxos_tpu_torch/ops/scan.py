"""Scan primitives of the consensus step (kernel K3).

- ``commit_frontier``: the prefix-AND over the committed window that
  gives the contiguous committed frontier (ops/scan.py of the JAX
  package, a cumulative pass there).
- ``segmented_scan_max`` / ``exclusive_segmented_scan_max``: the
  segmented max-scan the KV engine uses for "last write to my key before
  me" (a ``lax.associative_scan`` there; PyTorch has no counterpart).

All take a leading batch axis and scan along the last one. On a CUDA
tensor they launch ``kernels/csrc/scan.cu``; on the CPU they run the
plain version below.
"""

from __future__ import annotations

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
