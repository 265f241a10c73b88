"""Batched indexing helpers: JAX idioms over an explicit batch axis.

Every device array of the port carries a leading batch axis (B = groups
x replicas); these helpers give the per-row JAX forms their batched
PyTorch spelling with JAX's results (first-maximum ties, int32 prefix
sums, floor division).
"""

from __future__ import annotations

import torch

I32 = torch.int32


def col(x: torch.Tensor) -> torch.Tensor:
    """A per-row scalar [B] as a column [B, 1] for broadcasting."""
    return x[:, None]


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather: a[b, idx[b, ...]] — ``a[idx]`` of the JAX row."""
    if idx.dim() == 1:
        return torch.gather(a, 1, idx[:, None].long())[:, 0]
    return torch.gather(a, 1, idx.long())


def masked_max(x: torch.Tensor, mask: torch.Tensor, fill: int) -> torch.Tensor:
    """jnp.max(jnp.where(mask, x, fill)) per row."""
    return torch.where(mask, x, fill).amax(dim=1)


def argmax_first(x: torch.Tensor) -> torch.Tensor:
    """Per-row index of the first maximum (jnp.argmax's tie rule)."""
    n = x.shape[1]
    idx = torch.arange(n, device=x.device).expand_as(x)
    hit = x == x.amax(dim=1, keepdim=True)
    return torch.where(hit, idx, n).amin(dim=1)


def argmin_first(x: torch.Tensor) -> torch.Tensor:
    """Per-row index of the first minimum (jnp.argmin's tie rule)."""
    n = x.shape[1]
    idx = torch.arange(n, device=x.device).expand_as(x)
    hit = x == x.amin(dim=1, keepdim=True)
    return torch.where(hit, idx, n).amin(dim=1)


def first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 if none) — jnp.argmax
    on a bool array."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, device=mask.device).view(shape).expand_as(mask)
    first = torch.where(mask, idx, n).amin(dim=dim)
    return torch.where(first == n, 0, first)


def cumsum32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int32 prefix sum (torch's cumsum of ints gives int64)."""
    return torch.cumsum(x, dim=dim, dtype=I32)


def floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 lane (bit masks of up to 16 replicas)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v & 0xFF) + ((v >> 8) & 0xFF) + ((v >> 16) & 0xFF) + ((v >> 24) & 0xFF)
