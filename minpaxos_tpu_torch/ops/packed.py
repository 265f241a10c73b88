"""64-bit keys/values as pairs of 32-bit lanes, and the key hash.

Device code carries every 64-bit quantity as (hi: i32, lo: i32) lane
pairs; host code splits and joins at the boundary. The hash works on
uint32 lanes. PyTorch has no uint32 shifts on the CPU, so the lanes are
emulated in int64 holding values in [0, 2**32) and masked after every
wrapping operation.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def split_i64(x) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: int64 array -> (hi i32, lo i32), lo holding the low 32
    bits reinterpreted as signed."""
    x = np.asarray(x, dtype=np.int64)
    hi = (x >> 32).astype(np.int32)
    lo = (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return hi, lo


def join_i64(hi, lo) -> np.ndarray:
    """Host-side inverse of split_i64."""
    hi = np.asarray(hi, dtype=np.int64)
    lo = np.asarray(lo).astype(np.int32).view(np.uint32).astype(np.int64)
    return (hi << 32) | lo


def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an integer tensor, as int64."""
    return x.to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 lanes (int64-held)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def pair_hash(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """uint32 hash of an (hi, lo) pair, as int64 in [0, 2**32)."""
    h = _mix32(u32(lo) ^ 0x9E3779B9)
    return _mix32(h ^ u32(hi))
