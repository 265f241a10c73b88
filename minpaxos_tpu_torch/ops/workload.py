"""On-device benchmark workload: counter-based Threefry proposal batches.

The port's copy of the JAX package's ``ops/workload.py``: Threefry-2x32
(20 rounds) keyed on (seed, round) and countered on (shard, row), so any
(round, shard, row) cell of the workload can be regenerated on its own
and the host mirror ``threefry2x32_host`` reproduces the device stream
bit for bit. PyTorch has no uint32 shifts on the CPU, so the device
lanes are int64 holding uint32 values, masked after every wrap.

Keys: a per-(shard, round) base plus an odd-stride walk, masked into the
power-of-two ``key_space`` — distinct within a round. Values: Threefry
lane 1. Rows are PUT PROPOSEs, cmd_id = round * rows + row, client_id =
shard. Plain PyTorch in this slice (a kernel is queued).
"""

from __future__ import annotations

import numpy as np
import torch

from minpaxos_tpu_torch.ops.packed import MASK32, mul32
from minpaxos_tpu_torch.wire.messages import MsgKind, Op

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_KEY_STRIDE = 2654435761


def _u32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK32


def threefry2x32(k0, k1, c0, c1, device=None):
    """Threefry-2x32 over broadcastable integer inputs; returns two
    int64 tensors of uint32 values."""
    dev = device if device is not None else next(
        (t.device for t in (k0, k1, c0, c1) if isinstance(t, torch.Tensor)),
        torch.device("cpu"))
    k0, k1, x0, x1 = (_u32(a, dev) for a in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def threefry2x32_host(k0, k1, c0, c1):
    """NumPy mirror of ``threefry2x32`` (uint32 arrays): the independent
    host reference the device stream is held to."""
    with np.errstate(over="ignore"):
        k0 = np.uint32(k0) * np.ones(1, np.uint32)
        k1 = np.uint32(k1) * np.ones(1, np.uint32)
        x0 = np.broadcast_to(c0, np.broadcast_shapes(
            np.shape(c0), np.shape(c1))).astype(np.uint32)
        x1 = np.broadcast_to(c1, x0.shape).astype(np.uint32)
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in (_ROT_A if i % 2 == 0 else _ROT_B):
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x1 ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def workload_lanes(n_shards: int, ext_rows: int, round_idx, seed,
                   key_space: int = 1 << 20, device=None):
    """(key, val) int32 lanes for ``round_idx``: a scalar gives [G, M], a
    [k] vector gives [k, G, M] (all of a dispatch's rounds at once)."""
    dev = torch.device("cpu" if device is None else device)
    r = torch.as_tensor(round_idx, device=dev).to(torch.int64)[..., None, None]
    shard = torch.arange(n_shards, device=dev)[:, None]
    row = torch.arange(ext_rows, device=dev)[None, :]
    b0, b1 = threefry2x32(seed, r, shard, row, device=dev)
    key = ((b0[..., :1] + mul32(row, _KEY_STRIDE)) & (key_space - 1))
    return key.to(torch.int32), _to_i32(b1)


def workload_lanes_host(n_shards: int, ext_rows: int, round_idx: int, seed: int,
                        key_space: int = 1 << 20):
    """NumPy twin of ``workload_lanes`` for one round: (key, val) int32
    [G, M] — the host replay a run's KV contents are checked against."""
    b0, b1 = threefry2x32_host(seed, np.uint32(np.int64(round_idx) & MASK32),
                               np.arange(n_shards, dtype=np.int32)[:, None],
                               np.arange(ext_rows, dtype=np.int32)[None, :])
    with np.errstate(over="ignore"):
        colu = np.arange(ext_rows, dtype=np.uint32)[None, :]
        key = ((b0[:, :1] + colu * np.uint32(_KEY_STRIDE))
               & np.uint32(key_space - 1)).astype(np.int32)
    return key, b1.astype(np.int32)


def assemble_batch(n_replicas: int, n_shards: int, ext_rows: int, count: int,
                   leader: int, round_idx, key: torch.Tensor, val: torch.Tensor):
    """One round's PROPOSE rows, [G * R, M] per MsgBatch column, from
    [G, M] key/val lanes: ``count`` rows per shard, addressed to
    ``leader`` (to every replica when leader < 0)."""
    from minpaxos_tpu_torch.models.minpaxos import MsgBatch

    g, r, m = n_shards, n_replicas, ext_rows
    dev = key.device
    shard = torch.arange(g, dtype=torch.int32, device=dev)[:, None, None]
    rep = torch.arange(r, dtype=torch.int32, device=dev)[None, :, None]
    colm = torch.arange(m, dtype=torch.int32, device=dev)[None, None, :]
    active = (((rep == leader) | (leader < 0)) & (colm < count)).expand(g, r, m)
    z = torch.zeros((g * r, m), dtype=torch.int32, device=dev)

    def flat(x):
        return x.expand(g, r, m).reshape(g * r, m)

    def sel(x):
        return flat(torch.where(active, x, 0).to(torch.int32))

    return MsgBatch(
        kind=sel(int(MsgKind.PROPOSE)),
        src=torch.full((g * r, m), -1, dtype=torch.int32, device=dev),
        ballot=z,
        inst=z,
        last_committed=z,
        op=sel(int(Op.PUT)),
        key_hi=z,
        key_lo=sel(key[:, None, :]),
        val_hi=z,
        val_lo=sel(val[:, None, :]),
        cmd_id=sel(round_idx * m + colm),
        client_id=sel(shard),
    )


def propose_batch(n_replicas: int, n_shards: int, ext_rows: int, count: int,
                  leader: int, round_idx: int, seed: int,
                  key_space: int = 1 << 20, device=None):
    """[G * R, M] PROPOSE rows for one protocol round, made on ``device``."""
    key, val = workload_lanes(n_shards, ext_rows, round_idx, seed, key_space,
                              device)
    return assemble_batch(n_replicas, n_shards, ext_rows, count, leader,
                          round_idx, key, val)
