"""On-device benchmark workload: counter-based Threefry proposal batches.

The port's copy of the JAX package's ``ops/workload.py``: Threefry-2x32
(20 rounds) keyed on (seed, round) and countered on (shard, row), so any
(round, shard, row) cell of the workload can be regenerated on its own
and the host mirror ``threefry2x32_host`` reproduces the device stream
bit for bit. PyTorch has no uint32 shifts on the CPU, so the device
lanes are int64 holding uint32 values, masked after every wrap.

Keys: a per-(shard, round) base plus an odd-stride walk, masked into the
power-of-two ``key_space`` — distinct within a round; ``hot_pct`` (the
hot-key knob) redirects that share of rows into the ``hot_keys`` lowest
keys, drawn from an independent counter block (shard + n_shards), and
at 0 leaves the stream unchanged. Values: Threefry lane 1. Rows are PUT
PROPOSEs, cmd_id = round * rows + row (wrapping in int32), client_id =
shard.

``propose_batch`` makes one round's rows: on a CUDA device one launch of
kernel K8 (``kernels/csrc/workload.cu``) writes all twelve columns; on
the CPU the plain twin ``workload_lanes`` + ``assemble_batch`` does.
``propose_batch_host`` is the numpy twin, the independent reference.
"""

from __future__ import annotations

import numpy as np
import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.packed import MASK32, mul32
from minpaxos_tpu_torch.wire.messages import MsgKind, Op

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_KEY_STRIDE = 2654435761


def _i64(x, device) -> torch.Tensor:
    """An int or array as an int64 tensor on ``device`` (a Python int as
    a fill, so the plain path also runs inside a CUDA-graph capture)."""
    if isinstance(x, int):
        return torch.full((), x, dtype=torch.int64, device=device)
    return torch.as_tensor(x, device=device).to(torch.int64)


def _u32(x, device) -> torch.Tensor:
    return _i64(x, device) & MASK32


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
                   key_space: int = 1 << 20, device=None, hot_pct: int = 0,
                   hot_keys: int = 8):
    """(key, val) int32 lanes for ``round_idx``: a scalar gives [G, M], a
    [k] vector gives [k, G, M] (all of a dispatch's rounds at once)."""
    dev = torch.device("cpu" if device is None else device)
    r = _i64(round_idx, dev)[..., None, None]
    shard = torch.arange(n_shards, device=dev)[:, None]
    row = torch.arange(ext_rows, device=dev)[None, :]
    b0, b1 = threefry2x32(seed, r, shard, row, device=dev)
    key = ((b0[..., :1] + mul32(row, _KEY_STRIDE)) & (key_space - 1))
    if hot_pct:
        h0, h1 = threefry2x32(seed, r, shard + n_shards, row, device=dev)
        key = torch.where(h0 % 100 < hot_pct, h1 % hot_keys, key)
    return key.to(torch.int32), _to_i32(b1)


def workload_lanes_host(n_shards: int, ext_rows: int, round_idx: int, seed: int,
                        key_space: int = 1 << 20, hot_pct: int = 0,
                        hot_keys: int = 8):
    """NumPy twin of ``workload_lanes`` for one round: (key, val) int32
    [G, M] — the host replay a run's KV contents are checked against."""
    rnd = np.uint32(np.int64(round_idx) & MASK32)
    rows = np.arange(ext_rows, dtype=np.int32)[None, :]
    b0, b1 = threefry2x32_host(seed, rnd,
                               np.arange(n_shards, dtype=np.int32)[:, None], rows)
    with np.errstate(over="ignore"):
        colu = np.arange(ext_rows, dtype=np.uint32)[None, :]
        key = ((b0[:, :1] + colu * np.uint32(_KEY_STRIDE))
               & np.uint32(key_space - 1)).astype(np.int32)
    if hot_pct:
        h0, h1 = threefry2x32_host(
            seed, rnd, np.arange(n_shards, dtype=np.int32)[:, None] + np.int32(n_shards),
            rows)
        key = np.where(h0 % np.uint32(100) < np.uint32(hot_pct),
                       (h1 % np.uint32(hot_keys)).astype(np.int32), key)
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
        cmd_id=sel(_to_i32((_i64(round_idx, dev) * m + colm) & MASK32)),
        client_id=sel(shard),
    )


def _propose_rows_plain(n_replicas, n_shards, ext_rows, count, leader, round_idx,
                        seed, key_space, hot_pct, hot_keys, device):
    """K8's plain twin: the Threefry lanes, then the twelve columns."""
    key, val = workload_lanes(n_shards, ext_rows, round_idx, seed, key_space,
                              device=device, hot_pct=hot_pct, hot_keys=hot_keys)
    return assemble_batch(n_replicas, n_shards, ext_rows, count, leader, round_idx,
                          key, val)


@K.kernel("propose_rows")
def _propose_rows_kernel(out, n_replicas, n_shards, ext_rows, count, leader,
                         round_idx, seed, key_space, hot_pct, hot_keys):
    f_ = K.fn("workload", "mp_propose_rows",
              [K.P, K.I, K.I, K.I, K.I, K.I, K.U, K.U, K.U, K.I, K.U, K.I, K.I, K.P])
    rc = f_(K.ptr(out), n_shards, n_replicas, ext_rows, count, leader,
            round_idx & MASK32, seed & MASK32, (key_space - 1) & MASK32,
            hot_pct, hot_keys & MASK32, int(MsgKind.PROPOSE), int(Op.PUT),
            K.stream(out))
    K.check("workload", rc, "propose_rows")
    _propose_rows_kernel.launches += 1
    return out


def propose_batch(n_replicas: int, n_shards: int, ext_rows: int, count: int,
                  leader: int, round_idx: int, seed: int,
                  key_space: int = 1 << 20, hot_pct: int = 0, hot_keys: int = 8,
                  device=None):
    """[G * R, M] PROPOSE rows for one protocol round, made on ``device``:
    one K8 launch into a [12, G * R, M] buffer on the card, the plain
    twin on the CPU."""
    if key_space & (key_space - 1) or not 0 < key_space <= 1 << 31:
        raise ValueError(f"key_space must be a power of two, got {key_space}")
    if hot_pct < 0 or (hot_pct and hot_keys < 1):
        raise ValueError(f"hot_pct={hot_pct}, hot_keys={hot_keys}: need hot_pct "
                         ">= 0 and hot_keys >= 1")
    from minpaxos_tpu_torch.models.minpaxos import MsgBatch

    out = torch.empty((12, n_shards * n_replicas, ext_rows), dtype=torch.int32,
                      device=torch.device("cpu" if device is None else device))
    if K.on_cpu(out):
        return _propose_rows_plain(n_replicas, n_shards, ext_rows, count, leader,
                                   round_idx, seed, key_space, hot_pct, hot_keys,
                                   out.device)
    _propose_rows_kernel(out, n_replicas, n_shards, ext_rows, count, leader,
                         int(round_idx), int(seed), key_space, int(hot_pct),
                         int(hot_keys))
    return MsgBatch(*out.unbind(0))


def propose_batch_host(n_replicas: int, n_shards: int, ext_rows: int, count: int,
                       leader: int, round_idx: int, seed: int,
                       key_space: int = 1 << 20, hot_pct: int = 0,
                       hot_keys: int = 8):
    """The numpy twin of ``propose_batch``: the same rows, [G * R, M]
    int32 per MsgBatch column, from the same (seed, round)."""
    from minpaxos_tpu_torch.models.minpaxos import MsgBatch

    g, r, m = n_shards, n_replicas, ext_rows
    key, val = workload_lanes_host(g, m, round_idx, seed, key_space,
                                   hot_pct=hot_pct, hot_keys=hot_keys)
    shard = np.arange(g, dtype=np.int32)[:, None, None]
    rep = np.arange(r, dtype=np.int32)[None, :, None]
    col = np.arange(m, dtype=np.int32)[None, None, :]
    active = np.broadcast_to(((rep == leader) | (leader < 0)) & (col < count),
                             (g, r, m)).reshape(g * r, m)
    with np.errstate(over="ignore"):
        cmd = (np.uint32(np.int64(round_idx) & MASK32) * np.uint32(m)
               + col.astype(np.uint32)).astype(np.int32)
    z = np.zeros((g * r, m), np.int32)

    def sel(x):
        return np.where(active, x, 0).astype(np.int32)

    return MsgBatch(
        kind=sel(np.int32(int(MsgKind.PROPOSE))),
        src=np.full((g * r, m), -1, np.int32),
        ballot=z, inst=z, last_committed=z,
        op=sel(np.int32(int(Op.PUT))),
        key_hi=z,
        key_lo=sel(np.repeat(key, r, axis=0)),
        val_hi=z,
        val_lo=sel(np.repeat(val, r, axis=0)),
        cmd_id=sel(cmd[0]),
        client_id=sel(np.repeat(shard[:, 0], r, axis=0)),
    )
