"""Vectorized replicated-KV state machine (kernel K4 for probe and insert).

The batched form of the JAX package's ``ops/kvstore.py``: every replica
owns a bucketized two-choice hash table (WAYS ways per bucket, two
candidate buckets per key), and one call applies a contiguous batch of
committed commands with sequential semantics — a GET sees the latest
earlier PUT/DELETE to its key in the batch, else the table; the table
ends as if the commands ran one by one.

Mechanics, per replica row: a stable sort by (key, slot); "last write
before me" and "the final writer of my key" come from one pass over the
sorted rows' segments (``ops/scan.py kv_segments``, K3: the JAX engine's
exclusive and reversed segmented max-scans); rows with no earlier writer
probe the table (``kv_lookup_lanes``, K4); the final writer per key is
inserted (``kv_insert_unique``, K4).

One departure from the JAX engine: a row whose two candidate buckets
are both full is not given up at once. A third pass (``_displace``)
moves one resident of those buckets to the resident's other bucket and
takes its way, so an acknowledged PUT is not lost while the table still
has room; only rows that pass cannot place count in ``dropped``. Where
the JAX engine places every row, the two produce the same table bytes.

On a CUDA tensor the probe and the insert launch
``kernels/csrc/kvstore.cu``. The insert kernel UPDATES THE TABLE IN
PLACE (the tables are the largest arrays of the state, ~840 MB at the
1M-instance deployment) and returns the same tensors; the plain CPU
version returns new ones.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.packed import pair_hash
from minpaxos_tpu_torch.ops.scan import kv_segments
from minpaxos_tpu_torch.ops.util import I32, cumsum32, first_true
from minpaxos_tpu_torch.wire.messages import Op

EMPTY, LIVE = 0, 1
WAYS = 4
VAL_LANES = 2
# failing rows per table and batch that pass C tries to place by
# displacement; the rest count in ``dropped``
DISPLACE_ROUNDS = 8
_BIG = 2 ** 31 - 1


class KVState(NamedTuple):
    """Per-replica hash tables, batched: leaves [B, C] / [B, C, L] / [B]."""

    key_hi: torch.Tensor  # i32[B, C]
    key_lo: torch.Tensor  # i32[B, C]
    val: torch.Tensor  # i32[B, C, L]
    slot: torch.Tensor  # i32[B, C]: EMPTY / LIVE
    dropped: torch.Tensor  # i32[B]: inserts lost to a full table


def kv_init(capacity_pow2: int, n_batch: int, device, val_lanes: int = VAL_LANES) -> KVState:
    c = 1 << capacity_pow2
    assert c >= WAYS, "table must hold at least one bucket"

    def z():
        return torch.zeros((n_batch, c), dtype=I32, device=device)

    return KVState(z(), z(), torch.zeros((n_batch, c, val_lanes), dtype=I32,
                                         device=device),
                   z(), torch.zeros(n_batch, dtype=I32, device=device))


def _buckets(capacity: int, k_hi: torch.Tensor, k_lo: torch.Tensor):
    """The two candidate buckets of each key: (b1, b2) int64[...].

    Bucket 1 from the primary hash; bucket 2 from an independent mix,
    forced distinct from bucket 1 when the table has more than one
    bucket (the unsigned modulo is taken on the int64-held uint32)."""
    nb = capacity // WAYS
    b1 = pair_hash(k_hi, k_lo) & (nb - 1)
    if nb > 1:
        h2 = pair_hash(k_lo ^ 0x2545F491, k_hi ^ 0x61C88647)
        b2 = (b1 + 1 + h2 % (nb - 1)) % nb
    else:
        b2 = b1
    return b1, b2


def _grouped_keys(capacity: int, n: int, generator: torch.Generator,
                  sizes=(2, 4, 6)) -> torch.Tensor:
    """``n`` distinct int32 keys (key_hi 0) in groups of ``sizes`` in
    turn, each group sharing its first candidate bucket of a
    ``capacity``-way table, a bucket per group: the contention that
    K4 insert's claim rounds and pass B resolve (its card tests and
    ``chip_smoke.py``'s compare draw their keys here)."""
    dev = generator.device
    cand = torch.unique(torch.randint(0, 1 << 30, (1 << 22,), device=dev, dtype=I32,
                                      generator=generator))
    b1, _ = _buckets(capacity, torch.zeros_like(cand), cand)
    b1, order = torch.sort(b1, stable=True)
    cand = cand[order]
    _, counts = torch.unique_consecutive(b1, return_counts=True)
    keys, have, start = [], 0, 0
    for cnt in counts.tolist():
        want = min(sizes[len(keys) % len(sizes)], n - have)
        if want <= 0:
            break
        if cnt >= want:
            keys.append(cand[start:start + want])
            have += want
        start += cnt
    if have != n:
        raise ValueError(f"_grouped_keys: {have} of {n} keys (too few per bucket)")
    return torch.cat(keys)


def _cand_pos(capacity: int, k_hi: torch.Tensor, k_lo: torch.Tensor) -> torch.Tensor:
    """The 2*WAYS candidate positions of each key: int64[..., 2W],
    bucket 1's ways then bucket 2's."""
    b1, b2 = _buckets(capacity, k_hi, k_lo)
    w = torch.arange(WAYS, device=k_hi.device)
    return torch.cat([b1[..., None] * WAYS + w, b2[..., None] * WAYS + w], -1)


def _probe(kv: KVState, pos: torch.Tensor):
    """Table entries at candidate positions [B, E, P]: (slot, key_hi,
    key_lo) each [B, E, P]."""
    b, e, p = pos.shape
    flat = pos.reshape(b, e * p)

    def g(a):
        return torch.gather(a, 1, flat).view(b, e, p)

    return g(kv.slot), g(kv.key_hi), g(kv.key_lo)


def _kv_lookup_plain(kv, k_hi, k_lo, valid):
    c, lanes = kv.val.shape[1:]
    b, e = k_hi.shape
    pos = _cand_pos(c, k_hi, k_lo)
    s, th, tl = _probe(kv, pos)
    hit = ((s == LIVE) & (th == k_hi[..., None]) & (tl == k_lo[..., None])
           & valid[..., None])
    found = hit.any(-1)
    p = torch.gather(pos, 2, first_true(hit)[..., None])[..., 0]  # [B, E]
    v = torch.gather(kv.val, 1, p[..., None].expand(b, e, lanes))
    return found, torch.where(found[..., None], v, 0)


@K.kernel("kv_lookup")
def _kv_lookup_kernel(kv, k_hi, k_lo, valid):
    t_hi = K.cuda_arg(kv.key_hi, I32, "kv key_hi")
    t_lo = K.cuda_arg(kv.key_lo, I32, "kv key_lo")
    t_v = K.cuda_arg(kv.val, I32, "kv val")
    t_s = K.cuda_arg(kv.slot, I32, "kv slot")
    q_hi = K.cuda_arg(k_hi, I32, "kv_lookup k_hi")
    q_lo = K.cuda_arg(k_lo, I32, "kv_lookup k_lo")
    vd = K.cuda_arg(valid, torch.bool, "kv_lookup valid")
    b, e = q_hi.shape
    c, lanes = t_v.shape[1:]
    out = torch.empty((b, e, lanes), dtype=I32, device=q_hi.device)
    found = torch.empty((b, e), dtype=torch.bool, device=q_hi.device)
    f_ = K.fn("kvstore", "mp_kv_lookup",
              [K.P] * 9 + [K.L, K.I, K.I, K.I, K.P])
    rc = f_(K.ptr(t_hi), K.ptr(t_lo), K.ptr(t_v), K.ptr(t_s), K.ptr(q_hi),
            K.ptr(q_lo), K.ptr(vd), K.ptr(out), K.ptr(found), b, e, c, lanes,
            K.stream(q_hi))
    K.check("kvstore", rc, "kv_lookup")
    _kv_lookup_kernel.launches += 1
    return found, out


def kv_lookup_lanes(kv: KVState, k_hi: torch.Tensor, k_lo: torch.Tensor,
                    valid: torch.Tensor | None = None):
    """Batched lookup of [B, E] keys: (found bool[B, E], v i32[B, E, L])."""
    if valid is None:
        valid = torch.ones(k_hi.shape, dtype=torch.bool, device=k_hi.device)
    if K.on_cpu(kv.key_hi, k_hi, k_lo, valid):
        return _kv_lookup_plain(kv, k_hi, k_lo, valid)
    return _kv_lookup_kernel(kv, k_hi, k_lo, valid)


LOOKUP_FAMILIES = ("quarter_full", "half_full", "all_hit", "all_miss", "each_way",
                   "last_way", "key_hi", "invalid_rows", "sorted")


def lookup_families(rng, b: int, e: int, c: int, lanes: int = VAL_LANES,
                    names=None) -> dict:
    """``kv_lookup_lanes`` input families as numpy, drawn from the numpy
    generator ``rng``: each is (tables, queries), tables = (key_hi,
    key_lo, val, slot) of [b, c] ([b, c, lanes] for val) and queries =
    (key_hi, key_lo, valid) of [b, e]. A quarter (or half) of the ways
    are LIVE under filler keys, all negative (no query key is); a
    query's key is written into one of its 2 x WAYS candidate ways, the
    ways before it in probe order LIVE under other keys that share its
    key_hi.

    ``quarter_full`` / ``half_full``: tables a quarter / half LIVE, half
    the queries present at a random way, a tenth present under an EMPTY
    slot (a deleted key), 90% valid. ``all_hit``: every query present;
    ``all_miss``: none, half the ways LIVE. ``each_way``: query i at way
    i % 8. ``last_way``: every query in bucket 2's last way, the longest
    walk in probe order. ``key_hi``: key_hi not 0, the ways before a
    query's holding its key_lo under another key_hi, and absent queries
    whose key_lo is LIVE under another key_hi. ``invalid_rows``: every
    query present, half of them invalid. ``sorted``: the apply's rows:
    keys drawn with repeats from 2e keys, 19 in 20 of them present, rows
    sorted by key as ``sort_order`` sorts them and valid only where no
    earlier row has the key (every row a write). ``names`` picks some
    families (all by default); the CPU oracle test, the card tests and
    ``chip_smoke.py`` share them."""
    i32 = np.int32
    out = {}
    for name in names or LOOKUP_FAMILIES:
        fill = 0.5 if name in ("half_full", "all_miss", "last_way") else 0.25
        slot = (rng.random((b, c)) < fill).astype(i32)
        t_hi = np.zeros((b, c), i32)
        t_lo = rng.integers(-(1 << 30), 0, (b, c)).astype(i32)
        val = rng.integers(-(1 << 30), 1 << 30, (b, c, lanes)).astype(i32)
        q_hi = np.zeros((b, e), i32)
        q_lo = rng.integers(0, 1 << 30, (b, e)).astype(i32)
        valid = np.ones((b, e), bool)
        if name == "key_hi":
            q_hi = rng.integers(1, 1 << 30, (b, e)).astype(i32)
        if name == "sorted":
            q_lo = rng.integers(0, 2 * e, (b, e)).astype(i32)
        b1, b2 = (x.numpy() for x in _buckets(c, torch.from_numpy(q_hi),
                                               torch.from_numpy(q_lo)))
        way = rng.integers(0, 2 * WAYS, (b, e))
        if name == "each_way":
            way = np.broadcast_to(np.arange(e) % (2 * WAYS), (b, e))
        elif name == "last_way":
            way = np.full((b, e), 2 * WAYS - 1)
        present = np.ones((b, e), bool)
        if name in ("quarter_full", "half_full"):
            u = rng.random((b, e))
            present, deleted = u < 0.5, (u >= 0.5) & (u < 0.6)
            valid = rng.random((b, e)) < 0.9
        elif name == "all_miss":
            present = np.zeros((b, e), bool)
        elif name == "key_hi":
            present = rng.random((b, e)) < 0.7
        elif name == "invalid_rows":
            valid = rng.random((b, e)) < 0.5
        elif name == "sorted":  # a key's way and presence follow the key
            way, present = q_lo % (2 * WAYS), q_lo % 20 != 0

        def at(w):
            return np.where(w < WAYS, b1, b2) * WAYS + w % WAYS

        # the ways before each placed key: LIVE under another key with
        # the query's key_hi (its key_lo, another key_hi, for key_hi)
        for w in range(2 * WAYS - 1):
            before = present & (way > w)
            r, q = np.nonzero(before)
            p = at(w)[r, q]
            slot[r, p] = LIVE
            if name == "key_hi":
                t_hi[r, p] = q_hi[r, q] ^ 1
                t_lo[r, p] = q_lo[r, q]
            else:
                t_hi[r, p] = q_hi[r, q]
        if name == "key_hi":  # absent keys whose key_lo is LIVE elsewhere
            r, q = np.nonzero(~present)
            p = at(way)[r, q]
            slot[r, p], t_hi[r, p], t_lo[r, p] = LIVE, q_hi[r, q] + 1, q_lo[r, q]
        r, q = np.nonzero(present)
        p = at(way)[r, q]
        slot[r, p], t_hi[r, p], t_lo[r, p] = LIVE, q_hi[r, q], q_lo[r, q]
        if name in ("quarter_full", "half_full"):
            r, q = np.nonzero(deleted)
            p = at(way)[r, q]
            slot[r, p], t_hi[r, p], t_lo[r, p] = EMPTY, q_hi[r, q], q_lo[r, q]
        if name == "sorted":
            order = sort_order(torch.from_numpy(q_hi), torch.from_numpy(q_lo),
                               torch.ones((b, e), dtype=torch.bool)).numpy()
            q_hi, q_lo = (np.take_along_axis(x, order, 1) for x in (q_hi, q_lo))
            valid[:, 1:] = (q_hi[:, 1:] != q_hi[:, :-1]) | (q_lo[:, 1:] != q_lo[:, :-1])
        out[name] = ((t_hi, t_lo, val, slot), (q_hi, q_lo, valid))
    return out


def _kv_insert_plain(kv: KVState, k_hi, k_lo, v, delete, valid) -> KVState:
    b, c = kv.key_hi.shape
    e = k_hi.shape[1]
    nb = c // WAYS
    dev = k_hi.device
    rows = torch.arange(e, dtype=I32, device=dev).expand(b, e)
    way_ix = torch.arange(WAYS, dtype=I32, device=dev)

    pos = _cand_pos(c, k_hi, k_lo)  # [B, E, 2W]
    s, th, tl = _probe(kv, pos)
    live_match = (s == LIVE) & (th == k_hi[..., None]) & (tl == k_lo[..., None])
    has_match = live_match.any(-1)
    match_pos = torch.gather(pos, 2, first_true(live_match)[..., None])[..., 0]

    free = s == EMPTY
    free1, free2 = free[..., :WAYS], free[..., WAYS:]
    bkt1, bkt2 = pos[..., 0] // WAYS, pos[..., WAYS] // WAYS
    pref2 = free2.sum(-1) > free1.sum(-1)
    place = valid & ~has_match & ~delete

    def assign(mask, bkt, fm):
        rank = cumsum32(fm.to(I32), -1) - 1  # [B, E, W]
        onehot = fm[..., None, :] & (rank[..., None, :] == way_ix[:, None])
        has_rank = onehot.any(-1)  # [B, E, W(rank)]
        way_of_rank = first_true(onehot)  # [B, E, W(rank)]
        dest = torch.full((b, e), -1, dtype=torch.int64, device=dev)
        rem = mask
        for r in range(WAYS):
            claims = torch.full((b, nb + 1), _BIG, dtype=I32, device=dev)
            claims.scatter_reduce_(1, torch.where(rem, bkt, nb),
                                   torch.where(rem, rows, _BIG),
                                   reduce="amin", include_self=True)
            won = rem & (torch.gather(claims, 1, bkt.clamp(0, nb - 1)) == rows)
            ok = won & has_rank[..., r]
            dest = torch.where(ok, bkt * WAYS + way_of_rank[..., r], dest)
            rem = rem & ~won
        return dest >= 0, dest

    tb = torch.where(pref2, bkt2, bkt1)
    placed_a, pos_a = assign(place, tb, torch.where(pref2[..., None], free2, free1))
    ob = torch.where(pref2, bkt1, bkt2)
    cl_bits = torch.zeros((b, nb + 1), dtype=torch.int64, device=dev)
    cl_bits.scatter_add_(1, torch.where(placed_a, pos_a // WAYS, nb),
                         torch.where(placed_a, torch.bitwise_left_shift(
                             torch.ones_like(pos_a), pos_a % WAYS), 0))
    taken_b = (torch.gather(cl_bits, 1, ob.clamp(0, nb - 1))[..., None]
               >> way_ix) & 1
    fm_b = torch.where(pref2[..., None], free1, free2) & (taken_b == 0)
    placed_b, pos_b = assign(place & ~placed_a, ob, fm_b)

    claimed = torch.cat([torch.where(placed_a, pos_a, c),
                         torch.where(placed_b, pos_b, c)], 1)
    matched = torch.where(valid & has_match, match_pos, c)
    fail = place & ~placed_a & ~placed_b
    pos_c, src, dst = _displace(kv, pos, fail, claimed, matched)

    dest = torch.where(valid & has_match, match_pos,
                       torch.where(placed_a, pos_a,
                                   torch.where(placed_b, pos_b, pos_c)))
    wpos = torch.cat([dst, torch.where(dest >= 0, dest, c)], 1)
    new_slot = torch.where(delete, EMPTY, LIVE).to(I32)

    def put(table, x):
        # displaced residents move src -> dst first (read from the table
        # as it was), then the rows land; the positions are disjoint
        buf = torch.cat([table, table[:, :1]], 1)
        if table.dim() == 3:
            lanes = table.shape[2]
            moved = torch.gather(buf, 1, src[..., None].expand(-1, -1, lanes))
            idx = wpos[..., None].expand(-1, -1, lanes)
        else:
            moved = torch.gather(buf, 1, src)
            idx = wpos
        return buf.scatter(1, idx, torch.cat([moved, x], 1))[:, :c].contiguous()

    lost = (fail & (pos_c < 0)).sum(-1, dtype=I32)
    return KVState(put(kv.key_hi, k_hi), put(kv.key_lo, k_lo), put(kv.val, v),
                   put(kv.slot, new_slot), kv.dropped + lost)


def _displace(kv: KVState, pos, fail, claimed, matched):
    """Pass C: place rows that fit in neither candidate bucket by moving
    one resident of those buckets to its own other bucket.

    The first DISPLACE_ROUNDS failing rows of each table, in row order,
    each look at their 2W candidate ways in order for a movable resident
    (LIVE before the batch and not written by it) whose other bucket
    still has a way free after passes A and B and the moves before it;
    the row takes the resident's way and the resident moves to the
    first such free way. Returns (the rows' positions, -1 where none,
    and the [B, DISPLACE_ROUNDS] move sources and destinations, the sink
    column C where a round moved nothing)."""
    b, c = kv.slot.shape
    e = fail.shape[1]
    dev = fail.device
    bi = torch.arange(b, device=dev)
    occ = torch.cat([kv.slot != EMPTY, torch.ones_like(fail[:, :1])], 1)
    occ.scatter_(1, claimed, True)
    movable = torch.cat([kv.slot == LIVE, torch.zeros_like(fail[:, :1])], 1)
    movable.scatter_(1, matched, False)
    way_ix = torch.arange(WAYS, device=dev)
    dest = torch.full((b, e), -1, dtype=torch.int64, device=dev)
    src = torch.full((b, DISPLACE_ROUNDS), c, dtype=torch.int64, device=dev)
    dst = src.clone()
    rem = fail.clone()
    for r in range(DISPLACE_ROUNDS):
        has = rem.any(1)
        q = first_true(rem)
        qpos = pos[bi, q]  # [B, 2W]
        v1, v2 = _buckets(c, kv.key_hi.gather(1, qpos), kv.key_lo.gather(1, qpos))
        alt = torch.where(qpos // WAYS == v1, v2, v1)
        tpos = alt[..., None] * WAYS + way_ix  # [B, 2W, W]
        free = ~occ.gather(1, tpos.flatten(1)).view(tpos.shape)
        ok = movable.gather(1, qpos) & free.any(-1) & has[:, None]
        k = first_true(ok)
        go = ok.any(1)
        p = torch.where(go, qpos[bi, k], c)[:, None]
        t = torch.where(go, tpos[bi, k, first_true(free[bi, k])], c)[:, None]
        q = q[:, None]
        dest.scatter_(1, q, torch.where(go[:, None], p, dest.gather(1, q)))
        occ.scatter_(1, t, True)
        movable.scatter_(1, p, False)
        src[:, r:r + 1] = p
        dst[:, r:r + 1] = t
        rem.scatter_(1, q, False)
    return dest, src, dst


# per (device, E, C): the insert's global-memory claim scratch, for
# tables whose claim arrays exceed a block's shared memory (C > 2^17),
# [rows, ints a row] for the most rows a launch has asked for; a launch
# of B rows takes the first B (so callers whose B varies, like the model
# checker's batches, keep one entry). Callers of one process share an
# entry: the replica servers of one process, each on its own thread.
# That is safe because an insert is one launch and they all launch on
# the device's default stream, so their inserts run one after another.
_SCRATCH: dict[tuple, torch.Tensor | None] = {}


def _insert_scratch(b: int, e: int, c: int, device) -> torch.Tensor | None:
    key = (str(device), e, c)
    t = _SCRATCH.get(key, False)
    if t is False or (t is not None and t.shape[0] < b):
        f_ = K.fn("kvstore", "mp_kv_insert_scratch_ints", [K.I, K.I])
        f_.restype = ctypes.c_longlong
        n = int(f_(e, c))
        t = _SCRATCH[key] = (torch.empty((b, n), dtype=I32, device=device)
                             if n else None)
    return None if t is None else t[:b]


@K.kernel("kv_insert")
def _kv_insert_kernel(kv: KVState, k_hi, k_lo, v, delete, valid) -> KVState:
    t_hi = K.cuda_arg(kv.key_hi, I32, "kv key_hi")
    t_lo = K.cuda_arg(kv.key_lo, I32, "kv key_lo")
    t_v = K.cuda_arg(kv.val, I32, "kv val")
    t_s = K.cuda_arg(kv.slot, I32, "kv slot")
    t_d = K.cuda_arg(kv.dropped, I32, "kv dropped")
    if not all(a.data_ptr() == t.data_ptr() for a, t in
               ((kv.key_hi, t_hi), (kv.key_lo, t_lo), (kv.val, t_v),
                (kv.slot, t_s), (kv.dropped, t_d))):
        raise ValueError("kv_insert: the table must be contiguous (updated in place)")
    q_hi = K.cuda_arg(k_hi, I32, "kv_insert k_hi")
    q_lo = K.cuda_arg(k_lo, I32, "kv_insert k_lo")
    q_v = K.cuda_arg(v, I32, "kv_insert v")
    q_del = K.cuda_arg(delete, torch.bool, "kv_insert delete")
    q_ok = K.cuda_arg(valid, torch.bool, "kv_insert valid")
    b, e = q_hi.shape
    c, lanes = t_v.shape[1:]
    f_ = K.fn("kvstore", "mp_kv_insert",
              [K.P] * 10 + [K.L, K.I, K.I, K.I, K.P, K.P])
    scratch = _insert_scratch(b, e, c, t_hi.device)
    rc = f_(K.ptr(t_hi), K.ptr(t_lo), K.ptr(t_v), K.ptr(t_s), K.ptr(t_d),
            K.ptr(q_hi), K.ptr(q_lo), K.ptr(q_v), K.ptr(q_del), K.ptr(q_ok),
            b, e, c, lanes, None if scratch is None else K.ptr(scratch),
            K.stream(q_hi))
    K.check("kvstore", rc, "kv_insert")
    _kv_insert_kernel.launches += 1
    return kv


def kv_insert_unique(kv: KVState, k_hi, k_lo, v, delete, valid) -> KVState:
    """Insert/overwrite/delete [B, E] rows with DISTINCT keys per batch
    row (``v`` is i32[B, E, L]). A key LIVE in a candidate way is
    overwritten in place (DELETE frees it); new keys take the emptier
    candidate bucket, contention resolved by WAYS claim rounds (lowest
    row wins), overflow retrying the other bucket; rows that fit in
    neither displace a resident to its other bucket (``_displace``), and
    rows that cannot count in ``dropped``."""
    if K.on_cpu(kv.key_hi, k_hi, k_lo, v, delete, valid):
        return _kv_insert_plain(kv, k_hi, k_lo, v, delete, valid)
    return _kv_insert_kernel(kv, k_hi, k_lo, v, delete, valid)


def sort_order(k_hi: torch.Tensor, k_lo: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-row permutation sorting by (key_hi, key_lo, row), invalid rows
    last — ``jnp.lexsort((rows, sk_lo, sk_hi))``. One stable sort on a
    composite int64 key; both halves order as SIGNED int32, like
    jnp.lexsort."""
    sk_hi = torch.where(valid, k_hi, _BIG).to(torch.int64)
    sk_lo = torch.where(valid, k_lo, _BIG).to(torch.int64)
    comp = (sk_hi << 32) + (sk_lo + 2 ** 31)
    return torch.sort(comp, dim=1, stable=True).indices


def kv_apply_batch_lanes(kv: KVState, op, k_hi, k_lo, v, valid):
    """Apply [B, E] commands in slot order; returns (kv', out i32[B, E, L],
    found bool[B, E]) in the original row order: PUT echoes its value,
    GET returns the value visible at its slot (found False and zeros
    when absent), DELETE returns zeros."""
    b, e = op.shape
    is_put = valid & (op == int(Op.PUT))
    is_del = valid & (op == int(Op.DELETE))
    is_get = valid & (op == int(Op.GET))
    is_write = is_put | is_del

    order = sort_order(k_hi, k_lo, valid)

    def g(x):
        return torch.gather(x, 1, order)

    s_khi, s_klo, s_valid = g(k_hi), g(k_lo), g(valid)
    s_put, s_del, s_write, s_get = g(is_put), g(is_del), g(is_write), g(is_get)
    lanes = v.shape[2]
    s_v = torch.gather(v, 1, order[..., None].expand(b, e, lanes))

    prev_w, is_final_writer = kv_segments(s_khi, s_klo, s_valid, s_write)
    has_prev = prev_w >= 0
    pw = torch.where(has_prev, prev_w, 0).long()
    prev_present = has_prev & torch.gather(s_put, 1, pw)
    prev_v = torch.gather(s_v, 1, pw[..., None].expand(b, e, lanes))

    t_found, t_v = kv_lookup_lanes(kv, s_khi, s_klo, s_valid & ~has_prev)

    eff_present = torch.where(has_prev, prev_present, t_found)
    eff_v = torch.where(has_prev[..., None],
                        torch.where(prev_present[..., None], prev_v, 0), t_v)
    out_s = torch.where(s_put[..., None], s_v,
                        torch.where(s_get[..., None], eff_v, 0))
    found_s = torch.where(s_get, eff_present, s_put)

    out = torch.empty_like(v).scatter_(1, order[..., None].expand(b, e, lanes), out_s)
    found = torch.empty_like(valid).scatter_(1, order, found_s)

    kv = kv_insert_unique(kv, s_khi, s_klo, s_v, delete=s_del,
                          valid=is_final_writer)
    return kv, out, found


def kv_apply_batch(kv: KVState, op, k_hi, k_lo, v_hi, v_lo, valid):
    """2-lane (single-i64-value) apply: (kv', out_hi, out_lo, found)."""
    v = torch.stack([v_hi, v_lo], dim=2)
    kv, out, found = kv_apply_batch_lanes(kv, op, k_hi, k_lo, v, valid)
    return kv, out[..., 0], out[..., 1], found
