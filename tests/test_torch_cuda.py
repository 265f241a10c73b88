"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These need an NVIDIA card with nvcc (the kernels build at first use) and
skip without one. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(from the repo root; ``--noconftest`` because tests/conftest.py sets up
JAX, which a machine for the port need not have)

Inputs are seeded; results are integers and must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minpaxos_tpu_torch.ops.ackruns import ACK_FAMILIES, PVOTE_FAMILIES
from minpaxos_tpu_torch.ops.kvstore import LOOKUP_FAMILIES
from minpaxos_tpu_torch.ops.scan import FRONTIER_FAMILIES, SEGMENT_FAMILIES

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def test_scatter_max_kernel(dev):
    from minpaxos_tpu_torch.ops import winner

    g = _gen(dev)
    tgt = torch.randint(-2, 70, (40, 300), device=dev, dtype=torch.int32, generator=g)
    val = torch.randint(-50, 50, (40, 300), device=dev, dtype=torch.int32, generator=g)
    ok = torch.rand((40, 300), device=dev, generator=g) < 0.5
    assert torch.equal(winner.scatter_max(64, tgt, val, ok, -1),
                       winner._scatter_max_plain(64, tgt, val, ok, -1))


# K2 forms: (batch, rows, size, fill, target range, ok share, value
# range); targets past [0, size] and negative ones go to the sink
_SM_CASES = {
    "window_fill-1": (64, 2176, 4096, -1, (-8, 4105), 0.5, (-3, 4352)),
    "window_int32_min": (32, 2112, 4096, -2 ** 31, (-8, 4105), 0.5, (-2 ** 31, 2 ** 31 - 1)),
    "window_2049": (16, 1024, 2048, -1, (-4, 2060), 0.5, (-3, 64)),
    "window_4097_B1": (1, 2176, 4096, -1, (-4, 4100), 0.5, (-3, 64)),
    "window_16385": (8, 2048, 16384, -1, (-4, 16390), 0.5, (-3, 64)),
    "above_one_tile": (4, 2048, 39999, -1, (-4, 40005), 0.5, (-3, 64)),
    "narrow_R5_fill-2^30": (1280, 2176, 5, -2 ** 30, (0, 6), 1.0, (-2 ** 30, 1 << 20)),
    "narrow_R3_B1": (1, 1024, 3, -2 ** 30, (-2, 6), 0.8, (-2 ** 30, 1 << 20)),
    "window_21": (40, 300, 20, -1, (-2, 25), 0.7, (-5, 5)),
    "all_masked": (16, 512, 4096, -1, (0, 4097), 0.0, (-3, 64)),
    "all_out_of_range": (16, 512, 4096, -1, (4097, 9000), 1.0, (-3, 64)),
    "duplicates_equal": (16, 512, 4096, -1, (0, 4), 1.0, (7, 8)),
    "rows_not_multiple_of_4": (16, 1001, 4096, -1, (-4, 4100), 0.5, (-3, 64)),
    "no_rows": (4, 0, 4096, -5, (0, 1), 1.0, (0, 1)),
}


@pytest.mark.parametrize("case", list(_SM_CASES))
def test_scatter_max_forms(dev, case):
    """K2 against its twin in every form the steps use (fills -1 =
    NO_BALLOT, INT32_MIN, -2^30; windows of 2,049 to 16,385 columns,
    one wider than a tile, the narrow peer-frontier rows), at B = 1,
    with every row masked or out of range, duplicate targets with equal
    values, rows that do not fill 16-byte loads, and inputs that start
    off a 16-byte boundary."""
    from minpaxos_tpu_torch.ops import winner

    b, m, size, fill, (t_lo, t_hi), p_ok, (v_lo, v_hi) = _SM_CASES[case]
    g = _gen(dev, len(case))
    tgt = torch.randint(t_lo, t_hi, (b, m), device=dev, dtype=torch.int32, generator=g)
    val = torch.randint(v_lo, v_hi, (b, m), device=dev, dtype=torch.int32, generator=g)
    ok = torch.rand((b, m), device=dev, generator=g) < p_ok
    want = winner._scatter_max_plain(size, tgt, val, ok, fill)
    assert torch.equal(winner.scatter_max(size, tgt, val, ok, fill), want)
    # the same rows one element into their storage (scalar loads)
    shifted = [torch.cat([x.new_zeros(1), x.flatten()])[1:].view(b, m) for x in (tgt, val, ok)]
    assert torch.equal(winner.scatter_max(size, *shifted, fill), want)


@pytest.mark.parametrize("n", [1, 100, 512, 1500])
def test_scan_kernels(dev, n):
    from minpaxos_tpu_torch.ops import scan

    g = _gen(dev, n)
    vals = torch.randint(-9, 9, (16, n), device=dev, dtype=torch.int32, generator=g)
    seg = torch.rand((16, n), device=dev, generator=g) < 0.2
    assert torch.equal(scan.segmented_scan_max(vals, seg),
                       scan._segmented_scan_max_plain(vals, seg))
    assert torch.equal(scan.exclusive_segmented_scan_max(vals, seg, -1),
                       scan._exclusive_plain(vals, seg, -1))
    committed = torch.rand((16, n), device=dev, generator=g) < 0.9
    start = torch.randint(-2, n + 2, (16,), device=dev, dtype=torch.int32, generator=g)
    assert torch.equal(scan.commit_frontier(committed, start),
                       scan._commit_frontier_plain(committed, start))


# K1 cases: (groups, replicas, outbox rows per replica, inbox capacity,
# live-row share, broadcast / unicast shares of dst, alive share); dst
# draws of unicast are in [-3, R + 1], so client rows (-2), rows to
# self and out-of-range destinations occur
_RT_CASES = {
    "random": (4, 5, 50, 64, 0.6, (0.5, 0.3), 0.8),
    "every_row_dead": (4, 5, 50, 64, 0.0, (0.5, 0.3), 1.0),
    "broadcasts_overflow_cap": (8, 5, 200, 64, 1.0, (1.0, 0.0), 1.0),
    "zero_tail": (8, 5, 400, 1664, 0.05, (0.5, 0.3), 1.0),
    "dead_destination": (16, 5, 300, 256, 0.6, (0.5, 0.3), -1.0),
    "R3_not_a_tile_multiple": (6, 3, 1111, 700, 0.5, (0.4, 0.4), 0.9),
    "R5_mainpath_rows": (4, 5, 3265, 1664, 0.6, (0.5, 0.3), 0.95),
    "R7_two_chunks": (4, 7, 3001, 2048, 0.4, (0.3, 0.5), 0.9),
    "cap_not_a_multiple_of_4": (4, 5, 50, 65, 0.6, (0.5, 0.3), 0.8),
    "N_a_multiple_of_the_chunk": (3, 4, 4096, 600, 0.7, (0.5, 0.3), 1.0),
    "R17_past_the_block_map": (3, 17, 300, 900, 0.5, (0.4, 0.4), 0.9),
    "cap_past_the_block_map": (2, 5, 4000, 16384, 0.9, (0.6, 0.3), 1.0),
}


@pytest.mark.parametrize("case", list(_RT_CASES))
def test_route_kernel(dev, case):
    """K1 against route_plan + gather_rows: every row dead, broadcasts
    past the capacity, a mostly empty outbox (the zero tail), one dead
    destination per group (alive share -1), R of 3, 4, 5 and 7, pooled
    row counts that are no multiple of a thread's 32 rows and one that
    is exactly one chunk (16,384 pooled rows), an outbox of more than one
    chunk per group, and a capacity that takes the kernel's one-slot
    stores instead of its 16-byte ones; then the shapes the one-block
    kernel's shared-memory slot map cannot hold, which take its
    per-(group, destination) kernel: 17 replicas, and an R x capacity
    map of 81,920 slots."""
    from minpaxos_tpu_torch.ops import segscatter

    G, R, m, cap, p_live, (p_bc, p_uni), p_alive = _RT_CASES[case]
    g = _gen(dev, len(case))
    n = R * m
    cols = torch.randint(-5, 99, (12, G, n), device=dev, dtype=torch.int32, generator=g)
    live = torch.rand((G, n), device=dev, generator=g) < p_live
    cols[0] = torch.where(live, cols[0].abs() + 1, 0)
    u = torch.rand((G, n), device=dev, generator=g)
    uni = torch.randint(-3, R + 2, (G, n), device=dev, generator=g)
    dst = torch.where(u < p_bc, -1, torch.where(u < p_bc + p_uni, uni, -2)).to(torch.int32)
    if p_alive < 0:
        alive = torch.ones((G, R), dtype=torch.bool, device=dev)
        alive[torch.arange(G, device=dev), torch.arange(G, device=dev) % R] = False
    else:
        alive = torch.rand((G, R), device=dev, generator=g) < p_alive
    out, hit = segscatter.route(cols, dst, alive, m, cap)
    win, phit = segscatter.route_plan(cols[0], dst, alive, m, cap)
    assert torch.equal(out, segscatter.gather_rows(cols, win, phit))
    assert torch.equal(hit, phit)


@pytest.mark.parametrize("p_live", [0.6, 0.05])
def test_route_kernel_repeats_at_the_deployment(dev, p_live):
    """K1 at the MinPaxos deployment's shape (256 groups x 5 replicas,
    3,265 outbox rows each, capacity 1,664), launched 25 times back to
    back: every launch equals the twin, so a race between a block's warps
    shows as a launch that differs. Dense and mostly empty outboxes."""
    from minpaxos_tpu_torch.ops import segscatter

    G, R, m, cap = 256, 5, 3265, 1664
    g = _gen(dev, 7)
    n = R * m
    cols = torch.randint(-5, 1 << 20, (12, G, n), device=dev, dtype=torch.int32, generator=g)
    cols[0] = torch.where(torch.rand((G, n), device=dev, generator=g) < p_live,
                          cols[0].abs() + 1, 0)
    u = torch.rand((G, n), device=dev, generator=g)
    uni = torch.randint(0, R, (G, n), device=dev, generator=g)
    dst = torch.where(u < 0.5, -1, torch.where(u < 0.8, uni, -2)).to(torch.int32)
    alive = torch.rand((G, R), device=dev, generator=g) < 0.95
    win, phit = segscatter.route_plan(cols[0], dst, alive, m, cap)
    want = segscatter.gather_rows(cols, win, phit)
    for _ in range(25):
        out, hit = segscatter.route(cols, dst, alive, m, cap)
        assert torch.equal(out, want) and torch.equal(hit, phit)


def test_exec_select_kernel_repeats_at_the_deployment(dev):
    """K6 at the Mencius deployment's shape (1,280 windows of 4,096
    slots, E = 320), launched 25 times back to back: every launch equals
    the twin."""
    from minpaxos_tpu_torch.ops import mencius_exec

    rng = np.random.default_rng(11)
    arrs = mencius_exec.exec_families(rng, 1280, 4096, 320)["random"]
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs) + (320,)
    want = mencius_exec._exec_select_plain(*args)
    for _ in range(25):
        got = mencius_exec.exec_select(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kv_kernels_and_apply(dev):
    from minpaxos_tpu_torch.ops import kvstore as kvs

    g = _gen(dev, 4)
    B, E = 6, 48
    kv = kvs.kv_init(6, B, dev)
    kv_p = kvs.kv_init(6, B, dev)
    displaced = 0
    for _ in range(5):
        # mostly PUTs over more keys than the 64 ways hold: the tables
        # fill, rows overflow both buckets, displace residents and drop
        u = torch.rand((B, E), device=dev, generator=g)
        op = torch.where(u < 0.7, 1, torch.where(u < 0.9, 2, 3)).to(torch.int32)
        k_lo = torch.randint(0, 120, (B, E), device=dev, dtype=torch.int32, generator=g)
        k_hi = torch.zeros_like(k_lo)
        v = torch.randint(0, 1 << 20, (B, E, 2), device=dev, dtype=torch.int32, generator=g)
        ok = torch.rand((B, E), device=dev, generator=g) < 0.9
        pre = kvs.KVState(*[t.clone() for t in kv])
        kv, out, found = kvs.kv_apply_batch_lanes(kv, op, k_hi, k_lo, v, ok)
        # a way LIVE before and after under another key took a displaced row
        displaced += int(((pre.slot == 1) & (kv.slot == 1)
                          & (pre.key_lo != kv.key_lo)).sum())
        kv_c = kvs.KVState(*[t.cpu() for t in kv_p])
        kv_c, out_c, found_c = kvs.kv_apply_batch_lanes(
            kv_c, op.cpu(), k_hi.cpu(), k_lo.cpu(), v.cpu(), ok.cpu())
        kv_p = kvs.KVState(*[t.to(dev) for t in kv_c])
        for a, b in zip(kv, kv_c):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(out.cpu(), out_c) and torch.equal(found.cpu(), found_c)
    assert displaced > 0  # the displacement pass ran
    assert int(kv.dropped.sum()) > 0  # and rows it could not place dropped


# K4 lookup at each path's shape (batch rows, query rows, table ways),
# and a table of one bucket (both candidates the same)
_KV_LOOKUP_SHAPES = {"minpaxos": (1280, 512, 1 << 15), "mencius": (1280, 320, 1 << 14),
                     "tcp": (1, 128, 1 << 18), "one_bucket": (8, 64, 4)}


def _on_dev(dev, x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


@pytest.mark.parametrize("family", LOOKUP_FAMILIES)
@pytest.mark.parametrize("path", list(_KV_LOOKUP_SHAPES))
def test_kv_lookup_kernel_on_families(dev, path, family):
    """K4 lookup against its twin on every family of ``ops/kvstore.py
    lookup_families`` at the MinPaxos, Mencius and TCP shapes and on a
    one-bucket table, launched 10 times each: a race shows as a launch
    that differs."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    b, e, c = _KV_LOOKUP_SHAPES[path]
    tables, queries = kvs.lookup_families(np.random.default_rng(b + e + c), b, e, c,
                                          names=(family,))[family]
    kv = kvs.KVState(*(_on_dev(dev, x) for x in tables),
                     torch.zeros(b, dtype=torch.int32, device=dev))
    q = [_on_dev(dev, x) for x in queries]
    want = kvs._kv_lookup_plain(kv, *q)
    for _ in range(10):
        got = kvs.kv_lookup_lanes(kv, *q)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kv_lookup_refuses_misaligned_table(dev):
    """K4 lookup reads a bucket in one 16-byte load, so a table that
    does not start on a 16-byte boundary raises instead of launching."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    B, C = 2, 1 << 10
    slot = torch.zeros(B * C + 1, dtype=torch.int32, device=dev)[1:].view(B, C)
    kv = kvs.kv_init(10, B, dev)._replace(slot=slot)
    lo = torch.arange(1, 9, device=dev, dtype=torch.int32)[None].expand(B, -1).contiguous()
    with pytest.raises(RuntimeError, match="shape not supported"):
        kvs.kv_lookup_lanes(kv, torch.zeros_like(lo), lo, torch.ones_like(lo, dtype=torch.bool))


# kv_segments at each path's shape (batch rows, exec rows), one row, a
# row off every vector width, and rows of several chunks
_SEG_SHAPES = {"minpaxos": (1280, 512), "mencius": (1280, 320), "tcp": (1, 128),
               "E1": (5, 1), "E33": (7, 33), "E1100_three_chunks": (6, 1100)}


@pytest.mark.parametrize("family", SEGMENT_FAMILIES)
@pytest.mark.parametrize("shape", list(_SEG_SHAPES))
def test_kv_segments_kernel_on_families(dev, shape, family):
    """The fused segment kernel against its twin on every family of
    ``ops/scan.py segment_families``, launched 10 times each, and on the
    same rows one element into their storage (scalar loads)."""
    from minpaxos_tpu_torch.ops import scan

    b, e = _SEG_SHAPES[shape]
    arrs = [_on_dev(dev, x) for x in scan.segment_families(
        np.random.default_rng(b + e), b, e, names=(family,))[family]]
    want = scan._kv_segments_plain(*arrs)
    for _ in range(10):
        got = scan.kv_segments(*arrs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    shifted = [torch.cat([x.new_zeros(1), x.flatten()])[1:].view(b, e) for x in arrs]
    got = scan.kv_segments(*shifted)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("stride", [1, 5])
def test_ackruns_kernels(dev, stride):
    from minpaxos_tpu_torch.ops import ackruns

    g = _gen(dev, 10 + stride)
    B, M, S, R = 12, 300, 256, 5
    is_acc = torch.rand((B, M), device=dev, generator=g) < 0.8
    src = torch.randint(-1, R + 1, (B, M), device=dev, dtype=torch.int32, generator=g)
    src = torch.repeat_interleave(src[:, ::6], 6, dim=1)[:, :M].contiguous()
    step = torch.where(torch.rand((B, M), device=dev, generator=g) < 0.85, stride,
                       torch.randint(1, 2 * R, (B, M), device=dev, generator=g))
    inst = (torch.cumsum(step, 1) - 40).to(torch.int32)
    ok = torch.rand((B, M), device=dev, generator=g) < 0.9
    ballot = torch.randint(0, 2, (B, M), device=dev, dtype=torch.int32, generator=g)
    bal = ballot if stride > 1 else None
    got = ackruns.compress_ack_runs(is_acc, src, inst, ok, ballot=bal, stride=stride)
    want = ackruns._compress_plain(is_acc, src, inst, ok, bal, stride)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    count = torch.randint(0, 40, (B, M), device=dev, dtype=torch.int32, generator=g)
    wb = torch.randint(0, 600, (B,), device=dev, dtype=torch.int32, generator=g)
    got = ackruns.range_vote_bits(ok, src, inst, count, wb, S, R, stride=stride)
    want = ackruns.pack_vote_bits(ackruns.range_vote_coverage(
        ok, src, inst, count, wb, S, R, stride=stride))
    assert torch.equal(got, want) and int((got != 0).sum()) > 0
    idx = torch.randint(-2, S + 3, (B, M), device=dev, dtype=torch.int32, generator=g)
    assert torch.equal(ackruns.scatter_vote_bits(S, idx, src, ok, R),
                       ackruns._scatter_vote_bits_plain(S, idx, src, ok, R))


# K5 at each path's shape: batch rows, inbox rows, window, replicas, stride
# (odd sizes: rows and window off every vector width, the scalar paths)
_K5_SHAPES = {"minpaxos": (1280, 2176, 4096, 5, 1), "mencius": (1280, 2112, 4096, 5, 5),
              "tcp": (1, 1024, 2048, 3, 1), "server_window": (4, 4096, 16384, 5, 1),
              "odd_sizes": (10, 601, 250, 5, 1), "odd_sizes_stride5": (10, 601, 250, 5, 5)}


@pytest.mark.parametrize("family", ACK_FAMILIES)
@pytest.mark.parametrize("path", list(_K5_SHAPES))
def test_ackruns_kernels_on_families(dev, path, family):
    """K5 ack_runs and vote_bits (alone, fused with the OR into a votes
    table, and under a mask too) on every input family of
    ``ops/ackruns.py ack_families`` at each path's shape, launched 10
    times each: every launch equals the twin, and ``into`` is kept."""
    from minpaxos_tpu_torch.ops import ackruns

    b, m, s, r, d = _K5_SHAPES[path]
    fam = ackruns.ack_families(np.random.default_rng(b + m + d), b, m, s, r, d,
                               names=(family,))[family]

    def t(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    runs = [t(x) for x in fam["runs"]]
    votes = [t(x) for x in fam["votes"]]
    into, mask = t(fam["into"]), t(fam["mask"])
    want = ackruns._compress_plain(*runs, d)
    for _ in range(10):
        got = ackruns.compress_ack_runs(*runs[:4], ballot=runs[4], stride=d)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    keep = into.clone()
    for i, k in ((None, None), (into, None), (into, mask)):
        want = ackruns._vote_bits_plain(*votes, s, r, d, i, k)
        for _ in range(10):
            assert torch.equal(ackruns.range_vote_bits(*votes, s, r, stride=d, into=i, mask=k),
                               want)
    assert torch.equal(into, keep)


# the pvotes scatter at each path's shape: batch rows, inbox rows, window,
# replicas (odd sizes: rows and window off every vector width)
_PV_SHAPES = {"minpaxos": (1280, 2176, 4096, 5), "mencius": (1280, 2112, 4096, 5),
              "tcp": (1, 1024, 2048, 3), "golden": (5, 40, 64, 5),
              "odd_sizes": (10, 601, 250, 5)}


@pytest.mark.parametrize("family", PVOTE_FAMILIES)
@pytest.mark.parametrize("path", list(_PV_SHAPES))
def test_scatter_vote_bits_fused_on_families(dev, path, family):
    """K5 scatter_vote_bits fused with the OR into pvotes, and alone, on
    every family of ``ops/ackruns.py pvote_families`` at each path's
    shape, launched 10 times each: every launch equals the twin, and
    ``into`` is kept."""
    from minpaxos_tpu_torch.ops import ackruns

    b, m, s, r = _PV_SHAPES[path]
    arrs = ackruns.pvote_families(np.random.default_rng(b + m + s), b, m, s, r,
                                  names=(family,))[family]
    idx, src, valid, into = (torch.from_numpy(x).to(dev) for x in arrs)
    keep = into.clone()
    for i in (into, None):
        want = ackruns._scatter_vote_bits_plain(s, idx, src, valid, r, i)
        for _ in range(10):
            assert torch.equal(ackruns.scatter_vote_bits(s, idx, src, valid, r, into=i), want)
    assert torch.equal(into, keep)
    # the same rows one element into their storage (scalar loads)
    shifted = [torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
               for x in (idx, src, valid, into)]
    assert torch.equal(ackruns.scatter_vote_bits(s, *shifted[:3], r, into=shifted[3]),
                       ackruns._scatter_vote_bits_plain(s, *shifted[:3], r, shifted[3]))


# the frontier at each path's shape: batch rows, window
_CF_SHAPES = {"minpaxos": (1280, 4096), "mencius": (1280, 4096), "tcp": (1, 2048),
              "golden": (5, 64), "odd_sizes": (10, 250)}


@pytest.mark.parametrize("family", FRONTIER_FAMILIES)
@pytest.mark.parametrize("path", list(_CF_SHAPES))
def test_advance_frontier_on_families(dev, path, family):
    """K3 advance_frontier (the COMMITTED form, and the EXECUTED form
    with ``executed``) and the standalone commit_frontier on every family
    of ``ops/scan.py frontier_families`` at each path's shape, launched
    10 times each: every launch equals the twin, and ``upto`` is kept."""
    from minpaxos_tpu_torch.ops import scan
    from minpaxos_tpu_torch.wire.messages import COMMITTED, EXECUTED

    b, s = _CF_SHAPES[path]
    arrs = scan.frontier_families(np.random.default_rng(b + s), b, s, names=(family,))[family]
    status, upto, wb, executed = (torch.from_numpy(x).to(dev) for x in arrs)
    keep = upto.clone()
    for thr, ex in ((COMMITTED, None), (EXECUTED, executed)):
        want = scan._advance_frontier_plain(status, thr, upto, wb, ex)
        for _ in range(10):
            assert torch.equal(scan.advance_frontier(status, thr, upto, wb, executed=ex), want)
    assert torch.equal(upto, keep)
    committed, start = status >= COMMITTED, upto + 1 - wb
    want = scan._commit_frontier_plain(committed, start)
    for _ in range(10):
        assert torch.equal(scan.commit_frontier(committed, start), want)
    # the same windows one byte into their storage (scalar loads)
    shifted = [torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
               for x in (status, executed)]
    assert torch.equal(scan.advance_frontier(shifted[0], EXECUTED, upto, wb, executed=shifted[1]),
                       scan._advance_frontier_plain(*shifted[:1], EXECUTED, upto, wb, shifted[1]))


_EX_SHAPES = [(64, 12), (100, 50), (4096, 320), (16384, 512)]
_EX_FAMILIES = ["random", "one_key", "distinct_keys", "gap_at_slot_0", "no_gap",
                "frontier_past_window", "budget_binds"]


@pytest.mark.parametrize("family", _EX_FAMILIES)
@pytest.mark.parametrize("s,e", _EX_SHAPES)
def test_exec_select_kernel(dev, s, e, family):
    """K6 against its twin on every input family of
    ``ops/mencius_exec.py exec_families``
    at windows of 64 to 16,384 slots (a window wider than one table
    fill of candidates takes several)."""
    from minpaxos_tpu_torch.ops import mencius_exec

    rng = np.random.default_rng(s + e)
    B = 40 if s < 16384 or family == "random" else 12
    arrs = mencius_exec.exec_families(rng, B, s, e)[family]
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs) + (e,)
    got = mencius_exec.exec_select(*args)
    want = mencius_exec._exec_select_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("stride", [1, 5])
def test_vote_bits_at_the_server_window(dev, stride):
    """K5 vote bits at the server's default window (S = 16384) with five
    replicas: the window is tiled over several blocks per replica."""
    from minpaxos_tpu_torch.ops import ackruns

    g = _gen(dev, 20 + stride)
    B, M, S, R = 4, 4096, 16384, 5
    src = torch.randint(0, R, (B, M), device=dev, dtype=torch.int32, generator=g)
    wb = torch.randint(0, 1 << 20, (B,), device=dev, dtype=torch.int32, generator=g)
    inst = wb[:, None] + torch.randint(-300, S + 300, (B, M), device=dev,
                                       dtype=torch.int32, generator=g)
    count = torch.randint(0, 3000, (B, M), device=dev, dtype=torch.int32, generator=g)
    ok = torch.rand((B, M), device=dev, generator=g) < 0.3
    got = ackruns.range_vote_bits(ok, src, inst, count, wb, S, R, stride=stride)
    want = ackruns.pack_vote_bits(ackruns.range_vote_coverage(
        ok, src, inst, count, wb, S, R, stride=stride))
    assert torch.equal(got, want)
    assert int((got == (1 << R) - 1).sum()) > 0  # some slots covered by all


def _colliding_keys(kvs, c, n_buckets, n, dev, seed):
    """``n`` distinct keys whose first candidate bucket is among the
    first ``n_buckets`` of a 2^k-way table: a contended insert."""
    g = _gen(dev, seed)
    found = []
    while sum(len(f) for f in found) < n:
        lo = torch.randint(0, 1 << 30, (1 << 22,), device=dev, dtype=torch.int32, generator=g)
        b1, _ = kvs._buckets(c, torch.zeros_like(lo), lo)
        found.append(lo[b1 < n_buckets])
    return torch.unique(torch.cat(found))[:n]


def _distinct_bucket_keys(kvs, c, n, dev, seed):
    """``n`` keys whose first candidate buckets are all distinct."""
    g = _gen(dev, seed)
    lo = torch.unique(torch.randint(0, 1 << 30, (4 * n + 64,), device=dev,
                                    dtype=torch.int32, generator=g))
    b1, _ = kvs._buckets(c, torch.zeros_like(lo), lo)
    first = torch.ones_like(b1, dtype=torch.bool)
    b1s, order = torch.sort(b1, stable=True)
    first[1:] = b1s[1:] != b1s[:-1]
    keys = lo[order][first]
    assert len(keys) >= n
    return keys[torch.randperm(len(keys), device=dev, generator=g)[:n]]


@pytest.mark.parametrize("pow2", [15, 18])
@pytest.mark.parametrize("e", [1, 512, 4096])
@pytest.mark.parametrize("pattern", ["no_contention", "groups_2_4_6", "displacement"])
def test_kv_insert_claims(dev, pow2, e, pattern):
    """K4 insert against its twin on shared (C = 2^15) and global (2^18)
    claim scratch at E = 1, 512 and 4,096 rows:
    * no_contention: keys with distinct first buckets into an empty
      table, so no two rows claim one bucket;
    * groups_2_4_6: keys sharing one bucket in groups of 2, 4 and 6,
      rows shuffled per table, into an empty table (a group of 6 has
      two rows of rank >= WAYS, so pass B runs) and again into the
      table that left;
    * displacement: random keys into tables 90% full, where rows fit
      in neither bucket and pass C moves residents."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    C, B = 1 << pow2, 2
    g = _gen(dev, pow2 + e)
    kv = kvs.kv_init(pow2, B, dev)

    def rows(lo):
        hi = torch.zeros_like(lo)
        v = torch.randint(0, 1 << 30, lo.shape + (2,), device=dev, dtype=torch.int32,
                          generator=g)
        dele = torch.rand(lo.shape, device=dev, generator=g) < 0.05
        ok = torch.rand(lo.shape, device=dev, generator=g) < 0.95
        return hi, lo, v, dele, ok

    def shuffled(keys):
        perm = torch.argsort(torch.rand((B, e), device=dev, generator=g), 1)
        return keys[perm].contiguous()

    if pattern == "no_contention":
        batches = [shuffled(_distinct_bucket_keys(kvs, C, e, dev, pow2))]
    elif pattern == "groups_2_4_6":
        keys = kvs._grouped_keys(C, 2 * e, _gen(dev, pow2))
        batches = [shuffled(keys[:e]), shuffled(keys[e:])]
    else:
        n = int(0.9 * C)
        fill = torch.unique(torch.randint(0, 1 << 30, (n + n // 8,), device=dev,
                                          dtype=torch.int32, generator=g))[:n]
        kv = kvs._kv_insert_plain(kv, *rows(fill[None].expand(B, -1).contiguous()))
        batches = [torch.unique(torch.randint(0, 1 << 30, (e,), device=dev,
                                              dtype=torch.int32, generator=g))
                   [None].expand(B, -1).contiguous()]
    moved = 0
    for lo in batches:
        args = rows(lo)
        pre = kvs.KVState(*[t.clone() for t in kv])
        want = kvs._kv_insert_plain(pre, *args)
        kv = kvs.kv_insert_unique(kv, *args)
        for a, b in zip(kv, want):
            assert torch.equal(a, b)
        moved += int(((pre.slot == 1) & (kv.slot == 1) & (pre.key_lo != kv.key_lo)).sum())
    if pattern == "displacement" and e >= 512:
        assert moved > 0


def test_kv_insert_refuses_misaligned_table(dev):
    """K4 insert reads a bucket in one 16-byte load, so a table that
    does not start on a 16-byte boundary raises instead of launching."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    B, C = 2, 1 << 10
    slot = torch.zeros(B * C + 1, dtype=torch.int32, device=dev)[1:].view(B, C)
    kv = kvs.kv_init(10, B, dev)._replace(slot=slot)
    lo = torch.arange(1, 9, device=dev, dtype=torch.int32)[None].expand(B, -1).contiguous()
    with pytest.raises(RuntimeError, match="shape not supported"):
        kvs.kv_insert_unique(kv, torch.zeros_like(lo), lo,
                             torch.zeros(lo.shape + (2,), dtype=torch.int32, device=dev),
                             torch.zeros_like(lo, dtype=torch.bool),
                             torch.ones_like(lo, dtype=torch.bool))


@pytest.mark.parametrize("e", [128, 1024])
def test_kv_insert_above_shared_memory(dev, e):
    """K4 insert at C = 2^18 (the serving deployment's -kvpow2 18), where
    the claim arrays live in global memory, against the plain twin:
    random keys into an empty table; keys crowded into 64 buckets, so
    the claim rounds contend and rows overflow to their other bucket;
    then random keys into a table 90% full, where rows displace
    residents and drop."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    C = 1 << 18
    B = 2
    assert kvs._insert_scratch(B, e, C, dev) is not None  # the global path
    g = _gen(dev, e)
    kv = kvs.kv_init(18, B, dev)
    crowd = _colliding_keys(kvs, C, 64, 2 * e, dev, 7)

    def rand_keys(n):
        return torch.randint(0, 1 << 30, (n,), device=dev, dtype=torch.int32, generator=g)

    moved = 0
    for it in range(5):
        if it == 3:  # fill to 90% through the plain twin
            n = int(0.9 * C) - int((kv.slot[0] == 1).sum())
            fill = torch.unique(rand_keys(n + n // 8))[:n][None].expand(B, -1).contiguous()
            kv = kvs._kv_insert_plain(kv, torch.zeros_like(fill), fill, torch.ones(
                fill.shape + (2,), dtype=torch.int32, device=dev), torch.zeros_like(
                fill, dtype=torch.bool), torch.ones_like(fill, dtype=torch.bool))
        lo = crowd[(it - 1) * e:it * e] if it in (1, 2) else rand_keys(e)
        lo = torch.unique(lo)[None].expand(B, -1).contiguous()
        hi = torch.zeros_like(lo)
        v = torch.randint(0, 1 << 30, lo.shape + (2,), device=dev, dtype=torch.int32,
                          generator=g)
        dele = torch.rand(lo.shape, device=dev, generator=g) < 0.05
        ok = torch.rand(lo.shape, device=dev, generator=g) < 0.95
        pre = kvs.KVState(*[t.clone() for t in kv])
        want = kvs._kv_insert_plain(pre, hi, lo, v, dele, ok)
        kv = kvs.kv_insert_unique(kv, hi, lo, v, dele, ok)
        for a, b in zip(kv, want):
            assert torch.equal(a, b)
        moved += int(((pre.slot == 1) & (kv.slot == 1) & (pre.key_lo != kv.key_lo)).sum())
    assert moved > 0 and int(kv.dropped.sum()) > 0


def _pack_scenario(dev, protocol):
    """States, outboxes and exec results of a three-replica exchange on
    the card (proposals to replica 0, or to every Mencius owner)."""
    from minpaxos_tpu_torch.models import mencius as tme
    from minpaxos_tpu_torch.models import minpaxos as tmp

    R, M = 3, 32
    cfg = tmp.MinPaxosConfig(n_replicas=R, window=128, inbox=M, exec_batch=16,
                             kv_pow2=8, catchup_rows=8, recovery_rows=8,
                             gossip_ticks=1)
    if protocol == "mencius":
        st = tme.init_mencius(cfg, list(range(R)), device=dev)
        step = tme.mencius_step_impl
    else:
        st = tmp.init_replica(cfg, list(range(R)), device=dev)._replace(
            default_ballot=torch.full((R,), 16, dtype=torch.int32, device=dev),
            max_recv_ballot=torch.full((R,), 16, dtype=torch.int32, device=dev),
            leader_id=torch.zeros(R, dtype=torch.int32, device=dev),
            prepared=torch.arange(R, device=dev) == 0,
            prepare_oks=torch.ones((R, R), dtype=torch.bool, device=dev))
        step = tmp.replica_step_impl
    g = _gen(dev, 5)
    out = []
    st, ob, ex = step(cfg, st, tmp.MsgBatch.empty(R, M, dev))
    for it in range(8):
        cols = torch.zeros((12, R, M), dtype=torch.int32, device=dev)
        kind, dst = ob.msgs.kind, ob.dst
        for q in range(R):
            rows = [torch.stack(list(ob.msgs))[:, s, (kind[s] != 0) & ((dst[s] == q) | (dst[s] == -1))]
                    for s in range(R) if s != q]
            if (protocol == "mencius" or q == 0) and it < 5:
                n = 6
                p = torch.zeros((12, n), dtype=torch.int32, device=dev)
                p[0], p[1], p[5] = 1, -1, 1
                p[7] = torch.randint(0, 24, (n,), device=dev, dtype=torch.int32, generator=g)
                p[9] = torch.randint(1, 1 << 20, (n,), device=dev, dtype=torch.int32,
                                     generator=g)
                p[10] = 1000 * (q + 1) + n * it + torch.arange(n, device=dev)
                p[11] = 7
                rows.append(p)
            r = torch.cat(rows, 1)[:, :M]
            cols[:, q, :r.shape[1]] = r
        st, ob, ex = step(cfg, st, tmp.MsgBatch(*cols.unbind(0)))
        out.append((st, ob, ex))
    return out


@pytest.mark.parametrize("protocol", ["minpaxos", "mencius"])
def test_pack_outputs_kernel(dev, protocol):
    """K7 against its plain twin on states of a live exchange, batched
    (B = 3), on a narrowed (strided) view with a reported window base,
    and for one replica row at a time."""
    from minpaxos_tpu_torch.ops import substeps

    executed = 0
    for st, ob, ex in _pack_scenario(dev, protocol):
        got = substeps.pack_outputs(st, ob, ex)
        want = substeps._pack_plain(st, ob, ex, torch.empty_like(got), st.window_base)
        assert torch.equal(got, want)
        executed += int(ex.count.sum())
        view, _ = substeps.narrow_view(st, 8, 64)
        rb = st.window_base + 3
        got = substeps.pack_outputs(view, ob, ex, report_base=rb)
        want = substeps._pack_plain(view, ob, ex, torch.empty_like(got), rb)
        assert torch.equal(got, want)
    assert executed > 0
    assert substeps._pack_kernel.launches > 0


def _row_of(t, r):
    """Replica row r of a state, outbox or exec result, as B = 1 views."""
    return type(t)(*[_row_of(x, r) if isinstance(x, tuple) else x[r:r + 1] for x in t])


def test_pack_outputs_interleaved_layouts(dev):
    """K7 against its plain twin over 10 rounds of launches in which the
    layouts take turns: MinPaxos and Mencius states of a live exchange
    (full window, the narrow view with a report base, one replica row)
    and the B = 1,280 random forms of chip_smoke.py's compare. The
    layout cache is emptied before every other round, so hits and misses
    alternate; a stale layout or pointer would show as a difference."""
    from minpaxos_tpu_torch.ops import substeps

    cases = {}
    for protocol in ("minpaxos", "mencius"):
        st, ob, ex = _pack_scenario(dev, protocol)[-1]
        view, _ = substeps.narrow_view(st, 8, 64)
        cases[f"{protocol}_full"] = (st, ob, ex, st.window_base)
        cases[f"{protocol}_narrow"] = (view, ob, ex, st.window_base + 3)
        row = (_row_of(st, 1), _row_of(ob, 1), _row_of(ex, 1))
        cases[f"{protocol}_B1"] = (*row, row[0].window_base)
    rng = np.random.default_rng(11)
    for name, c in substeps.pack_cases(rng, 1280, 4096, 5, 2176, 1664, 512).items():
        st, ob, ex = substeps.pack_case_tensors(c, dev)
        cases[f"batch_{name}"] = (st, ob, ex, st.window_base)
    want = {}
    for name, (st, ob, ex, rb) in cases.items():
        w = substeps.row_width(ob.msgs.kind.shape[1], ex.val_hi.shape[1],
                               st.peer_commits.shape[1])
        want[name] = substeps._pack_plain(
            st, ob, ex, torch.empty((st.me.shape[0], w), dtype=torch.int32, device=dev), rb)
    before = substeps._pack_kernel.launches
    for rnd in range(10):
        if rnd % 2 == 0:
            substeps._launch.layouts.clear()
        for name, (st, ob, ex, rb) in cases.items():
            got = substeps.pack_outputs(st, ob, ex, report_base=rb)
            assert torch.equal(got, want[name]), (rnd, name)
    assert substeps._pack_kernel.launches - before == 10 * len(cases)


@pytest.mark.parametrize("r,m_in", [(1, 1664), (5, 1663), (32, 1664)])
def test_pack_outputs_anchor_edges(dev, r, m_in):
    """K7 on ops/substeps.py pack_cases at B = 1,280 over 10 launches
    each: both anchor forms on random scalars and the Mencius edge rows
    (rel < 0, 0, S - 1, S and past it; status exactly COMMITTED, one
    below, one above; tk_anchor -1), with R = 1, 5 and 32 replicas for
    the peer-commit reduction. An odd inbox length puts the acked rows
    on and off 4-byte boundaries, and a view one byte into its storage
    puts every row off them."""
    from minpaxos_tpu_torch.ops import substeps

    rng = np.random.default_rng(r)
    for name, c in substeps.pack_cases(rng, 1280, 4096, r, 2176, m_in, 512).items():
        st, ob, ex = substeps.pack_case_tensors(c, dev)
        forms = [ob]
        if name == "mencius_edges":
            wide = torch.zeros((1280, m_in + 1), dtype=torch.bool, device=dev)
            wide[:, 1:] = ob.acked
            forms.append(ob._replace(acked=wide[:, 1:]))
        w = substeps.row_width(2176, 512, r)
        for obf in forms:
            want = substeps._pack_plain(st, obf, ex, torch.empty(
                (1280, w), dtype=torch.int32, device=dev), st.window_base)
            for _ in range(10):
                assert torch.equal(substeps.pack_outputs(st, obf, ex), want), name


def test_golden_digests_on_the_card(dev):
    from minpaxos_tpu_torch.golden import PROTOCOLS, drive, first_divergence, load_fixture

    gold = load_fixture()
    for proto in PROTOCOLS:
        assert first_divergence(drive(proto, device=dev), gold[proto]) is None


@pytest.mark.parametrize("hot_pct", [0, 30])
def test_propose_rows_kernel(dev, hot_pct):
    """K8 against its plain twin and the numpy twin: both leader forms,
    rounds 0, 1 and one where cmd_id wraps in int32."""
    from minpaxos_tpu_torch.ops import workload as wl

    g, r, m = 7, 5, 300
    n0 = wl._propose_rows_kernel.launches
    for leader, count in ((0, 211), (-1, 64)):
        for rnd in (0, 1, 2 ** 31 // m + 5):
            got = wl.propose_batch(r, g, m, count, leader, rnd, 9, 1 << 14,
                                   hot_pct=hot_pct, device=dev)
            want = wl.propose_batch(r, g, m, count, leader, rnd, 9, 1 << 14,
                                    hot_pct=hot_pct, device="cpu")
            host = wl.propose_batch_host(r, g, m, count, leader, rnd, 9, 1 << 14,
                                         hot_pct=hot_pct)
            for a, b, c in zip(got, want, host):
                assert torch.equal(a.cpu(), b)
                assert (a.cpu().numpy() == c).all()
    assert wl._propose_rows_kernel.launches == n0 + 6


@pytest.mark.parametrize("tel_rows", [0, 5])
def test_round_kernels_at_edge_cursors(dev, tel_rows):
    """K9 against its plain twin where a group assigns or commits nothing,
    fewer than, exactly or more than a ring's worth of slots in a round,
    or its cursors go backwards, with the telemetry ring off and wrapping."""
    from types import SimpleNamespace as NS

    from minpaxos_tpu_torch.ops import resident

    gr, r, w, bins, rnd = 14, 3, 64, 9, 70
    g = _gen(dev, 5)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, device=dev, dtype=torch.int32, generator=g)

    steps = torch.tensor([-2, 0, 1, 17, 63, 64, 65, 200, 3, 0, 64, 1, 130, 7],
                         dtype=torch.int32, device=dev)
    u0 = ri(0, 500, (gr * r,))
    pre = NS(committed_upto=u0, crt_inst=u0 + 1 + ri(0, 90, (gr * r,)),
             executed_upto=u0 - ri(0, 9, (gr * r,)))
    post = NS(committed_upto=u0 + steps.flip(0).repeat_interleave(r),
              crt_inst=pre.crt_inst + steps.repeat_interleave(r),
              executed_upto=pre.executed_upto + ri(0, 30, (gr * r,)),
              prepared=torch.rand((gr * r,), device=dev, generator=g) < 0.5)
    kind = torch.where(torch.rand((gr * r, 40), device=dev, generator=g) < 0.4,
                       ri(1, 12, (gr * r, 40)), 0)
    bufs = (resident.new_scratch(gr, dev),
            torch.where(torch.rand((gr, w), device=dev, generator=g) < 0.8,
                        ri(0, rnd, (gr, w)), -1),
            ri(0, 20, (bins,)), torch.full((tel_rows, 9), -1, dtype=torch.int32, device=dev))
    out = []
    for fo, fc in ((resident.round_open, resident.round_close),
                   (resident._round_open_plain, resident._round_close_plain)):
        scr, inj, hist, tel = (t.clone() for t in bufs)
        fo(scr, pre, kind, 1, gr, 11, 1, True, tel_rows > 0, rnd)
        fc(scr, inj, hist, tel, post, 1, rnd, 3, gr * 11)
        out.append((scr, inj, hist, tel))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert (out[0][1] == rnd).any() and not torch.equal(out[0][2], bufs[2])


def _k9_chain_check(dev, family, g, r, w, mp, p, leader, tel_rows, drain, bins,
                    rounds=12):
    """K9 over ``rounds`` chained rounds of a k9_families family, the
    kernels against the plain twins on the same card, every buffer
    compared after every round: a race in the accumulator handover shows
    as a round that differs."""
    from minpaxos_tpu_torch.ops import resident

    fam = resident.k9_on(resident.k9_families(np.random.default_rng(11), g, r, w, mp,
                                              rounds, p, names=(family,))[family],
                         dev, with_prepared=leader >= 0)

    def bufs():
        return (resident.new_scratch(g, dev), fam["inj"].clone(),
                torch.arange(bins, dtype=torch.int32, device=dev),
                torch.full((tel_rows, 9), -1, dtype=torch.int32, device=dev))

    a, b = bufs(), bufs()
    n0 = resident._round_close_kernel.launches
    cur = max(leader, 0)
    for _ in zip(resident.chain_rounds(fam, a, cur, p, leader, 3, drain=drain),
                 resident.chain_rounds(fam, b, cur, p, leader, 3, drain=drain, plain=True)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert resident._round_close_kernel.launches == n0 + rounds
    assert resident.totals_of(a[0]).abs().sum() > 0


@pytest.mark.parametrize("drain", [False, True])
@pytest.mark.parametrize("tel_rows", [0, 5, 160])
@pytest.mark.parametrize("family", ["random", "one_bin", "edges"])
def test_round_close_fused_chains(dev, family, tel_rows, drain):
    """K9 fused (each close opens the next round, the last writes the
    totals) against its twins over 12 chained rounds: random latencies,
    every latency in one bin, and groups that assign or commit nothing,
    fewer than, exactly or more than a ring's worth, or go backwards;
    the telemetry ring off, wrapping and long."""
    _k9_chain_check(dev, family, 14, 3, 64, 40, 12, 1, tel_rows, drain, 9)


@pytest.mark.parametrize("path", ["minpaxos", "mencius"])
@pytest.mark.parametrize("family", ["random", "one_bin", "edges"])
def test_round_close_fused_at_the_deployment(dev, path, family):
    """The fused K9 at the 1M-instance deployments' widths (256 groups x
    5 replicas, W = 4096, the pending inboxes' widths, 512 bins), ring
    armed with a drain sub-step's open, over 12 chained rounds."""
    mp, p, leader = (1664, 512, 0) if path == "minpaxos" else (2048, 320, -1)
    _k9_chain_check(dev, family, 256, 5, 4096, mp, p, leader, 160, True, 512)


def _slot_inputs(dev, seed, b=12, m=300, s=4100):
    g = _gen(dev, seed)
    from minpaxos_tpu_torch.models.minpaxos import MsgBatch
    from minpaxos_tpu_torch.ops import winner

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, device=dev, dtype=torch.int32, generator=g)

    hot = ri(0, s, (b, 4))
    tgt = torch.where(torch.rand((b, m), device=dev, generator=g) < 0.5,
                      torch.gather(hot, 1, ri(0, 4, (b, m)).long()), ri(-3, s + 4, (b, m)))
    inbox = MsgBatch(*[ri(-2, 300, (b, m)) for _ in range(12)])
    old = [ri(-1, 1 << 20, (b, s)) for _ in winner.SLOT_COLS]
    old[1] = ri(0, 6, (b, s)).to(torch.uint8)
    old[2] = ri(0, 4, (b, s)).to(torch.uint8)
    return (tgt, torch.rand((b, m), device=dev, generator=g) < 0.5,
            torch.rand((b, m), device=dev, generator=g) < 0.7, inbox, tuple(old),
            ri(0, 5, (b,)), ri(0, 99, (b,)))


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_write_kernels(dev, seed):
    """K10 against its plain twins: both slot_write modes, every
    gather_rows form, and old columns read through a narrowed
    (strided) view of a wider window."""
    from minpaxos_tpu_torch.ops import winner

    tgt, sec, ok, inbox, old, me, cb = _slot_inputs(dev, seed)
    s = old[0].shape[1]
    for modes, cball in ((winner.WRITE_A, None), (winner.WRITE_B, cb)):
        got = winner.slot_write(modes, s, tgt, sec, ok, inbox, old, me, cball, n_replicas=5)
        want = winner._slot_write_plain(modes, s, tgt, sec, ok, inbox, old, me, cball, 5)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    wide = tuple(torch.cat([o, o[:, :64]], 1) for o in old)
    view = tuple(o.narrow(1, 32, s) for o in wide)
    got = winner.slot_write(winner.WRITE_B, s, tgt, sec, ok, inbox, view, me, cb, n_replicas=5)
    want = winner._slot_write_plain(winner.WRITE_B, s, tgt, sec, ok, inbox, view, me, cb, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    win, hit = winner.slot_winner(s, torch.where(ok, tgt, s), ok)
    for mode in (winner.SlotMode(winner.BAL_ROW, winner.ST_ACCEPTED, winner.V_KEEP),
                 winner.SlotMode(winner.BAL_ROW, winner.ST_COMMIT, winner.V_KEEP),
                 winner.SlotMode(winner.BAL_ROW, winner.ST_ACCEPTED, winner.V_ME),
                 winner.SlotMode(winner.BAL_CONST, winner.ST_ACCEPTED, winner.V_ME)):
        got = winner.gather_rows(mode, win, hit, inbox, old, me, n_replicas=5)
        want = winner._gather_rows_plain(mode, win, hit, inbox, old, me, None, 5)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert winner._slot_write_kernel.launches > 0
    assert winner._gather_rows_kernel.launches > 0


@pytest.mark.parametrize("protocol,substeps", [("minpaxos", 1), ("minpaxos", 2),
                                               ("mencius", 2)])
def test_resident_loop_on_the_card(dev, protocol, substeps):
    """The resident loop with the telemetry ring armed (K8, K9 and K10
    on the path) equals the CPU run's plain twins: per-dispatch scalars,
    telemetry rows, inject ring, histogram and state."""
    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.models.cluster import numpy_leaves
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
    from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

    cfg = MinPaxosConfig(n_replicas=5, window=256, inbox=128, exec_batch=40,
                         kv_pow2=10, catchup_rows=8, recovery_rows=8)
    out = []
    for d in (dev, "cpu"):
        sc = ShardedCluster(cfg, 3, ext_rows=16, key_space=256, seed=7, device=d,
                            protocol=protocol)
        if protocol == "minpaxos":
            sc.elect(0)
        sc.begin_resident(telemetry_rounds=20)
        K.reset_launches()
        res = [sc.run_resident(8, 6 if protocol == "mencius" else 12, substeps)
               for _ in range(3)]
        res += [sc.run_resident(8, 0, substeps) for _ in range(2)]
        launches = K.launch_counts()
        tel = sc.resident_telemetry()
        inj = sc._inject_round.cpu().numpy()
        out.append((res, tel, inj, sc.end_resident(), numpy_leaves(sc.ss), launches))
    (a, b) = out
    assert a[0] == b[0] and a[0][-1][1] == 0
    for x, y in zip(a[1:4], b[1:4]):
        assert (x == y).all()
    assert len(a[4]) == len(b[4]) and all((x == y).all() for x, y in zip(a[4], b[4]))
    for name in ("propose_rows", "round_open", "round_close",
                 "slot_write" if protocol == "minpaxos" else "gather_rows"):
        assert a[5][name] > 0, name


# ---- paxmc on the card: the explorer's batched steps through the kernels ----

_MC_FIXTURE = "tests/fixtures/paxmc_state_digests.json"
# a trace to a state whose next delivery, (1, 0), commits and executes a
# slot (the K4 insert writes the stepped replica's KV table)
_MC_TRACE = {
    "minpaxos": [{"a": "deliver", "link": [0, 1]}, {"a": "deliver", "link": [1, 0]},
                 {"a": "deliver", "link": [-1, 0]}, {"a": "deliver", "link": [0, 1]}],
    "mencius": [{"a": "deliver", "link": [-1, 0]}, {"a": "deliver", "link": [0, 1]}],
}
_MC_TRACE["classic"] = _MC_TRACE["minpaxos"]


@pytest.mark.parametrize("protocol", ["minpaxos", "classic", "mencius"])
def test_mc_tiny_leg_on_the_card_equals_the_reference_digest(dev, protocol):
    """The tiny leg's states, transitions and state digest on the card
    are the JAX explorer's (the fixture)."""
    import json
    import os

    from minpaxos_tpu_torch.verify import mc

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, _MC_FIXTURE)) as f:
        want = json.load(f)["runs"][f"tiny-{protocol}"]
    ex = mc.Explorer(protocol, mc.Bounds(**want["bounds"]), **want["kw"], device=dev)
    res = ex.run()
    assert res.ok and res.drained
    assert (res.states, res.transitions, mc.state_digest(ex.seen)) == \
        (want["states"], want["transitions"], want["digest"])


def _mc_node(ex, protocol):
    node = ex.initial()
    for a in _MC_TRACE[protocol]:
        node = ex._apply(node, a)
    return node


@pytest.mark.parametrize("protocol", ["minpaxos", "classic", "mencius"])
def test_mc_one_state_stepped_twice_gives_equal_results(dev, protocol):
    """K4's insert updates the KV table in place on the card: the batch
    is built from copies, so one parent stepped twice in a batch, and
    again in another call, gives equal states and outboxes (the CPU
    twin's), and the parent's bytes stay as they were."""
    from minpaxos_tpu_torch.verify import mc

    b = mc.Bounds(max_depth=6, drops=1, dups=1, internal=1, elections=0, n_cmds=1,
                  propose_to=(0,))
    ex = mc.Explorer(protocol, b, device=dev)
    cpu = mc.Explorer(protocol, b, device="cpu")
    node = _mc_node(ex, protocol)
    parent = node[0][0]
    before = parent.buf.copy()
    row = node[1][(1, 0)][0]
    kv = ex.stepper.lay.fields["kv"]
    twice, outs = ex.stepper.step([parent, parent], [row, row])
    again, outs2 = ex.stepper.step([parent], [row])
    want, want_out = cpu.stepper.step([parent], [row])
    assert (twice[0].buf[kv.off:kv.off + kv.n] != before[kv.off:kv.off + kv.n]).any(), \
        "the step did not write the KV table: the trace no longer reaches an execution"
    for st in (twice[0], twice[1], again[0]):
        assert st.buf.tobytes() == want[0].buf.tobytes()
    assert outs[0] == outs[1] == outs2[0] == want_out[0]
    assert parent.buf.tobytes() == before.tobytes()


@pytest.mark.parametrize("protocol", ["minpaxos", "mencius"])
def test_mc_chunk_at_the_largest_smoke_batch(dev, protocol):
    """8,192 rows (the largest batch the smoke legs step, the default
    chunk) in one step call equal the CPU twin's, and K4's insert
    scratch cache keeps one entry whatever the batch."""
    from minpaxos_tpu_torch.ops import kvstore
    from minpaxos_tpu_torch.verify import mc

    b = mc.Bounds(max_depth=6, drops=1, dups=1, internal=1, elections=0, n_cmds=1,
                  propose_to=(0,))
    ex = mc.Explorer(protocol, b, device=dev)
    cpu = mc.Explorer(protocol, b, device="cpu")
    node = _mc_node(ex, protocol)
    pairs = [mc._stepping(node, a) for a in ex._actions(node)]
    pairs = [p for p in pairs if p is not None]
    rows = [pairs[i % len(pairs)] for i in range(mc.CHUNK)]
    parents = [node[0][to] for to, _r in rows]
    inbox = [r for _to, r in rows]
    got, got_out = ex.stepper.step(parents, inbox)
    assert ex.stepper.max_batch == mc.CHUNK
    want, want_out = cpu.stepper.step(parents, inbox)
    assert [s.buf.tobytes() for s in got] == [s.buf.tobytes() for s in want]
    assert got_out == want_out
    ex.stepper.step(parents[:1], inbox[:1])
    cfg = ex.cfg
    keys = [k for k in kvstore._SCRATCH
            if k[0].startswith("cuda") and k[1:] == (cfg.exec_batch, 1 << cfg.kv_pow2)]
    assert len(keys) == 1
