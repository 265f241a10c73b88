"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These need an NVIDIA card with nvcc (the kernels build at first use) and
skip without one. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(from the repo root; ``--noconftest`` because tests/conftest.py sets up
JAX, which a machine for the port need not have)

Inputs are seeded; results are integers and must be equal.
"""

from __future__ import annotations

import pytest
import torch

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


def test_route_kernel(dev):
    from minpaxos_tpu_torch.ops import segscatter

    g = _gen(dev, 3)
    G, R, m, cap = 4, 5, 50, 64
    cols = torch.randint(-5, 99, (12, G, R * m), device=dev, dtype=torch.int32, generator=g)
    cols[0] = torch.where(torch.rand((G, R * m), device=dev, generator=g) < 0.6, cols[0].abs() + 1, 0)
    u = torch.rand((G, R * m), device=dev, generator=g)
    dst = torch.where(u < 0.5, -1, torch.where(
        u < 0.8, torch.randint(0, R, (G, R * m), device=dev, generator=g), -2)).to(torch.int32)
    alive = torch.rand((G, R), device=dev, generator=g) < 0.8
    out, hit = segscatter.route(cols, dst, alive, m, cap)
    win, phit = segscatter.route_plan(cols[0], dst, alive, m, cap)
    assert torch.equal(out, segscatter.gather_rows(cols, win, phit))
    assert torch.equal(hit, phit)


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


@pytest.mark.parametrize("s,e", [(64, 12), (100, 50), (4096, 320), (16384, 512)])
def test_exec_select_kernel(dev, s, e):
    from minpaxos_tpu_torch.ops import mencius_exec

    g = _gen(dev, s)
    B = 40
    key_hi = torch.randint(-1, 1, (B, s), device=dev, dtype=torch.int32, generator=g)
    key_lo = torch.randint(-3, 4 + s // 16, (B, s), device=dev, dtype=torch.int32, generator=g)
    p = torch.tensor([0.05, 0.15, 0.25, 0.25, 0.2, 0.1], device=dev)
    code = torch.multinomial(p, B * s, replacement=True, generator=g).view(B, s)
    status = torch.tensor([0, 3, 4, 4, 4, 5], device=dev, dtype=torch.uint8)[code]
    op = torch.randint(0, 4, (B, s), device=dev, dtype=torch.uint8, generator=g)
    executed = (status == 5) | (torch.rand((B, s), device=dev, generator=g) < 0.05)
    wb = torch.randint(-5, 100, (B,), device=dev, dtype=torch.int32, generator=g)
    eu = wb + torch.randint(-2, 10, (B,), device=dev, dtype=torch.int32, generator=g)
    cu = eu + torch.randint(-2, s // 2, (B,), device=dev, dtype=torch.int32, generator=g)
    args = (key_hi, key_lo, status, op, executed, wb, cu, eu, e)
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


def test_golden_digests_on_the_card(dev):
    from minpaxos_tpu_torch.golden import PROTOCOLS, drive, first_divergence, load_fixture

    gold = load_fixture()
    for proto in PROTOCOLS:
        assert first_divergence(drive(proto, device=dev), gold[proto]) is None
