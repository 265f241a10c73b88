"""The port's ops against their JAX twins, bit for bit (tolerance 0).

Every input is made with numpy from a seed and goes through both the
JAX function (vmapped over the batch axis where the JAX op works on one
row) and the port's counterpart on the CPU, which takes the plain
PyTorch path of each kernel. Results are integers, so they must be equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.cluster import _route_segmented as jax_route
from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.models.minpaxos import MsgBatch as JaxMsgBatch
from minpaxos_tpu.ops import ackruns as jack
from minpaxos_tpu.ops import kvstore as jkv
from minpaxos_tpu.ops import packed as jpk
from minpaxos_tpu.ops import scan as jscan
from minpaxos_tpu.ops import winner as jwin
from minpaxos_tpu.ops import workload as jwl
from minpaxos_tpu_torch.ops import ackruns as tack
from minpaxos_tpu_torch.ops import kvstore as tkv
from minpaxos_tpu_torch.ops import packed as tpk
from minpaxos_tpu_torch.ops import scan as tscan
from minpaxos_tpu_torch.ops import segscatter as tseg
from minpaxos_tpu_torch.ops import winner as twin
from minpaxos_tpu_torch.ops import workload as twl
from minpaxos_tpu_torch.wire.messages import Op

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def jv(fn):
    """The JAX row function, vmapped over the batch axis and jitted."""
    return jax.jit(jax.vmap(fn))


def eq(jax_val, torch_val, what=""):
    a = np.asarray(jax_val)
    b = torch_val.numpy() if isinstance(torch_val, torch.Tensor) else np.asarray(torch_val)
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_pair_hash_bit_exact():
    rng = np.random.default_rng(0)
    hi = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    hi[:4], lo[:4] = [0, -1, 2**31 - 1, -2**31], [0, -1, -2**31, 2**31 - 1]
    want = np.asarray(jpk.pair_hash(jnp.asarray(hi), jnp.asarray(lo)))
    got = tpk.pair_hash(T(hi), T(lo)).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)


def test_split_join_i64_round_trip():
    rng = np.random.default_rng(1)
    x = rng.integers(-2**63, 2**63 - 1, 1000, dtype=np.int64)
    hi, lo = tpk.split_i64(x)
    jhi, jlo = jpk.split_i64(x)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(tpk.join_i64(hi, lo), x)


@pytest.mark.parametrize("n", [1, 64, 513])
def test_segmented_scans(n):
    rng = np.random.default_rng(n)
    b = 6
    vals = rng.integers(-50, 50, (b, n)).astype(np.int32)
    seg = rng.random((b, n)) < 0.25
    eq(jv(jscan.segmented_scan_max)(jnp.asarray(vals), jnp.asarray(seg)),
       tscan.segmented_scan_max(T(vals), T(seg)), "inclusive")
    eq(jv(lambda v, s: jscan.exclusive_segmented_scan_max(v, s, jnp.int32(-1)))(
        jnp.asarray(vals), jnp.asarray(seg)),
       tscan.exclusive_segmented_scan_max(T(vals), T(seg), -1), "exclusive")


def test_commit_frontier():
    rng = np.random.default_rng(3)
    b, n = 64, 40
    committed = rng.random((b, n)) < 0.8
    committed[::5, :] = True  # fully committed rows
    start = rng.integers(-3, n + 3, b).astype(np.int32)
    want = jv(jscan.commit_frontier)(jnp.asarray(committed), jnp.asarray(start))
    eq(want, tscan.commit_frontier(T(committed), T(start)))


# scatter_max forms: (batch, rows, size, fill, target range, share of
# rows ok, value range); beside the window form with fills -1 and -2^30,
# the narrow peer-frontier form, every row in the sink (masked or out
# of range), duplicate targets of equal values and the INT32_MIN fill
_SM_FORMS = {
    "-1": (8, 50, 16, -1, (-2, 19), 0.6, (-100, 100)),
    "-1073741824": (8, 50, 16, -2 ** 30, (-2, 19), 0.6, (-100, 100)),
    "narrow_R5_fill-2^30": (6, 203, 5, -2 ** 30, (0, 6), 1.0, (-2 ** 30, 1 << 20)),
    "narrow_R3_masked": (6, 203, 3, -2 ** 30, (-2, 7), 0.6, (-2 ** 30, 1 << 20)),
    "sink_only_masked": (6, 203, 64, -1, (0, 65), 0.0, (-5, 50)),
    "sink_only_out_of_range": (6, 203, 64, -1, (65, 200), 1.0, (-5, 50)),
    "duplicates_equal": (6, 203, 64, -1, (0, 3), 1.0, (7, 8)),
    "int32_min_fill": (6, 203, 64, -2 ** 31, (-3, 68), 0.5, (-2 ** 31, 2 ** 31 - 1)),
}


@pytest.mark.parametrize("form", list(_SM_FORMS))
def test_keyed_scatter_max_and_slot_winner(form):
    b, m, size, fill, (t_lo, t_hi), p_ok, (v_lo, v_hi) = _SM_FORMS[form]
    rng = np.random.default_rng(4)
    tgt = rng.integers(t_lo, t_hi, (b, m)).astype(np.int32)
    val = rng.integers(v_lo, v_hi, (b, m), dtype=np.int64).astype(np.int32)
    ok = rng.random((b, m)) < p_ok

    def jax_row(t, v, o):
        return jnp.full(size + 1, fill, jnp.int32).at[
            jnp.where(o & (t >= 0) & (t <= size), t, size)].max(v, mode="drop")

    eq(jv(jax_row)(jnp.asarray(tgt), jnp.asarray(val), jnp.asarray(ok)),
       twin.scatter_max(size, T(tgt), T(val), T(ok), fill))
    rel = np.where(ok, np.clip(tgt, 0, size), size).astype(np.int32)
    jw, jh = jv(lambda r, o: jwin.slot_winner(size, r, o))(
        jnp.asarray(rel), jnp.asarray(ok))
    tw, th = twin.slot_winner(size, T(rel), T(ok))
    eq(jw, tw)
    eq(jh, th)
    col = rng.integers(0, 9, (b, m)).astype(np.int32)
    old = rng.integers(0, 9, (b, size)).astype(np.int32)
    eq(jv(jwin.gather_row)(jw, jh, jnp.asarray(col), jnp.asarray(old)),
       twin.gather_row(tw, th, T(col), T(old)))


def _ack_rows(rng, b, m, r):
    """Inboxes with real runs: consecutive ACCEPT instances per sender."""
    is_acc = rng.random((b, m)) < 0.7
    src = np.repeat(rng.integers(0, r, (b, m // 4 + 1)), 4, axis=1)[:, :m].astype(np.int32)
    inst = (np.cumsum(rng.random((b, m)) < 0.85, axis=1)
            + rng.integers(-5, 5, (b, 1))).astype(np.int32)
    ok = rng.random((b, m)) < 0.9
    return is_acc, src, inst, ok


def test_compress_ack_runs():
    rng = np.random.default_rng(5)
    is_acc, src, inst, ok = _ack_rows(rng, 8, 40, 5)
    ballot = rng.integers(0, 2, (8, 40)).astype(np.int32)
    for kw_j, kw_t, stride in (({}, {}, 1),
                               ({"ballot": jnp.asarray(ballot)}, {"ballot": T(ballot)}, 3)):
        js, jl = jax.vmap(lambda a, s, i, o, **k: jack.compress_ack_runs(
            a, s, i, o, stride=stride, **k))(
            jnp.asarray(is_acc), jnp.asarray(src), jnp.asarray(inst),
            jnp.asarray(ok), **kw_j)
        ts, tl = tack.compress_ack_runs(T(is_acc), T(src), T(inst), T(ok),
                                        stride=stride, **kw_t)
        eq(js, ts, f"run_start stride={stride}")
        eq(jl, tl, f"run_len stride={stride}")


@pytest.mark.parametrize("stride", [1, 3])
def test_range_vote_coverage_and_bits(stride):
    rng = np.random.default_rng(6 + stride)
    b, m, s, r = 6, 30, 24, 5
    valid = rng.random((b, m)) < 0.7
    src = rng.integers(-1, r + 1, (b, m)).astype(np.int32)
    wb = rng.integers(0, 20, b).astype(np.int32)
    inst = (wb[:, None] + rng.integers(-10, s + 10, (b, m))).astype(np.int32)
    count = rng.integers(0, 12, (b, m)).astype(np.int32)
    cov_j = jv(lambda v, sr, i, c, w: jack.range_vote_coverage(
        v, sr, i, c, w, s, r, stride=stride))(
        jnp.asarray(valid), jnp.asarray(src), jnp.asarray(inst),
        jnp.asarray(count), jnp.asarray(wb))
    cov_t = tack.range_vote_coverage(T(valid), T(src), T(inst), T(count), T(wb),
                                     s, r, stride=stride)
    eq(cov_j, cov_t)
    eq(np.asarray(jv(jack.pack_vote_bits)(cov_j)).astype(np.int32),
       tack.pack_vote_bits(cov_t))
    idx = rng.integers(0, s + 1, (b, m)).astype(np.int32)
    sb_j = jv(lambda i, sr, v: jack.scatter_vote_bits(s, i, sr, v, r))(
        jnp.asarray(idx), jnp.asarray(src), jnp.asarray(valid))
    eq(np.asarray(sb_j).astype(np.int32),
       tack.scatter_vote_bits(s, T(idx), T(src), T(valid), r))


def _kv_to_torch(kv):
    return tkv.KVState(*[T(np.asarray(x)) for x in kv])


def _kv_batched_jax(pow2, b):
    one = jkv.kv_init(pow2)
    return jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), one)


def _table_map(kv, i):
    """Table ``i`` as a mapping (key_hi, key_lo) -> value lanes; no key
    may be held twice."""
    live = np.asarray(kv.slot[i]) == tkv.LIVE
    keys = zip(np.asarray(kv.key_hi[i])[live].tolist(),
               np.asarray(kv.key_lo[i])[live].tolist())
    m = {k: tuple(v) for k, v in zip(keys, np.asarray(kv.val[i])[live].tolist())}
    assert len(m) == int(live.sum())
    return m


def _sequential(m, op, k_hi, k_lo, v, valid):
    """The batch applied one command at a time to a dict."""
    m = dict(m)
    for o, kh, kl, x, ok in zip(op.tolist(), k_hi.tolist(), k_lo.tolist(),
                                v.tolist(), valid.tolist()):
        if ok and o == int(Op.PUT):
            m[(kh, kl)] = tuple(x)
        elif ok and o == int(Op.DELETE):
            m.pop((kh, kl), None)
    return m


@pytest.mark.parametrize("pow2,key_range", [(4, 40), (6, 300)])
def test_kv_apply_batch_lanes_collisions_and_full_buckets(pow2, key_range):
    """Tiny tables (4 and 16 buckets) under more distinct keys than fit:
    collisions, full buckets, drops, overwrites and deletes. Both engines
    apply each batch to one state (the port's). Outputs are equal; a
    table in which the reference placed every row is identical byte for
    byte; where the reference dropped rows, the port's displacement pass
    places what it can, so its table holds every entry of the
    reference's. Both hold only the values of the batch applied one
    command at a time, and each misses exactly its dropped count."""
    rng = np.random.default_rng(pow2)
    b, e, lanes = 4, 24, 3
    jax_kv = _kv_batched_jax(pow2, b)
    jax_kv = jax_kv._replace(val=jnp.zeros((b, 1 << pow2, lanes), jnp.int32))
    t_kv = _kv_to_torch(jax_kv)
    apply = jax.jit(jax.vmap(jkv.kv_apply_batch_lanes))
    jax_lost = port_lost = 0
    for step in range(6):
        op = rng.choice([int(Op.PUT)] * 5 + [int(Op.GET)] * 2 + [int(Op.DELETE)],
                        (b, e)).astype(np.int32)
        keys = rng.integers(0, key_range, (b, e))
        k_hi, k_lo = tpk.split_i64(keys * 7919 - 3)
        v = rng.integers(-2**31, 2**31, (b, e, lanes), dtype=np.int64).astype(np.int32)
        valid = rng.random((b, e)) < 0.9
        pre = t_kv
        jax_kv, jo, jf = apply(jkv.KVState(*[jnp.asarray(x.numpy()) for x in pre]),
                               jnp.asarray(op), jnp.asarray(k_hi), jnp.asarray(k_lo),
                               jnp.asarray(v), jnp.asarray(valid))
        t_kv, to, tf = tkv.kv_apply_batch_lanes(pre, T(op), T(k_hi), T(k_lo), T(v),
                                                T(valid))
        eq(jo, to, f"step {step} out")
        eq(jf, tf, f"step {step} found")
        jd = np.asarray(jax_kv.dropped) - pre.dropped.numpy()
        td = t_kv.dropped.numpy() - pre.dropped.numpy()
        for i in range(b):
            if jd[i] == 0:
                for f, a, c in zip(tkv.KVState._fields, jax_kv, t_kv):
                    eq(np.asarray(a)[i], c[i], f"step {step} table {i} {f}")
            want = _sequential(_table_map(pre, i), op[i], k_hi[i], k_lo[i], v[i],
                               valid[i])
            jm, tm = _table_map(jax_kv, i), _table_map(t_kv, i)
            assert jm.items() <= tm.items() <= want.items(), f"step {step} table {i}"
            assert len(want) - len(jm) == jd[i] and len(want) - len(tm) == td[i]
        jax_lost += int(jd.sum())
        port_lost += int(td.sum())
    assert jax_lost > 0  # the full-bucket path ran
    assert port_lost < jax_lost  # and displacement placed some of those rows


def test_kv_displacement_keeps_every_write_at_deployment_load():
    """The 1M-instance deployment's table load: a 2^15-entry table per
    replica under the Threefry workload's 16384-key space, 128 batches of
    512 PUTs for 16 groups. The reference engine drops inserts there
    (both candidate buckets full); the port places them by displacement,
    drops none, and reads every key back with its last value."""
    g, rows, rounds, ks, pow2 = 16, 512, 128, 16384, 15
    jax_kv = _kv_batched_jax(pow2, g)
    t_kv = _kv_to_torch(jax_kv)
    apply = jax.jit(jax.vmap(jkv.kv_apply_batch_lanes))
    op = np.full((g, rows), int(Op.PUT), np.int32)
    zero = np.zeros((g, rows), np.int32)
    ok = np.ones((g, rows), bool)
    last = [dict() for _ in range(g)]
    for rnd in range(rounds):
        key, val = twl.workload_lanes_host(g, rows, rnd, 0, ks)
        v = np.stack([zero, val], axis=2)
        jax_kv, _, _ = apply(jax_kv, jnp.asarray(op), jnp.asarray(zero),
                             jnp.asarray(key), jnp.asarray(v), jnp.asarray(ok))
        t_kv, _, _ = tkv.kv_apply_batch_lanes(t_kv, T(op), T(zero), T(key), T(v), T(ok))
        for i in range(g):
            last[i].update(zip(key[i].tolist(), val[i].tolist()))
    assert int(np.asarray(jax_kv.dropped).sum()) > 0
    assert int(t_kv.dropped.sum()) == 0
    for i in range(g):
        assert _table_map(t_kv, i) == {(0, k): (0, x) for k, x in last[i].items()}


def test_kv_lookup_lanes_matches():
    rng = np.random.default_rng(11)
    b, e = 3, 32
    jax_kv = _kv_batched_jax(7, b)
    keys = rng.integers(0, 200, (b, e))
    k_hi, k_lo = tpk.split_i64(keys)
    ins = jv(jkv.kv_insert_unique)
    uniq = np.stack([np.concatenate([np.unique(k), np.full(e - len(np.unique(k)), -1)])
                     for k in keys])
    u_hi, u_lo = tpk.split_i64(uniq)
    v = rng.integers(0, 1000, (b, e, 2)).astype(np.int32)
    ok = uniq >= 0
    jax_kv = ins(jax_kv, jnp.asarray(u_hi), jnp.asarray(u_lo), jnp.asarray(v),
                 jnp.zeros((b, e), bool), jnp.asarray(ok))
    t_kv = _kv_to_torch(jax_kv)
    qv = rng.random((b, e)) < 0.8
    jf, jval = jv(jkv.kv_lookup_lanes)(jax_kv, jnp.asarray(k_hi),
                                           jnp.asarray(k_lo), jnp.asarray(qv))
    tf, tv = tkv.kv_lookup_lanes(t_kv, T(k_hi), T(k_lo), T(qv))
    eq(jf, tf)
    eq(jval, tv)


R = 5


def _outboxes(g, m, n_live, seed):
    rng = np.random.default_rng(seed)
    cols = np.zeros((12, g, R, m), np.int32)
    dst = np.full((g, R, m), -1, np.int32)
    for gi in range(g):
        for r in range(R):
            pos = np.sort(rng.choice(m, size=n_live, replace=False))
            cols[0, gi, r, pos] = rng.integers(1, 10, n_live)
            cols[1:, gi, r, pos] = rng.integers(-5, 1 << 20, (11, n_live))
            u = rng.random(n_live)
            dst[gi, r, pos] = np.where(u < 0.5, -1, np.where(
                u < 0.8, rng.integers(0, R, n_live), -2))
    return cols, dst


@pytest.mark.parametrize("m,n_live,capacity", [
    (32, 16, 32),  # ordinary mix
    (32, 32, 16),  # heavy overflow
    (64, 3, 64),  # sparse
    (16, 16, 128),  # capacity beyond the pool
])
def test_route_matches_segmented_fabric(m, n_live, capacity):
    """route (plan + gather) equals the JAX fabric row for row, with
    dead senders/destinations and overflow dropped beyond capacity."""
    g = 3
    cfg = JaxCfg(n_replicas=R, window=64, inbox=capacity)
    for seed in range(3):
        cols, dst = _outboxes(g, m, n_live, seed)
        alive = np.ones((g, R), bool)
        alive[1, 2] = False
        alive[2, [0, 4]] = False
        msgs = JaxMsgBatch(*[jnp.asarray(c) for c in cols])
        want = jv(lambda ms, d, a: jax_route(cfg, ms, d, a, capacity))(
            msgs, jnp.asarray(dst), jnp.asarray(alive))
        got, hit = tseg.route(T(cols.reshape(12, g, R * m)), T(dst.reshape(g, R * m)),
                              T(alive), m, capacity)
        for f, (a, c) in enumerate(zip(want, got)):
            eq(a, c, f"seed={seed} column {JaxMsgBatch._fields[f]}")
        eq(np.asarray(want.kind) != 0, hit & (got[0] != 0))


def test_prefix_pack_plan():
    rng = np.random.default_rng(12)
    live = rng.random((5, 40)) < 0.4
    from minpaxos_tpu.ops.segscatter import prefix_pack_plan as jpp

    for cap in (8, 40, 64):
        jw, jh = jv(lambda x: jpp(x, cap))(jnp.asarray(live))
        tw, th = tseg.prefix_pack_plan(T(live), cap)
        eq(jw, tw.to(torch.int32))
        eq(jh, th)


def test_threefry_matches_host_reference():
    rng = np.random.default_rng(13)
    c0 = rng.integers(0, 2**31, 2048).astype(np.int32)
    c1 = rng.integers(0, 2**31, 2048).astype(np.int32)
    for seed, rnd in ((0, 0), (7, 123456), (2**31 - 1, 2**30)):
        h0, h1 = jwl.threefry2x32_host(seed, rnd, c0, c1)
        d0, d1 = twl.threefry2x32(seed, rnd, T(c0), T(c1))
        np.testing.assert_array_equal(h0.astype(np.int64), d0.numpy())
        np.testing.assert_array_equal(h1.astype(np.int64), d1.numpy())
        p0, p1 = twl.threefry2x32_host(seed, rnd, c0, c1)
        np.testing.assert_array_equal(p0, h0)
        np.testing.assert_array_equal(p1, h1)


def test_workload_lanes_and_rows_match():
    g, m, ks = 3, 16, 64
    rounds = np.arange(5, 9)
    jk, jvl = jwl.workload_lanes(g, m, jnp.asarray(rounds), 11, ks)
    tk, tv = twl.workload_lanes(g, m, torch.as_tensor(rounds), 11, ks)
    eq(jk, tk)
    eq(jvl, tv)
    hk, hv = twl.workload_lanes_host(g, m, 6, 11, ks)
    np.testing.assert_array_equal(hk, np.asarray(jk[1]))
    np.testing.assert_array_equal(hv, np.asarray(jvl[1]))
    jrows = jwl.propose_batch(R, g, m, 10, 0, 6, 11, ks)
    trows = twl.propose_batch(R, g, m, 10, 0, 6, 11, ks)
    for f, a, c in zip(JaxMsgBatch._fields, jrows, trows):
        eq(np.asarray(a).reshape(g * R, m), c, f)
