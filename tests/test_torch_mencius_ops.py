"""The ops under the port's Mencius step against the JAX package and oracles.

* K5's plain versions at Mencius's stride R = 5: run compression with
  the echoed ballot, and the fused packed vote bits, equal to the JAX
  ``compress_ack_runs`` and ``pack_vote_bits(range_vote_coverage(...))``.
* K6's plain version (``ops/mencius_exec.py``) against a numpy oracle
  that follows the JAX step's rule (``models/mencius.py`` step 11) slot
  by slot in plain loops, on random windows with duplicate keys, gaps,
  uncommitted writes and more candidates than the exec budget, and on
  the adversarial families the card tests also run
  (``ops/mencius_exec.py exec_families``).
* The KV engine at Mencius's deployment (E = 320 rows per batch, tables
  of C = 2^14 ways, a 8192-key space): where the reference places every
  row the table bytes are the reference's, and nothing is dropped.

Integer results: tolerance 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.ops import ackruns as jack
from minpaxos_tpu.ops import kvstore as jkv
from minpaxos_tpu_torch.ops import ackruns as tack
from minpaxos_tpu_torch.ops import kvstore as tkv
from minpaxos_tpu_torch.ops import workload as twl
from minpaxos_tpu_torch.ops.mencius_exec import exec_families, exec_select
from minpaxos_tpu_torch.wire.messages import (
    ACCEPTED,
    COMMITTED,
    EXECUTED,
    NONE,
    Op,
)

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def jv(fn):
    return jax.jit(jax.vmap(fn))


def eq(jax_val, torch_val, what=""):
    np.testing.assert_array_equal(np.asarray(jax_val), torch_val.numpy(), err_msg=what)


def _stride_rows(rng, b, m, r):
    """Accept bursts of one owner's slots, R apart, some interrupted."""
    is_acc = rng.random((b, m)) < 0.8
    src = np.repeat(rng.integers(0, r, (b, m // 6 + 1)), 6, axis=1)[:, :m].astype(np.int32)
    step = np.where(rng.random((b, m)) < 0.85, r, rng.integers(1, 2 * r, (b, m)))
    inst = (np.cumsum(step, axis=1) + rng.integers(-20, 20, (b, 1))).astype(np.int32)
    ok = rng.random((b, m)) < 0.9
    ballot = np.where(rng.random((b, m)) < 0.9, 0, 17).astype(np.int32)
    return is_acc, src, inst, ok, ballot


def test_compress_ack_runs_at_owner_stride_with_ballot():
    rng = np.random.default_rng(21)
    r = 5
    is_acc, src, inst, ok, ballot = _stride_rows(rng, 6, 64, r)
    js, jl = jax.vmap(lambda a, s, i, o, b: jack.compress_ack_runs(
        a, s, i, o, ballot=b, stride=r))(*map(jnp.asarray, (is_acc, src, inst, ok, ballot)))
    ts, tl = tack.compress_ack_runs(T(is_acc), T(src), T(inst), T(ok), ballot=T(ballot),
                                    stride=r)
    eq(js, ts, "run_start")
    eq(jl, tl, "run_len at every row")
    assert int(np.asarray(jl).max()) > 1  # runs longer than one row formed


@pytest.mark.parametrize("stride", [1, 5])
def test_range_vote_bits_fused(stride):
    """The packed votes of range acks, coverage and packing in one call."""
    rng = np.random.default_rng(30 + stride)
    b, m, s, r = 6, 40, 64, 5
    valid = rng.random((b, m)) < 0.7
    src = rng.integers(-1, r + 1, (b, m)).astype(np.int32)
    wb = rng.integers(0, 30, b).astype(np.int32)
    inst = (wb[:, None] + rng.integers(-3 * stride - 5, s + 10, (b, m))).astype(np.int32)
    count = rng.integers(0, 9, (b, m)).astype(np.int32)
    want = jv(lambda v, sr, i, c, w: jack.pack_vote_bits(jack.range_vote_coverage(
        v, sr, i, c, w, s, r, stride=stride)))(*map(jnp.asarray, (valid, src, inst, count, wb)))
    got = tack.range_vote_bits(T(valid), T(src), T(inst), T(count), T(wb), s, r,
                               stride=stride)
    eq(np.asarray(want).astype(np.int32), got)
    assert int((got != 0).sum()) > 0


def _oracle(key_hi, key_lo, status, op, executed, wb, cu, eu, e):
    """models/mencius.py step 11's choice, one slot at a time."""
    b, s = status.shape
    slot_of = np.full((b, e), s, np.int32)
    newly = np.zeros((b, s), bool)
    for row in range(b):
        n_in = min(max(int(cu[row]) - int(eu[row]), 0), e)
        rel0 = int(eu[row]) + 1 - int(wb[row])
        pre = [rel0 <= i < rel0 + n_in for i in range(s)]
        key = list(zip(key_hi[row].tolist(), key_lo[row].tolist()))
        st, ex = status[row], executed[row]
        poisoned = [(ACCEPTED <= st[i] < EXECUTED and not ex[i] and not pre[i])
                    or (st[i] == ACCEPTED and op[row, i] in (int(Op.PUT), int(Op.DELETE)))
                    for i in range(s)]
        gaps = [int(wb[row]) + i for i in range(s)
                if int(wb[row]) + i > cu[row] and st[i] == NONE]
        first_gap = min(gaps + [2 ** 30])
        rank = 0
        for i in range(s):
            a = int(wb[row]) + i
            clear = not any(poisoned[j] and key[j] == key[i] for j in range(i))
            ooo = (st[i] == COMMITTED and not ex[i] and not pre[i] and a > cu[row]
                   and a < first_gap and clear)
            if (pre[i] and not ex[i]) or ooo:
                if rank < e:
                    slot_of[row, rank] = i
                    newly[row, i] = True
                rank += 1
    return slot_of, newly


@pytest.mark.parametrize("s,e", [(48, 7), (64, 12)])
def test_exec_select_matches_oracle(s, e):
    rng = np.random.default_rng(s + e)
    b = 24
    key_hi = rng.integers(-1, 1, (b, s)).astype(np.int32)
    key_lo = rng.integers(-3, 4, (b, s)).astype(np.int32)
    # mostly committed, with accepted (some uncommitted writes) slots
    # and NONE gaps sprinkled in
    status = rng.choice([NONE, ACCEPTED, COMMITTED, COMMITTED, COMMITTED, EXECUTED],
                        (b, s), p=[0.05, 0.15, 0.25, 0.25, 0.2, 0.1]).astype(np.uint8)
    op = rng.integers(0, 4, (b, s)).astype(np.uint8)
    executed = (status == EXECUTED) | (rng.random((b, s)) < 0.05)
    wb = rng.integers(-5, 100, b).astype(np.int32)
    eu = (wb + rng.integers(-2, 10, b)).astype(np.int32)
    cu = (eu + rng.integers(-2, s // 2, b)).astype(np.int32)
    want_slot, want_new = _oracle(key_hi, key_lo, status, op, executed, wb, cu, eu, e)
    slot_of, newly = exec_select(T(key_hi), T(key_lo), T(status), T(op), T(executed),
                                 T(wb), T(cu), T(eu), e)
    np.testing.assert_array_equal(slot_of.numpy(), want_slot)
    np.testing.assert_array_equal(newly.numpy(), want_new)
    # the cases the rule distinguishes all occur
    full = (want_slot < s).all(1)
    assert full.any() and (~full).any()  # budget-bound and not
    ooo = want_new & (wb[:, None] + np.arange(s)[None, :] > cu[:, None])
    assert ooo.any()  # out-of-order picks past the frontier
    # the adversarial families the card test holds K6 to: one key, all
    # keys distinct, the gap at slot 0, no gap, the frontier past the
    # window, the budget binding
    for family, arrs in exec_families(rng, b, s, e).items():
        want_slot, want_new = _oracle(*arrs, e)
        slot_of, newly = exec_select(*[T(a) for a in arrs], e)
        np.testing.assert_array_equal(slot_of.numpy(), want_slot, err_msg=family)
        np.testing.assert_array_equal(newly.numpy(), want_new, err_msg=family)


def _kv_batched_jax(pow2, b):
    one = jkv.kv_init(pow2)
    return jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), one)


def _tkv_to_jax(kv):
    return jkv.KVState(*[jnp.asarray(x.numpy()) for x in kv])


def _table_map(kv, i):
    live = np.asarray(kv.slot[i]) == tkv.LIVE
    keys = zip(np.asarray(kv.key_hi[i])[live].tolist(),
               np.asarray(kv.key_lo[i])[live].tolist())
    m = {k: tuple(v) for k, v in zip(keys, np.asarray(kv.val[i])[live].tolist())}
    assert len(m) == int(live.sum())
    return m


def test_kv_at_the_mencius_deployment():
    """Mencius's exec batches at the deployment: per round each of the
    5 owners commits the same 64 Threefry (key, value) rows, interleaved
    in slot order (row i of owner r at slot 5i + r), 320 rows per batch,
    into tables of 2^14 ways, over the 128 rounds the card run measures.
    The reference and the port apply each batch to one state; the table
    bytes are equal in every table where the reference placed every row,
    the port drops nothing, and every key reads back its last value."""
    g, p, r, rounds, ks, pow2 = 8, 64, 5, 128, 8192, 14
    e = p * r
    jax_kv = _kv_batched_jax(pow2, g)
    t_kv = tkv.KVState(*[T(np.asarray(x)) for x in jax_kv])
    apply = jax.jit(jax.vmap(jkv.kv_apply_batch_lanes))
    op = np.full((g, e), int(Op.PUT), np.int32)
    zero = np.zeros((g, e), np.int32)
    ok = np.ones((g, e), bool)
    last = [dict() for _ in range(g)]
    identical = 0
    for rnd in range(rounds):
        key, val = twl.workload_lanes_host(g, p, rnd, 0, ks)
        key, val = np.repeat(key, r, axis=1), np.repeat(val, r, axis=1)
        v = np.stack([zero, val], axis=2)
        pre = t_kv
        jax_kv, jo, _ = apply(_tkv_to_jax(pre), jnp.asarray(op), jnp.asarray(zero),
                              jnp.asarray(key), jnp.asarray(v), jnp.asarray(ok))
        t_kv, to, _ = tkv.kv_apply_batch_lanes(pre, T(op), T(zero), T(key), T(v), T(ok))
        eq(jo, to, f"round {rnd} out")
        jd = np.asarray(jax_kv.dropped) - pre.dropped.numpy()
        for i in range(g):
            if jd[i] == 0:
                identical += 1
                for f, a, c in zip(tkv.KVState._fields, jax_kv, t_kv):
                    eq(np.asarray(a)[i], c[i], f"round {rnd} table {i} {f}")
            last[i].update(zip(key[i].tolist(), val[i].tolist()))
    assert identical > 0
    assert int(t_kv.dropped.sum()) == 0
    for i in range(g):
        assert _table_map(t_kv, i) == {(0, k): (0, x) for k, x in last[i].items()}
