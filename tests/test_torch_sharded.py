"""A small sharded resident run of the port equals the JAX run.

G=2 groups x R=5 replicas, W=64, k=8 rounds per dispatch, the same seed
and key space: the per-dispatch (committed_total, in_flight), the
inject ring, the latency histogram and every leaf of the final state
outside the KV tables must be equal (integers: tolerance 0). The
64-entry KV table is smaller than the key space, so buckets fill: the
reference drops such inserts, while the port's displacement pass places
some of them, so the tables differ in layout. They must agree on the
value of every key both hold, and the port must drop fewer inserts.
"""

from __future__ import annotations

import jax
import numpy as np

from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.parallel.sharded import ShardedCluster as JaxSharded
from minpaxos_tpu_torch.models.cluster import to_numpy_state
from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

SHAPE = dict(n_replicas=5, window=64, inbox=40, exec_batch=16, kv_pow2=6,
             catchup_rows=8, recovery_rows=8)
G, EXT, K, P = 2, 16, 8, 12


def _run(sc, inject_of):
    sc.elect(0)
    sc.begin_resident()
    res = [sc.run_resident(K, P) for _ in range(3)]
    res += [sc.run_resident(K, 0) for _ in range(2)]
    inj = inject_of(sc)
    return res, inj, sc.end_resident()


def test_resident_run_matches_jax():
    j = JaxSharded(JaxCfg(**SHAPE), G, ext_rows=EXT, key_space=64, seed=3)
    jres, jinj, jhist = _run(j, lambda s: np.asarray(s._inject_round))
    t = ShardedCluster(MinPaxosConfig(**SHAPE), G, ext_rows=EXT, key_space=64,
                       seed=3, device="cpu")
    tres, tinj, thist = _run(t, lambda s: s._inject_round.numpy())
    assert jres == tres
    # drained; every commit sampled (proposals that do not fit the
    # W=64 window are rejected, so committed < proposed here)
    assert jres[-1][1] == 0 and 0 < jres[-1][0] <= G * P * 3 * K
    np.testing.assert_array_equal(jinj, tinj)
    np.testing.assert_array_equal(jhist, thist)
    assert int(thist.sum()) == jres[-1][0]
    tn = to_numpy_state(t.ss, single=False)
    js = j.ss.states
    for f in tn.states._fields:
        if f == "kv":
            continue
        a, b = np.asarray(getattr(js, f)), getattr(tn.states, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f, a, b in zip(tn.pending._fields, j.ss.pending, tn.pending):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"pending {f}")
    np.testing.assert_array_equal(np.asarray(j.ss.alive), tn.alive)
    jkv = jax.tree_util.tree_map(np.asarray, js.kv)
    tkv = tn.states.kv
    assert int(jkv.dropped.sum()) > 0  # buckets filled
    assert int(tkv.dropped.sum()) < int(jkv.dropped.sum())
    for g in range(G):
        for r in range(SHAPE["n_replicas"]):
            jm, tm = _table_map(jkv, g, r), _table_map(tkv, g, r)
            assert all(tm[k] == v for k, v in jm.items() if k in tm), (g, r)


def _table_map(kv, g, r):
    live = kv.slot[g, r] == 1
    keys = zip(kv.key_hi[g, r][live].tolist(), kv.key_lo[g, r][live].tolist())
    m = dict(zip(keys, map(tuple, kv.val[g, r][live].tolist())))
    assert len(m) == int(live.sum())  # no key held twice
    return m
