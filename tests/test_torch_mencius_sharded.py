"""A small Mencius sharded resident run of the port equals the JAX run.

``ShardedCluster(protocol="mencius")`` of both packages: G=2 groups x
R=5 owners, W=256, k=8 rounds per dispatch, every owner proposing p=4
rows per round, the same seed and key space. The per-dispatch
(committed_total, in_flight), the inject ring, the latency histogram
and every leaf of the final state outside the KV tables must be equal
(integers: tolerance 0), and every injected proposal commits. The
64-entry KV tables are smaller than the key space, so buckets fill: the
reference drops such inserts, while the port's displacement pass places
some of them, so the tables are compared by content — the same value
wherever both hold a key, and fewer drops in the port.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.parallel.sharded import ShardedCluster as JaxSharded
from minpaxos_tpu_torch.models.cluster import to_numpy_state
from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

torch.set_num_threads(1)

SHAPE = dict(n_replicas=5, window=256, inbox=128, exec_batch=40, kv_pow2=6,
             catchup_rows=8, recovery_rows=8, noop_delay=8)
G, EXT, K, P = 2, 8, 8, 4


def _run(sc, inject_of):
    sc.begin_resident()
    res = [sc.run_resident(K, P) for _ in range(3)]
    res += [sc.run_resident(K, 0) for _ in range(2)]
    return res, inject_of(sc), sc.end_resident()


def _table_map(kv, g, r):
    live = kv.slot[g, r] == 1
    keys = zip(kv.key_hi[g, r][live].tolist(), kv.key_lo[g, r][live].tolist())
    m = dict(zip(keys, map(tuple, kv.val[g, r][live].tolist())))
    assert len(m) == int(live.sum())  # no key held twice
    return m


def test_mencius_resident_run_matches_jax():
    j = JaxSharded(JaxCfg(**SHAPE), G, ext_rows=EXT, key_space=64, seed=5,
                   protocol="mencius")
    jres, jinj, jhist = _run(j, lambda s: np.asarray(s._inject_round))
    t = ShardedCluster(MinPaxosConfig(**SHAPE), G, ext_rows=EXT, key_space=64,
                       seed=5, device="cpu", protocol="mencius")
    tres, tinj, thist = _run(t, lambda s: s._inject_round.numpy())
    assert jres == tres
    injected = G * P * SHAPE["n_replicas"] * 3 * K
    assert jres[-1] == (injected, 0)  # drained, every proposal committed
    np.testing.assert_array_equal(jinj, tinj)
    np.testing.assert_array_equal(jhist, thist)
    assert int(thist.sum()) == injected
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
    jkv = jax.tree_util.tree_map(np.asarray, js.kv)
    tkv = tn.states.kv
    assert int(jkv.dropped.sum()) > 0  # buckets filled
    assert int(tkv.dropped.sum()) < int(jkv.dropped.sum())
    for g in range(G):
        for r in range(SHAPE["n_replicas"]):
            jm, tm = _table_map(jkv, g, r), _table_map(tkv, g, r)
            assert all(tm[k] == v for k, v in jm.items() if k in tm), (g, r)


def test_mencius_sharded_has_no_elections():
    sc = ShardedCluster(MinPaxosConfig(**SHAPE), 1, ext_rows=EXT, device="cpu",
                        protocol="mencius")
    assert sc.leader == -1
    with pytest.raises(ValueError):
        sc.elect(0)
