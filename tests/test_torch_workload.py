"""The port's workload (K8's plain twin) and host-in-the-loop leg equal
the JAX package's, bit for bit (tolerance 0).

``propose_batch`` (the twin K8 is held to on the card) and the numpy
``propose_batch_host`` against JAX's ``propose_batch``, with and without
the hot-key knob, across rounds 0, 1 and one where cmd_id = round * M +
row wraps in int32; the Threefry pin of tests/test_workload.py; and
``ShardedCluster.run_fused`` (``sharded_run``) against JAX's, with the
resident loop's commit stream held to the fused loop's cursors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.models.minpaxos import MsgBatch as JaxMsgBatch
from minpaxos_tpu.ops import workload as jwl
from minpaxos_tpu.parallel.sharded import ShardedCluster as JaxSharded
from minpaxos_tpu_torch.models.cluster import to_numpy_state
from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
from minpaxos_tpu_torch.ops import workload as twl
from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

torch.set_num_threads(1)

R, G, M = 5, 3, 24
WRAP_ROUND = 2 ** 31 // M + 3  # round * M passes 2^31: cmd_id wraps


@pytest.mark.parametrize("hot_pct", [0, 30])
@pytest.mark.parametrize("leader,count", [(0, 17), (-1, 9)])
def test_propose_batch_matches_jax_and_host(hot_pct, leader, count):
    ks = 1 << 12
    for rnd in (0, 1, WRAP_ROUND):
        want = jwl.propose_batch(R, G, M, count, leader, jnp.int32(rnd), 11, ks,
                                 hot_pct=hot_pct, hot_keys=8)
        got = twl.propose_batch(R, G, M, count, leader, rnd, 11, ks,
                                hot_pct=hot_pct, hot_keys=8, device="cpu")
        host = twl.propose_batch_host(R, G, M, count, leader, rnd, 11, ks,
                                      hot_pct=hot_pct, hot_keys=8)
        for f, a, b, c in zip(JaxMsgBatch._fields, want, got, host):
            a = np.asarray(a).reshape(G * R, M)
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{f} round {rnd}")
            np.testing.assert_array_equal(a, c, err_msg=f"host {f} round {rnd}")
        live = got.kind != 0
        if rnd == WRAP_ROUND:
            assert bool((got.cmd_id[live] < 0).any())  # the wrap happened
        if hot_pct:
            hot = live & (got.key_lo < 8)
            assert 0 < int(hot.sum()) < int(live.sum())


def test_hot_pct_zero_leaves_the_stream_unchanged():
    a = twl.propose_batch(R, G, M, M, 0, 4, 2, 1 << 10, device="cpu")
    b = twl.propose_batch(R, G, M, M, 0, 4, 2, 1 << 10, hot_pct=0, hot_keys=3,
                          device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_threefry_pin_through_the_batch():
    """tests/test_workload.py's pinned Threefry values (key [7, 42],
    counter (i, i + 4)) come out of the batch as (shard i, row i + 4)'s
    value lane, with seed 7 and round 42."""
    want0 = [2626804800, 2398813549, 2223630828, 3945575549]
    want1 = [592614780, 124672495, 3815937248, 2652798884]
    c0, c1 = torch.arange(4), torch.arange(4, 8)
    d0, d1 = twl.threefry2x32(7, 42, c0, c1)
    assert d0.tolist() == want0 and d1.tolist() == want1
    h0, h1 = twl.threefry2x32_host(7, 42, np.arange(4, dtype=np.uint32),
                                   np.arange(4, 8, dtype=np.uint32))
    assert h0.tolist() == want0 and h1.tolist() == want1
    rows = twl.propose_batch(1, 4, 8, 8, 0, 42, 7, device="cpu")
    vals = rows.val_lo.numpy().astype(np.uint32)
    assert [int(vals[i, i + 4]) for i in range(4)] == want1


SHAPE = dict(n_replicas=5, window=64, inbox=40, exec_batch=16, kv_pow2=10,
             catchup_rows=8, recovery_rows=8)
GF, EXT, K, P = 2, 16, 8, 12


def _fused(sc, substeps):
    sc.elect(0)
    hist = [sc.run_fused(K, P, substeps) for _ in range(2)]
    hist += [sc.run_fused(K, 0, substeps) for _ in range(2)]
    return np.concatenate([h[0] for h in hist]), np.concatenate([h[1] for h in hist])


@pytest.mark.parametrize("substeps", [1, 2])
def test_run_fused_matches_jax(substeps):
    j = JaxSharded(JaxCfg(**SHAPE), GF, ext_rows=EXT, key_space=64, seed=3)
    t = ShardedCluster(MinPaxosConfig(**SHAPE), GF, ext_rows=EXT, key_space=64,
                       seed=3, device="cpu")
    ju, jc = _fused(j, substeps)
    tu, tc = _fused(t, substeps)
    assert tu.shape == (4 * K, GF)
    np.testing.assert_array_equal(ju, tu)
    np.testing.assert_array_equal(jc, tc)
    assert (tu[-1] > 0).all() and (tu[-1] + 1 == tc[-1]).all()  # drained
    tn = to_numpy_state(t.ss, single=False)
    for f, a, b in zip(tn.states._fields, jax.tree_util.tree_leaves(j.ss.states),
                       jax.tree_util.tree_leaves(tn.states)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)


def test_resident_loop_equals_fused_loop():
    """The port's form of tests/test_workload.py's resident-vs-legacy
    pin: from the same seed the resident loop and the fused loop commit
    the same stream and end in the same state, and the histogram holds
    one sample per committed slot."""
    a = ShardedCluster(MinPaxosConfig(**SHAPE), GF, ext_rows=EXT, key_space=64,
                       seed=5, device="cpu")
    ups, crts = _fused(a, 1)
    b = ShardedCluster(MinPaxosConfig(**SHAPE), GF, ext_rows=EXT, key_space=64,
                       seed=5, device="cpu")
    b.elect(0)
    b.begin_resident()
    res = [b.run_resident(K, P) for _ in range(2)] + [b.run_resident(K, 0)
                                                      for _ in range(2)]
    hist = b.end_resident()
    assert [r[0] for r in res] == [int((ups[i] + 1).sum()) for i in (7, 15, 23, 31)]
    assert [r[1] for r in res] == [int((crts[i] - 1 - ups[i]).sum())
                                   for i in (7, 15, 23, 31)]
    assert int(hist.sum()) == res[-1][0] and res[-1][1] == 0
    for x, y in zip(to_numpy_state(a.ss, single=False).states,
                    to_numpy_state(b.ss, single=False).states):
        for u, v in zip(jax.tree_util.tree_leaves(x), jax.tree_util.tree_leaves(y)):
            np.testing.assert_array_equal(u, v)
