"""The plain twin of K4 insert against the JAX function on the
contention patterns the kernel's claim logic resolves (tolerance 0:
integer results).

On the card, ``tests/test_torch_cuda.py`` holds the kernel to this
twin; here the twin is held to the JAX package with 2, 4 and 6 rows
sharing one bucket (ranks at and past WAYS fall to pass B). K2's
narrow and sink-only forms are cases of ``tests/test_torch_ops.py``'s
``test_keyed_scatter_max_and_slot_winner``. Inputs are made with numpy from a seed. A table in which the JAX engine
places every row must come out byte for byte the same; where it drops
rows, the port's displacement pass places what it can (ROADMAP §C), so
the port's table holds every entry of the reference's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.ops import kvstore as jkv
from minpaxos_tpu_torch.ops import kvstore as tkv

torch.set_num_threads(1)

POW2 = 8  # 64 buckets of 4 ways


def T(x):
    return torch.from_numpy(np.array(x))


def _bucket_groups(rng, c, sizes):
    """Distinct keys, one group per entry of ``sizes``, each group
    sharing its first candidate bucket, a different bucket per group."""
    lo = np.unique(rng.integers(0, 2 ** 30, 1 << 14)).astype(np.int32)
    b1 = tkv._buckets(c, torch.zeros(len(lo), dtype=torch.int32), T(lo))[0].numpy()
    buckets = [b for b in np.unique(b1) if (b1 == b).sum() >= max(sizes)]
    pick = rng.choice(len(buckets), len(sizes), replace=False)
    return [lo[b1 == buckets[p]][:n] for p, n in zip(pick, sizes)]


def _table_map(kv, i):
    live = np.asarray(kv.slot[i]) == tkv.LIVE
    keys = zip(np.asarray(kv.key_hi[i])[live].tolist(), np.asarray(kv.key_lo[i])[live].tolist())
    return dict(zip(keys, map(tuple, np.asarray(kv.val[i])[live].tolist())))


# K4 cases: (group sizes, extra single keys, table load before, share of
# rows valid, share deleted)
_KV_CASES = {
    "one_bucket_2": ((2,), 10, 0.0, 1.0, 0.0),
    "one_bucket_4": ((4,), 10, 0.0, 1.0, 0.0),
    "one_bucket_6": ((6,), 10, 0.0, 1.0, 0.0),
    "groups_2_4_6_shuffled": ((2, 4, 6, 6, 4, 2), 4, 0.0, 0.9, 0.1),
    "groups_into_half_full": ((6, 6, 4, 2), 8, 0.5, 1.0, 0.0),
}


@pytest.mark.parametrize("case", list(_KV_CASES))
def test_kv_insert_claims_match_jax(case):
    """Rows of each table contend for one bucket in groups, in shuffled
    row order: the round-r winner (lowest contending row) takes the
    bucket's r-th free way, and the rows past the free ways retry their
    other bucket (pass B). The twin's tables equal the JAX engine's."""
    sizes, singles, load, p_valid, p_del = _KV_CASES[case]
    rng = np.random.default_rng(len(case))
    b, c, lanes = 3, 1 << POW2, 2
    one = jkv.kv_init(POW2)
    jax_kv = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), one)
    if load:
        n = int(load * c)
        pre = rng.choice(2 ** 30, (b, n), replace=False).astype(np.int32) | 1
        jax_kv = jax.jit(jax.vmap(jkv.kv_insert_unique))(
            jax_kv, jnp.zeros((b, n), jnp.int32), jnp.asarray(pre),
            jnp.ones((b, n, lanes), jnp.int32), jnp.zeros((b, n), bool), jnp.ones((b, n), bool))
    groups = [np.concatenate(_bucket_groups(rng, c, sizes)) for _ in range(b)]
    lo = np.stack([rng.permutation(np.concatenate(
        [g, (rng.choice(2 ** 29, singles, replace=False) * 2).astype(np.int32)]))
        for g in groups])
    hi = np.zeros_like(lo)
    v = rng.integers(-2 ** 31, 2 ** 31, lo.shape + (lanes,), dtype=np.int64).astype(np.int32)
    valid = rng.random(lo.shape) < p_valid
    delete = rng.random(lo.shape) < p_del
    t_kv = tkv.KVState(*[T(np.asarray(x)) for x in jax_kv])
    want = jax.jit(jax.vmap(jkv.kv_insert_unique))(
        jax_kv, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(v), jnp.asarray(delete),
        jnp.asarray(valid))
    got = tkv.kv_insert_unique(t_kv, T(hi), T(lo), T(v), T(delete), T(valid))
    jd = np.asarray(want.dropped) - np.asarray(jax_kv.dropped)
    for i in range(b):
        if jd[i] == 0:
            for f, a, x in zip(tkv.KVState._fields, want, got):
                np.testing.assert_array_equal(np.asarray(a)[i], x[i].numpy(), err_msg=f)
        else:
            assert _table_map(want, i).items() <= _table_map(got, i).items()
    if not load:
        assert not jd.any()  # an empty table places every row: bytes compared

