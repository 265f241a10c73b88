"""K4 lookup, the KV apply's segments and the whole apply: the port's
plain twins against the JAX package on every input family.

The families of ``minpaxos_tpu_torch/ops/kvstore.py lookup_families``
and ``ops/scan.py segment_families`` (the same ones the card tests and
``chip_smoke.py`` hold the kernels to) go, as numpy arrays from a seed,
through the JAX functions (vmapped over the batch axis) and through the
port on the CPU, which takes each kernel's plain PyTorch version:

* ``kv_lookup_lanes`` against JAX ``kv_lookup_lanes``, at C = 4 (one
  bucket: both candidates are the same), 2^10 and 2^12 ways (standing
  in for the serving deployment's 2^18);
* ``kv_segments`` against the JAX apply's segment lines
  (``ops/kvstore.py:270-308``: rolled keys, ``exclusive_segmented_scan_max``
  and the reversed ``segmented_scan_max``) at E = 1, 33, 320 and 512;
* ``kv_apply_batch_lanes`` against JAX's on commands made from the
  segment families, rows shuffled, onto tables a first batch filled:
  tables, outputs and found flags compared leaf for leaf.

Results are integers: tolerance 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.ops import kvstore as jkv
from minpaxos_tpu.ops import scan as jscan
from minpaxos_tpu_torch.ops import kvstore as tkv
from minpaxos_tpu_torch.ops import scan as tscan
from minpaxos_tpu_torch.wire.messages import Op

torch.set_num_threads(1)

# batch rows, query rows, table ways
LOOKUP_SHAPES = {"C4": (3, 40, 4), "C1024": (4, 96, 1 << 10), "C4096": (2, 128, 1 << 12)}
SEGMENT_E = [1, 33, 320, 512]
APPLY_E = [33, 320]
APPLY_POW2 = 12


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _lookup_families(shape):
    b, e, c = LOOKUP_SHAPES[shape]
    return tkv.lookup_families(np.random.default_rng(c + e), b, e, c)


@functools.lru_cache(maxsize=None)
def _jax_lookup():
    def row(hi, lo, v, s, qh, ql, ok):
        return jkv.kv_lookup_lanes(jkv.KVState(hi, lo, v, s, jnp.int32(0)), qh, ql, ok)
    return jax.jit(jax.vmap(row))


@pytest.mark.parametrize("family", tkv.LOOKUP_FAMILIES)
@pytest.mark.parametrize("shape", list(LOOKUP_SHAPES))
def test_kv_lookup_on_family(shape, family):
    tables, queries = _lookup_families(shape)[family]
    jf, jv = _jax_lookup()(*map(jnp.asarray, tables + queries))
    b = queries[0].shape[0]
    kv = tkv.KVState(*map(_t, tables), torch.zeros(b, dtype=torch.int32))
    tf, tv = tkv.kv_lookup_lanes(kv, *map(_t, queries))
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy(), err_msg="found")
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy(), err_msg="value")
    n_valid = int(queries[2].sum())
    if family in ("all_hit", "each_way", "last_way") and shape != "C4":
        # collisions between placed keys cost a few hits, no more (one
        # bucket holds only four)
        assert int(tf.sum()) >= 0.8 * n_valid
    if family == "all_miss":
        assert not tf.any()
    if family == "invalid_rows":
        assert 0 < n_valid < queries[2].size and not (tf & ~_t(queries[2])).any()


def _jax_segments_row(s_khi, s_klo, s_valid, s_write):
    """ops/kvstore.py:270-308 of the JAX package, line for line."""
    b = s_khi.shape[0]
    pos = jnp.arange(b, dtype=jnp.int32)
    seg_start = (pos == 0) | (s_khi != jnp.roll(s_khi, 1)) | (s_klo != jnp.roll(s_klo, 1)) \
        | (s_valid != jnp.roll(s_valid, 1))
    wpos = jnp.where(s_write, pos, -1)
    prev_w = jscan.exclusive_segmented_scan_max(wpos, seg_start, jnp.int32(-1))
    seg_max_w = jscan.segmented_scan_max(wpos, seg_start)
    seg_end = jnp.roll(seg_start, -1).at[b - 1].set(True)
    seg_total = jscan.segmented_scan_max(seg_max_w[::-1], seg_end[::-1])[::-1]
    return prev_w, s_write & (pos == seg_total)


_jax_segments = jax.jit(jax.vmap(_jax_segments_row))


@pytest.mark.parametrize("family", tscan.SEGMENT_FAMILIES)
@pytest.mark.parametrize("e", SEGMENT_E)
def test_kv_segments_on_family(e, family):
    arrs = tscan.segment_families(np.random.default_rng(e), 3, e, names=(family,))[family]
    jp, jf = _jax_segments(*map(jnp.asarray, arrs))
    tp, tf = tscan.kv_segments(*map(_t, arrs))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy(), err_msg="prev_w")
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy(), err_msg="is_final_writer")
    if family == "one_key" and e > 1:
        # one segment: exactly the last write is final
        assert int(tf.sum()) == int(arrs[3].any(1).sum())


_jax_apply = jax.jit(jax.vmap(jkv.kv_apply_batch_lanes))


def _commands(rng, arrs):
    """(op, key_hi, key_lo, v, valid) from a segment family: writes are
    PUT (4 in 5) or DELETE, other rows GET; rows shuffled (the apply
    sorts them itself)."""
    hi, lo, ok, wr = arrs
    b, e = hi.shape
    op = np.where(wr, np.where(rng.random((b, e)) < 0.8, int(Op.PUT), int(Op.DELETE)),
                  int(Op.GET)).astype(np.int32)
    perm = np.argsort(rng.random((b, e)), 1)
    cols = [np.take_along_axis(x, perm, 1) for x in (op, hi, lo, ok)]
    v = rng.integers(-(1 << 30), 1 << 30, (b, e, tkv.VAL_LANES)).astype(np.int32)
    return cols[0], cols[1], cols[2], v, cols[3]


@pytest.mark.parametrize("family", tscan.SEGMENT_FAMILIES)
@pytest.mark.parametrize("e", APPLY_E)
def test_kv_apply_on_family(e, family):
    rng = np.random.default_rng(100 + e)
    b = 2
    arrs = tscan.segment_families(rng, b, e, names=(family,))[family]
    # a first batch PUTs every key of the family, so GETs and deletes
    # without an earlier writer in the batch find them in the table
    fill = (np.full((b, e), int(Op.PUT), np.int32), arrs[0], arrs[1],
            rng.integers(0, 1 << 20, (b, e, tkv.VAL_LANES)).astype(np.int32),
            np.ones((b, e), bool))
    jstate = jax.vmap(lambda _: jkv.kv_init(APPLY_POW2))(jnp.arange(b))
    tstate = tkv.kv_init(APPLY_POW2, b, "cpu")
    for cmds in (fill, _commands(rng, arrs)):
        jstate, jout, jfound = _jax_apply(jstate, *map(jnp.asarray, cmds))
        tstate, tout, tfound = tkv.kv_apply_batch_lanes(tstate, *map(_t, cmds))
        # the JAX engine placed every row, so the tables must be equal
        assert int(np.asarray(jstate.dropped).sum()) == 0
        for name, a, t in zip(tkv.KVState._fields, jstate, tstate):
            np.testing.assert_array_equal(np.asarray(a), t.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(jout), tout.numpy(), err_msg="out")
        np.testing.assert_array_equal(np.asarray(jfound), tfound.numpy(), err_msg="found")


def test_wrappers_take_the_kernel_or_raise_off_the_cpu():
    """A tensor off the CPU takes the kernel or raises: no fall-back to
    the twin; and the kernel wrappers refuse CPU tensors."""
    i = torch.zeros((2, 8), dtype=torch.int32)
    b = torch.zeros((2, 8), dtype=torch.bool)
    mi = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    mb = torch.zeros((2, 8), dtype=torch.bool, device="meta")
    kv = tkv.kv_init(4, 2, "cpu")
    with pytest.raises(RuntimeError):
        tscan.kv_segments(i, i, b, mb)
    with pytest.raises(RuntimeError):
        tkv.kv_lookup_lanes(kv, i, mi, b)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        tscan._kv_segments_kernel(i, i, b, b)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        tkv._kv_lookup_kernel(kv, i, i, b)
