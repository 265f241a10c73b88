"""K5's plain twins against the JAX package on every input family.

The families of ``minpaxos_tpu_torch/ops/ackruns.py ack_families`` (the
same ones the card tests and ``chip_smoke.py`` hold the kernels to) go,
as numpy arrays from a seed, through the JAX functions (vmapped over the
batch axis) and through the port on the CPU, which takes each kernel's
plain PyTorch version:

* ``compress_ack_runs`` against JAX ``compress_ack_runs`` (stride 1, and
  stride R with the ballot in the run key);
* ``range_vote_bits`` alone, fused with the OR into a votes table
  (``into``), and under a mask as well, against JAX
  ``votes | pack_vote_bits(range_vote_coverage(...) [& mask])``: the
  expressions of ``models/minpaxos.py:875`` and ``models/mencius.py:416``.

Results are integers: tolerance 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.ops import ackruns as jack
from minpaxos_tpu_torch.ops import ackruns as tack

torch.set_num_threads(1)

# two groups of five replicas; inboxes long enough for a 512-row run
B, M, S, R = 10, 600, 512, 5
STRIDES = [1, R]


@functools.lru_cache(maxsize=None)
def _families(stride):
    return tack.ack_families(np.random.default_rng(70 + stride), B, M, S, R, stride)


@functools.lru_cache(maxsize=None)
def _jax_runs(stride):
    if stride == 1:
        return jax.jit(jax.vmap(lambda a, s, i, o: jack.compress_ack_runs(a, s, i, o)))
    return jax.jit(jax.vmap(lambda a, s, i, o, b: jack.compress_ack_runs(
        a, s, i, o, ballot=b, stride=stride)))


@functools.lru_cache(maxsize=None)
def _jax_votes(stride, form):
    def row(v, sr, i, c, w, votes, mask):
        cov = jack.range_vote_coverage(v, sr, i, c, w, S, R, stride=stride)
        if form == "into_mask":
            cov = cov & mask[:, None]
        bits = jack.pack_vote_bits(cov)
        return bits if form == "bits" else votes | bits
    return jax.jit(jax.vmap(row))


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("family", tack.ACK_FAMILIES)
@pytest.mark.parametrize("stride", STRIDES)
def test_compress_ack_runs_on_family(stride, family):
    is_acc, src, inst, ok, ballot = _families(stride)[family]["runs"]
    args = (is_acc, src, inst, ok) + ((ballot,) if stride > 1 else ())
    js, jl = _jax_runs(stride)(*map(jnp.asarray, args))
    ts, tl = tack.compress_ack_runs(_t(is_acc), _t(src), _t(inst), _t(ok),
                                    ballot=_t(ballot), stride=stride)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy(), err_msg="run_start")
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy(), err_msg="run_len")
    if family in ("leader_only", "one_long_run", "full_window"):
        # the family's long runs formed (a round's run: 512 rows, 64 at stride R)
        assert int(tl.max()) >= (512 if stride == 1 else 64)
    if family == "no_accept":
        assert not ts.any() and not tl.any()


@pytest.mark.parametrize("form", ["bits", "into", "into_mask"])
@pytest.mark.parametrize("family", tack.ACK_FAMILIES)
@pytest.mark.parametrize("stride", STRIDES)
def test_range_vote_bits_on_family(stride, family, form):
    fam = _families(stride)[family]
    valid, src, inst, count, wb = fam["votes"]
    votes, mask = fam["into"], fam["mask"]
    want = _jax_votes(stride, form)(*map(jnp.asarray, (
        valid, src, inst, count, wb, votes.astype(np.uint16), mask)))
    into = None if form == "bits" else _t(votes)
    got = tack.range_vote_bits(_t(valid), _t(src), _t(inst), _t(count), _t(wb), S, R,
                               stride=stride, into=into,
                               mask=_t(mask) if form == "into_mask" else None)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int32), got.numpy())
    if into is not None:
        np.testing.assert_array_equal(into.numpy(), votes)  # a new table; into kept
    bits = tack.range_vote_bits(_t(valid), _t(src), _t(inst), _t(count), _t(wb), S, R,
                                stride=stride)
    if family == "no_accept":
        assert not bits.any()
    elif family == "full_window":
        assert bool((bits == (1 << R) - 1).all())
    elif family == "leader_only":
        # only the leader rows (replica 0 of each group) take votes
        assert bits[0::R].any() and not bits[np.arange(B) % R != 0].any()
    else:
        assert bits.any()
