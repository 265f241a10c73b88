"""The fused pvotes scatter and frontier update against the JAX package.

The families of ``minpaxos_tpu_torch/ops/ackruns.py pvote_families`` and
``minpaxos_tpu_torch/ops/scan.py frontier_families`` (the same ones the
card tests and ``chip_smoke.py`` hold the kernels to) go, as numpy
arrays from a seed, through the JAX functions (vmapped over the batch
axis) and through the port on the CPU, which takes each kernel's plain
PyTorch version:

* ``scatter_vote_bits(..., into=pvotes)`` against JAX
  ``pvotes | scatter_vote_bits(...)`` (``models/minpaxos.py:493``,
  ``models/mencius.py:498``), compared as uint16, the JAX state's type;
  the form without ``into`` against JAX ``scatter_vote_bits`` alone;
* ``advance_frontier`` against JAX
  ``maximum(upto, commit_frontier(status >= C [| executed],
  upto + 1 - wb) + wb)`` (``models/minpaxos.py:900-904``,
  ``models/mencius.py:529-533`` and ``:900-903``), and the standalone
  ``commit_frontier`` on the same windows.

Then the golden scenario of every protocol runs through the port's
clusters on the CPU with both calls watched: the digests stay the
fixture's, and the steps hand the kernels the dtypes they take (u8
status, bool executed, int32 tables).

Results are integers: tolerance 0.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.ops import ackruns as jack
from minpaxos_tpu.ops import scan as jscan
from minpaxos_tpu_torch.ops import ackruns as tack
from minpaxos_tpu_torch.ops import scan as tscan
from minpaxos_tpu_torch.wire.messages import COMMITTED, EXECUTED

torch.set_num_threads(1)

# two groups of five replicas; an inbox longer than the window, a window
# off and on the 16-byte width
B, M, R = 10, 150, 5
WINDOWS = [120, 256]
FORMS = {"committed": (COMMITTED, False), "executed": (EXECUTED, True)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _pvote_families(s):
    return tack.pvote_families(np.random.default_rng(90 + s), B, M, s, R)


@functools.lru_cache(maxsize=None)
def _jax_pvotes(s, fused):
    def row(i, sr, v, pv):
        bits = jack.scatter_vote_bits(s, i, sr, v, R)
        return pv | bits if fused else bits
    return jax.jit(jax.vmap(row))


@pytest.mark.parametrize("fused", [True, False], ids=["into", "alone"])
@pytest.mark.parametrize("family", tack.PVOTE_FAMILIES)
@pytest.mark.parametrize("s", WINDOWS)
def test_scatter_vote_bits_on_family(s, family, fused):
    idx, src, valid, into = _pvote_families(s)[family]
    want = _jax_pvotes(s, fused)(jnp.asarray(idx), jnp.asarray(src), jnp.asarray(valid),
                                 jnp.asarray(into.astype(np.uint16)))
    into_t = _t(into)
    got = tack.scatter_vote_bits(s, _t(idx), _t(src), _t(valid), R,
                                 into=into_t if fused else None)
    assert got.dtype == torch.int32 and got.shape == (B, s)
    assert int(got.min()) >= 0 and int(got.max()) < 1 << R
    np.testing.assert_array_equal(np.asarray(want), got.numpy().astype(np.uint16))
    # a new table: ``into`` is not changed
    np.testing.assert_array_equal(into_t.numpy(), into)
    if family == "no_valid":
        np.testing.assert_array_equal(got.numpy(), into if fused else 0)
    if family == "prepare":
        # the hot slot of each row holds every sender's bit
        hot = idx[:, 0]
        bits = _jax_pvotes(s, False)(jnp.asarray(idx), jnp.asarray(src), jnp.asarray(valid),
                                     jnp.asarray(into.astype(np.uint16)))
        assert (np.asarray(bits)[np.arange(B), hot] == (1 << R) - 1).all()
    if family == "edges":
        # indices at -2, s and s + 3 and senders outside [0, R - 1] occur
        assert (valid & (idx == -2)).any() and (valid & (idx == s)).any()
        assert (valid & (idx == s + 3)).any()
        assert (valid & ((src < 0) | (src >= R))).any()


@functools.lru_cache(maxsize=None)
def _frontier_families(s):
    return tscan.frontier_families(np.random.default_rng(110 + s), B, s)


@functools.lru_cache(maxsize=None)
def _jax_advance(threshold, with_executed):
    def f(status, upto, wb, executed):
        done = status >= threshold
        if with_executed:
            done = executed | done
        rel = jax.vmap(jscan.commit_frontier)(done, upto + 1 - wb)
        return jnp.maximum(upto, rel + wb)
    return jax.jit(f)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("family", tscan.FRONTIER_FAMILIES)
@pytest.mark.parametrize("s", WINDOWS)
def test_advance_frontier_on_family(s, family, form):
    status, upto, wb, executed = _frontier_families(s)[family]
    threshold, with_executed = FORMS[form]
    want = np.asarray(_jax_advance(threshold, with_executed)(
        *map(jnp.asarray, (status, upto, wb, executed))))
    upto_t = _t(upto)
    got = tscan.advance_frontier(_t(status), threshold, upto_t, _t(wb),
                                 executed=_t(executed) if with_executed else None)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(upto_t.numpy(), upto)  # upto is not changed
    start = upto + 1 - wb
    if family == "start_past_window":
        assert (start >= s).all() and (start == s).any()
        np.testing.assert_array_equal(got.numpy(), upto)
    if family == "start_negative":
        assert (start < 0).all()
    if family == "unaligned_start":
        assert (start % 16 != 0).all()
    if family == "no_gap" and form == "committed":
        np.testing.assert_array_equal(got.numpy(), wb + s - 1)
    if family == "gap_at_start":
        np.testing.assert_array_equal(got.numpy(), upto)
    if family == "path" and form == "committed":
        assert (got.numpy() > upto).any()
    if family == "executed" and form == "executed":
        # executed covers slots that status does not: the executed form
        # goes further than status >= EXECUTED alone in some row
        alone = np.asarray(_jax_advance(EXECUTED, False)(
            *map(jnp.asarray, (status, upto, wb, executed))))
        assert (got.numpy() > alone).any()


@pytest.mark.parametrize("family", tscan.FRONTIER_FAMILIES)
def test_commit_frontier_on_family(family):
    s = WINDOWS[0]
    status, upto, wb, _ = _frontier_families(s)[family]
    committed = status >= COMMITTED
    start = (upto + 1 - wb).astype(np.int32)
    want = jax.jit(jax.vmap(jscan.commit_frontier))(jnp.asarray(committed), jnp.asarray(start))
    got = tscan.commit_frontier(_t(committed), _t(start))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_the_steps_hand_the_fused_calls_their_dtypes(monkeypatch):
    """The golden scenario of each protocol on the CPU, both fused calls
    watched: the digests stay the fixture's; every call gets a u8
    status, int32 cursors and tables, bool flags, pvotes as ``into``;
    MinPaxos and classic advance one frontier a step, Mencius two (the
    commit frontier, then the executed one with ``executed``)."""
    from minpaxos_tpu_torch import golden
    from minpaxos_tpu_torch.models import mencius as tmc
    from minpaxos_tpu_torch.models import minpaxos as tmp

    calls = {"frontier": [], "pvotes": []}

    def watch_frontier(status, threshold, upto, window_base, executed=None):
        calls["frontier"].append((status.dtype, threshold, upto.dtype, window_base.dtype,
                                  None if executed is None else executed.dtype))
        return tscan.advance_frontier(status, threshold, upto, window_base, executed)

    def watch_pvotes(size, idx, src, valid, n_replicas, into=None):
        calls["pvotes"].append((idx.dtype, src.dtype, valid.dtype,
                                None if into is None else into.dtype, int(valid.sum())))
        return tack.scatter_vote_bits(size, idx, src, valid, n_replicas, into=into)

    for mod in (tmp, tmc):
        monkeypatch.setattr(mod, "advance_frontier", watch_frontier)
        monkeypatch.setattr(mod, "scatter_vote_bits", watch_pvotes)
    gold = golden.load_fixture(os.path.join(os.path.dirname(__file__), "fixtures",
                                            "kernel_golden.json"))
    for proto in golden.PROTOCOLS:
        calls["frontier"].clear()
        calls["pvotes"].clear()
        got = golden.drive(proto, device=torch.device("cpu"))
        assert golden.first_divergence(got, gold[proto]) is None, proto
        i32, u8 = torch.int32, torch.uint8
        thresholds = [c[1] for c in calls["frontier"]]
        if proto == "mencius":
            assert thresholds == [COMMITTED, EXECUTED] * (len(thresholds) // 2)
            assert all(c == (u8, EXECUTED, i32, i32, torch.bool)
                       for c in calls["frontier"][1::2])
            assert all(c == (u8, COMMITTED, i32, i32, None) for c in calls["frontier"][::2])
        else:
            assert thresholds and set(thresholds) == {COMMITTED}
            assert all(c == (u8, COMMITTED, i32, i32, None) for c in calls["frontier"])
        assert len(calls["pvotes"]) * (2 if proto == "mencius" else 1) == len(thresholds)
        assert all(c[:4] == (i32, i32, torch.bool, i32) for c in calls["pvotes"])
        # an election or a takeover: some step ORs valid rows in
        assert any(c[4] for c in calls["pvotes"]), proto
