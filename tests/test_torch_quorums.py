"""The port's configured legs that the defaults leave out, against the JAX package.

* The batched step under flexible quorums, the fast path and gossip
  cadence: ``tests/test_torch_step.py``'s differential (the same seeded
  inboxes through the JAX step vmapped over replicas and the port's
  step, every leaf of state, outbox and exec result equal after every
  step) at (q1, q2) in {(4, 2), (3, 3), (2, 4)} for n = 5, with
  ``fast_path``, with ``gossip_ticks`` 2 and 3, for MinPaxos and classic
  Paxos (the step takes the fast-path flag in both; the cluster
  refuses it for classic).
* ``compact_inbox``: the JAX ``Cluster`` and the port's ``Cluster`` (and
  ``MenciusCluster``) driven through the scenario of
  ``tests/test_route_fabric.py``'s compaction test (kill and revive
  under load, the compacted inbox below inbox + ext rows), every state
  leaf and the routed inboxes equal after every step, and the same
  replies.
* ``tests/test_flexible_quorum.py``'s scenarios through the port's
  ``Cluster``, each also held leaf for leaf against the JAX ``Cluster``
  after every step: a commit at q2 = 2 with three of five replicas dead,
  the majority control that stalls there, an election that needs q1 = 4
  promises, and the fast path's broadcast commits, exactly once; and the
  port's refusal of non-intersecting quorums.

Integer results: tolerance 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.cluster import Cluster as JaxCluster
from minpaxos_tpu.models.mencius import MenciusCluster as JaxMenciusCluster
from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.models.minpaxos import replica_step_impl as jax_step
from minpaxos_tpu.models.paxos import classic_config as jax_classic
from minpaxos_tpu.wire.messages import Op
from minpaxos_tpu_torch.models import minpaxos as tmp
from minpaxos_tpu_torch.models.cluster import Cluster, numpy_leaves
from minpaxos_tpu_torch.models.mencius import MenciusCluster
from minpaxos_tpu_torch.models.paxos import classic_config as torch_classic
from tests.test_torch_step import SHAPE, STEPS, _assert_same, _inbox, _start_state

torch.set_num_threads(1)

# the golden scenario's shape (tests/test_kernel_golden.py _KW)
GOLDEN = dict(n_replicas=5, window=64, inbox=32, exec_batch=16, kv_pow2=8,
              catchup_rows=8, recovery_rows=8)

# the configured legs of the step differential
LEGS = {
    "q4_2": dict(q1=4, q2=2),
    "q3_3": dict(q1=3, q2=3),
    "q2_4": dict(q1=2, q2=4),
    "fast_path": dict(fast_path=True),
    "gossip3": dict(gossip_ticks=3),
    "q4_2_gossip2": dict(q1=4, q2=2, gossip_ticks=2),
}


@pytest.mark.parametrize("leg", list(LEGS))
@pytest.mark.parametrize("protocol", ["minpaxos", "classic"])
def test_step_matches_jax_under_configured_legs(protocol, leg):
    kw = dict(SHAPE, gate_exec=False, **LEGS[leg])
    if protocol == "classic":
        jcfg, tcfg = jax_classic(**kw), torch_classic(**kw)
    else:
        jcfg, tcfg = JaxCfg(**kw), tmp.MinPaxosConfig(**kw)
    step = jax.jit(jax.vmap(functools.partial(jax_step, jcfg)))
    js = jax.tree_util.tree_map(jnp.asarray, _start_state(jcfg))
    ts = tmp.from_numpy_state(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    rng = np.random.default_rng(len(leg) + 7 * (protocol == "classic"))
    executed = 0
    for i in range(STEPS):
        inbox = _inbox(rng, js)
        js, jout, jex = step(js, jax.tree_util.tree_map(jnp.asarray, inbox))
        ts, tout, tex = tmp.replica_step_impl(
            tcfg, ts, tmp.MsgBatch(*[torch.from_numpy(c) for c in inbox]))
        _assert_same(js, tmp.to_numpy_state(ts), f"{leg} step {i} state")
        _assert_same(jout.msgs, tout.msgs, f"{leg} step {i} outbox")
        np.testing.assert_array_equal(np.asarray(jout.dst), tout.dst.numpy())
        np.testing.assert_array_equal(np.asarray(jout.acked), tout.acked.numpy())
        _assert_same(jex, tex, f"{leg} step {i} exec")
        executed += int(np.asarray(jex.count).sum())
    assert executed > 0


# ---- cluster level: the JAX Cluster and the port's, side by side ----

def _jax_leaves(cl):
    cs = cl.cs
    return [np.asarray(x) for x in jax.tree_util.tree_leaves((cs.states, cs.pending,
                                                               cs.alive))]


class Pair:
    """A JAX cluster and a port cluster (on the CPU) of one config,
    driven by the same calls; ``step`` holds every state leaf, the
    routed inboxes and the alive mask equal after each round."""

    def __init__(self, cfg_kw: dict, protocol: str = "minpaxos", ext_rows: int = 8):
        if protocol == "mencius":
            self.j = JaxMenciusCluster(JaxCfg(**cfg_kw), ext_rows=ext_rows)
            self.t = MenciusCluster(tmp.MinPaxosConfig(**cfg_kw), ext_rows=ext_rows,
                                    device="cpu")
        elif protocol == "classic":
            self.j = JaxCluster(jax_classic(**cfg_kw), ext_rows=ext_rows)
            self.t = Cluster(torch_classic(**cfg_kw), ext_rows=ext_rows, device="cpu")
        else:
            self.j = JaxCluster(JaxCfg(**cfg_kw), ext_rows=ext_rows)
            self.t = Cluster(tmp.MinPaxosConfig(**cfg_kw), ext_rows=ext_rows, device="cpu")
        self.steps = 0

    def both(self, name, *a, **kw):
        getattr(self.j, name)(*a, **kw)
        getattr(self.t, name)(*a, **kw)

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            self.j.step()
            self.t.step()
            self.steps += 1
            want, got = _jax_leaves(self.j), numpy_leaves(self.t.cs)
            assert len(want) == len(got)
            for k, (a, b) in enumerate(zip(want, got)):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"leaf {k} differs after step {self.steps}")

    def check_replies(self) -> None:
        assert self.t.replies == self.j.replies
        assert self.t.reply_log == self.j.reply_log


@pytest.mark.parametrize("protocol", ["minpaxos", "classic", "mencius"])
def test_compact_inbox_matches_jax_cluster(protocol):
    """compact_inbox = 36 < inbox + ext = 40: the compacted inboxes,
    and so every state leaf, equal the JAX cluster's after every step
    through the kill / revive scenario of test_route_fabric.py."""
    p = Pair(dict(GOLDEN, compact_inbox=36), protocol)
    rng = np.random.default_rng(11)
    if protocol != "mencius":
        p.both("elect", 0)
        p.step(2)
    for i in range(10):
        if i == 4:
            p.both("kill", 2)
        if i == 7:
            p.both("revive", 2)
        n = 5
        p.both("propose", np.full(n, int(Op.PUT)), rng.integers(0, 30, n),
               rng.integers(0, 99, n), np.arange(n) + i * 10, client_id=1, to=0)
        p.step()
    p.step(6)
    p.check_replies()
    assert p.t.replies  # commands were answered


def _put_batch(p: Pair, n: int, client: int, to=None):
    p.both("propose", ops=[Op.PUT] * n, keys=list(range(n)),
           vals=[k * 7 for k in range(n)], cmd_ids=list(range(n)),
           client_id=client, to=to)


def _boot5(q1: int, q2: int) -> Pair:
    p = Pair(dict(GOLDEN, q1=q1, q2=q2))
    p.both("elect", 0)
    p.step(3)
    assert bool(p.t.cs.states.prepared[0])
    return p


def test_commit_at_q2_survives_majority_loss():
    """n = 5, (q1, q2) = (4, 2): three non-leaders dead, 2 live < the
    majority, and a q2-sized vote set still commits every PUT."""
    p = _boot5(4, 2)
    for r in (2, 3, 4):
        p.both("kill", r)
    _put_batch(p, 8, client=1)
    p.step(6)
    p.check_replies()
    assert len(p.t.replies) == 8
    assert all(p.t.replies[(1, i)]["value"] == i * 7 for i in range(8))
    assert int(p.t.cs.states.committed_upto[0]) >= 7


def test_majority_config_stalls_where_q2_commits():
    """The control: the same scenario at (3, 3) commits nothing."""
    p = _boot5(3, 3)
    for r in (2, 3, 4):
        p.both("kill", r)
    _put_batch(p, 8, client=1)
    p.step(6)
    p.check_replies()
    assert not p.t.replies
    assert int(p.t.cs.states.committed_upto[0]) < 7


def test_leader_change_requires_q1_promises():
    """n = 5, q1 = 4: an election with three replicas alive does not
    prepare; after a fourth revives, the next Prepare round does."""
    p = Pair(dict(GOLDEN, q1=4, q2=2))
    p.both("kill", 3)
    p.both("kill", 4)
    p.both("elect", 1)
    p.step(4)
    assert not bool(p.t.cs.states.prepared[1])
    p.both("revive", 3)
    p.both("elect", 1)
    p.step(4)
    assert bool(p.t.cs.states.prepared[1])


def test_fast_path_broadcast_commits_exactly_once():
    """n = 3 fast path: unicasts put the leader's cursor ahead of the
    followers', so the broadcast batch takes the value-fingerprint
    fallback to the classic path; every proposal commits exactly once
    and the GETs read every write."""
    p = Pair(dict(n_replicas=3, window=256, inbox=512, exec_batch=128, kv_pow2=10,
                  fast_path=True), ext_rows=256)
    p.both("elect", 0)
    p.step(3)
    p.both("propose", ops=[Op.PUT] * 10, keys=list(range(10)),
           vals=[k + 100 for k in range(10)], cmd_ids=list(range(10)), client_id=1, to=0)
    p.both("propose", ops=[Op.PUT] * 10, keys=list(range(10, 20)),
           vals=[k + 100 for k in range(10, 20)], cmd_ids=list(range(10, 20)),
           client_id=1, to=-1)
    p.step(8)
    p.both("propose", ops=[Op.GET] * 20, keys=list(range(20)), vals=[0] * 20,
           cmd_ids=list(range(20, 40)), client_id=1, to=-1)
    p.step(8)
    p.check_replies()
    assert not [e for e in p.t.reply_log if e.get("duplicate")]
    for i in range(20):
        assert p.t.replies[(1, i)]["value"] == i + 100
        rep = p.t.replies[(1, 20 + i)]
        assert rep["found"] and rep["value"] == i + 100
    assert int(p.t.cs.states.committed_upto.min()) >= 39


def test_non_intersecting_config_refused():
    """q1 + q2 <= n, and a fast quorum below n, are refused before any
    step runs; certified pairs construct."""
    with pytest.raises(ValueError, match="non-intersecting"):
        Cluster(tmp.MinPaxosConfig(**dict(GOLDEN, q1=2, q2=2)), ext_rows=8, device="cpu")
    with pytest.raises(ValueError, match="q_fast"):
        Cluster(tmp.MinPaxosConfig(**dict(GOLDEN, fast_path=True, q_fast=4)),
                ext_rows=8, device="cpu")
    for q1, q2 in ((4, 2), (2, 4), (5, 1), (1, 5)):
        Cluster(tmp.MinPaxosConfig(**dict(GOLDEN, q1=q1, q2=q2)), ext_rows=8, device="cpu")
