"""The port's batched Mencius step against the JAX step vmapped over replicas.

Both start from one state (built in numpy, carried into the port with
``from_numpy_state``) and consume the same seeded random inboxes — every
message kind Mencius reads, owner-plausible ACCEPTs, range acks, SKIPs,
PREPARE_INST sweeps and the answers to the replicas' own takeovers,
instances around the window — each evolving its own state. After every
step every leaf of the state, the outbox (rows, dst, acked) and the exec
result must be equal (integers: tolerance 0). Two crafted phases make
step 11 execute past a blocked slot and make takeover answers count.
Two scenarios of ``tests/test_mencius.py`` run through both packages'
``MenciusCluster`` and their states are compared after every round.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.mencius import MenciusCluster as JaxMencius
from minpaxos_tpu.models.mencius import init_mencius as jax_init
from minpaxos_tpu.models.mencius import mencius_step_impl as jax_step
from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.models.minpaxos import MsgBatch as JaxMsgBatch
from minpaxos_tpu_torch.models import mencius as tmc
from minpaxos_tpu_torch.models import minpaxos as tmp
from minpaxos_tpu_torch.models.cluster import to_numpy_state
from minpaxos_tpu_torch.wire.messages import MsgKind, Op

torch.set_num_threads(1)

GOLDEN = dict(n_replicas=5, window=64, inbox=32, exec_batch=16, kv_pow2=8,
              catchup_rows=8, recovery_rows=8, noop_delay=2, retention=16)
# bench.py mencius_64k per group; inbox rows = inbox + ext_rows
DEPLOY = dict(n_replicas=5, window=4096, inbox=2048, exec_batch=320, kv_pow2=14,
              catchup_rows=128, recovery_rows=64, noop_delay=8)
KINDS = [0, int(MsgKind.PROPOSE), int(MsgKind.ACCEPT), int(MsgKind.ACCEPT),
         int(MsgKind.ACCEPT_REPLY), int(MsgKind.ACCEPT_REPLY), int(MsgKind.SKIP),
         int(MsgKind.COMMIT), int(MsgKind.COMMIT), int(MsgKind.PREPARE_INST),
         int(MsgKind.PREPARE_INST_REPLY), int(MsgKind.PREPARE_INST_REPLY)]
BALLOTS = [-1, 0, 0, 0, 17, 18, 33]


def _start_state(cfg, ids):
    return jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[jax_init(cfg, int(i)) for i in ids])


def _inbox(rng, st, r, m, s, span, ooo=False):
    """Seeded random rows around each replica's window (its first
    ``span`` slots past the frontier when ``span`` < S), frontier and
    takeover; SKIP ranges a few owned slots long. With ``ooo``: an
    ACCEPT for the slot after the frontier and COMMITs of distinct new
    keys for the six slots after it."""
    b = len(np.asarray(st.me))
    kind = rng.choice(KINDS, (b, m)).astype(np.int32)
    src = rng.integers(0, r, (b, m)).astype(np.int32)
    src[kind == int(MsgKind.PROPOSE)] = -1
    wb = np.asarray(st.window_base)[:, None]
    crt = np.asarray(st.crt_inst)[:, None]
    upto = np.asarray(st.committed_upto)[:, None]
    lo = wb if span >= s else upto + 1
    inst = np.where(rng.random((b, m)) < 0.5,
                    lo + rng.integers(-3, span + 3, (b, m)),
                    crt + rng.integers(-6, 3, (b, m))).astype(np.int32)
    owned = (kind == int(MsgKind.ACCEPT)) & (rng.random((b, m)) < 0.7)
    inst = np.where(owned, inst - np.mod(inst, r) + src, inst).astype(np.int32)
    ballot = rng.choice(BALLOTS, (b, m)).astype(np.int32)
    tb = np.asarray(st.takeover_ballot)[:, None]
    lc = np.where(rng.random((b, m)) < 0.3, rng.choice(BALLOTS, (b, m)),
                  crt + rng.integers(-8, 2, (b, m))).astype(np.int32)
    # takeover answers: PIRs tagged with the replica's own sweep ballot
    # for the blocked range
    pir = (kind == int(MsgKind.PREPARE_INST_REPLY)) & (rng.random((b, m)) < 0.7)
    lc = np.where(pir, tb, lc).astype(np.int32)
    skip = kind == int(MsgKind.SKIP)
    lc = np.where(skip, inst - rng.integers(0, 4 * r, (b, m)), lc).astype(np.int32)
    inst = np.where(pir, upto + 1 + rng.integers(0, 6, (b, m)), inst).astype(np.int32)
    cols = dict(
        kind=kind, src=src, ballot=ballot, inst=inst, last_committed=lc,
        op=rng.integers(0, 4, (b, m)).astype(np.int32),
        key_hi=rng.integers(0, 2, (b, m)).astype(np.int32),
        key_lo=rng.integers(0, 12, (b, m)).astype(np.int32),
        val_hi=rng.integers(-3, 3, (b, m)).astype(np.int32),
        val_lo=rng.integers(-1000, 1000, (b, m)).astype(np.int32),
        cmd_id=rng.integers(0, 6, (b, m)).astype(np.int32),
        client_id=rng.integers(0, 3, (b, m)).astype(np.int32))
    # a run of COMMIT rows past each frontier, so slots commit
    # contiguously and execution and the window slide run
    n = 7
    cols["kind"][:, :n] = int(MsgKind.COMMIT)
    cols["inst"][:, :n] = upto + 1 + np.arange(n)
    cols["ballot"][:, :n] = 0
    if ooo:
        # slot upto+1 only ACCEPTED (blocked), upto+2.. committed with
        # fresh keys: they execute out of order
        cols["kind"][:, 0] = int(MsgKind.ACCEPT)
        cols["src"][:, 0] = np.mod(upto[:, 0] + 1, r)
        cols["key_hi"][:, :n] = 5
        cols["key_lo"][:, :n] = 100 + np.arange(n) + 10 * np.asarray(st.tick)[:, None]
        cols["op"][:, :n] = int(Op.PUT)
    return JaxMsgBatch(**cols)


def _assert_same(jax_tree, torch_tree, what):
    for name, a, b in zip(type(torch_tree)._fields, jax_tree, torch_tree):
        if hasattr(b, "_fields"):
            _assert_same(a, b, f"{what}.{name}")
            continue
        a = np.asarray(a)
        b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if b.dtype != a.dtype:  # votes/pvotes: int32 in the port
            b = b.astype(a.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("shape,ids,steps,span", [
    (GOLDEN, range(5), 16, 64),
    (DEPLOY, (0, 2, 4), 3, 256),
], ids=["golden", "deployment"])
def test_step_matches_jax_leaf_for_leaf(shape, ids, steps, span):
    r, s = shape["n_replicas"], shape["window"]
    m = shape["inbox"] + (8 if s == 64 else 64)
    jcfg = JaxCfg(**shape, gate_exec=False)
    tcfg = tmp.MinPaxosConfig(**shape, gate_exec=False)
    step = jax.jit(jax.vmap(functools.partial(jax_step, jcfg)))
    js = jax.tree_util.tree_map(jnp.asarray, _start_state(jcfg, ids))
    ts = tmp.from_numpy_state(jax.tree_util.tree_map(np.asarray, js), device="cpu",
                              cls=tmc.MenciusState)
    rng = np.random.default_rng(11 + s)
    ooo_runs = takeover_votes = 0
    for i in range(steps):
        inbox = _inbox(rng, js, r, m, s, span, ooo=i % 3 == 1)
        js, jout, jex = step(js, jax.tree_util.tree_map(jnp.asarray, inbox))
        ts, tout, tex = tmc.mencius_step_impl(
            tcfg, ts, tmp.MsgBatch(*[torch.from_numpy(c) for c in inbox]))
        _assert_same(js, tmp.to_numpy_state(ts), f"step {i} state")
        _assert_same(jout.msgs, tout.msgs, f"step {i} outbox")
        np.testing.assert_array_equal(np.asarray(jout.dst), tout.dst.numpy())
        np.testing.assert_array_equal(np.asarray(jout.acked), tout.acked.numpy())
        _assert_same(jex, tex, f"step {i} exec")
        ex = np.asarray(js.executed)
        rel = np.asarray(js.executed_upto - js.window_base)
        ooo_runs += sum(int(ex[j, max(rel[j] + 1, 0):].any()) for j in range(len(ids)))
        me_bit = (1 << np.asarray(js.me)).astype(np.uint16)[:, None]
        takeover_votes += int(((np.asarray(js.pvotes) & ~me_bit) != 0).any())
    assert int(np.asarray(js.executed_upto).max()) >= 0
    assert ooo_runs > 0  # some slot executed past a blocked one
    if s == 64:
        assert takeover_votes > 0  # peers' phase-1 answers counted
        assert int(np.asarray(js.window_base).max()) > 0  # the window slid


def _cfg(**kw):
    base = dict(n_replicas=3, window=256, inbox=512, exec_batch=128, kv_pow2=10,
                catchup_rows=64, recovery_rows=32, noop_delay=4)
    base.update(kw)
    return JaxCfg(**base), tmp.MinPaxosConfig(**base)


def _run_both(jc, tc, rounds):
    for i in range(rounds):
        jc.step()
        tc.step()
        want = jax.tree_util.tree_map(np.asarray, jc.cs)
        got = to_numpy_state(tc.cs)
        _assert_same(want.states, got.states, f"round {i} state")
        _assert_same(want.pending, got.pending, f"round {i} pending")
    assert tc.replies == jc.replies
    assert tc.reply_log == jc.reply_log


def test_out_of_order_execution_past_blocked_slot():
    """tests/test_mencius.py's scenario: owner 1 dead, takeover off;
    slots past the blocked one execute early, in both packages alike."""
    jcfg, tcfg = _cfg(noop_delay=1000)
    jc, tc = JaxMencius(jcfg, ext_rows=128), tmc.MenciusCluster(tcfg, ext_rows=128,
                                                                 device="cpu")
    n = 10
    for c in (jc, tc):
        c.kill(1)
        c.propose(ops=[Op.PUT] * n, keys=np.arange(n), vals=np.arange(n) + 7,
                  cmd_ids=np.arange(n), client_id=1, to=0)
    _run_both(jc, tc, 8)
    st = to_numpy_state(tc.cs).states
    assert int(st.committed_upto[0]) < 3 * (n - 1)  # the frontier is blocked
    assert len(tc.replies) >= 1


def test_dead_owner_takeover_unblocks_frontier():
    """tests/test_mencius.py's scenario: owner 1 dead; its successor
    takes its slots over with no-op fills and the frontier moves on."""
    jcfg, tcfg = _cfg()
    jc, tc = JaxMencius(jcfg, ext_rows=128), tmc.MenciusCluster(tcfg, ext_rows=128,
                                                                 device="cpu")
    n = 15
    for c in (jc, tc):
        c.kill(1)
        c.propose(ops=[Op.PUT] * n, keys=np.arange(n), vals=np.arange(n) * 5,
                  cmd_ids=np.arange(n), client_id=1, to=0)
        c.propose(ops=[Op.PUT] * n, keys=np.arange(n) + 50, vals=np.arange(n) * 11,
                  cmd_ids=np.arange(n) + 50, client_id=2, to=2)
    _run_both(jc, tc, 30)
    st = to_numpy_state(tc.cs).states
    assert int(st.committed_upto[0]) >= 3 * (n - 1)
    assert len(tc.replies) == 2 * n
    assert not [e for e in tc.reply_log if e.get("duplicate")]


def test_mencius_cluster_has_no_leader():
    _, tcfg = _cfg()
    c = tmc.MenciusCluster(tcfg, device="cpu")
    with pytest.raises(ValueError):
        c.elect(0)
    with pytest.raises(ValueError):
        c.propose([1], [1], [1], [1], client_id=1)
