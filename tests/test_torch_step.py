"""The port's batched replica step against the JAX step vmapped over replicas.

Both start from one state (built in numpy, carried into the port with
``from_numpy_state``) and consume the same seeded random inboxes — every
message kind, ballots around the current one, instances around the
window — for several steps, each evolving its own state. After every
step every leaf of the state, the outbox (rows, dst, acked) and the exec
result must be equal (integers: tolerance 0), for MinPaxos and classic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.models.minpaxos import MsgBatch as JaxMsgBatch
from minpaxos_tpu.models.minpaxos import init_replica as jax_init
from minpaxos_tpu.models.minpaxos import replica_step_impl as jax_step
from minpaxos_tpu.models.paxos import classic_config as jax_classic
from minpaxos_tpu_torch.models import minpaxos as tmp
from minpaxos_tpu_torch.models.paxos import classic_config as torch_classic
from minpaxos_tpu_torch.wire.messages import MsgKind

torch.set_num_threads(1)

SHAPE = dict(n_replicas=5, window=32, inbox=24, exec_batch=8, kv_pow2=5,
             catchup_rows=4, recovery_rows=4, noop_delay=3, retention=4)
R, M, STEPS = 5, 24, 14
KINDS = [0, int(MsgKind.PROPOSE), int(MsgKind.PREPARE), int(MsgKind.PREPARE_REPLY),
         int(MsgKind.ACCEPT), int(MsgKind.ACCEPT), int(MsgKind.ACCEPT_REPLY),
         int(MsgKind.ACCEPT_REPLY), int(MsgKind.COMMIT), int(MsgKind.COMMIT_SHORT),
         int(MsgKind.PREPARE_INST), int(MsgKind.PREPARE_INST_REPLY)]
BALLOTS = [-1, 0, 16, 16, 16, 17, 32]


def _start_state(cfg):
    """Replica 0 leads at ballot 16 and is prepared; everyone follows."""
    st = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[jax_init(cfg, i) for i in range(R)])
    st = st._replace(
        default_ballot=np.full(R, 16, np.int32),
        max_recv_ballot=np.full(R, 16, np.int32),
        leader_id=np.zeros(R, np.int32),
        prepared=np.arange(R) == 0,
        prepare_oks=np.tile(np.arange(R) < 3, (R, 1)))
    return st


def _inbox(rng, st):
    """Seeded random rows around each replica's window and ballot."""
    kind = rng.choice(KINDS, (R, M)).astype(np.int32)
    src = rng.integers(0, R, (R, M)).astype(np.int32)
    src[kind == int(MsgKind.PROPOSE)] = -1
    wb = np.asarray(st.window_base)[:, None]
    crt = np.asarray(st.crt_inst)[:, None]
    inst = np.where(rng.random((R, M)) < 0.5,
                    wb + rng.integers(-3, SHAPE["window"] + 3, (R, M)),
                    crt + rng.integers(-6, 3, (R, M))).astype(np.int32)
    ballot = rng.choice(BALLOTS, (R, M)).astype(np.int32)
    lc = np.where(rng.random((R, M)) < 0.3, rng.choice(BALLOTS, (R, M)),
                  crt + rng.integers(-8, 2, (R, M))).astype(np.int32)
    # a run of consecutive COMMIT rows past each frontier, so slots
    # commit contiguously and execution and the window slide run
    upto = np.asarray(st.committed_upto)[:, None]
    kind[:, :6] = int(MsgKind.COMMIT)
    inst[:, :6] = upto + 1 + np.arange(6)
    ballot[:, :6] = 16
    cols = dict(
        kind=kind, src=src, ballot=ballot, inst=inst, last_committed=lc,
        op=rng.integers(0, 4, (R, M)).astype(np.int32),
        key_hi=rng.integers(0, 2, (R, M)).astype(np.int32),
        key_lo=rng.integers(0, 12, (R, M)).astype(np.int32),
        val_hi=rng.integers(-3, 3, (R, M)).astype(np.int32),
        val_lo=rng.integers(-1000, 1000, (R, M)).astype(np.int32),
        cmd_id=rng.integers(0, 6, (R, M)).astype(np.int32),
        client_id=rng.integers(0, 3, (R, M)).astype(np.int32))
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


@pytest.mark.parametrize("protocol", ["minpaxos", "classic"])
def test_step_matches_jax_leaf_for_leaf(protocol):
    explicit_commit = protocol == "classic"
    jmake, tmake = ((jax_classic, torch_classic) if explicit_commit
                    else (JaxCfg, tmp.MinPaxosConfig))
    jcfg = jmake(**SHAPE, gate_exec=False)
    tcfg = tmake(**SHAPE, gate_exec=False)
    step = jax.jit(jax.vmap(functools.partial(jax_step, jcfg)))
    js = jax.tree_util.tree_map(jnp.asarray, _start_state(jcfg))
    ts = tmp.from_numpy_state(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    rng = np.random.default_rng(1 + explicit_commit)
    executed = 0
    for i in range(STEPS):
        inbox = _inbox(rng, js)
        js, jout, jex = step(js, jax.tree_util.tree_map(jnp.asarray, inbox))
        ts, tout, tex = tmp.replica_step_impl(
            tcfg, ts, tmp.MsgBatch(*[torch.from_numpy(c) for c in inbox]))
        _assert_same(js, tmp.to_numpy_state(ts), f"step {i} state")
        _assert_same(jout.msgs, tout.msgs, f"step {i} outbox")
        np.testing.assert_array_equal(np.asarray(jout.dst), tout.dst.numpy())
        np.testing.assert_array_equal(np.asarray(jout.acked), tout.acked.numpy())
        _assert_same(jex, tex, f"step {i} exec")
        executed += int(np.asarray(jex.count).sum())
    # the scenario reached execution and the window slide
    assert executed > 0
    assert int(np.asarray(js.window_base).max()) > 0


def test_state_round_trip_keeps_jax_dtypes():
    cfg = JaxCfg(**SHAPE)
    st = _start_state(cfg)
    back = tmp.to_numpy_state(tmp.from_numpy_state(st, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(st), tmp.state_leaves(back)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
