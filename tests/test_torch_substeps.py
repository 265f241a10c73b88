"""The port's packed serving step against the JAX package's, and K7's twin.

``minpaxos_tpu_torch.runtime.replica._packed_step`` (k substeps, an
optional narrow view, everything packed into one int32 buffer by
``ops/substeps.py pack_outputs``) against
``minpaxos_tpu.runtime.replica._packed_step`` (its [k, 14, M] outbox,
[k, 6, E] exec and [k, N_SCAL] scalar stacks), for minpaxos, classic
and mencius, at k = 1, k = 3 and a narrow view at k = 1.

The states are those of a live three-replica exchange: replica 0 (every
owner, for Mencius) proposes seeded PUT/GET batches, rows route between
the replicas as the transport would deliver them, and at several points
of the exchange every replica's state and inbox go through both
functions. Integers throughout: the packed outputs, the peer-commit
tail and every state leaf must be equal exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.mencius import MenciusState as JaxMenciusState
from minpaxos_tpu.models.mencius import mencius_step_impl as jax_mencius_step
from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.models.minpaxos import MsgBatch as JaxMsgBatch
from minpaxos_tpu.models.minpaxos import ReplicaState as JaxReplicaState
from minpaxos_tpu.models.minpaxos import replica_step_impl as jax_step
from minpaxos_tpu.ops.kvstore import KVState as JaxKV
from minpaxos_tpu.runtime.replica import _packed_step as jax_packed_step
from minpaxos_tpu_torch.models import mencius as tme
from minpaxos_tpu_torch.models import minpaxos as tmp
from minpaxos_tpu_torch.ops import substeps
from minpaxos_tpu_torch.runtime.replica import _packed_step
from minpaxos_tpu_torch.wire.messages import MsgKind, Op

torch.set_num_threads(1)

SHAPE = dict(n_replicas=3, window=128, inbox=32, exec_batch=16, kv_pow2=8,
             catchup_rows=8, recovery_rows=8, gossip_ticks=1)
R, M, E = 3, 32, 16
NARROW = 32
STEPS = 10
CHECK_AT = (2, 5, 8)


def _cfgs(protocol):
    kw = dict(SHAPE, explicit_commit=protocol == "classic")
    return JaxCfg(**kw), tmp.MinPaxosConfig(**kw)


def _row(st, r):
    """Batch row r of a port state, as a B = 1 state (copies)."""
    kv = type(st.kv)(*[t[r:r + 1].clone() for t in st.kv])
    return type(st)(**{f: getattr(st, f)[r:r + 1].clone()
                       for f in st._fields if f != "kv"}, kv=kv)


def _to_jax(st):
    """A B = 1 port state -> the JAX package's single-replica state."""
    npst = tmp.to_numpy_state(st, lead_shape=())
    cls = JaxMenciusState if isinstance(st, tme.MenciusState) else JaxReplicaState
    kv = JaxKV(*[jnp.asarray(x) for x in npst.kv])
    return cls(**{f: jnp.asarray(getattr(npst, f)) for f in cls._fields
                  if f != "kv"}, kv=kv)


def _leaves_equal(port_st, jax_st, what):
    got = tmp.state_leaves(tmp.to_numpy_state(port_st, lead_shape=()))
    want = jax.tree_util.tree_leaves(jax_st)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{what}: leaf {i}")


def _proposals(rng, n, base_cmd):
    cols = {c: np.zeros(n, np.int32) for c in JaxMsgBatch._fields}
    cols["kind"][:] = int(MsgKind.PROPOSE)
    cols["src"][:] = -1
    cols["op"][:] = np.where(rng.random(n) < 0.7, int(Op.PUT), int(Op.GET))
    cols["key_lo"][:] = rng.integers(0, 24, n)
    cols["val_lo"][:] = rng.integers(1, 1 << 20, n)
    cols["cmd_id"][:] = base_cmd + np.arange(n)
    cols["client_id"][:] = 7
    return cols


def _route(outbox, protocol, rng, step):
    """Each replica's next inbox [R, M] (numpy columns): the rows its
    peers addressed to it (dst == its id, or -1 broadcast), in sender
    order, truncated to M, plus this step's client proposals."""
    kind = outbox.msgs.kind.numpy()
    dst = outbox.dst.numpy()
    cols = {c: np.zeros((R, M), np.int32) for c in JaxMsgBatch._fields}
    for q in range(R):
        rows = []
        for s in range(R):
            if s == q:
                continue
            live = (kind[s] != 0) & ((dst[s] == q) | (dst[s] == -1))
            rows.append({c: getattr(outbox.msgs, c)[s].numpy()[live]
                         for c in JaxMsgBatch._fields})
        owners = range(R) if protocol == "mencius" else (0,)
        if q in owners and step < STEPS - 3:
            rows.append(_proposals(rng, 6, 1000 * (q + 1) + 6 * step))
        fill = 0
        for part in rows:
            n = min(len(part["kind"]), M - fill)
            for c in JaxMsgBatch._fields:
                cols[c][q, fill:fill + n] = part[c][:n]
            fill += n
    return cols


def _start(protocol, tcfg):
    if protocol == "mencius":
        return tme.init_mencius(tcfg, list(range(R)), device="cpu")
    st = tmp.init_replica(tcfg, list(range(R)), device="cpu")
    # replica 0 leads at ballot 16, prepared; the others follow
    return st._replace(
        default_ballot=torch.full((R,), 16, dtype=torch.int32),
        max_recv_ballot=torch.full((R,), 16, dtype=torch.int32),
        leader_id=torch.zeros(R, dtype=torch.int32),
        prepared=torch.arange(R) == 0,
        prepare_oks=(torch.arange(R) < R)[None].expand(R, R).clone())


def _variants():
    return [(1, 0), (3, 0), (1, NARROW)]


def _compare(protocol, jcfg, tcfg, st_row, inbox_cols, k, narrow):
    step_t = tme.mencius_step_impl if protocol == "mencius" else tmp.replica_step_impl
    step_j = jax_mencius_step if protocol == "mencius" else jax_step
    s = jcfg.window
    off = 0
    if narrow:
        off = int(np.clip(int(st_row.executed_upto[0]) + 1
                          - int(st_row.window_base[0]), 0, s - narrow))
    jst = _to_jax(st_row)
    jin = JaxMsgBatch(**{c: jnp.asarray(v) for c, v in inbox_cols.items()})
    jst2, o_j, e_j, s_j = jax_packed_step(jcfg, jst, jin, step_j, k, narrow, off)
    tin = tmp.MsgBatch(*[torch.from_numpy(inbox_cols[c].copy())[None]
                         for c in tmp.MsgBatch._fields])
    tst2, buf = _packed_step(tcfg, _row(st_row, 0), tin, step_t, k, narrow, off)
    what = f"{protocol} k={k} narrow={narrow}"
    assert buf.shape[:2] == (k, 1)
    o_t, e_t, s_t, pc_t = substeps.unpack(buf[:, 0].numpy(), E, R)
    np.testing.assert_array_equal(o_t, np.asarray(o_j), err_msg=f"{what}: outbox")
    np.testing.assert_array_equal(e_t, np.asarray(e_j), err_msg=f"{what}: exec")
    np.testing.assert_array_equal(s_t, np.asarray(s_j), err_msg=f"{what}: scalars")
    np.testing.assert_array_equal(pc_t[-1], np.asarray(jst2.peer_commits),
                                  err_msg=f"{what}: peer_commits tail")
    _leaves_equal(tst2, jst2, what)
    return int(np.asarray(s_j)[:, substeps.SCAL_EXEC_COUNT].sum())


@pytest.mark.parametrize("protocol", ["minpaxos", "classic", "mencius"])
def test_packed_step_equals_jax(protocol):
    jcfg, tcfg = _cfgs(protocol)
    step_t = tme.mencius_step_impl if protocol == "mencius" else tmp.replica_step_impl
    rng = np.random.default_rng(7)
    st = _start(protocol, tcfg)
    empty = tmp.MsgBatch.empty(R, M, "cpu")
    st, outbox, _ = step_t(tcfg, st, empty)
    executed = 0
    checked = 0
    for step in range(STEPS):
        cols = _route(outbox, protocol, rng, step)
        if step in CHECK_AT:
            for r in range(R):
                row_cols = {c: v[r] for c, v in cols.items()}
                for k, narrow in _variants():
                    executed += _compare(protocol, jcfg, tcfg, _row(st, r),
                                         row_cols, k, narrow)
                    checked += 1
        inbox = tmp.MsgBatch(*[torch.from_numpy(cols[c]) for c in tmp.MsgBatch._fields])
        st, outbox, _ = step_t(tcfg, st, inbox)
    assert checked == len(CHECK_AT) * R * len(_variants())
    # the exchange really committed and executed commands
    assert int(st.executed_upto.min()) > 0
    assert executed > 0


@functools.partial(jax.jit, static_argnums=(0, 3))
def _jax_step_pack(cfg, st, inbox, step):
    from minpaxos_tpu.ops.substeps import pack_outputs as jax_pack

    st, ob, ex = step(cfg, st, inbox)
    return st, jax_pack(st, ob, ex)


def test_pack_outputs_plain_twin_matches_jax_pack_outputs():
    """``pack_outputs`` on the CPU against the JAX package's
    ``pack_outputs`` + ``_anchors`` on one mid-exchange state, for both
    state types (the anchors' MinPaxos and Mencius forms)."""
    for protocol in ("minpaxos", "mencius"):
        jcfg, tcfg = _cfgs(protocol)
        step_t = tme.mencius_step_impl if protocol == "mencius" else tmp.replica_step_impl
        step_j = jax_mencius_step if protocol == "mencius" else jax_step
        rng = np.random.default_rng(3)
        st = _start(protocol, tcfg)
        st, outbox, _ = step_t(tcfg, st, tmp.MsgBatch.empty(R, M, "cpu"))
        for step in range(4):
            cols = _route(outbox, protocol, rng, step)
            inbox = tmp.MsgBatch(*[torch.from_numpy(cols[c]) for c in tmp.MsgBatch._fields])
            st_prev = st
            st, outbox, execr = step_t(tcfg, st, inbox)
        for r in range(R):
            jst = _to_jax(_row(st_prev, r))
            jin = JaxMsgBatch(**{c: jnp.asarray(v[r]) for c, v in cols.items()})
            jst2, (o_j, e_j, s_j) = _jax_step_pack(jcfg, jst, jin, step_j)
            row = substeps.pack_outputs(
                _row(st, r), tmp.Outbox(
                    tmp.MsgBatch(*[c[r:r + 1] for c in outbox.msgs]),
                    outbox.dst[r:r + 1], outbox.acked[r:r + 1]),
                tmp.ExecResult(*[c[r:r + 1] for c in execr]))
            o_t, e_t, s_t, pc_t = substeps.unpack(row.numpy(), E, R)
            np.testing.assert_array_equal(o_t[0], np.asarray(o_j))
            np.testing.assert_array_equal(e_t[0], np.asarray(e_j))
            np.testing.assert_array_equal(s_t[0], np.asarray(s_j))
            np.testing.assert_array_equal(pc_t[0], np.asarray(jst2.peer_commits))


def test_narrow_view_selects_slot_fields_by_name():
    """At a window equal to R (here 3), a [B, R] leaf has the window's
    width; the view must still narrow only the slot fields."""
    cfg = tmp.MinPaxosConfig(n_replicas=3, window=3, inbox=4, exec_batch=2,
                             kv_pow2=4, catchup_rows=2, recovery_rows=2)
    st = tmp.init_replica(cfg, [0], device="cpu")
    view, fields = substeps.narrow_view(st, 1, 2)
    assert "peer_commits" not in fields and "prepare_oks" not in fields
    assert view.peer_commits.shape == (1, 3) and view.ballot.shape == (1, 2)
    assert int(view.window_base[0]) == 1
    ms = tme.init_mencius(cfg, [0], device="cpu")
    _, mfields = substeps.narrow_view(ms, 0, 2)
    assert "executed" in mfields and "peer_commits" not in mfields
