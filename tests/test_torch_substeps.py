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

import ctypes
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


# ---- K7's launch layout (the kernel's half that runs on the CPU) ----

_PROTOCOLS = ("minpaxos", "classic", "mencius")


def _mid_exchange(protocol):
    """(state, outbox, exec result) of every replica after four steps of
    the exchange, as the plain-twin test above takes them."""
    _, tcfg = _cfgs(protocol)
    step_t = tme.mencius_step_impl if protocol == "mencius" else tmp.replica_step_impl
    rng = np.random.default_rng(3)
    st = _start(protocol, tcfg)
    st, outbox, _ = step_t(tcfg, st, tmp.MsgBatch.empty(R, M, "cpu"))
    for step in range(4):
        cols = _route(outbox, protocol, rng, step)
        inbox = tmp.MsgBatch(*[torch.from_numpy(cols[c]) for c in tmp.MsgBatch._fields])
        st, outbox, execr = step_t(tcfg, st, inbox)
    return st, outbox, execr


def _sources(protocol, narrow=False):
    """K7's sources and an ``out`` for them: the full state, or its
    ``narrow_view(st, 8, 64)`` with a report base of its own."""
    st, ob, ex = _mid_exchange(protocol)
    rb = st.window_base
    if narrow:
        st, _ = substeps.narrow_view(st, 8, 64)
        rb = rb + 3
    srcs = substeps.pack_sources(st, ob, ex, rb)
    m_out = ob.msgs.kind.shape[1]
    out = torch.empty((R, substeps.row_width(m_out, E, R)), dtype=torch.int32)
    return srcs, out


@pytest.mark.parametrize("narrow", [False, True], ids=["full", "narrow"])
@pytest.mark.parametrize("protocol", _PROTOCOLS)
def test_pack_layout_describes_every_source(protocol, narrow):
    """The layout K7 is launched with holds each source's strides, valid
    length and dtype code, as the tensors have them; the 1-byte sources
    (acked, found, prepared or status) are read as bytes."""
    srcs, out = _sources(protocol, narrow)
    lay = substeps.pack_layout(srcs, out)
    men = protocol == "mencius"
    m_out = srcs[0].shape[1]
    assert m_out > M and srcs[substeps.N_OUT_COLS - 1].shape[1] == M
    assert (lay.B, lay.Mout, lay.E, lay.R) == (R, m_out, E, R)
    assert lay.W == out.shape[1] and lay.mencius == int(men)
    assert lay.S == ((64 if narrow else SHAPE["window"]) if men else 1)
    assert len(srcs) == substeps.N_SRC
    for i, t in enumerate(srcs):
        if t is None:
            assert lay.len[i] == 0, i
            continue
        n = t.shape[1] if t.dim() == 2 else 1
        cap = m_out if i < substeps.N_OUT_COLS else (E if i < substeps.N_COLS else n)
        assert lay.len[i] == min(n, cap), i
        assert lay.sb[i] == t.stride(0), i
        assert lay.si[i] == (t.stride(1) if t.dim() == 2 else 0), i
        assert lay.dt[i] == (1 if t.dtype in (torch.uint8, torch.bool) else 0), i
        assert t.dtype in (torch.int32, torch.uint8, torch.bool), i
    one_byte = [substeps.N_OUT_COLS - 1, substeps.N_OUT_COLS + substeps.EXEC_COLS.index("found")]
    one_byte.append(substeps.SRC_STATUS if men else substeps.SRC_PEER_COMMITS - 7)
    for i in one_byte:
        assert srcs[i].element_size() == 1 and lay.dt[i] == 1, i
    assert lay.len[substeps.N_OUT_COLS - 1] == srcs[substeps.N_OUT_COLS - 1].shape[1]
    if men:
        status = srcs[substeps.SRC_STATUS]
        assert lay.sb[substeps.SRC_STATUS] == SHAPE["window"] and lay.si[substeps.SRC_STATUS] == 1
        assert lay.len[substeps.SRC_STATUS] == status.shape[1] == lay.S
        # leader_id and prepared: no source; the kernel reads -1 and 1
        assert srcs[26] is None and srcs[27] is None
    else:
        assert all(srcs[i] is None for i in (31, 32, 33, substeps.SRC_STATUS))


def _changed(srcs, change):
    """``srcs`` with one layout input changed."""
    s = list(srcs)
    acked = substeps.N_OUT_COLS - 1
    if change == "stride":  # the same values, column-major
        s[0] = s[0].t().contiguous().t()
    elif change == "length":
        s[acked] = s[acked][:, :-1]
    elif change == "dtype":
        s[acked] = s[acked].to(torch.int32)
    elif change == "dtype_one_byte":  # bool to uint8: the same layout
        s[acked] = s[acked].to(torch.uint8)
    elif change == "report_base_stride":
        s[21] = torch.stack([s[21], s[21]], 1)[:, 0]
    elif change == "device":
        s[5] = s[5].to("meta")
    elif change == "protocol":
        s = list(_sources("mencius")[0])
    elif change == "narrow":
        s = list(_sources("mencius", narrow=True)[0])
    return tuple(s)


@pytest.mark.parametrize("change", ["stride", "length", "dtype", "dtype_one_byte",
                                    "report_base_stride", "device", "protocol", "narrow"])
def test_layout_key_changes_with_each_layout_input(change):
    """A changed stride, valid length, dtype, report base layout, device,
    protocol or narrow view gives another cache key, so the launch never
    reuses a stale layout; sources with equal metadata (a copy of every
    tensor with its strides, whose pointers differ) share one, since a launch rewrites
    every pointer. A MinPaxos narrow view reads no slot field, so it
    shares the full window's layout; a Mencius one reads status."""
    srcs, out = _sources("mencius" if change == "narrow" else "minpaxos")
    key = substeps.layout_key(srcs, out)
    if change == "narrow":
        assert substeps.layout_key(*_sources("minpaxos", narrow=True)) == \
            substeps.layout_key(*_sources("minpaxos"))
    copy = tuple(None if t is None else torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype).copy_(t) for t in srcs)
    assert substeps.layout_key(copy, out.clone()) == key
    assert substeps.layout_key(_changed(srcs, change), out) != key
    if change not in ("dtype_one_byte", "device", "protocol", "narrow"):
        assert bytes(substeps.pack_layout(_changed(srcs, change), out)) != bytes(
            substeps.pack_layout(srcs, out))


def _fake_cuda(t):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cuda")


@pytest.mark.parametrize("protocol", _PROTOCOLS)
def test_launcher_never_serves_a_cuda_layout_to_another_device(protocol):
    """A layout cached for CUDA sources (fake tensors: metadata only) is
    served again for CUDA sources of the same layout, and never for the
    same layout on the CPU, nor for a mix: those raise and cache nothing."""
    srcs, out = _sources(protocol)
    cuda = tuple(None if t is None else _fake_cuda(t) for t in srcs)
    launch = substeps._Launcher()
    hit = launch.entry(cuda, _fake_cuda(out))
    assert launch.entry(cuda, _fake_cuda(out)) is hit
    assert bytes(hit[0]) == bytes(substeps.pack_layout(srcs, out))
    assert hit[2:] == (ctypes.addressof(hit[0]), ctypes.addressof(hit[1]))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        launch.entry(srcs, out)
    mixed = list(cuda)
    mixed[3] = srcs[3]
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        launch.entry(tuple(mixed), _fake_cuda(out))
    assert len(launch.layouts) == 1


def _jax_pack_rows(case, s, r):
    """JAX's pack_outputs, row by row (vmap), on a ``pack_cases`` case."""
    import collections

    from minpaxos_tpu.ops.substeps import pack_outputs as jax_pack

    keys = [k for k in case if k not in ("msgs", "dst", "acked", "kv_dropped")
            and not k.startswith("exec_")]
    St = collections.namedtuple("St", keys + ["kv"])
    Kv = collections.namedtuple("Kv", ["dropped"])
    Ob = collections.namedtuple("Ob", ["msgs", "dst", "acked"])
    Ex = collections.namedtuple("Ex", list(tmp.ExecResult._fields))
    st = St(**{k: jnp.asarray(case[k]) for k in keys}, kv=Kv(jnp.asarray(case["kv_dropped"])))
    ob = Ob(JaxMsgBatch(*[jnp.asarray(c) for c in case["msgs"]]),
            jnp.asarray(case["dst"]), jnp.asarray(case["acked"]))
    ex = Ex(*[jnp.asarray(case[f"exec_{f}"]) for f in Ex._fields])
    return jax.vmap(jax_pack)(st, ob, ex)


@pytest.mark.parametrize("r", [1, 5, 32])
@pytest.mark.parametrize("name", list(substeps.PACK_CASES))
def test_pack_cases_plain_twin_matches_jax(name, r):
    """The card tests' and chip_smoke.py's K7 inputs: the plain twin
    equals JAX's pack_outputs row by row, at R = 1, 5 and 32 (the
    peer-commit reduction's edges); the edge rows reach every rel edge
    and both values of work_pending."""
    b, s, m_out, m_in, e = 42, 64, 40, 30, 9
    case = substeps.pack_cases(np.random.default_rng(r), b, s, r, m_out, m_in, e,
                               names=(name,))[name]
    st, ob, ex = substeps.pack_case_tensors(case, "cpu")
    o_t, e_t, s_t, pc_t = substeps.unpack(substeps.pack_outputs(st, ob, ex).numpy(), e, r)
    o_j, e_j, s_j = _jax_pack_rows(case, s, r)
    np.testing.assert_array_equal(o_t, np.asarray(o_j))
    np.testing.assert_array_equal(e_t, np.asarray(e_j))
    np.testing.assert_array_equal(s_t, np.asarray(s_j))
    np.testing.assert_array_equal(pc_t, case["peer_commits"])
    if name == "mencius_edges":
        cs, me = case["commit_sent"], case["me"]
        rel = cs + 1 + (me - cs - 1) % r - case["window_base"]
        assert set(rel.tolist()) == {-7, -1, 0, 1, s - 1, s, s + 5}
        assert set(s_t[:, substeps.SCAL_WORK_PENDING].tolist()) == {0, 1}
        assert (case["tk_anchor"] == -1).any() and (case["tk_anchor"] >= 0).any()
