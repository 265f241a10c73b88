"""The port server's pipelined tick loop: equality and durability.

The port's counterparts of ``tests/test_pipeline.py``: deferring a
tick's host phases under the next tick's device work must give
byte-identical replies (content and per-connection order) and
leaf-identical device state against the strictly serial -nopipeline
order over a randomized trace, and under -durable no reply may reach
the transport before its tick's records are flushed. The test owns the
tick loop (no protocol thread, no sockets), so both runs consume the
same tick sequence; the servers step on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig, state_leaves, to_numpy_state
from minpaxos_tpu_torch.runtime.replica import CONTROL, ReplicaServer, RuntimeFlags
from minpaxos_tpu_torch.runtime.transport import FROM_CLIENT
from minpaxos_tpu_torch.wire.messages import MsgKind, Op, make_batch

torch.set_num_threads(1)

CID = 7  # the one client connection id both runs use

CFG = MinPaxosConfig(n_replicas=1, window=128, inbox=16, exec_batch=8,
                     kv_pow2=8, catchup_rows=8, recovery_rows=8,
                     gossip_ticks=1)


def _mk_server(tmp_path, name: str, pipeline: bool, durable: bool = False,
               narrow: int = 0) -> ReplicaServer:
    d = tmp_path / name
    d.mkdir()
    flags = RuntimeFlags(pipeline=pipeline, durable=durable, store_dir=str(d),
                         narrow_window=narrow, device="cpu")
    return ReplicaServer(0, [("127.0.0.1", 7077)], CFG, flags)


def _capture_replies(srv: ReplicaServer, log: list) -> None:
    srv.transport.send_client = (  # type: ignore[method-assign]
        lambda cid, kind, rows: log.append((cid, int(kind), rows.copy()))
        or True)


def _elect(srv: ReplicaServer) -> None:
    srv.queue.put((CONTROL, 0, "be_the_leader", None))
    for _ in range(20):
        if srv._drain(0.001):
            srv._become_leader()
        srv._device_tick(srv.inbox)
        if srv.snapshot["prepared"]:
            return
    raise AssertionError(f"never prepared: {srv.snapshot}")


def _trace(n_frames: int, rows: int, seed: int) -> list[np.ndarray]:
    """Randomized PROPOSE frames, unique cmd_ids, a PUT/GET mix over a
    small key space (GET replies depend on execution order)."""
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n_frames):
        ops = rng.choice([int(Op.PUT), int(Op.GET)], size=rows, p=[0.7, 0.3])
        out.append(make_batch(
            MsgKind.PROPOSE,
            cmd_id=(1000 + f * rows + np.arange(rows)).astype(np.int32),
            op=ops.astype(np.uint8),
            key=rng.integers(0, 40, rows).astype(np.int64),
            val=rng.integers(1, 1 << 20, rows).astype(np.int64),
            timestamp=0))
    return out


def _run_trace(srv: ReplicaServer, trace, extra_ticks: int = 12) -> list:
    replies: list = []
    _capture_replies(srv, replies)
    _elect(srv)
    for frame in trace:
        srv.queue.put((FROM_CLIENT, CID, MsgKind.PROPOSE, frame))
    for _ in range(3 * len(trace) + extra_ticks):
        srv._drain(0.001)
        srv._device_tick(srv.inbox)
    srv._flush_inflight()
    return replies


def _assert_replies_equal(a: list, b: list) -> None:
    assert len(a) == len(b), (len(a), len(b))
    for i, ((cid_a, kind_a, rows_a), (cid_b, kind_b, rows_b)) in enumerate(zip(a, b)):
        assert (cid_a, kind_a) == (cid_b, kind_b), i
        for f in rows_a.dtype.names:
            if f == "timestamp":
                continue  # wall-clock stamp: the one intended delta
            np.testing.assert_array_equal(rows_a[f], rows_b[f],
                                          err_msg=f"reply {i} field {f}")


def test_pipelined_equals_serial_over_randomized_trace(tmp_path):
    trace = _trace(n_frames=6, rows=CFG.inbox, seed=11)
    srv_p = _mk_server(tmp_path, "pipe", pipeline=True)
    srv_s = _mk_server(tmp_path, "serial", pipeline=False)
    try:
        rep_p = _run_trace(srv_p, trace)
        rep_s = _run_trace(srv_s, trace)
        assert srv_p.stats["pipelined_ticks"] > 0, srv_p.stats
        assert srv_s.stats["pipelined_ticks"] == 0, srv_s.stats
        n_cmds = sum(len(rep[2]["cmd_id"]) for rep in rep_p
                     if rep[1] == int(MsgKind.PROPOSE_REPLY))
        assert n_cmds == 6 * CFG.inbox
        _assert_replies_equal(rep_p, rep_s)
        assert srv_p.snapshot == srv_s.snapshot
        for leaf_p, leaf_s in zip(state_leaves(to_numpy_state(srv_p.state)),
                                  state_leaves(to_numpy_state(srv_s.state))):
            np.testing.assert_array_equal(leaf_p, leaf_s)
        for key in ("dispatches", "full_steps", "fused_dispatches",
                    "narrow_steps", "proposals", "executed"):
            assert srv_p.stats[key] == srv_s.stats[key], key
        # the durable mirrors agree too
        assert (srv_p.store.read_range(0, 1 << 20).tobytes()
                == srv_s.store.read_range(0, 1 << 20).tobytes())
    finally:
        srv_p.store.close()
        srv_s.store.close()


def test_durable_no_reply_precedes_its_ticks_fsync(tmp_path):
    srv = _mk_server(tmp_path, "durable", pipeline=True, durable=True)
    dirty = [False]
    violations = []
    store = srv.store
    orig_slots, orig_front = store.append_slots, store.append_frontier
    orig_flush = store.flush

    def slots(*a, **kw):
        dirty[0] = True
        return orig_slots(*a, **kw)

    def front(committed_upto):
        if committed_upto > store.frontier:
            dirty[0] = True
        return orig_front(committed_upto)

    def flush():
        dirty[0] = False
        return orig_flush()

    store.append_slots, store.append_frontier = slots, front
    store.flush = flush

    def send_client(cid, kind, rows):
        if dirty[0]:
            violations.append((cid, int(kind), rows["cmd_id"].tolist()))
        return True

    srv.transport.send_client = send_client  # type: ignore[method-assign]
    try:
        _elect(srv)
        for frame in _trace(n_frames=4, rows=CFG.inbox, seed=23):
            srv.queue.put((FROM_CLIENT, CID, MsgKind.PROPOSE, frame))
        for _ in range(24):
            srv._drain(0.001)
            srv._device_tick(srv.inbox)
        srv._flush_inflight()
        assert violations == []
        assert srv.stats["pipelined_ticks"] > 0
        assert srv.stats["executed"] == 4 * CFG.inbox
    finally:
        srv.store.close()


def test_durable_crash_point_loses_reply_and_persist_together(tmp_path):
    """A crash between a tick's dispatch and its deferred host phases
    loses the replies and the persist together, never the reply alone."""
    srv = _mk_server(tmp_path, "crash", pipeline=True, durable=True)
    replies: list = []
    _capture_replies(srv, replies)
    flushes = [0]
    orig_flush = srv.store.flush
    srv.store.flush = lambda: flushes.__setitem__(0, flushes[0] + 1) or orig_flush()
    try:
        _elect(srv)
        n_before, f_before = len(replies), flushes[0]
        for frame in _trace(n_frames=2, rows=CFG.inbox, seed=31):
            srv.queue.put((FROM_CLIENT, CID, MsgKind.PROPOSE, frame))
        srv._drain(0.001)
        srv._device_tick(srv.inbox)
        assert srv._inflight is not None  # host phases pending
        assert len(replies) == n_before
        assert flushes[0] == f_before
        srv._inflight = None
    finally:
        srv.store.close()


def test_narrow_view_dispatches_equal_full_width(tmp_path):
    """Narrow-view dispatches happen on ordinary traffic, the anchor
    validation never falls back, and replies and state equal a server
    without the view."""
    trace = _trace(n_frames=3, rows=CFG.inbox, seed=17)
    srv_n = _mk_server(tmp_path, "narrow", pipeline=True, narrow=32)
    srv_f = _mk_server(tmp_path, "full", pipeline=True)
    try:
        rep_n = _run_trace(srv_n, trace, extra_ticks=9)
        rep_f = _run_trace(srv_f, trace, extra_ticks=9)
        assert srv_n.stats["narrow_steps"] > 0, srv_n.stats
        assert srv_n.stats["narrow_fallbacks"] == 0, srv_n.stats
        assert srv_n.stats["executed"] == 3 * CFG.inbox
        _assert_replies_equal(rep_n, rep_f)
        for leaf_n, leaf_f in zip(state_leaves(to_numpy_state(srv_n.state)),
                                  state_leaves(to_numpy_state(srv_f.state))):
            np.testing.assert_array_equal(leaf_n, leaf_f)
    finally:
        srv_n.store.close()
        srv_f.store.close()
