"""Message kinds and frame schemas: the wire vocabulary.

The port's own copy of the JAX package's ``wire/messages.py``: the same
``Op`` and ``MsgKind`` values, the same structured row dtypes in the
same field order (the values and layouts are the wire contract, so a
port server and a JAX-package client, or the reverse, speak one
protocol). A frame carries N rows of one kind as a packed numpy
structured buffer; ``wire/codec.py`` frames it.
"""

from __future__ import annotations

import enum

import numpy as np


class Op(enum.IntEnum):
    """KV command opcodes."""

    NONE = 0
    PUT = 1
    GET = 2
    DELETE = 3
    RLOCK = 4
    WLOCK = 5


class MsgKind(enum.IntEnum):
    """Frame opcodes. Fixed forever; append-only."""

    # client <-> replica
    PROPOSE = 1
    PROPOSE_REPLY = 2
    READ = 3
    READ_REPLY = 4
    PROPOSE_AND_READ = 5
    PROPOSE_AND_READ_REPLY = 6
    BEACON = 7
    BEACON_REPLY = 8

    # replica <-> replica: global-ballot MinPaxos messages
    PREPARE = 16
    PREPARE_REPLY = 17
    ACCEPT = 18
    ACCEPT_REPLY = 19
    COMMIT = 20
    COMMIT_SHORT = 21

    # classic per-instance Paxos extras
    PREPARE_INST = 24
    PREPARE_INST_REPLY = 25

    # Mencius extras
    SKIP = 28

    # per-command trace context (client -> replica, ahead of the
    # PROPOSE it describes); the port's server ignores it
    TRACE_CTX = 32

    # snapshot catch-up: SNAP_META announces one transfer (frontier +
    # row count), SNAP_ROWS carries its live KV pairs
    SNAP_META = 33
    SNAP_ROWS = 34

    # connection handshake pseudo-kinds (raw bytes, never frames)
    HANDSHAKE_CLIENT = 120
    HANDSHAKE_PEER = 121


# Log-slot statuses (minpaxosproto.go:8-15 plus EXECUTED).
NONE, PREPARING, PREPARED, ACCEPTED, COMMITTED, EXECUTED = range(6)


# Command columns shared by every frame that carries commands. 1 + 8 + 8
# bytes — the reference's fixed 17-byte Command (statemarsh.go:8-21) —
# plus client bookkeeping for exactly-once replies.
_CMD_FIELDS = [
    ("op", "u1"),
    ("key", "<i8"),
    ("val", "<i8"),
    ("cmd_id", "<i4"),
    ("client_id", "<i4"),
]

SCHEMAS: dict[MsgKind, np.dtype] = {
    # Propose{CommandId, Command, Timestamp} — genericsmrproto.go:20-24.
    MsgKind.PROPOSE: np.dtype(
        [("cmd_id", "<i4"), ("op", "u1"), ("key", "<i8"), ("val", "<i8"),
         ("timestamp", "<i8")]),
    # ProposeReplyTS{OK, CommandId, Value, Timestamp, Leader} —
    # genericsmrproto.go:31-37 (Leader enables client re-routing).
    MsgKind.PROPOSE_REPLY: np.dtype(
        [("ok", "u1"), ("cmd_id", "<i4"), ("val", "<i8"),
         ("timestamp", "<i8"), ("leader", "i1")]),
    # Read / ReadReply — genericsmrproto.go:39-46 (parsed-but-dropped in
    # the reference, genericsmr.go:470-477; implemented here).
    MsgKind.READ: np.dtype([("cmd_id", "<i4"), ("key", "<i8")]),
    MsgKind.READ_REPLY: np.dtype([("cmd_id", "<i4"), ("val", "<i8")]),
    MsgKind.PROPOSE_AND_READ: np.dtype(
        [("cmd_id", "<i4"), ("op", "u1"), ("key", "<i8"), ("val", "<i8")]),
    MsgKind.PROPOSE_AND_READ_REPLY: np.dtype(
        [("ok", "u1"), ("cmd_id", "<i4"), ("val", "<i8")]),
    # Beacon{Rid, Timestamp} — genericsmrproto.go:63-69.
    MsgKind.BEACON: np.dtype([("rid", "i1"), ("timestamp", "<u8")]),
    MsgKind.BEACON_REPLY: np.dtype([("rid", "i1"), ("timestamp", "<u8")]),
    # Prepare{LeaderId, Ballot, LastCommitted} — minpaxosproto.go:48-54
    # (global ballot: ONE prepare covers all instances).
    MsgKind.PREPARE: np.dtype(
        [("leader_id", "i1"), ("ballot", "<i4"), ("last_committed", "<i4")]),
    # PrepareReply — minpaxosproto.go:56-64. The reference piggybacks an
    # in-flight instance + CatchUpLog; here those travel as ACCEPT rows
    # in the same frame batch, so the reply itself is scalar columns.
    MsgKind.PREPARE_REPLY: np.dtype(
        [("id", "i1"), ("ok", "u1"), ("ballot", "<i4"),
         ("last_committed", "<i4"), ("crt_instance", "<i4")]),
    # Accept — minpaxosproto.go:66-73. One row accepts one slot; a
    # frame of rows is the reference's batched Accept + CatchUpLog.
    MsgKind.ACCEPT: np.dtype(
        [("leader_id", "i1"), ("inst", "<i4"), ("ballot", "<i4"),
         ("last_committed", "<i4")] + _CMD_FIELDS),
    # AcceptReply{Instance, OK, Ballot, Id} — minpaxosproto.go:75-80,
    # extended with count (this repo's wire extension, modeled on the
    # reference's CommitShort{Instance, Count} range message,
    # paxosproto.go:50-54) so one row acks [inst, inst+count).
    MsgKind.ACCEPT_REPLY: np.dtype(
        [("id", "i1"), ("ok", "u1"), ("inst", "<i4"), ("count", "<i4"),
         ("ballot", "<i4"), ("last_committed", "<i4")]),
    # Commit (with command rows) / CommitShort (range only) —
    # minpaxosproto.go:82-94. last_committed piggybacks the sender's
    # commit frontier honestly (the host catch-up path claims its real
    # frontier; without the field, inbound COMMIT rows fabricated a
    # frontier-0 claim). Note a just-elected leader's lc gate
    # (models/minpaxos.py, ballot >= default_ballot) ignores claims at
    # old ballots — COMMIT answers to its PREPARE_INST sweep heal via
    # the direct COMMITTED install in step 3, not via this field.
    MsgKind.COMMIT: np.dtype(
        [("leader_id", "i1"), ("inst", "<i4"), ("ballot", "<i4"),
         ("last_committed", "<i4")] + _CMD_FIELDS),
    MsgKind.COMMIT_SHORT: np.dtype(
        [("leader_id", "i1"), ("inst", "<i4"), ("count", "<i4"),
         ("ballot", "<i4")]),
    # Classic paxos per-instance Prepare{LeaderId, Instance, Ballot,
    # ToInfinity} — paxosproto.go:16-21.
    MsgKind.PREPARE_INST: np.dtype(
        [("leader_id", "i1"), ("inst", "<i4"), ("ballot", "<i4"),
         ("to_infinity", "u1")]),
    MsgKind.PREPARE_INST_REPLY: np.dtype(
        [("id", "i1"), ("ok", "u1"), ("inst", "<i4"), ("ballot", "<i4"),
         ("vballot", "<i4")] + _CMD_FIELDS),
    # Mencius Skip{LeaderId, StartInstance, EndInstance} —
    # menciusproto.go:7-11.
    MsgKind.SKIP: np.dtype(
        [("leader_id", "i1"), ("start_inst", "<i4"), ("end_inst", "<i4")]),
    # trace context: trace id + the client's origin wall-clock ns,
    # one row per sampled command
    MsgKind.TRACE_CTX: np.dtype(
        [("cmd_id", "<i4"), ("trace_id", "<i8"),
         ("origin_wall_ns", "<i8")]),
    # snapshot catch-up announcement: the sender's snapshot frontier,
    # how many SNAP_ROWS rows follow for it, and the sender id. One
    # row per transfer; the receiver assembles rows keyed by
    # (frontier, count) and installs only a COMPLETE set that is ahead
    # of its own committed frontier.
    MsgKind.SNAP_META: np.dtype(
        [("leader_id", "i1"), ("frontier", "<i4"), ("count", "<i4"),
         ("seq", "<i4")]),
    # one live KV pair of the snapshot at ``frontier`` (the frontier
    # repeats per row so a reordered/interleaved stream can't splice
    # rows from two different snapshots into one install)
    MsgKind.SNAP_ROWS: np.dtype(
        [("frontier", "<i4"), ("key", "<i8"), ("val", "<i8")]),
}


def schema(kind: MsgKind) -> np.dtype:
    try:
        return SCHEMAS[MsgKind(kind)]
    except KeyError:
        # e.g. HANDSHAKE_* pseudo-kinds: raw single bytes exchanged
        # before framed streaming starts, never valid as frames.
        raise ValueError(f"no frame schema for kind {kind}") from None


def empty_batch(kind: MsgKind, n: int = 0) -> np.ndarray:
    """A zeroed structured array of n rows of the given kind."""
    return np.zeros(n, dtype=schema(kind))


def make_batch(kind: MsgKind, **cols) -> np.ndarray:
    """Build a structured batch from column arrays (broadcast scalars).

    >>> make_batch(MsgKind.ACCEPT, inst=np.arange(4), ballot=3, op=1,
    ...            key=np.arange(4), val=0, cmd_id=0, client_id=0,
    ...            leader_id=0, last_committed=-1)
    """
    dt = schema(kind)
    n = 1
    for v in cols.values():
        a = np.asarray(v)
        if a.ndim > 0:
            n = max(n, a.shape[0])
    out = np.zeros(n, dtype=dt)
    for name, v in cols.items():
        out[name] = v
    return out
