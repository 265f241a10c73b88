"""Opcodes shared by the consensus kernels.

The port's own copy of the ``Op`` and ``MsgKind`` enums of the JAX
package's ``wire/messages.py`` (same names, same values — the values are
the wire contract). The frame codec is not ported yet.
"""

from __future__ import annotations

import enum


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

    PROPOSE = 1
    PROPOSE_REPLY = 2
    READ = 3
    READ_REPLY = 4
    PROPOSE_AND_READ = 5
    PROPOSE_AND_READ_REPLY = 6
    BEACON = 7
    BEACON_REPLY = 8

    PREPARE = 16
    PREPARE_REPLY = 17
    ACCEPT = 18
    ACCEPT_REPLY = 19
    COMMIT = 20
    COMMIT_SHORT = 21

    PREPARE_INST = 24
    PREPARE_INST_REPLY = 25

    SKIP = 28

    TRACE_CTX = 32

    SNAP_META = 33
    SNAP_ROWS = 34


# Log-slot statuses (minpaxosproto.go:8-15 plus EXECUTED).
NONE, PREPARING, PREPARED, ACCEPTED, COMMITTED, EXECUTED = range(6)
