"""Framed columnar codec for the TCP byte streams.

The port's copy of the JAX package's ``wire/codec.py`` (its pure-numpy
path; the optional native frame scan is not carried over). Frame
layout, little-endian:

    [opcode u8][nrows u32][payload: nrows * itemsize bytes]

where the payload is the packed numpy structured buffer of that
opcode's schema (wire/messages.py). Encoding a frame is one
``ndarray.tobytes()``; decoding is one ``np.frombuffer``. Frames are
byte-identical to the JAX package's, so either package's client can
talk to either package's server.
"""

from __future__ import annotations

import struct

import numpy as np

from minpaxos_tpu_torch.wire.messages import MsgKind, schema

_HEADER = struct.Struct("<BI")
HEADER_SIZE = _HEADER.size
MAX_FRAME_ROWS = 1 << 22  # sanity bound against corrupt streams


def encode_frame(kind: MsgKind, rows: np.ndarray) -> bytes:
    """Serialize a structured batch into one wire frame.

    Batches larger than MAX_FRAME_ROWS are rejected (the decoder would
    treat them as corrupt); callers split long logs into several
    frames.
    """
    dt = schema(kind)
    if len(rows) > MAX_FRAME_ROWS:
        raise ValueError(f"batch of {len(rows)} rows exceeds MAX_FRAME_ROWS; split it")
    if rows.dtype != dt:
        rows = rows.astype(dt)
    return _HEADER.pack(int(kind), len(rows)) + rows.tobytes()


def decode_frame(buf, offset: int = 0) -> tuple[MsgKind, np.ndarray, int]:
    """Decode one frame starting at buf[offset].

    Returns (kind, rows, end_offset); raises ValueError on a malformed
    header, IndexError if buf holds an incomplete frame. ``rows`` is a
    copy and does not alias ``buf``.
    """
    if len(buf) - offset < HEADER_SIZE:
        raise IndexError("incomplete header")
    op, nrows = _HEADER.unpack_from(buf, offset)
    kind = MsgKind(op)
    if nrows > MAX_FRAME_ROWS:
        raise ValueError(f"frame too large: {nrows} rows")
    dt = schema(kind)
    end = offset + HEADER_SIZE + nrows * dt.itemsize
    if len(buf) < end:
        raise IndexError("incomplete payload")
    rows = np.frombuffer(
        bytes(memoryview(buf)[offset + HEADER_SIZE : end]), dtype=dt, count=nrows
    )
    return kind, rows, end


class StreamDecoder:
    """Incremental frame decoder over a TCP byte stream: feed it
    arbitrary chunks; it returns the complete (kind, rows) frames and
    keeps any trailing partial frame."""

    __slots__ = ("_buf", "error")

    def __init__(self) -> None:
        self._buf = bytearray()
        self.error: ValueError | None = None

    def feed(self, chunk: bytes) -> list[tuple[MsgKind, np.ndarray]]:
        """Decode whole frames from chunk (+ any retained prefix).

        On a malformed frame the stream is latched corrupt: frames
        decoded *before* the corruption are still returned, ``error``
        is set (the caller closes the connection), and any further
        feed raises.
        """
        if self.error is not None:
            raise self.error
        self._buf.extend(chunk)
        out: list[tuple[MsgKind, np.ndarray]] = []
        pos = 0
        try:
            while True:
                kind, rows, pos = decode_frame(self._buf, pos)
                out.append((kind, rows))
        except IndexError:
            pass
        except ValueError as e:
            self.error = e
        if pos:
            del self._buf[:pos]
        return out

    def pending_bytes(self) -> int:
        return len(self._buf)


class FrameWriter:
    """Batching frame writer over a socket-like object: frames
    accumulate in a buffer and leave in one ``sendall`` at ``flush``,
    so a burst of frames costs one syscall."""

    __slots__ = ("_sock", "_buf")

    def __init__(self, sock) -> None:
        self._sock = sock
        self._buf = bytearray()

    def write(self, kind: MsgKind, rows: np.ndarray) -> None:
        self._buf += encode_frame(kind, rows)

    def flush(self) -> None:
        if self._buf:
            data = bytes(self._buf)
            self._buf.clear()
            self._sock.sendall(data)
