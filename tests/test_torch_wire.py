"""The port's wire codec and stable store against the JAX package's.

Frames: for seeded random batches of every frame kind, both packages'
``encode_frame`` give the same bytes, and the port's ``StreamDecoder``
reads a JAX-encoded stream fed in 3-byte chunks. Stores: a log written
by either package's ``StableStore`` (slots, frontiers, a snapshot and a
torn tail) replays in the other to the same mirror, frontier, snapshot
and committed prefix.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from minpaxos_tpu.runtime.stable import StableStore as JaxStore
from minpaxos_tpu.wire import codec as jax_codec
from minpaxos_tpu.wire import messages as jax_msgs
from minpaxos_tpu_torch.runtime.stable import StableStore as PortStore
from minpaxos_tpu_torch.wire import codec, messages

torch.set_num_threads(1)


def _random_rows(rng, kind, n):
    dt = messages.schema(kind)
    raw = rng.integers(0, 256, n * dt.itemsize, dtype=np.uint8)
    return np.frombuffer(raw.tobytes(), dtype=dt, count=n).copy()


def test_enums_and_schemas_match_the_jax_package():
    assert {k.name: int(k) for k in messages.MsgKind} == \
        {k.name: int(k) for k in jax_msgs.MsgKind}
    assert {k.name: int(k) for k in messages.Op} == \
        {k.name: int(k) for k in jax_msgs.Op}
    assert {int(k): v for k, v in messages.SCHEMAS.items()} == \
        {int(k): v for k, v in jax_msgs.SCHEMAS.items()}


@pytest.mark.parametrize("kind", [k for k in messages.MsgKind if k in messages.SCHEMAS])
def test_frames_byte_identical(kind):
    rng = np.random.default_rng(int(kind))
    for n in (0, 1, 7, 300):
        rows = _random_rows(rng, kind, n)
        port = codec.encode_frame(kind, rows)
        ref = jax_codec.encode_frame(jax_msgs.MsgKind(int(kind)), rows)
        assert port == ref
        k2, back, end = codec.decode_frame(port)
        assert int(k2) == int(kind) and end == len(port)
        assert back.tobytes() == rows.tobytes()


def test_port_decoder_reads_jax_stream_in_3_byte_chunks():
    rng = np.random.default_rng(11)
    kinds = [k for k in jax_msgs.MsgKind if k in jax_msgs.SCHEMAS]
    sent = []
    stream = b""
    for i in range(60):
        kind = kinds[int(rng.integers(len(kinds)))]
        rows = _random_rows(rng, messages.MsgKind(int(kind)), int(rng.integers(0, 40)))
        sent.append((int(kind), rows.tobytes()))
        stream += jax_codec.encode_frame(kind, rows)
    # a 5000-row ACCEPT frame too (the reference's MAX_BATCH)
    big = _random_rows(rng, messages.MsgKind.ACCEPT, 5000)
    sent.append((int(messages.MsgKind.ACCEPT), big.tobytes()))
    stream += jax_codec.encode_frame(jax_msgs.MsgKind.ACCEPT, big)
    dec = codec.StreamDecoder()
    got = []
    for i in range(0, len(stream), 3):
        got.extend((int(k), r.tobytes()) for k, r in dec.feed(stream[i:i + 3]))
    assert got == sent
    assert dec.pending_bytes() == 0 and dec.error is None


def test_decoder_latches_corruption():
    rows = _random_rows(np.random.default_rng(2), messages.MsgKind.PREPARE, 3)
    good = codec.encode_frame(messages.MsgKind.PREPARE, rows)
    dec = codec.StreamDecoder()
    out = dec.feed(good + bytes([250, 1, 0, 0, 0]))  # opcode 250: no schema
    assert len(out) == 1 and dec.error is not None
    with pytest.raises(ValueError):
        dec.feed(good)


def _write(store_cls, path, rng, torn: bool):
    st = store_cls(path, sync=False)
    for lo in range(0, 600, 150):
        n = 150
        inst = np.arange(lo, lo + n, dtype=np.int32)
        st.append_slots(inst, np.full(n, 17, np.int32),
                        np.where(inst < 450, 4, 3).astype(np.uint8),
                        np.ones(n, np.uint8), rng.integers(0, 1 << 40, n),
                        rng.integers(0, 1 << 40, n), inst + 1000,
                        np.full(n, 5, np.int32))
        st.append_frontier(min(lo + n - 1, 449))
        st.flush()
        if lo == 300:
            keys = rng.choice(1 << 30, 64, replace=False).astype(np.int64)
            st.take_snapshot(keys, keys * 3, 400, wall_ns=123)
    st.close()
    if torn:
        with open(path, "ab") as f:
            f.write(bytes([1, 200, 0, 0]))  # a record header cut short
    return path


def _state(st):
    hi = st.max_inst()
    return dict(mirror=st.read_range(0, hi).tobytes(), frontier=st.frontier,
                prefix=st.committed_prefix(), base=st.base,
                snap=(st.snap_frontier, st.snapshot_pairs.tobytes()),
                max_ballot=st.max_ballot(),
                committed=st.is_committed(np.arange(hi + 2)).tolist())


@pytest.mark.parametrize("writer,reader", [(JaxStore, PortStore), (PortStore, JaxStore)])
@pytest.mark.parametrize("torn", [False, True])
def test_store_written_by_one_package_replays_in_the_other(tmp_path, writer, reader, torn):
    a = _write(writer, str(tmp_path / "a"), np.random.default_rng(5), torn)
    b = _write(reader, str(tmp_path / "b"), np.random.default_rng(5), torn)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()  # the same bytes on disk
    other, own = reader(a, sync=False), writer(b, sync=False)
    try:
        assert _state(other) == _state(own)
        assert other.base == 400 and other.committed_prefix() == 449
        if torn:  # the torn tail is cut on open
            assert os.path.getsize(a) == os.path.getsize(b)
    finally:
        other.close()
        own.close()
