"""Append-only durable log ("stable store") + replay.

The port's copy of the JAX package's ``runtime/stable.py``; the file
format is byte-for-byte the same, so a store written by one package
replays in the other.

Counterpart of the reference's per-replica ``stable-store-replica<id>``
file: 12-byte instance metadata + marshaled commands appended and
fsync'd per accept (bareminpaxos.go:164-197), replayed wholesale on
boot (getDataFromStableStore :122-161). Two deliberate upgrades:

* **Batched records.** One protocol tick persists every slot it
  accepted as one contiguous numpy write + one fsync, instead of a
  write+sync per instance.
* **Frontier records.** The reference never logs commit progress (a
  revived replica rediscovers it from the leader); we append a tiny
  frontier record when committed_upto advances so recovery can
  re-execute the committed prefix locally and the leader can serve
  beyond-window catch-up from its own log (models/minpaxos.py window
  slide LIMIT note).

The in-memory mirror (a dense growable structured array — log slots
are dense integers) doubles as the leader's beyond-retention resync
source: reads never touch disk.
"""

from __future__ import annotations

import os
import struct
import sys
import zlib

import numpy as np

#: v1 framing: [type u8][len u32][payload] — no integrity check; a
#: flipped payload byte replayed as protocol state (silent divergence)
MAGIC_V1 = b"MPXL0001"
#: v2 framing (current): [type u8][len u32][crc u32][payload], crc =
#: crc32(header || payload). Replay SKIPS records whose CRC fails
#: (counted + warned) instead of ingesting flipped bytes; the holes
#: report not-committed, so peers' re-sends self-heal them. The magic
#: picks the framing per file: v1 files replay — and keep appending —
#: in v1 form, so an old log stays self-consistent.
MAGIC = b"MPXL0002"

_COMMITTED = 4  # models/minpaxos.py status enum (kept import-free here)

# one record per accepted slot
SLOT_DT = np.dtype([
    ("inst", "<i4"), ("ballot", "<i4"), ("status", "u1"), ("op", "u1"),
    ("key", "<i8"), ("val", "<i8"), ("cmd_id", "<i4"), ("client_id", "<i4"),
])
_FRONTIER = struct.Struct("<i")  # committed_upto

REC_SLOTS = 1  # payload: u32 count + count*SLOT_DT
REC_FRONTIER = 2  # payload: i32
#: snapshot of the APPLIED KV state at an exec frontier: payload is
#: [frontier i32][wall_ns i64][count u32] + count*SNAP_DT, CRC-framed
#: like every v2 record — a flipped byte fails the record CRC and
#: replay falls back to the previous retained snapshot (take_snapshot
#: keeps two) + a longer redo replay. Record-type tags are append-only
#: like wire opcodes (analysis/store_golden.py).
REC_SNAPSHOT = 3
_HDR = struct.Struct("<BI")  # record type, payload bytes
_CRC = struct.Struct("<I")  # v2 framing: crc32(header || payload)

#: one snapshot row: a live KV pair (key, value), sorted by key so the
#: same applied state always snapshots byte-identically regardless of
#: hash-table insertion order
SNAP_DT = np.dtype([("key", "<i8"), ("val", "<i8")])
_SNAP_HDR = struct.Struct("<iqI")  # frontier, wall_ns, pair count

#: rows per REC_SLOTS record when take_snapshot rewrites the suffix
_REWRITE_CHUNK = 8192

#: per-file cap on individually warned corrupt records (the tally
#: keeps counting; the terminal must not scroll a rotted disk forever)
_CORRUPT_WARN_CAP = 5


class StableStore:
    """Durable redo log for one replica.

    File layout: MAGIC, then records of [type u8][len u32][crc u32]
    [payload] (the crc field only under the v2 magic — see MAGIC_V1).
    ``sync=False`` trades durability for speed (the reference's
    non--durable mode skips persistence entirely).
    """

    def __init__(self, path: str, sync: bool = True):
        self.path = path
        self.sync = sync
        # a stale .tmp is a segment swap that died before its
        # os.replace: the original file is still authoritative
        try:
            os.unlink(path + ".tmp")
        except OSError:
            pass
        existed = os.path.exists(path) and os.path.getsize(path) > len(MAGIC)
        # mirror: log slots are DENSE integers, so the in-memory mirror
        # is a growable structured array + presence mask (34 B/slot,
        # vectorized update/read) rather than a dict of numpy scalars —
        # the per-row dict/.copy() loop was the hottest host path in a
        # tick profile
        self._mirror = np.zeros(0, SLOT_DT)
        self._have = np.zeros(0, bool)
        self._max_inst = -1
        # insts recorded with status >= COMMITTED: commitment is final,
        # so re-appends of these slots are pure log amplification and
        # the runtime's _persist drops them (heal sweeps deliver R-1
        # duplicate COMMIT rows per slot)
        self.committed: set[int] = set()
        self._committed_arr: np.ndarray | None = None  # sorted cache
        # largest c with slot records 0..c all present — maintained
        # incrementally so committed_prefix()/is_committed() never walk
        # or sort the whole mirror
        self._contig = -1
        self.frontier = -1
        # CRC-rejected records seen by _replay (surfaced as a metrics
        # fn-gauge by the replica runtime)
        self.corrupt_records = 0
        # snapshot state. ``base``: highest slot covered by the
        # snapshot THIS replay started from (-1 = replayed the full
        # redo log) — slot records at/below it are not in the mirror
        # after a restart, so readers must treat [0, base] as
        # snapshot-covered. A LIVE take_snapshot never rebases the
        # mirror (disk is bounded, RAM stays complete), so base only
        # moves at restart.
        self.base = -1
        self.snap_frontier = -1  # newest retained snapshot's frontier
        self.snap_wall_ns = 0
        self.snapshot_pairs = np.zeros(0, SNAP_DT)
        self._snapshots: list[tuple[int, int, np.ndarray]] = []
        self.snapshots_taken = 0  # this process, not lifetime
        self.truncated_bytes = 0
        self._crashed = False
        # whether this FILE carries v2 per-record CRCs (decided by its
        # magic on replay; new files are always v2)
        self.crc_framing = True
        if existed:
            self._replay()
            # truncate the torn tail before appending: new records
            # written AFTER leftover partial-record bytes would be
            # swallowed into that record's length field on the next
            # replay (v1 could then silently mis-parse; v2 would skip
            # them as CRC garbage) — cut to the last record boundary
            self._f = open(path, "r+b")
            self._f.seek(self._parsed_end)
            self._f.truncate()
        else:
            self._f = open(path, "wb")
            self._f.write(MAGIC)
            self._f.flush()

    @property
    def recovered(self) -> bool:
        return self._max_inst >= 0 or self.frontier >= 0

    # -- append --

    def _ensure(self, upto: int) -> None:
        if upto < len(self._mirror):
            return
        cap = max(1024, 2 * len(self._mirror), upto + 1)
        mirror = np.zeros(cap, SLOT_DT)
        mirror[: len(self._mirror)] = self._mirror
        have = np.zeros(cap, bool)
        have[: len(self._have)] = self._have
        self._mirror, self._have = mirror, have

    def _update_mirror(self, rec: np.ndarray) -> None:
        """Apply one record batch to the mirror (ballot supersede)."""
        insts = rec["inst"].astype(np.int64)
        if int(insts.min()) < 0:
            # the mirror indexes by inst directly: a negative inst (a
            # padding row slipping through a caller's mask) would
            # wrap-index and silently overwrite the highest slots
            raise ValueError(
                f"stable store: negative inst in record batch "
                f"(min={int(insts.min())}) — caller mask bug")
        self._ensure(int(insts.max()))
        if len(np.unique(insts)) != len(insts):
            # same slot twice in one batch (e.g. ACCEPT + COMMIT in one
            # tick): supersede must see earlier rows' writes — rare, so
            # sequential
            for j in range(len(rec)):
                i = int(insts[j])
                if (not self._have[i]
                        or rec["ballot"][j] >= self._mirror["ballot"][i]):
                    self._mirror[i] = rec[j]
                    self._have[i] = True
        else:
            old_ballot = np.where(self._have[insts],
                                  self._mirror["ballot"][insts], -(2 ** 31))
            take = rec["ballot"] >= old_ballot
            self._mirror[insts[take]] = rec[take]
            self._have[insts[take]] = True
        self._max_inst = max(self._max_inst, int(insts.max()))
        cm = insts[rec["status"] >= _COMMITTED]
        if cm.size:
            self.committed.update(cm.tolist())
            self._committed_arr = None
        # advance the contiguous prefix in one scan of the newly
        # covered region (amortized O(1) per slot over the log's life);
        # bound the scan at _max_inst — everything past it is False, so
        # scanning the full doubled capacity would make this O(cap)
        start = self._contig + 1
        end = self._max_inst + 2
        if start < len(self._have) and self._have[start]:
            gap = np.nonzero(~self._have[start:end])[0]
            self._contig = (start + int(gap[0]) - 1) if gap.size else (
                self._max_inst)

    def append_slots(self, inst, ballot, status, op, key, val, cmd_id,
                     client_id) -> None:
        n = len(inst)
        if n == 0:
            return
        rec = np.zeros(n, SLOT_DT)
        rec["inst"], rec["ballot"], rec["status"] = inst, ballot, status
        rec["op"], rec["key"], rec["val"] = op, key, val
        rec["cmd_id"], rec["client_id"] = cmd_id, client_id
        self._write_record(REC_SLOTS, rec.tobytes())
        self._update_mirror(rec)

    def _write_record(self, rtype: int, payload: bytes) -> None:
        self._write_record_to(self._f, rtype, payload)

    def append_frontier(self, committed_upto: int) -> None:
        if committed_upto <= self.frontier:
            return
        self.frontier = committed_upto
        self._write_record(REC_FRONTIER, _FRONTIER.pack(committed_upto))
        # entries at/below min(contig, frontier) are covered by the
        # is_committed() prefix check — prune so the set stays small in
        # steady state instead of growing for the process lifetime
        if self.committed:
            covered = min(self._contig, self.frontier)
            pruned = {i for i in self.committed if i > covered}
            if len(pruned) != len(self.committed):
                self.committed = pruned
                self._committed_arr = None

    def flush(self) -> None:
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._f.close()

    def crash(self) -> None:
        """Emulate a process kill for fault injection: everything in
        the userspace write buffer is LOST (like a SIGKILLed process's
        unflushed stdio), the on-disk file keeps only what already
        reached the kernel — possibly ending in a torn record. Further
        appends/flushes land in /dev/null so the protocol thread dies
        quietly instead of racing a closed fd."""
        self._crashed = True
        self.sync = False  # /dev/null rejects fsync on some kernels
        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            # dup2 swaps the underlying fd: the buffered writer's
            # pending bytes flush into /dev/null on close — gone, as
            # they would be for a real kill
            os.dup2(devnull, self._f.fileno())
            os.close(devnull)
        except OSError:
            pass

    def log_bytes(self) -> int:
        """Current on-disk size — the bound truncation maintains
        (a metrics fn-gauge; safe to call from the control thread)."""
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def snap_bytes(self) -> int:
        """Bytes the retained snapshots occupy on disk (framing incl.)."""
        per = _HDR.size + (_CRC.size if self.crc_framing else 0) + \
            _SNAP_HDR.size
        return sum(per + len(p) * SNAP_DT.itemsize
                   for _, _, p in self._snapshots)

    def take_snapshot(self, keys, vals, frontier: int,
                      wall_ns: int = 0) -> int:
        """Checkpoint the applied KV state at ``frontier`` and truncate
        the redo log below the PREVIOUS snapshot's frontier, as one
        atomic segment swap (write ``.tmp``, fsync, ``os.replace``).

        Retains the last TWO snapshots: redo records in
        (prev_frontier, new_frontier] stay in the file, so a corrupt
        newest snapshot (bit rot, torn swap tail) falls back to the
        previous one + a longer replay instead of diverging. The first
        snapshot therefore truncates nothing. The in-RAM mirror is NOT
        rebased — only disk is bounded; a live replica keeps serving
        full-history catch-up from memory.

        Returns bytes freed on disk (may be negative right after the
        first snapshot), or -1 when refused (v1 file — no CRC framing
        to protect the snapshot — or a crashed/invalid store).
        """
        if self._crashed or frontier < 0 or not self.crc_framing:
            return -1
        keys = np.asarray(keys, np.int64)
        vals = np.asarray(vals, np.int64)
        pairs = np.zeros(len(keys), SNAP_DT)
        order = np.argsort(keys, kind="stable")
        pairs["key"], pairs["val"] = keys[order], vals[order]
        prev = self._snapshots[-1] if self._snapshots else None
        keep_above = prev[0] if prev else -1
        if self._contig < frontier:
            # a snapshot AHEAD of the log we hold (wire catch-up
            # installing onto a wiped or lagging replica, never a
            # replica checkpointing its own applied state): slots
            # [0, frontier] become snapshot-covered — rebase exactly
            # as a restart replay would, so committed_prefix() and the
            # catch-up readers stay truthful on the live store
            self.base = max(self.base, frontier)
            self._contig = frontier
            start, end = frontier + 1, self._max_inst + 2
            if start < len(self._have) and self._have[start]:
                gap = np.nonzero(~self._have[start:end])[0]
                self._contig = (start + int(gap[0]) - 1) if gap.size \
                    else self._max_inst
        self.frontier = max(self.frontier, frontier)
        self._max_inst = max(self._max_inst, frontier)
        # buffered appends must reach the file before its size is the
        # "before" of the freed-bytes accounting (and before close()
        # would flush them into the about-to-be-replaced file anyway)
        self._f.flush()
        old_size = self.log_bytes()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as tf:
            tf.write(MAGIC)
            for f_s, w_ns, p in ([prev] if prev else []):
                self._write_snapshot(tf, f_s, w_ns, p)
            self._write_snapshot(tf, frontier, wall_ns, pairs)
            hi = self._max_inst
            rows = (self._mirror[: hi + 1][self._have[: hi + 1]]
                    if hi >= 0 else np.zeros(0, SLOT_DT))
            rows = rows[rows["inst"] > keep_above]
            for i in range(0, len(rows), _REWRITE_CHUNK):
                chunk = rows[i: i + _REWRITE_CHUNK]
                self._write_record_to(tf, REC_SLOTS, chunk.tobytes())
            if self.frontier >= 0:
                self._write_record_to(tf, REC_FRONTIER,
                                      _FRONTIER.pack(self.frontier))
            tf.flush()
            os.fsync(tf.fileno())
        # the swap: old file stays authoritative until the replace
        # lands (a crash between fsync and replace leaves a stale .tmp
        # that __init__ discards)
        self._f.close()
        os.replace(tmp, self.path)
        try:
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            os.fsync(dfd)
            os.close(dfd)
        except OSError:
            pass
        self._f = open(self.path, "ab")
        self._snapshots = ([prev] if prev else []) + [
            (frontier, wall_ns, pairs)]
        self.snap_frontier = frontier
        self.snap_wall_ns = wall_ns
        self.snapshot_pairs = pairs
        self.snapshots_taken += 1
        freed = old_size - self.log_bytes()
        self.truncated_bytes += max(0, freed)
        return freed

    def _write_snapshot(self, f, frontier: int, wall_ns: int,
                        pairs: np.ndarray) -> None:
        payload = _SNAP_HDR.pack(frontier, wall_ns, len(pairs)) + \
            pairs.tobytes()
        self._write_record_to(f, REC_SNAPSHOT, payload)

    def _write_record_to(self, f, rtype: int, payload: bytes) -> None:
        hdr = _HDR.pack(rtype, len(payload))
        f.write(hdr)
        if self.crc_framing:
            f.write(_CRC.pack(zlib.crc32(payload, zlib.crc32(hdr))))
        f.write(payload)

    # -- read --

    @staticmethod
    def _resync(data: bytes, start: int) -> int | None:
        """Scan past a corrupt length field (v2 framing only) for the
        next whole-record boundary: an offset qualifies iff its header
        is plausible AND its CRC validates, so a false positive is a
        2^-32 coincidence. Runs only on corruption, never on the clean
        replay path. Returns None when no record follows — i.e. the
        unparseable region really is a torn tail."""
        end = len(data)
        off = start + 1
        while off + _HDR.size + _CRC.size <= end:
            rtype, plen = _HDR.unpack_from(data, off)
            body = off + _HDR.size + _CRC.size
            if (rtype in (REC_SLOTS, REC_FRONTIER, REC_SNAPSHOT)
                    and body + plen <= end):
                (crc,) = _CRC.unpack_from(data, off + _HDR.size)
                want = zlib.crc32(data[body: body + plen],
                                  zlib.crc32(data[off: off + _HDR.size]))
                if crc == want:
                    return off
            off += 1
        return None

    def _replay(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        magic = data[: len(MAGIC)]
        if magic == MAGIC:
            crc_framing = True
        elif magic == MAGIC_V1:
            crc_framing = False  # pre-CRC log: replay + append as v1
        else:
            raise ValueError(f"{self.path}: bad magic")
        self.crc_framing = crc_framing
        pos = len(MAGIC)
        self._parsed_end = pos  # last whole-record boundary reached
        snaps: list[tuple[int, int, np.ndarray]] = []
        while pos + _HDR.size <= len(data):
            rtype, plen = _HDR.unpack_from(data, pos)
            body = pos + _HDR.size + (_CRC.size if crc_framing else 0)
            if body + plen > len(data):
                # the declared record runs past EOF. A genuine torn
                # tail (crash mid-append) looks exactly like a flipped
                # LENGTH byte mid-file — but __init__ TRUNCATES at
                # _parsed_end, so treating the latter as a tail would
                # destroy every valid record after it. Resync on the
                # next CRC-valid record boundary: found ⇒ mid-file
                # corruption, skip the garbage; not found ⇒ real tail
                nxt = self._resync(data, pos) if crc_framing else None
                if nxt is None:
                    break  # torn tail write (crash mid-append): ignore
                self.corrupt_records += 1
                if self.corrupt_records <= _CORRUPT_WARN_CAP:
                    print(f"{self.path}: corrupt length field at byte "
                          f"{pos} — resynced at {nxt}, "
                          f"{nxt - pos} B skipped; holes self-heal "
                          f"from peers", file=sys.stderr, flush=True)
                pos = nxt
                self._parsed_end = pos
                continue
            if crc_framing:
                (crc,) = _CRC.unpack_from(data, pos + _HDR.size)
                want = zlib.crc32(data[body: body + plen],
                                  zlib.crc32(data[pos: pos + _HDR.size]))
                if crc != want:
                    # flipped bytes: SKIP the record instead of
                    # ingesting it — the resulting slot holes report
                    # not-committed (is_committed) and peers' re-sends
                    # heal them. A corrupted in-file length field
                    # desyncs the skip and cascades CRC failures until
                    # a garbage header points past EOF, where the
                    # resync above recovers the remaining records.
                    self.corrupt_records += 1
                    if self.corrupt_records <= _CORRUPT_WARN_CAP:
                        print(f"{self.path}: CRC mismatch at byte "
                              f"{pos} (record type {rtype}, "
                              f"{plen} B) — record skipped; holes "
                              f"self-heal from peers",
                              file=sys.stderr, flush=True)
                    pos = body + plen
                    self._parsed_end = pos
                    continue
            if rtype == REC_SLOTS and plen % SLOT_DT.itemsize == 0:
                n = plen // SLOT_DT.itemsize
                if n:
                    self._update_mirror(np.frombuffer(data, SLOT_DT, n, body))
            elif rtype == REC_FRONTIER and plen == _FRONTIER.size:
                (fr,) = _FRONTIER.unpack_from(data, body)
                self.frontier = max(self.frontier, fr)
            elif rtype == REC_SNAPSHOT and plen >= _SNAP_HDR.size:
                f_s, w_ns, cnt = _SNAP_HDR.unpack_from(data, body)
                if plen == _SNAP_HDR.size + cnt * SNAP_DT.itemsize:
                    pairs = np.frombuffer(
                        data, SNAP_DT, cnt, body + _SNAP_HDR.size).copy()
                    snaps.append((f_s, w_ns, pairs))
            pos = body + plen
            self._parsed_end = pos
        if self.corrupt_records > _CORRUPT_WARN_CAP:
            print(f"{self.path}: {self.corrupt_records} corrupt records "
                  f"skipped in total", file=sys.stderr, flush=True)
        if snaps:
            # the newest CRC-valid snapshot is the replay base — a
            # corrupt newest one never reached ``snaps`` (its record
            # was skipped above), so the fallback to the previous
            # snapshot + a longer redo replay happens here for free
            snaps.sort(key=lambda s: s[0])
            f_s, w_ns, pairs = snaps[-1]
            self._snapshots = snaps[-2:]
            self.base = f_s
            self.snap_frontier = f_s
            self.snap_wall_ns = w_ns
            self.snapshot_pairs = pairs
            self.frontier = max(self.frontier, f_s)
            self._max_inst = max(self._max_inst, f_s)
            if self._contig < f_s:
                # slots [0, base] are snapshot-covered: restart the
                # contiguity scan just above the base
                self._contig = f_s
                start, end = f_s + 1, self._max_inst + 2
                if start < len(self._have) and self._have[start]:
                    gap = np.nonzero(~self._have[start:end])[0]
                    self._contig = (start + int(gap[0]) - 1) if gap.size \
                        else self._max_inst
        covered = min(self._contig, self.frontier)
        self.committed = {i for i in self.committed if i > covered}

    def is_committed(self, insts: np.ndarray) -> np.ndarray:
        """Vectorized: True where inst is already durably committed AND
        its record is present — at/below min(contiguous-records,
        frontier), or an explicit COMMITTED slot record. Slots below
        the frontier whose record is MISSING (torn write) report False
        so peers' re-sends self-heal the hole. Used by the runtime's
        _persist dedup; no per-row Python on the protocol thread."""
        insts = np.asarray(insts)
        out = insts <= min(self._contig, self.frontier)
        if self.committed:
            if (self._committed_arr is None
                    or len(self._committed_arr) != len(self.committed)):
                self._committed_arr = np.fromiter(
                    self.committed, np.int64, len(self.committed))
                self._committed_arr.sort()
            arr = self._committed_arr
            pos = np.searchsorted(arr, insts)
            pos_c = np.minimum(pos, len(arr) - 1)
            out = out | ((pos < len(arr)) & (arr[pos_c] == insts))
        return out

    def committed_prefix(self) -> int:
        """Largest f <= logged frontier with slots 0..f all present."""
        return min(self._contig, self.frontier)

    def read_range(self, lo: int, hi: int) -> np.ndarray:
        """Slot records for inst in [lo, hi] that exist, ascending —
        the leader's beyond-window catch-up source. One mirror slice."""
        lo = max(lo, 0)
        hi = min(hi, len(self._mirror) - 1)
        if hi < lo:
            return np.zeros(0, SLOT_DT)
        sl = slice(lo, hi + 1)
        return self._mirror[sl][self._have[sl]]  # mask index = fresh array

    def max_inst(self) -> int:
        return self._max_inst

    def max_ballot(self) -> int:
        """Highest ballot among recorded slots (recovery's promise
        restore, bareminpaxos.go:383-385)."""
        if self._max_inst < 0:
            return 0
        return int(self._mirror["ballot"][self._have].max(initial=0))
