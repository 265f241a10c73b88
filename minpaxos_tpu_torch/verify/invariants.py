"""The safety invariant catalogue: the predicates every prover shares.

The port's own copy of the JAX package's ``verify/invariants.py`` (the
same functions, line for line; only the import of ``Op`` differs), so
the port's bounded model checker (``verify/mc.py``) holds its states to
exactly the predicates the reference checker and the chaos campaigns
run.

Record contract: every prover reduces its artifacts to *slot records*
— numpy structured arrays carrying at least ``inst`` plus the
``VALUE_FIELDS`` (``op``/``key``/``val``/``cmd_id``/``client_id``,
the byte-level identity of a committed command). ``StableStore``'s
mirror rows (``runtime/stable.py SLOT_DT``) already have this shape;
the model checker builds the same shape from window arrays
(``make_records``).

Invariants:

* **Committed-slot agreement** — for every pair of replicas, every
  slot at or below BOTH committed frontiers holds the same command
  (ballot and status legitimately differ — a follower may hold the
  value as a superseded-ballot accept).
* **Validity** — every committed command was actually proposed (its
  cmd_id's op/key/val match the workload table) or is an explicit
  no-op fill (gap heal / Mencius skip). A log cannot invent writes.
* **Frontier monotonicity** — a replica's committed frontier, sampled
  in time order, never decreases.
* **Snapshot agreement** — a durable snapshot's (key, val) pairs
  byte-equal a record-complete peer's replay of the same prefix.
* **Per-key linearizable history** — replay the committed log in slot
  order; every acked GET's reply matches the replayed value of its
  key at some committed occurrence, and every acked command appears
  in the log (an acked-but-never-committed write is data loss).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from minpaxos_tpu_torch.wire.messages import Op

#: fields whose byte-level agreement IS the safety invariant
VALUE_FIELDS = ("op", "key", "val", "cmd_id", "client_id")

#: the minimal slot-record dtype (StableStore's SLOT_DT is a superset;
#: equality is checked field-by-name so extra fields are harmless)
SLOT_RECORD = np.dtype([
    ("inst", "<i4"), ("op", "u1"), ("key", "<i8"), ("val", "<i8"),
    ("cmd_id", "<i4"), ("client_id", "<i4"),
])


@dataclass
class CheckReport:
    ok: bool = True
    violations: list[str] = field(default_factory=list)
    compared_slots: int = 0
    replayed_slots: int = 0
    checked_gets: int = 0
    snapshot_pairs_checked: int = 0
    frontiers: dict[int, int] = field(default_factory=dict)

    def add(self, msg: str) -> None:
        self.ok = False
        self.violations.append(msg)

    def to_dict(self) -> dict:
        return {"ok": self.ok, "violations": self.violations,
                "compared_slots": self.compared_slots,
                "replayed_slots": self.replayed_slots,
                "checked_gets": self.checked_gets,
                "snapshot_pairs_checked": self.snapshot_pairs_checked,
                "frontiers": {str(k): v for k, v in self.frontiers.items()}}


def make_records(insts, ops, keys, vals, cmd_ids, client_ids) -> np.ndarray:
    """Build slot records from parallel columns (the model checker's
    window-array path; chaos feeds StableStore mirrors directly)."""
    rec = np.zeros(len(np.atleast_1d(insts)), SLOT_RECORD)
    for name, col in zip(("inst",) + VALUE_FIELDS,
                         (insts, ops, keys, vals, cmd_ids, client_ids)):
        rec[name] = np.atleast_1d(col)
    return rec


# ------------------------------------------------- committed agreement

def check_slot_agreement(records: dict[int, np.ndarray],
                         frontiers: dict[int, int],
                         report: CheckReport,
                         bases: dict[int, int] | None = None) -> None:
    """Pairwise byte-level cross-check of committed prefixes.

    ``records[rid]``: slot records for every slot replica ``rid`` holds
    committed at inst <= ``frontiers[rid]``; prefixes are expected to be
    record-complete (a missing slot below both frontiers is itself a
    violation — a committed slot a replica cannot produce is a hole).

    ``bases[rid]`` (optional, default -1): slots <= base are
    snapshot-covered on that replica — the records were truncated away
    behind a durable snapshot, so record agreement for a pair starts
    ABOVE the higher of the two bases (the snapshot itself is held to
    a record-complete peer by :func:`check_snapshot_agreement`).
    """
    ids = sorted(records)
    bases = bases or {}
    report.frontiers.update({r: int(frontiers[r]) for r in ids})
    for i, a in enumerate(ids):
        for b in ids[i + 1:]:
            lo_pref = min(frontiers[a], frontiers[b])
            if lo_pref < 0:
                continue
            base_hi = max(bases.get(a, -1), bases.get(b, -1))
            ra = records[a][(records[a]["inst"] <= lo_pref)
                            & (records[a]["inst"] > base_hi)]
            rb = records[b][(records[b]["inst"] <= lo_pref)
                            & (records[b]["inst"] > base_hi)]
            # align by inst: both prefixes are record-complete by
            # definition of committed_prefix, so the insts must match
            common, ia, ib = np.intersect1d(ra["inst"], rb["inst"],
                                            return_indices=True)
            if len(common) != lo_pref - base_hi:
                report.add(
                    f"replicas {a}/{b}: committed prefixes claim "
                    f"{lo_pref - base_hi} comparable slots (above "
                    f"snapshot base {base_hi}) but only {len(common)} "
                    f"records are present on both")
            for f in VALUE_FIELDS:
                bad = np.nonzero(ra[f][ia] != rb[f][ib])[0]
                if bad.size:
                    s = int(common[bad[0]])
                    report.add(
                        f"COMMITTED-SLOT DIVERGENCE replicas {a}/{b} "
                        f"slot {s} field {f}: "
                        f"{ra[ia[bad[0]]]!r} vs {rb[ib[bad[0]]]!r} "
                        f"(+{bad.size - 1} more)")
                    break
            report.compared_slots += len(common)


def check_log_agreement(stores: dict[int, "StableStore"],
                        report: CheckReport) -> None:
    """Agreement over durable-log mirrors (the chaos prover's path):
    reduce each store to slot records, then run the shared predicate.
    Snapshot-rebased stores (base >= 0 after a crash-restart replay)
    are compared above their base; the snapshot itself is verified by
    :func:`check_snapshot_agreement`."""
    frontiers = {rid: stores[rid].committed_prefix() for rid in stores}
    bases = {rid: int(getattr(stores[rid], "base", -1))
             for rid in stores}
    records = {rid: stores[rid].read_range(max(0, bases[rid] + 1),
                                           frontiers[rid])
               for rid in stores}
    check_slot_agreement(records, frontiers, report, bases=bases)


def check_snapshot_agreement(stores: dict[int, "StableStore"],
                             report: CheckReport) -> None:
    """Every durable snapshot must byte-equal a record-complete peer's
    replay of the same prefix: for each store whose newest snapshot
    covers [0, snap_frontier], replay slots 0..snap_frontier from a
    peer that still HOLDS those records (base < 0) into a KV dict and
    compare against the snapshot's (key, val) pairs. This is the
    byte-identical-convergence evidence for a restarted replica whose
    low slots exist only as snapshot state."""
    full = [r for r in sorted(stores)
            if int(getattr(stores[r], "base", -1)) < 0]
    for rid in sorted(stores):
        st = stores[rid]
        sf = int(getattr(st, "snap_frontier", -1))
        if sf < 0:
            continue
        donors = [p for p in full
                  if p != rid and stores[p].committed_prefix() >= sf]
        if not donors:
            # nothing record-complete reaches the snapshot frontier:
            # not a safety violation (agreement above base still ran),
            # just nothing to hold the snapshot against
            continue
        rec = stores[donors[0]].read_range(0, sf)
        kv: dict[int, int] = {}
        for j in range(len(rec)):
            if (int(rec["client_id"][j]) < 0
                    or int(rec["op"][j]) != int(Op.PUT)):
                continue
            kv[int(rec["key"][j])] = int(rec["val"][j])
        pairs = st.snapshot_pairs
        got = {int(k): int(v)
               for k, v in zip(pairs["key"], pairs["val"])}
        if got != kv:
            extra = sorted(set(got) - set(kv))[:3]
            missing = sorted(set(kv) - set(got))[:3]
            diff = sorted(k for k in set(kv) & set(got)
                          if kv[k] != got[k])[:3]
            report.add(
                f"SNAPSHOT DIVERGENCE replica {rid} snap_frontier {sf} "
                f"vs replica {donors[0]} replay: {len(got)} snapshot "
                f"pairs vs {len(kv)} replayed (extra keys {extra}, "
                f"missing {missing}, differing {diff})")
        report.snapshot_pairs_checked += len(kv)


# ------------------------------------------------------------ validity

def check_validity(records: np.ndarray, ops: np.ndarray, keys: np.ndarray,
                   vals: np.ndarray, report: CheckReport,
                   who: str = "") -> None:
    """Every committed command was proposed or is an explicit no-op.

    ``ops/keys/vals`` are the workload table (cmd_id == index). No-op
    fills (op == NONE, or client_id < 0 — takeover / gap heal / Mencius
    skip) are exempt: they carry no client command by design.
    """
    tag = f"{who}: " if who else ""
    for j in range(len(records)):
        op = int(records["op"][j])
        cid = int(records["client_id"][j])
        cmd = int(records["cmd_id"][j])
        if cid < 0 or op == int(Op.NONE):
            continue
        if not 0 <= cmd < len(ops):
            report.add(f"{tag}slot {int(records['inst'][j])}: committed "
                       f"cmd_id {cmd} was never proposed (workload has "
                       f"{len(ops)} commands) — the log invented a write")
            continue
        if (int(ops[cmd]) != op or int(keys[cmd]) != int(records["key"][j])
                or (op == int(Op.PUT)
                    and int(vals[cmd]) != int(records["val"][j]))):
            report.add(
                f"{tag}slot {int(records['inst'][j])}: committed command "
                f"(cmd {cmd}, op {op}, key {int(records['key'][j])}) does "
                f"not match the workload's cmd {cmd}")


# ------------------------------------------------- frontier monotonic

def check_frontier_monotonic(samples: dict[int, list[int]],
                             report: CheckReport) -> None:
    """``samples[rid]`` = that replica's frontier, sampled in time
    order (chaos: wall-clock sampler; model checker: pre/post step)."""
    for rid, seq in sorted(samples.items()):
        arr = np.asarray(seq)
        if arr.size < 2:
            continue
        drops = np.nonzero(np.diff(arr) < 0)[0]
        if drops.size:
            i = int(drops[0])
            report.add(f"replica {rid}: frontier went BACKWARD at "
                       f"sample {i + 1}: {int(arr[i])} -> "
                       f"{int(arr[i + 1])}")


# -------------------------------------------------- linearizability

def check_linearizable(store: "StableStore", replies: dict[int, dict],
                       ops: np.ndarray, keys: np.ndarray,
                       vals: np.ndarray, report: CheckReport) -> None:
    """Replay the committed prefix of ``store`` (the most advanced
    replica) in slot order and hold the client's history to it:

    * every acked command (cmd_id in ``replies``) must appear in the
      committed log — an acked-but-never-committed write is data loss;
    * every acked GET's reply value must match the replayed value of
      its key at some committed occurrence of that GET (a failover
      re-propose can legitimately commit a command twice; client-side
      cmd_id dedup is the exactly-once mechanism — what can NOT happen
      is a reply value no serialization of the log explains);
    * every committed occurrence of a PUT must carry the workload's
      (key, val) for that cmd_id — the log cannot invent writes.

    ``ops/keys/vals`` are the workload arrays (cmd_id == index), the
    same exactly-once bookkeeping the ``-check`` client mode uses.
    """
    prefix = store.committed_prefix()
    if prefix < 0:
        return
    # a snapshot-rebased store (base >= 0) only holds records above
    # base: replay the suffix, skip GETs whose prior state is
    # snapshot-covered, and waive the lost-write check (acked commands
    # below base are invisible by design). check_cluster prefers a
    # record-complete replica, so this weakening only engages when NO
    # replica still holds the full log.
    base = int(getattr(store, "base", -1))
    rec = store.read_range(base + 1 if base >= 0 else 0, prefix)
    report.replayed_slots += len(rec)
    acked = {int(c) for c in replies}
    seen: set[int] = set()
    kv: dict[int, int] = {}
    get_ok: set[int] = set()
    get_bad: dict[int, tuple[int, int]] = {}
    for j in range(len(rec)):
        cid = int(rec["client_id"][j])
        cmd = int(rec["cmd_id"][j])
        op = int(rec["op"][j])
        key = int(rec["key"][j])
        if cid < 0 or op == int(Op.NONE):
            continue  # no-op fill (takeover / gap heal)
        if cmd < len(ops):
            if int(ops[cmd]) != op or int(keys[cmd]) != key or (
                    op == int(Op.PUT) and int(vals[cmd]) != int(rec["val"][j])):
                report.add(
                    f"slot {int(rec['inst'][j])}: committed command "
                    f"(cmd {cmd}, op {op}, key {key}) does not match "
                    f"the workload's cmd {cmd}")
            seen.add(cmd)
        if op == int(Op.PUT):
            kv[key] = int(rec["val"][j])
        elif op == int(Op.GET) and cmd in acked and cmd not in get_ok:
            if base >= 0 and key not in kv:
                continue  # prior value snapshot-covered: unverifiable
            want = kv.get(key, 0)
            got = replies[cmd].get("val")
            if got == want:
                get_ok.add(cmd)
                get_bad.pop(cmd, None)
            else:
                get_bad[cmd] = (got, want)
    for cmd, (got, want) in sorted(get_bad.items())[:5]:
        report.add(f"GET cmd {cmd}: reply value {got} matches no "
                   f"committed occurrence (last replayed value {want})")
    report.checked_gets += len(get_ok) + len(get_bad)
    if base >= 0:
        return  # commands below base are snapshot-covered
    lost = sorted(acked - seen)
    if lost:
        report.add(f"{len(lost)} acked command(s) absent from the "
                   f"committed log (first: cmd {lost[0]}) — acked "
                   f"write lost")


# ----------------------------------------------------- the full suite

def check_cluster(stores: dict[int, "StableStore"],
                  frontier_samples: dict[int, list[int]] | None = None,
                  replies: dict[int, dict] | None = None,
                  workload: tuple | None = None) -> CheckReport:
    """Run every invariant that the provided artifacts allow (the
    chaos campaign's entry point; ``verify/mc.py`` calls the
    predicates piecemeal on model states instead)."""
    report = CheckReport()
    check_log_agreement(stores, report)
    check_snapshot_agreement(stores, report)
    if frontier_samples:
        check_frontier_monotonic(frontier_samples, report)
    if workload is not None:
        ops, keys, vals = workload
        # validity over EVERY replica's committed prefix — the same
        # predicate the model checker runs per state; an invented
        # write (cmd_id outside the workload) must fail the chaos
        # prover exactly like it fails the bounded exploration
        for rid in sorted(stores):
            lo = max(0, int(getattr(stores[rid], "base", -1)) + 1)
            rec = stores[rid].read_range(lo,
                                         stores[rid].committed_prefix())
            check_validity(rec, ops, keys, vals, report,
                           who=f"replica {rid}")
        if replies is not None:
            # prefer a record-complete replica (base -1 beats any
            # rebased store at equal prefix): the strong form of the
            # replay — every acked command held to the full log
            best = max(stores,
                       key=lambda r: (stores[r].committed_prefix(),
                                      -int(getattr(stores[r], "base",
                                                   -1))))
            check_linearizable(stores[best], replies, ops, keys, vals,
                               report)
    return report
