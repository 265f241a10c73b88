"""Static quorum-intersection certificates: prove it or show the split.

Paxos safety reduces to one set-theoretic fact: every phase-1 quorum
must intersect every phase-2 quorum (Flexible Paxos, PAPERS.md
1608.06696 — plain Paxos is the q1 == q2 == majority special case;
Fast Flexible Paxos 2008.02671 adds structured systems like grids).
In the vectorized kernels a quorum is nothing but a threshold in a
majority-mask compare (``n_votes >= majority``), which is exactly why
a non-intersecting (q1, q2) can slip in silently: the kernel compiles,
every test with a healthy network passes, and the first asymmetric
partition commits two different values for one slot.

This module makes the property a *certificate* — a small, checkable
object that either proves intersection or refutes it with an explicit
witness pair of disjoint quorums:

* **threshold systems** (N replicas, any q1 acceptors for phase 1, any
  q2 for phase 2): intersect iff q1 + q2 > N (pigeonhole); refutations
  carry the canonical disjoint pair A = {0..q1-1}, B = {N-q2..N-1}.
* **grid systems** (rows x cols cells, one replica per cell): phase-1
  quorum = all cells of one row, phase-2 = all cells of one column (or
  any row/col assignment per phase). Row-vs-column intersects at the
  crossing cell; same-axis assignments are refuted by two parallel
  lines.

``verify_certificate`` re-derives every certificate from scratch —
refutations by checking the witness, proofs by exhaustive enumeration
for small N and by the pigeonhole inequality beyond — so the ledger
(``verify/quorum_golden.py``, the port's copy of the JAX package's
``analysis/quorum_golden.py``) cannot go stale. The port's own copy of
the JAX package's ``verify/quorum.py``, pure stdlib.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from itertools import combinations

#: the ballot encoding (models/minpaxos.py make_ballot) caps replicas
#: at 16, so certifying N in [1, 16] covers every runnable config
MAX_N = 16

#: proofs for N <= this bound are re-verified by brute enumeration of
#: every (Q1, Q2) pair rather than trusted to the arithmetic argument
EXHAUSTIVE_N = 10


@dataclass(frozen=True)
class Certificate:
    """One (quorum system, q1, q2) intersection verdict.

    ``witness`` is ``None`` for proofs; for refutations it is a pair of
    concrete disjoint quorums (tuples of replica ids) — the seed of a
    counterexample schedule (partition the witness sets apart and each
    side can assemble its quorum without the other).
    """

    system: str  # "threshold" | "grid"
    n: int  # total replicas
    q1: object  # threshold int, or "row"/"col" for grids
    q2: object
    intersects: bool
    reason: str
    witness: tuple | None = None
    rows: int = 0  # grid shape (0 for threshold systems)
    cols: int = 0

    def to_dict(self) -> dict:
        d = asdict(self)
        if self.witness is not None:
            d["witness"] = [sorted(self.witness[0]), sorted(self.witness[1])]
        return d


def certify_threshold(n: int, q1: int, q2: int) -> Certificate:
    """Prove or refute intersection for the (n, q1, q2) threshold
    system. Degenerate thresholds (q < 1 or q > n: no such quorum can
    ever assemble, so the protocol is vacuously safe and totally live-
    less) are REFUSED rather than certified either way."""
    if not (1 <= q1 <= n and 1 <= q2 <= n):
        raise ValueError(
            f"degenerate quorum thresholds for n={n}: q1={q1}, q2={q2} "
            f"(must satisfy 1 <= q <= n)")
    if q1 + q2 > n:
        return Certificate(
            "threshold", n, q1, q2, True,
            f"pigeonhole: |Q1 ∩ Q2| >= q1 + q2 - n = {q1 + q2 - n} >= 1 "
            f"for every Q1, Q2")
    a = tuple(range(q1))
    b = tuple(range(n - q2, n))
    return Certificate(
        "threshold", n, q1, q2, False,
        f"q1 + q2 = {q1 + q2} <= n = {n}: disjoint quorums exist",
        witness=(a, b))


def certify_grid(rows: int, cols: int, q1: str = "row",
                 q2: str = "col") -> Certificate:
    """Prove or refute intersection for a rows x cols grid system
    where a phase-p quorum is all cells of one row (``"row"``) or one
    column (``"col"``). Cell (r, c) is replica r * cols + c."""
    if rows < 1 or cols < 1:
        raise ValueError(f"grid must be at least 1x1: {rows}x{cols}")
    if q1 not in ("row", "col") or q2 not in ("row", "col"):
        raise ValueError(f"grid quorum axes must be row/col: {q1}, {q2}")
    n = rows * cols

    def line(axis: str, i: int) -> tuple[int, ...]:
        if axis == "row":
            return tuple(i * cols + c for c in range(cols))
        return tuple(r * cols + i for r in range(rows))

    if q1 != q2:
        return Certificate(
            "grid", n, q1, q2, True,
            f"every {q1} meets every {q2} at exactly one cell of the "
            f"{rows}x{cols} grid", rows=rows, cols=cols)
    count = rows if q1 == "row" else cols
    if count == 1:
        return Certificate(
            "grid", n, q1, q2, True,
            f"only one {q1} exists in a {rows}x{cols} grid: every "
            f"quorum is the same set", rows=rows, cols=cols)
    return Certificate(
        "grid", n, q1, q2, False,
        f"two parallel {q1}s of a {rows}x{cols} grid are disjoint",
        witness=(line(q1, 0), line(q1, 1)), rows=rows, cols=cols)


def _grid_lines(cert: Certificate, axis: str) -> list[tuple[int, ...]]:
    if axis == "row":
        return [tuple(r * cert.cols + c for c in range(cert.cols))
                for r in range(cert.rows)]
    return [tuple(r * cert.cols + c for r in range(cert.rows))
            for c in range(cert.cols)]


def verify_certificate(cert: Certificate) -> bool:
    """Re-derive a certificate from scratch (no trust in ``reason``):

    * refutations: the witness must be two valid, disjoint quorums;
    * threshold proofs: exhaustive over every (Q1, Q2) pair for
      n <= EXHAUSTIVE_N, the pigeonhole inequality beyond;
    * grid proofs: exhaustive over every line pair (grids are tiny).
    """
    if cert.system == "threshold":
        n, q1, q2 = cert.n, cert.q1, cert.q2
        if not (isinstance(q1, int) and isinstance(q2, int)
                and 1 <= q1 <= n and 1 <= q2 <= n):
            return False
        if not cert.intersects:
            if cert.witness is None:
                return False
            a, b = (frozenset(cert.witness[0]), frozenset(cert.witness[1]))
            universe = frozenset(range(n))
            return (len(a) == q1 and len(b) == q2 and a <= universe
                    and b <= universe and not (a & b))
        if n <= EXHAUSTIVE_N:
            ids = range(n)
            return all(set(qa) & set(qb)
                       for qa in combinations(ids, q1)
                       for qb in combinations(ids, q2))
        return q1 + q2 > n
    if cert.system == "grid":
        if cert.rows * cert.cols != cert.n:
            return False
        if not cert.intersects:
            if cert.witness is None or cert.q1 != cert.q2:
                return False
            lines = _grid_lines(cert, cert.q1)
            a, b = (frozenset(cert.witness[0]), frozenset(cert.witness[1]))
            return (a in map(frozenset, lines) and b in map(frozenset, lines)
                    and not (a & b))
        return all(set(qa) & set(qb)
                   for qa in _grid_lines(cert, cert.q1)
                   for qb in _grid_lines(cert, cert.q2))
    return False


def majority(n: int) -> int:
    """The default threshold compiled into the kernels
    (``MinPaxosConfig.majority``): q = n // 2 + 1, both phases."""
    return n // 2 + 1


def certified_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """The certified ``(q1, q2)`` threshold pairs for ``n`` replicas,
    straight from the append-only ledger
    (``verify/quorum_golden.GOLDEN_THRESHOLDS``)."""
    from minpaxos_tpu_torch.verify.quorum_golden import GOLDEN_THRESHOLDS

    return tuple(GOLDEN_THRESHOLDS.get(n, ()))


def spec_quorums(n: int, q1: int = 0, q2: int = 0) -> tuple[int, int]:
    """Resolve a model configuration's quorum pair for the abstract
    spec (verify/spec.py): 0-sentinels become the majority default
    exactly as ``MinPaxosConfig.quorum1/quorum2`` resolve them, and
    the resulting pair MUST be in the certified ledger — re-proved
    here, not just looked up. This is the spec's ONLY quorum
    parameter source, so the abstract machine and the compiled
    kernels can never disagree about which (q1, q2) are legal."""
    rq1 = q1 if q1 > 0 else majority(n)
    rq2 = q2 if q2 > 0 else majority(n)
    if (rq1, rq2) not in certified_pairs(n):
        raise ValueError(
            f"(q1={rq1}, q2={rq2}) at n={n} is not in the certified "
            f"ledger (verify/quorum_golden.py); certify it first "
            f"via python -m minpaxos_tpu_torch.cli.mc --certify "
            f"{n},{rq1},{rq2}")
    cert = certify_threshold(n, rq1, rq2)
    if not (cert.intersects and verify_certificate(cert)):
        raise ValueError(
            f"ledger pair (q1={rq1}, q2={rq2}) at n={n} fails "
            f"re-certification: {cert.reason}")
    return rq1, rq2


def certify_fast(n: int, q1: int, qf: int) -> Certificate:
    """Fast Flexible Paxos fast-quorum certificate (PAPERS.md
    2008.02671): a fast quorum Qf is safe iff any two fast quorums
    intersect within every phase-1 quorum — for threshold systems,
    |Qf ∩ Qf' ∩ Q1| >= 2*qf + q1 - 2n >= 1, i.e. 2*qf + q1 > 2n
    (classic Fast Paxos' qf = ceil(3n/4) is the q1 = majority special
    case). Refutations carry a witness (Qf, Qf') pair whose overlap
    misses a Q1. NOTE: the shipped kernel additionally restricts
    qf = n (models/minpaxos.py fast_path field note — its index-
    tiebreak phase-1 adoption needs the committed value on every
    replica); this certificate proves the general condition."""
    if not (1 <= q1 <= n and 1 <= qf <= n):
        raise ValueError(
            f"degenerate quorum thresholds for n={n}: q1={q1}, qf={qf} "
            f"(must satisfy 1 <= q <= n)")
    if 2 * qf + q1 > 2 * n:
        return Certificate(
            "fast-threshold", n, q1, qf, True,
            f"|Qf ∩ Qf' ∩ Q1| >= 2*qf + q1 - 2n = {2 * qf + q1 - 2 * n}"
            f" >= 1 for every Qf, Qf', Q1")
    a = tuple(range(qf))
    b = tuple(range(n - qf, n))
    return Certificate(
        "fast-threshold", n, q1, qf, False,
        f"2*qf + q1 = {2 * qf + q1} <= 2n = {2 * n}: two fast quorums "
        f"can overlap outside some phase-1 quorum",
        witness=(a, b))


def validate_config_quorums(cfg) -> Certificate:
    """Certify the quorums a config would compile into the kernels, or
    raise ``ValueError`` with the refutation witness. Called by the
    host-side constructors (models/cluster.py, cli/server.py, the
    chaos harness) — NOT by the kernels or the model checker, which
    must be able to run planted non-intersecting mutants
    (verify/mc.py). Duck-typed: anything with ``n_replicas``/
    ``quorum1``/``quorum2`` (MinPaxosConfig) works."""
    n = cfg.n_replicas
    q1, q2 = cfg.quorum1, cfg.quorum2
    cert = certify_threshold(n, q1, q2)
    if not cert.intersects:
        raise ValueError(
            f"non-intersecting quorum config n={n}, q1={q1}, q2={q2}: "
            f"{cert.reason}; witness quorums {cert.witness} commit "
            f"split-brain under partition")
    if getattr(cfg, "fast_path", False):
        if getattr(cfg, "explicit_commit", False):
            raise ValueError("fast_path supports the minpaxos kernel "
                             "only (explicit_commit must be False)")
        qf = cfg.quorum_fast
        if qf != n:
            raise ValueError(
                f"fast_path with q_fast={qf} != n={n}: the kernel's "
                f"index-tiebreak phase-1 adoption is only safe at "
                f"unanimous fast quorums (fast_path field note)")
        fcert = certify_fast(n, q1, qf)
        if not fcert.intersects:
            raise ValueError(
                f"fast quorum refuted for n={n}, q1={q1}, qf={qf}: "
                f"{fcert.reason}")
    return cert
