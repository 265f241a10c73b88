"""The certified quorum ledger: every (system, q1, q2) the tree may use.

The port's own copy of the JAX package's ``analysis/quorum_golden.py``
(the same entries; ``tests/test_torch_verify.py`` holds the two equal).
An append-only record of quorum configurations whose intersection
property has been PROVED by ``verify/quorum.py`` certificates, which
re-verify every entry from scratch. ``verify/quorum.py
certified_pairs`` and ``spec_quorums`` read it: a pair the ledger does
not carry is refused before any exploration.

Rules:

* every entry must re-prove on every run — entries are certificates,
  not trust;
* a REFUTED configuration never enters the ledger.

``THRESHOLD_FORMULAS`` names the formulas (as functions of the replica
count ``n``) recognized as certified families; each must map into
``GOLDEN_THRESHOLDS`` for every n in [1, GOLDEN_MAX_N].
"""

from __future__ import annotations

#: replica-count ceiling certified here (the make_ballot encoding caps
#: replicas at 16 — verify/quorum.py MAX_N)
GOLDEN_MAX_N = 16

#: certified-intersecting threshold pairs: n -> tuple of (q1, q2).
#: The simple-majority family q1 == q2 == n // 2 + 1 is what the
#: kernels compile today (MinPaxosConfig.majority); the extra (q1, q2)
#: pairs at n = 3, 5, 7 pre-certify the flexible-quorum sweeps ROADMAP
#: item 2 plans (small q2 for steady-state speed, large q1 for
#: recovery: |Q1| + |Q2| > N).
#: The unanimous pair (n, n) certifies MinPaxosConfig.quorum_fast
#: (the fast-path fast quorum, which the kernel pins at n; trivially
#: intersecting since n + n > n for every n >= 1).
GOLDEN_THRESHOLDS: dict[int, tuple[tuple[int, int], ...]] = {
    1: ((1, 1),),
    2: ((2, 2), (1, 2), (2, 1)),
    3: ((2, 2), (3, 1), (1, 3), (3, 3)),
    4: ((3, 3), (3, 2), (2, 3), (4, 1), (1, 4), (4, 4)),
    5: ((3, 3), (4, 2), (2, 4), (5, 1), (1, 5), (5, 5)),
    6: ((4, 4), (4, 3), (3, 4), (5, 2), (2, 5), (6, 6)),
    7: ((4, 4), (5, 3), (3, 5), (6, 2), (2, 6), (7, 7)),
    8: ((5, 5), (5, 4), (4, 5), (6, 3), (3, 6), (8, 8)),
    9: ((5, 5), (6, 4), (4, 6), (7, 3), (3, 7), (9, 9)),
    10: ((6, 6), (6, 5), (5, 6), (10, 10)),
    11: ((6, 6), (7, 5), (5, 7), (11, 11)),
    12: ((7, 7), (7, 6), (6, 7), (12, 12)),
    13: ((7, 7), (8, 6), (6, 8), (13, 13)),
    14: ((8, 8), (8, 7), (7, 8), (14, 14)),
    15: ((8, 8), (9, 7), (7, 9), (15, 15)),
    16: ((9, 9), (9, 8), (8, 9), (16, 16)),
}

#: certified-intersecting grid systems (Fast Flexible Paxos 2008.02671):
#: (rows, cols, q1_axis, q2_axis). Row-by-column assignments intersect
#: at the crossing cell; these shapes cover every grid that fits the
#: 16-replica ballot cap.
GOLDEN_GRIDS: tuple[tuple[int, int, str, str], ...] = (
    (2, 2, "row", "col"),
    (2, 3, "row", "col"),
    (3, 2, "row", "col"),
    (2, 4, "row", "col"),
    (4, 2, "row", "col"),
    (3, 3, "row", "col"),
    (2, 5, "row", "col"),
    (5, 2, "row", "col"),
    (2, 6, "row", "col"),
    (6, 2, "row", "col"),
    (3, 4, "row", "col"),
    (4, 3, "row", "col"),
    (2, 7, "row", "col"),
    (7, 2, "row", "col"),
    (3, 5, "row", "col"),
    (5, 3, "row", "col"),
    (2, 8, "row", "col"),
    (8, 2, "row", "col"),
    (4, 4, "row", "col"),
)

#: threshold formulas (functions of the replica count n) the
#: quorum-certificate pass recognizes as certified families. Each must
#: evaluate into GOLDEN_THRESHOLDS for every n in [1, GOLDEN_MAX_N];
#: the pass evaluates candidate source expressions against these.
THRESHOLD_FORMULAS: dict[str, object] = {
    "n // 2 + 1": lambda n: n // 2 + 1,  # MinPaxosConfig.majority
    "n": lambda n: n,  # MinPaxosConfig.quorum_fast (unanimous fast path)
}
