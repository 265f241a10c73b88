"""paxref refinement checking on the port: every explored edge must be abstract.

The port of the JAX package's ``verify/refine.py``. The model checker
(``verify/mc.py``) certifies invariants on explored states; this module
certifies the transitions: each concrete step of the port must
correspond to abstract Multi-Paxos actions (``verify/spec.py``) or be a
stutter. The :class:`RefinementExplorer` is the plain explorer with the
per-edge ``check_edge`` hook filled in.

**The refinement mapping** (history-free, reading the state bytes the
explorer already hashes): acceptor promise <- ``default_ballot``
(minpaxos/classic); acceptor votes <- per-slot ``(ballot, value)`` for
slots with ``status >= ACCEPTED``; chosen values <- slots with
``status >= COMMITTED``; quorum evidence <- the per-slot ``votes`` ack
bitmask and the ``prepare_oks`` phase-1 set. Each edge is classified as
``Phase1b`` (the promise rose; it never sinks), ``Phase2b`` (a vote
appeared or moved to a higher ballot; one value per (ballot, slot)
across replicas), ``Commit`` (legal iff the stepping replica holds a
``q2``-sized ack quorum, or some replica already chose the same value;
chosen values are forever), ``Skip`` (Mencius: a no-op committed for
the slot's owner) or ``Stutter``.

The ``(q1, q2)`` thresholds come from
:func:`minpaxos_tpu_torch.verify.quorum.spec_quorums` — the certified
ledger, not the explorer's config — so a step whose quorum arithmetic
drifts from the ledger is flagged even when no safety invariant breaks.

**Planted mutant.** ``mutant="skip-quorum2"``: the leader's commit scan
drops its ``n_votes >= quorum2`` gate, committing own-ballot accepts
immediately. No invariant fails, but the commit edge has no abstract
counterpart (tests/fixtures/mc_refine_skip_quorum2_minpaxos.json). On
the batched path the mutation is a per-row hook on every stepped state
(numpy on the row, as the reference rewrites its stepped state).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from minpaxos_tpu_torch.models.minpaxos import NO_BALLOT
from minpaxos_tpu_torch.verify import invariants
from minpaxos_tpu_torch.verify.mc import CHUNK, Counterexample, Explorer
from minpaxos_tpu_torch.verify.quorum import spec_quorums
from minpaxos_tpu_torch.wire.messages import ACCEPTED, COMMITTED, Op

#: every refinement violation message carries this marker
MARK = "REFINEMENT"

#: the value identity fields (byte-level command identity, the same
#: columns invariants.VALUE_FIELDS compares)
_VALUE_COLS = ("op", "key_hi", "key_lo", "val_hi", "val_lo", "cmd_id",
               "client_id")


def _slot_values(st) -> list[tuple[int, ...]]:
    cols = [np.asarray(getattr(st, f)) for f in _VALUE_COLS]
    return [tuple(int(c[i]) for c in cols) for i in range(len(cols[0]))]


def _popcount(x: int) -> int:
    return bin(x & 0xFFFF).count("1")


class RefinementExplorer(Explorer):
    """The plain bounded explorer plus the per-edge refinement check
    (and, optionally, a planted kernel mutation)."""

    _edge_checked = True

    def __init__(self, protocol: str, bounds=None,
                 majority_override=None, q1: int = 0, q2: int = 0,
                 n_replicas: int = 3, mutant: str | None = None,
                 device="cuda", chunk: int = CHUNK):
        super().__init__(protocol, bounds, majority_override, q1=q1,
                         q2=q2, n_replicas=n_replicas, device=device,
                         chunk=chunk)
        if mutant not in (None, "skip-quorum2"):
            raise ValueError(f"unknown refinement mutant {mutant!r}")
        self.mutant = mutant
        # the spec's thresholds: certified-ledger resolution of the
        # SAME (q1, q2) the config compiled — never the explorer's raw
        # fields, so a threshold the ledger doesn't certify is refused
        # here before any exploration
        self.spec_q1, self.spec_q2 = spec_quorums(n_replicas, q1, q2)
        self.edges_checked = 0
        self.action_counts: Counter = Counter()

    # ------------------------------------------------------ mutant hook

    def _post_step(self, st):
        if self.mutant == "skip-quorum2":
            return self._skip_quorum2(st)
        return st

    def _skip_quorum2(self, st):
        """The planted bug: a leader's own-ballot accepts commit
        without the quorum2 vote scan."""
        if not hasattr(st, "default_ballot"):
            return st  # minpaxos/classic kernel only
        if (int(st.leader_id) != int(st.me)
                or not bool(np.asarray(st.prepared))):
            return st
        status = np.asarray(st.status).copy()
        ballot = np.asarray(st.ballot)
        mask = (status == ACCEPTED) & (ballot == int(st.default_ballot))
        if not mask.any():
            return st
        status[mask] = COMMITTED
        upto = int(st.committed_upto)
        while upto + 1 < status.shape[0] and status[upto + 1] >= COMMITTED:
            upto += 1
        return st._replace(status=status, committed_upto=np.int32(upto))

    # --------------------------------------------------------- factory

    def _make_ce(self, trace, report, states_explored) -> Counterexample:
        ce = super()._make_ce(trace, report, states_explored)
        ce.kind = "refinement"
        ce.mutant = self.mutant
        return ce

    # ------------------------------------------------------- edge check

    def check_edge(self, pre_node, action, post_node,
                   report: invariants.CheckReport) -> None:
        self.edges_checked += 1
        a = action["a"]
        if a == "drop":
            self.action_counts["Stutter"] += 1
            return
        r = action["r"] if a in ("tick", "elect") else action["link"][1]
        pre, post = pre_node[0][r], post_node[0][r]
        labels: set[str] = set()

        # -- promise monotonicity (Phase1b enabledness) ---------------
        has_promise = hasattr(pre, "default_ballot")
        post_prom = NO_BALLOT
        if has_promise:
            pre_prom = int(pre.default_ballot)
            post_prom = int(post.default_ballot)
            if post_prom < pre_prom:
                report.add(
                    f"{MARK} promise-backward: replica {r} promise "
                    f"{pre_prom} -> {post_prom} on {a} (no abstract "
                    f"action lowers a promise)")
            elif post_prom > pre_prom:
                labels.add("Phase1b")
                if a == "elect":
                    labels.add("Phase1a")

        # -- phase-1 quorum formation ---------------------------------
        if (has_promise and not bool(np.asarray(pre.prepared))
                and bool(np.asarray(post.prepared))):
            oks = int(np.asarray(post.prepare_oks).sum())
            if oks < self.spec_q1:
                report.add(
                    f"{MARK} prepared-no-quorum: replica {r} prepared "
                    f"with {oks} phase-1 oks < q1={self.spec_q1}")
            labels.add("Phase2a")  # quorum in hand enables proposing

        # -- per-slot vote / commit transitions -----------------------
        st_pre = np.asarray(pre.status)
        st_post = np.asarray(post.status)
        b_pre = np.asarray(pre.ballot)
        b_post = np.asarray(post.ballot)
        v_pre = _slot_values(pre)
        v_post = _slot_values(post)
        votes_post = np.asarray(post.votes)
        changed = np.nonzero(
            (st_pre != st_post) | (b_pre != b_post)
            | np.array([v_pre[i] != v_post[i]
                        for i in range(len(v_pre))]))[0]
        for i in changed:
            i = int(i)
            pre_com = st_pre[i] >= COMMITTED
            post_com = st_post[i] >= COMMITTED
            pre_vote = st_pre[i] >= ACCEPTED
            post_vote = st_post[i] >= ACCEPTED
            val_diff = v_pre[i] != v_post[i]
            if pre_com:
                # chosen values are forever
                if not post_com:
                    report.add(
                        f"{MARK} chosen-retracted: replica {r} slot "
                        f"{i} left COMMITTED on {a}")
                elif val_diff:
                    report.add(
                        f"{MARK} chosen-mutated: replica {r} slot {i} "
                        f"changed a chosen value {v_pre[i]} -> "
                        f"{v_post[i]} on {a}")
                continue
            if post_com:
                if (self.protocol == "mencius"
                        and v_post[i][0] == int(Op.NONE)):
                    labels.add("Skip")  # owner cede / learned skip
                else:
                    acks = _popcount(int(votes_post[i]))
                    learned = any(
                        int(np.asarray(o.status)[i]) >= COMMITTED
                        and _slot_values(o)[i] == v_post[i]
                        for j, o in enumerate(pre_node[0]) if j != r)
                    if acks >= self.spec_q2 or learned:
                        labels.add("Commit")
                    else:
                        report.add(
                            f"{MARK} commit-no-quorum: replica {r} "
                            f"slot {i} committed with {acks} votes < "
                            f"q2={self.spec_q2} and no replica had "
                            f"chosen it (value {v_post[i]}, {a})")
            if post_vote and (not pre_vote or b_pre[i] != b_post[i]
                              or val_diff):
                nb = int(b_post[i])
                if pre_vote and nb < int(b_pre[i]) and not post_com:
                    report.add(
                        f"{MARK} vote-ballot-backward: replica {r} "
                        f"slot {i} vote ballot {int(b_pre[i])} -> {nb}")
                if pre_vote and nb == int(b_pre[i]) and val_diff:
                    report.add(
                        f"{MARK} revote-same-ballot: replica {r} slot "
                        f"{i} re-voted {v_pre[i]} -> {v_post[i]} at "
                        f"ballot {nb} (one value per ballot per slot)")
                if has_promise and nb > post_prom:
                    report.add(
                        f"{MARK} vote-above-promise: replica {r} slot "
                        f"{i} voted at ballot {nb} > promise "
                        f"{post_prom}")
                labels.add("Phase2b")
                # a vote at a ballot carrying the voter's own id is
                # the proposer's own write: Phase2a + Phase2b fused
                if nb >= 0 and nb % 16 == r:
                    labels.add("Phase2a")
                # Phase2a uniqueness across replicas: same (ballot,
                # slot), different value = two proposals at one ballot
                for j, o in enumerate(post_node[0]):
                    if j == r:
                        continue
                    if (int(np.asarray(o.status)[i]) >= ACCEPTED
                            and int(np.asarray(o.ballot)[i]) == nb
                            and _slot_values(o)[i] != v_post[i]):
                        report.add(
                            f"{MARK} phase2a-uniqueness: replicas "
                            f"{r}/{j} hold different values at "
                            f"(ballot {nb}, slot {i}): {v_post[i]} "
                            f"vs {_slot_values(o)[i]}")
        if not labels:
            labels.add("Stutter")
        for lab in labels:
            self.action_counts[lab] += 1

    # ---------------------------------------------------------- stats

    def refine_stats(self) -> dict:
        return {"edges_checked": self.edges_checked,
                "spec_q1": self.spec_q1, "spec_q2": self.spec_q2,
                "mutant": self.mutant,
                "abstract_actions": dict(
                    sorted(self.action_counts.items()))}
