"""paxref abstract spec: an executable abstract Multi-Paxos machine.

The reference codebase certifies its Go implementation against a
718-line TLA+ spec. This module is that spec's executable counterpart
for the *compiled* kernels: a host-side abstract Multi-Paxos state
machine — ballots, per-slot vote sets, chosen values — with the five
classic actions (Phase1a/1b/2a/2b/Commit) as methods that either
apply or raise :class:`SpecViolation` with the exact precondition
that failed.

Quorum parameterization mirrors Flexible Paxos (1608.06696): every
action that forms a quorum takes its threshold from the ``(q1, q2)``
pair the machine was built with, and the ONLY legal source for that
pair is the certified ledger re-exported by
:func:`minpaxos_tpu_torch.verify.quorum.spec_quorums`, so the abstract
spec and the step can never disagree about which ``(q1, q2)`` are
legal.

:mod:`minpaxos_tpu_torch.verify.refine` maps every edge of the model
checker's explored state graph onto these actions (or a stutter) and
reports any concrete step with no abstract counterpart.
:data:`MSGKIND_ACTIONS` declares, for every ``MsgKind`` a step handles,
its abstract actions.

The port's own copy of the JAX package's ``verify/spec.py``, pure
stdlib.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: ballots: the kernels' encoding (models/minpaxos.py make_ballot)
NO_BALLOT = -1

#: the abstract action vocabulary. ``Skip`` is Mencius's cede action
#: (the slot owner unilaterally chooses a no-op in a slot only it may
#: propose into — ownership IS the quorum); ``Stutter`` labels
#: concrete steps that change no abstract state (bookkeeping,
#: retries, frontier gossip).
ABSTRACT_ACTIONS = (
    "Phase1a", "Phase1b", "Phase2a", "Phase2b", "Commit", "Skip",
    "Stutter",
)

#: step MsgKind-handling branch -> declared abstract action(s): every
#: ``MsgKind`` a step matches on (``k == int(MsgKind.X)``) appears
#: here, and every entry names only ABSTRACT_ACTIONS members. A plain
#: dict of tuples of strings, equal to the JAX package's table.
MSGKIND_ACTIONS = {
    # a PREPARE delivers a proposer's ballot announcement (Phase1a)
    # and the receiving acceptor's promise adoption (Phase1b)
    "PREPARE": ("Phase1a", "Phase1b"),
    # quorum-1 formation at the proposer; counting promises is
    # proposer bookkeeping that enables Phase2a
    "PREPARE_REPLY": ("Phase1b", "Phase2a"),
    # an ACCEPT carries the proposer's Phase2a value; delivery is the
    # acceptor's vote
    "ACCEPT": ("Phase2a", "Phase2b"),
    # vote counting at the proposer; a q2-th ack enables Commit
    "ACCEPT_REPLY": ("Commit",),
    # explicit decided-value transfer: learning an existing choice
    "COMMIT": ("Commit",),
    "COMMIT_SHORT": ("Commit",),
    # client ingress: slot assignment is the leader's Phase2a; the
    # leader's own-slot write is its Phase2b vote
    "PROPOSE": ("Phase2a", "Phase2b"),
    # per-instance recovery sweep: a slot-ranged Phase1a, answered by
    # promises
    "PREPARE_INST": ("Phase1a", "Phase1b"),
    # recovery answers: promises plus highest-vote adoption feeding
    # the re-drive Phase2a
    "PREPARE_INST_REPLY": ("Phase1b", "Phase2a"),
    # Mencius cede: owner's unilateral no-op choice
    "SKIP": ("Skip",),
}


class SpecViolation(Exception):
    """An abstract action's precondition failed (the action is not
    enabled in the current abstract state)."""


@dataclass
class SpecState:
    """Abstract Multi-Paxos state, mirroring the reference TLA+ spec's
    variables:

    * ``max_bal[a]`` — acceptor ``a``'s promise (highest ballot it
      participates in); TLA ``maxBal``.
    * ``proposals[(b, s)]`` — the unique value ballot ``b``'s proposer
      phase-2a'd for slot ``s``; TLA ``msgs2a`` (at most ONE value per
      (ballot, slot) — the invariant refinement leans on).
    * ``votes[(a, s)][b]`` — the value acceptor ``a`` voted for slot
      ``s`` at ballot ``b``; TLA ``maxVBal``/``maxVVal`` kept as the
      full vote set.
    * ``chosen[s]`` — the decided value, once a q2 quorum voted it.

    Values are opaque hashables (the refinement layer uses the
    kernels' byte-level value tuples).
    """

    n: int
    q1: int
    q2: int
    max_bal: list[int] = field(default_factory=list)
    started: set[int] = field(default_factory=set)
    proposals: dict[tuple[int, int], object] = field(default_factory=dict)
    votes: dict[tuple[int, int], dict[int, object]] = field(
        default_factory=dict)
    chosen: dict[int, object] = field(default_factory=dict)

    def __post_init__(self):
        if not self.max_bal:
            self.max_bal = [NO_BALLOT] * self.n
        if not (1 <= self.q1 <= self.n and 1 <= self.q2 <= self.n):
            raise SpecViolation(
                f"quorums out of range: q1={self.q1} q2={self.q2} "
                f"n={self.n}")

    # ----------------------------------------------------------- actions

    def phase1a(self, ballot: int) -> None:
        """A proposer starts ballot ``ballot`` (always enabled; fresh
        ballots are the caller's responsibility — the kernels encode
        uniqueness as ``counter*16 + replica_id``)."""
        if ballot <= NO_BALLOT:
            raise SpecViolation(f"Phase1a: ballot {ballot} not positive")
        self.started.add(ballot)

    def phase1b(self, acceptor: int, ballot: int) -> None:
        """Acceptor promises ballot: enabled iff it raises the
        acceptor's promise."""
        if not 0 <= acceptor < self.n:
            raise SpecViolation(f"Phase1b: no acceptor {acceptor}")
        if ballot <= self.max_bal[acceptor]:
            raise SpecViolation(
                f"Phase1b: ballot {ballot} <= promise "
                f"{self.max_bal[acceptor]} at acceptor {acceptor}")
        self.max_bal[acceptor] = ballot

    def _safe_at(self, ballot: int, slot: int, value) -> bool:
        """The Phase2a value constraint: there is a q1-sized set of
        acceptors promised >= ballot whose highest vote for ``slot``
        below ``ballot`` is ``value`` (or that never voted for it)."""
        quorum = [a for a in range(self.n) if self.max_bal[a] >= ballot]
        if len(quorum) < self.q1:
            return False
        # the highest vote below `ballot` among SOME q1 subset decides;
        # maximizing freedom, drop the highest-voting extras first
        best = (NO_BALLOT, None)
        ranked = sorted(
            quorum,
            key=lambda a: max([b for b in self.votes.get((a, slot), {})
                               if b < ballot], default=NO_BALLOT))
        for a in ranked[:self.q1]:
            for b, v in self.votes.get((a, slot), {}).items():
                if b < ballot and b > best[0]:
                    best = (b, v)
        return best[0] == NO_BALLOT or best[1] == value

    def phase2a(self, ballot: int, slot: int, value) -> None:
        """Ballot's proposer proposes ``value`` for ``slot``: enabled
        iff no DIFFERENT value was already proposed at (ballot, slot),
        the ballot was started, and the value is safe at this ballot
        (a q1 promise quorum whose highest prior vote is this value)."""
        if ballot not in self.started:
            raise SpecViolation(f"Phase2a: ballot {ballot} never started")
        prior = self.proposals.get((ballot, slot))
        if prior is not None and prior != value:
            raise SpecViolation(
                f"Phase2a: ({ballot}, {slot}) already proposed "
                f"{prior!r} != {value!r}")
        if not self._safe_at(ballot, slot, value):
            raise SpecViolation(
                f"Phase2a: {value!r} not safe at ballot {ballot} "
                f"slot {slot} (no q1={self.q1} promise quorum "
                f"supports it)")
        self.proposals[(ballot, slot)] = value

    def phase2b(self, acceptor: int, ballot: int, slot: int) -> None:
        """Acceptor votes for the (ballot, slot) proposal: enabled iff
        the proposal exists and the ballot is >= the acceptor's
        promise. Voting raises the promise to the ballot."""
        if (ballot, slot) not in self.proposals:
            raise SpecViolation(
                f"Phase2b: nothing proposed at ({ballot}, {slot})")
        if ballot < self.max_bal[acceptor]:
            raise SpecViolation(
                f"Phase2b: ballot {ballot} < promise "
                f"{self.max_bal[acceptor]} at acceptor {acceptor}")
        value = self.proposals[(ballot, slot)]
        cell = self.votes.setdefault((acceptor, slot), {})
        if ballot in cell and cell[ballot] != value:
            raise SpecViolation(
                f"Phase2b: acceptor {acceptor} already voted "
                f"{cell[ballot]!r} at ({ballot}, {slot})")
        cell[ballot] = value
        self.max_bal[acceptor] = max(self.max_bal[acceptor], ballot)

    def commit(self, slot: int, value) -> None:
        """Decide ``slot``: enabled iff some ballot accumulated a
        q2-sized vote quorum for ``value`` — and a prior choice, if
        any, matches (choices are forever)."""
        prior = self.chosen.get(slot)
        if prior is not None and prior != value:
            raise SpecViolation(
                f"Commit: slot {slot} already chose {prior!r} != "
                f"{value!r}")
        for ballot in self.started | {0}:
            voters = sum(
                1 for a in range(self.n)
                if self.votes.get((a, slot), {}).get(ballot) == value)
            if voters >= self.q2:
                self.chosen[slot] = value
                return
        raise SpecViolation(
            f"Commit: no ballot holds a q2={self.q2} vote quorum for "
            f"{value!r} at slot {slot}")

    def skip(self, owner: int, slot: int, noop) -> None:
        """Mencius cede: the slot's OWNER unilaterally chooses a no-op
        in a slot only it may propose into (round-robin ownership is a
        standing phase-1+2 quorum of one for the owner's untouched
        slots)."""
        if slot % self.n != owner:
            raise SpecViolation(
                f"Skip: slot {slot} not owned by {owner} (owner "
                f"{slot % self.n})")
        prior = self.chosen.get(slot)
        if prior is not None and prior != noop:
            raise SpecViolation(
                f"Skip: slot {slot} already chose {prior!r}")
        self.chosen[slot] = noop

    # --------------------------------------------------------- theorems

    def check_agreement(self) -> None:
        """The spec's own safety theorem, used by its unit tests: with
        a certified (q1, q2) pair, two quorums of votes for one slot
        can never disagree. Raises SpecViolation on the first
        double-chosen slot (reachable only via non-intersecting
        quorums)."""
        for slot in {s for (_a, s) in self.votes}:
            decided: dict[object, int] = {}
            for ballot in self.started | {0}:
                for value in {v for (a, s), cell in self.votes.items()
                              if s == slot
                              for b, v in cell.items() if b == ballot}:
                    voters = sum(
                        1 for a in range(self.n)
                        if self.votes.get((a, slot), {}).get(ballot)
                        == value)
                    if voters >= self.q2:
                        decided[value] = ballot
            if len(decided) > 1:
                raise SpecViolation(
                    f"agreement broken at slot {slot}: "
                    f"{sorted(map(repr, decided))} all hold q2 quorums")


def spec_for_model(n: int, q1: int = 0, q2: int = 0) -> SpecState:
    """Build the abstract machine for a model configuration, resolving
    the 0-sentinel quorums exactly as ``MinPaxosConfig`` does and
    refusing any pair the certified ledger doesn't carry (the
    spec/kernel agreement guarantee — verify/quorum.py
    ``spec_quorums``)."""
    from minpaxos_tpu_torch.verify.quorum import spec_quorums

    rq1, rq2 = spec_quorums(n, q1, q2)
    return SpecState(n=n, q1=rq1, q2=rq2)
