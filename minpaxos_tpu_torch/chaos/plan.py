"""Fault plans: per-directed-link chaos policies, seeded and serializable.

The port's copy of the JAX package's ``chaos/plan.py``, unchanged: the
same plan dicts travel between the two packages' control planes.

A :class:`FaultPlan` describes what the network does to every directed
replica->replica link. It is cluster-wide and JSON-serializable: the
campaign runner builds one plan, ships the same dict to every replica
via the ``CHAOS`` control verb (master ``cluster_chaos`` fan-out), and
each replica's :class:`~minpaxos_tpu_torch.chaos.shim.ChaosShim` enforces the
slice that concerns it — outbound ``block`` for links it is the source
of, the full policy for links it is the destination of. Enforcing
``block`` at both ends is idempotent, so a partition is airtight even
while the install fan-out is still propagating; the probabilistic
policies (drop/dup) run only at the receiver, so rates are applied
exactly once per frame.

Determinism: the plan carries one integer ``seed``. Every per-link
decision stream is a ``np.random.Generator`` seeded from
``[seed, src, dst]`` (reorder permutations from a separate
``[seed, src, dst, 1]`` stream so time-driven buffer flushes cannot
desynchronize the drop/dup/delay draws), and each frame consumes a
fixed number of draws — so for a given frame sequence on a link, the
same plan + seed always makes the same decisions, regardless of what
the other links or the wall clock are doing.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

#: delay ceiling (seconds) — a plan cannot schedule a frame further out
#: than this; keeps a typo'd jitter from parking traffic for minutes
MAX_DELAY_S = 10.0


@dataclass
class LinkPolicy:
    """What one directed link does to each frame crossing it.

    ``block`` wins over everything (the frame vanishes); otherwise the
    frame is independently dropped with ``drop`` probability, delivered
    after ``delay_s + U[0, jitter_s)``, duplicated with ``dup``
    probability, and — with ``reorder`` >= 2 — buffered until
    ``reorder`` frames are held, then released in a seeded random
    permutation (a time-based flush releases stragglers in order).
    """

    drop: float = 0.0
    delay_s: float = 0.0
    jitter_s: float = 0.0
    dup: float = 0.0
    reorder: int = 0
    block: bool = False

    def __post_init__(self):
        if not (0.0 <= self.drop <= 1.0 and 0.0 <= self.dup <= 1.0):
            raise ValueError(f"drop/dup must be probabilities: {self}")
        if self.delay_s < 0 or self.jitter_s < 0 \
                or self.delay_s + self.jitter_s > MAX_DELAY_S:
            raise ValueError(f"delay+jitter outside [0, {MAX_DELAY_S}]: "
                             f"{self}")
        if self.reorder < 0:
            raise ValueError(f"reorder window must be >= 0: {self}")

    def is_noop(self) -> bool:
        return (not self.block and self.drop == 0.0 and self.dup == 0.0
                and self.delay_s == 0.0 and self.jitter_s == 0.0
                and self.reorder < 2)


class FaultPlan:
    """Cluster-wide chaos description: {directed link -> LinkPolicy}.

    The link-setting methods mutate and return ``self`` so schedules
    read as one chained expression; ``to_dict``/``from_dict`` round-trip the
    plan through the JSON control plane losslessly.
    """

    def __init__(self, n_replicas: int, seed: int = 0):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1: {n_replicas}")
        self.n = n_replicas
        self.seed = int(seed)
        self.links: dict[tuple[int, int], LinkPolicy] = {}

    # -- link policies --

    def set_link(self, src: int, dst: int, **policy) -> "FaultPlan":
        self._check_id(src)
        self._check_id(dst)
        if src == dst:
            raise ValueError("a replica has no link to itself")
        self.links[(src, dst)] = LinkPolicy(**policy)
        return self

    def all_links(self, **policy) -> "FaultPlan":
        """Apply one policy to every directed link in the cluster."""
        for s in range(self.n):
            for d in range(self.n):
                if s != d:
                    self.set_link(s, d, **policy)
        return self

    def partition(self, group_a: list[int], group_b: list[int],
                  one_way: bool = False) -> "FaultPlan":
        """Block every link from ``group_a`` to ``group_b`` (and the
        reverse direction too unless ``one_way``). Existing policies on
        other links are kept — partitions compose with loss/delay."""
        for a in group_a:
            for b in group_b:
                if a == b:
                    raise ValueError(f"replica {a} in both groups")
                self.set_link(a, b, block=True)
                if not one_way:
                    self.set_link(b, a, block=True)
        return self

    def isolate(self, rid: int) -> "FaultPlan":
        """Symmetric partition of one replica from everyone else."""
        rest = [r for r in range(self.n) if r != rid]
        return self.partition([rid], rest)

    # -- queries --

    def link(self, src: int, dst: int) -> LinkPolicy | None:
        return self.links.get((src, dst))

    def is_noop(self) -> bool:
        return all(p.is_noop() for p in self.links.values())

    # -- serialization (JSON control plane) --

    def to_dict(self) -> dict:
        return {"n": self.n, "seed": self.seed,
                "links": {f"{s}>{d}": asdict(p)
                          for (s, d), p in sorted(self.links.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        plan = cls(int(d["n"]), int(d.get("seed", 0)))
        for key, pol in d.get("links", {}).items():
            src_s, _, dst_s = key.partition(">")
            plan.set_link(int(src_s), int(dst_s), **pol)
        return plan

    def _check_id(self, rid: int) -> None:
        if not 0 <= rid < self.n:
            raise ValueError(f"replica id {rid} outside [0, {self.n})")

    def __repr__(self) -> str:
        faulted = ", ".join(
            f"{s}>{d}:" + ("block" if p.block else "pol")
            for (s, d), p in sorted(self.links.items()) if not p.is_noop())
        return f"FaultPlan(n={self.n}, seed={self.seed}, [{faulted}])"
