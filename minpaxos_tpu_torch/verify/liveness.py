"""paxref liveness on the port: lasso/SCC model checking under weak fairness.

The port of the JAX package's ``verify/liveness.py``: **after the fault
budget is exhausted, every proposed command is eventually committed on
every fair schedule**. The planted ``dueling-leaders`` mutant (two
proposers preempting each other's phase 1 forever) must produce a
lasso.

**Model** (the reference's): the explorer builds the full reachable
transition graph over a *quotient* state — wall-clock bookkeeping
(``tick``, ``stall_ticks``, ``tenure_start``) masked out of the hash
and, for the mutant, ballots canonically renamed (rank-ordered,
proposer id kept) — with a zero fault budget: the graph is the fair
suffix after faults stop.

**Verdict**: goal states (some replica's committed log holds every
proposed command), deadlocks (an expanded non-goal state with no
enabled action) and fair lassos (a cyclic non-goal SCC in which every
continuously enabled action can be taken without leaving it). ``ok``:
drained, a goal reachable, no deadlock, no fair lasso.

**Batching.** ``explore`` visits breadth first for the healthy legs and
depth first for the mutant hunt, so a depth level is not its unit.
Breadth first, every node in the queue when a wave starts is expanded
in queue order, the stepping actions of the whole wave in one batched
step; depth first, the next node depends on the last expansion, so one
node's stepping actions make one batch. The bookkeeping (ids, edges,
the ``max_states`` cut) runs in the sequential order either way, so the
graph is the reference's.

Lassos serialize as ``paxmc-ce-v1`` counterexamples with
``kind="lasso"``: ``trace[:loop_start]`` is the stem,
``trace[loop_start:]`` the cycle; :func:`replay_lasso` re-executes both
and checks the cycle closes on the same quotient state with the
command still uncommitted.
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from minpaxos_tpu_torch.models.minpaxos import MsgBatch
from minpaxos_tpu_torch.verify import invariants
from minpaxos_tpu_torch.verify.mc import (
    CHUNK,
    CLIENT,
    Bounds,
    Counterexample,
    Explorer,
)
from minpaxos_tpu_torch.verify.quorum import spec_quorums
from minpaxos_tpu_torch.wire.messages import COMMITTED, MsgKind, Op

#: wall-clock bookkeeping masked from the quotient hash — these
#: advance on every step (or are derived from tick), so leaving them
#: in makes every state unique and liveness trivially vacuous
MASKED_FIELDS = frozenset({"tick", "stall_ticks", "tenure_start"})

#: fields holding ballots (models/minpaxos.py make_ballot
#: encoding: counter*16 + proposer id) — canonically renamed when the
#: ballot quotient is on
BALLOT_FIELDS = frozenset({"ballot", "default_ballot",
                           "max_recv_ballot", "takeover_ballot"})

_F = MsgBatch._fields
_ROW_KIND, _ROW_BALLOT = _F.index("kind"), _F.index("ballot")
_ROW_LC = _F.index("last_committed")

#: liveness violation marker
MARK = "LASSO"


@dataclass
class LivenessResult:
    protocol: str
    q1: int = 0
    q2: int = 0
    mutant: str | None = None
    states: int = 0
    transitions: int = 0
    sccs: int = 0
    cyclic_sccs: int = 0
    goal_states: int = 0
    deadlocks: int = 0
    fair_lassos: int = 0
    drained: bool = False
    wall_s: float = 0.0
    lasso: Counterexample | None = None

    @property
    def ok(self) -> bool:
        """Eventual commit under weak fairness (bounded certificate):
        goal reachable, no deadlock, no fair lasso, graph drained."""
        return (self.drained and self.goal_states > 0
                and self.deadlocks == 0 and self.fair_lassos == 0)

    def to_dict(self) -> dict:
        return {"protocol": self.protocol, "q1": self.q1, "q2": self.q2,
                "mutant": self.mutant, "states": self.states,
                "transitions": self.transitions, "sccs": self.sccs,
                "cyclic_sccs": self.cyclic_sccs,
                "goal_states": self.goal_states,
                "deadlocks": self.deadlocks,
                "fair_lassos": self.fair_lassos,
                "drained": self.drained, "ok": self.ok,
                "wall_s": round(self.wall_s, 2),
                "lasso": (None if self.lasso is None
                          else self.lasso.to_dict())}


def fair_bounds(n_cmds: int = 1, internal: int = 0,
                propose_to: tuple[int, ...] = (0,)) -> Bounds:
    """The fair-suffix bounds: zero fault budget (drops/dups/reorders
    all spent), no depth cutoff (the graph closes by itself — cycles
    are the whole point), elections off (the boot leader stands)."""
    return Bounds(max_depth=10 ** 9, drops=0, dups=0, reorders=0,
                  internal=internal, elections=0, n_cmds=n_cmds,
                  propose_to=propose_to)


def dueling_bounds() -> Bounds:
    """The mutant's bounds: same fair network, but both replicas 0 and
    1 may elect — and the mutant never charges the election budget."""
    b = fair_bounds()
    return Bounds(**{**b.to_dict(), "elections": 1,
                     "electable": (0, 1)})


class LivenessExplorer(Explorer):
    """Reachable-graph builder over the quotient state space."""

    def __init__(self, protocol: str, bounds: Bounds | None = None,
                 q1: int = 0, q2: int = 0, n_replicas: int = 3,
                 mutant: str | None = None, max_states: int = 20_000,
                 max_queue_rows: int = 24, device="cuda",
                 chunk: int = CHUNK):
        super().__init__(protocol, bounds or fair_bounds(), None,
                         q1=q1, q2=q2, n_replicas=n_replicas,
                         device=device, chunk=chunk)
        if mutant not in (None, "dueling-leaders"):
            raise ValueError(f"unknown liveness mutant {mutant!r}")
        self.mutant = mutant
        # the ballot quotient is only needed (and only sound to claim
        # results under) when ballots grow without bound — the duel
        self.ballot_quotient = mutant == "dueling-leaders"
        self.spec_q1, self.spec_q2 = spec_quorums(n_replicas, q1, q2)
        self.max_states = max_states
        self.max_queue_rows = max_queue_rows
        # byte ranges of every field the quotient hash keeps
        self._spans = self.stepper.lay.spans(MASKED_FIELDS)

    # ---------------------------------------------------- enabledness

    def _actions(self, node):
        """Paxos liveness is conditional on an established leader (FLP
        forbids the unconditional claim): a kernel consumes a PROPOSE
        delivered to an unprepared replica, which faithfully models a
        leaderless cluster shedding load — but makes "every command
        commits" fail for the wrong reason. The liveness model's
        client therefore submits only to a prepared leader; everything
        else (including the duel mutant's elections) stays enabled."""
        acts = super()._actions(node)
        states = node[0]
        out = []
        for a in acts:
            if a["a"] == "deliver" and a["link"][0] == CLIENT:
                st = states[a["link"][1]]
                if (hasattr(st, "prepared")
                        and not bool(np.asarray(st.prepared))):
                    continue
            if a["a"] == "elect" and self.mutant == "dueling-leaders":
                # dueling means PREEMPTING the rival, not re-electing
                # yourself: elect(r) only while r believes someone
                # else leads (kernel line: PREPARE adoption flips
                # leader_id to the sender, re-arming the loser)
                st = states[a["r"]]
                if int(st.leader_id) == a["r"]:
                    continue
            out.append(a)
        return out

    # ----------------------------------------------- mutant semantics

    def _apply_many(self, pairs):
        out = super()._apply_many(pairs)
        if self.mutant != "dueling-leaders":
            return out
        # the duel never runs out of elections: restore the budget
        for i, (_node, action) in enumerate(pairs):
            if action["a"] == "elect":
                states, links, (dr, du, ro, it, el) = out[i]
                out[i] = (states, links, (dr, du, ro, it, el + 1))
        return out

    # ------------------------------------------------- quotient hash

    def _ballot_renamer(self, node):
        states, links, _budgets = node
        vals: set[int] = set()
        for st in states:
            for f in st._fields:
                if f in BALLOT_FIELDS:
                    a = np.asarray(getattr(st, f)).ravel()
                    vals.update(int(x) for x in a[a > 0])
        for q in links.values():
            for row in q:
                if row[_ROW_BALLOT] > 0:
                    vals.add(row[_ROW_BALLOT])
                if (row[_ROW_KIND] == int(MsgKind.PREPARE_INST_REPLY)
                        and row[_ROW_LC] > 0):
                    vals.add(row[_ROW_LC])
        tab = np.array(sorted(vals), dtype=np.int64)

        def ren(arr: np.ndarray) -> np.ndarray:
            a = np.asarray(arr).astype(np.int64)
            if not tab.size:
                return a
            rank = np.searchsorted(tab, a)
            return np.where(a > 0, (rank + 1) * 16 + a % 16, a)

        return ren

    def _qkey(self, node) -> bytes:
        states, links, budgets = node
        ren = self._ballot_renamer(node) if self.ballot_quotient else None
        h = hashlib.blake2b(digest_size=16)
        for st in states:
            if ren is None:
                for a, b in self._spans:
                    h.update(st.buf[a:b])
                continue
            for f in st._fields:
                if f in MASKED_FIELDS:
                    continue
                if f in BALLOT_FIELDS:
                    h.update(ren(np.asarray(getattr(st, f))).tobytes())
                    continue
                fl = st.lay.fields[f]
                h.update(st.buf[fl.off:fl.off + fl.n])
        canon_links = []
        for link in sorted(links):
            rows = []
            for row in links[link]:
                if ren is not None:
                    row = list(row)
                    if row[_ROW_BALLOT] > 0:
                        row[_ROW_BALLOT] = int(
                            ren(np.asarray([row[_ROW_BALLOT]]))[0])
                    if (row[_ROW_KIND]
                            == int(MsgKind.PREPARE_INST_REPLY)
                            and row[_ROW_LC] > 0):
                        row[_ROW_LC] = int(
                            ren(np.asarray([row[_ROW_LC]]))[0])
                    row = tuple(row)
                rows.append(row)
            canon_links.append((link, tuple(rows)))
        h.update(repr(canon_links).encode())
        h.update(repr(budgets).encode())
        return h.digest()

    # ------------------------------------------------------ the goal

    def _is_goal(self, node) -> bool:
        """Some replica's committed log contains every proposed
        command — stable under every action (commits are forever)."""
        need = set(range(self.bounds.n_cmds))
        for st in node[0]:
            status = np.asarray(st.status)
            op = np.asarray(st.op)
            cmd = np.asarray(st.cmd_id)
            got = {int(cmd[i]) for i in range(status.shape[0])
                   if status[i] >= COMMITTED and op[i] == int(Op.PUT)}
            if need <= got:
                return True
        return False

    # -------------------------------------------------- graph explore

    def explore(self) -> "LivenessResult":
        t0 = time.monotonic()
        res = LivenessResult(self.protocol, q1=self.spec_q1,
                             q2=self.spec_q2, mutant=self.mutant)
        root = self.initial()
        ids: dict[bytes, int] = {self._qkey(root): 0}
        nodes = [root]
        goal = [self._is_goal(root)]
        parents: list[tuple[int, dict | None]] = [(-1, None)]
        edges: list[list[tuple[str, int]]] = [[]]
        enabled: list[frozenset[str]] = [frozenset()]
        expanded = [False]
        queue: deque[int] = deque([0])
        # healthy legs drain the whole graph, so visit order is moot;
        # capped mutant hunts need DFS — a lasso is a DEEP structure
        # (the duel's quotient cycle spans two full preemption rounds)
        # and breadth-first drowns in shallow interleavings first
        dfs = bool(self.mutant)
        drained = True
        while queue:
            wave = ([queue.pop()] if dfs
                    else [queue.popleft() for _ in range(len(queue))])
            todo = []
            for nid in wave:
                node = nodes[nid]
                if (sum(len(q) for q in node[1].values())
                        > self.max_queue_rows):
                    drained = False  # treated as a leaf: certify the prefix
                    continue
                todo.append((nid, self._actions(node)))
            succ = iter(self._apply_many(
                [(nodes[nid], a) for nid, acts in todo for a in acts]))
            for nid, acts in todo:
                expanded[nid] = True
                enabled[nid] = frozenset(
                    json.dumps(a, sort_keys=True) for a in acts)
                for action in acts:
                    res.transitions += 1
                    nxt = next(succ)
                    key = self._qkey(nxt)
                    mid = ids.get(key)
                    if mid is None:
                        mid = len(nodes)
                        ids[key] = mid
                        nodes.append(nxt)
                        goal.append(self._is_goal(nxt))
                        parents.append((nid, action))
                        edges.append([])
                        enabled.append(frozenset())
                        expanded.append(False)
                        if len(nodes) >= self.max_states:
                            return self._analyze(res, nodes, goal, parents,
                                                 edges, enabled, expanded,
                                                 False, t0)
                        queue.append(mid)
                    edges[nid].append(
                        (json.dumps(action, sort_keys=True), mid))
        return self._analyze(res, nodes, goal, parents, edges, enabled,
                             expanded, drained, t0)

    # ---------------------------------------------------- SCC analysis

    def _analyze(self, res, nodes, goal, parents, edges, enabled,
                 expanded, drained, t0) -> "LivenessResult":
        res.states = len(nodes)
        res.drained = drained
        res.goal_states = sum(goal)
        sccs = _tarjan(len(nodes), edges)
        res.sccs = len(sccs)
        lasso_scc = None
        for scc in sccs:
            inside = set(scc)
            cyclic = len(scc) > 1 or any(
                dst in inside for (_a, dst) in edges[scc[0]])
            if not cyclic:
                # a deadlock is an EXPANDED action-less non-goal node
                # (unexpanded cap casualties are covered by `drained`)
                if (not goal[scc[0]] and expanded[scc[0]]
                        and not edges[scc[0]]):
                    res.deadlocks += 1
                continue
            res.cyclic_sccs += 1
            if any(goal[n] for n in scc):
                continue  # goal is stable: the whole SCC is goal
            # weak fairness: only continuously-enabled actions are
            # forced; if every one of them can be taken WITHOUT
            # leaving the component, a fair schedule can stay forever
            common = frozenset.intersection(*(enabled[n] for n in scc))
            fair = all(
                any(dst in inside
                    for n in scc for (a, dst) in edges[n] if a == act)
                for act in common)
            if fair:
                res.fair_lassos += 1
                if lasso_scc is None:
                    lasso_scc = scc
        if lasso_scc is not None:
            res.lasso = self._lasso_ce(nodes, parents, edges, lasso_scc,
                                       len(nodes))
        res.wall_s = time.monotonic() - t0
        return res

    def _lasso_ce(self, nodes, parents, edges, scc, states) -> Counterexample:
        inside = set(scc)
        entry = min(scc)  # BFS discovery order: first-reached member
        stem: list[dict] = []
        p = entry
        while p >= 0:
            par, act = parents[p]
            if act is not None:
                stem.append(act)
            p = par
        stem.reverse()
        cycle = _cycle_actions(entry, edges, inside)
        report = invariants.CheckReport()
        report.add(
            f"{MARK}: fair non-progress cycle of {len(cycle)} actions "
            f"over a {len(scc)}-state component — every continuously "
            f"enabled action can be taken without leaving it, and no "
            f"state in it has all proposed commands committed")
        ce = Counterexample(
            self.protocol, self.bounds, None, stem + cycle,
            report.to_dict(), states_explored=states, q1=self.q1,
            q2=self.q2, n_replicas=self.R)
        ce.kind = "lasso"
        ce.mutant = self.mutant
        ce.loop_start = len(stem)
        return ce


def _tarjan(n: int, edges: list[list[tuple[str, int]]]) -> list[list[int]]:
    """Iterative Tarjan SCC (reverse topological order)."""
    index = [0] * n
    low = [0] * n
    on_stack = [False] * n
    visited = [False] * n
    stack: list[int] = []
    sccs: list[list[int]] = []
    counter = [1]
    for start in range(n):
        if visited[start]:
            continue
        work = [(start, 0)]
        while work:
            v, ei = work.pop()
            if ei == 0:
                visited[v] = True
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for i in range(ei, len(edges[v])):
                w = edges[v][i][1]
                if not visited[w]:
                    work.append((v, i + 1))
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
    return sccs


def _cycle_actions(entry: int, edges, inside: set[int]) -> list[dict]:
    """A concrete cycle entry -> entry staying inside the component
    (BFS over inside-edges; exists because the component is cyclic)."""
    prev: dict[int, tuple[int, str]] = {}
    queue = deque([entry])
    seen = {entry}
    closed_via = None
    while queue and closed_via is None:
        v = queue.popleft()
        for act, w in edges[v]:
            if w == entry:
                closed_via = (v, act)
                break
            if w in inside and w not in seen:
                seen.add(w)
                prev[w] = (v, act)
                queue.append(w)
    assert closed_via is not None, "cyclic SCC without a cycle?"
    v, act = closed_via
    actions = [json.loads(act)]
    while v != entry:
        v, act = prev[v]
        actions.append(json.loads(act))
    actions.reverse()
    return actions


# ------------------------------------------------------------- replay

def replay_lasso(ce: Counterexample | dict, device="cuda",
                 ) -> tuple[bool, invariants.CheckReport]:
    """Replay a lasso counterexample: run the stem, snapshot the
    quotient state, run the cycle, and assert it closes on the same
    quotient state with the goal still unreached anywhere along it.
    Returns (reproduced, report) in the replay_counterexample
    contract."""
    if isinstance(ce, dict):
        ce = Counterexample.from_dict(ce)
    if ce.kind != "lasso" or ce.loop_start is None:
        raise ValueError("not a lasso counterexample")
    ex = LivenessExplorer(ce.protocol, ce.bounds, q1=ce.q1, q2=ce.q2,
                          n_replicas=ce.n_replicas, mutant=ce.mutant,
                          device=device)
    node = ex.initial()
    for action in ce.trace[:ce.loop_start]:
        node = ex._apply(node, action)
    anchor = ex._qkey(node)
    goal_seen = ex._is_goal(node)
    for action in ce.trace[ce.loop_start:]:
        node = ex._apply(node, action)
        goal_seen = goal_seen or ex._is_goal(node)
    closed = ex._qkey(node) == anchor
    reproduced = closed and not goal_seen
    report = invariants.CheckReport()
    if reproduced:
        report.add(
            f"{MARK}: cycle of {len(ce.trace) - ce.loop_start} actions "
            f"(after a {ce.loop_start}-action stem) returns to the "
            f"same quotient state with proposed commands uncommitted")
    return reproduced, report
