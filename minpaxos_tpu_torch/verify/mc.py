"""paxmc on the port: bounded model checking of the port's step functions.

The port of the JAX package's ``verify/mc.py``. It explores the port's
``models/minpaxos.py replica_step_impl`` (classic Paxos under
``explicit_commit``) and ``models/mencius.py mencius_step_impl`` at the
same small configuration (N=3 replicas, an 8-slot window, one message
per step), under every interleaving the bounds admit, and holds every
reached state to the shared invariant predicates
(``verify/invariants.py``). On the card every step runs through the
hand-written kernels.

**Network model** (the reference's, unchanged): one FIFO queue per
directed link (replica->replica plus client->replica ingress), and an
adversarial scheduler that at every step chooses to **deliver** the
head of a link, **drop** it (``Bounds.drops``), **duplicate** it
(``Bounds.dups``), **reorder** a link's first two frames
(``Bounds.reorders``), run an internal **tick** of a replica
(``Bounds.internal``), or start an **election** (``become_leader`` on
an electable replica, ``Bounds.elections``).

**One batched step per BFS layer.** The reference steps one replica per
transition. Here ``Explorer.run`` lists every (node, action) pair of a
depth level in the reference's order (nodes in queue order, actions as
``_actions`` gives them) and stacks the pairs' stepping actions into
one batch of states and one-row inboxes, at most ``chunk`` rows a
call: one step call per chunk, one ``become_leader`` call for the
chunk's elections. Dedup, the invariants, ``check_edge``, the
``max_states`` / ``max_transitions`` cut-offs and the counterexample
then run over the pairs in exactly the sequential order, so states,
transitions, ``max_depth_seen``, ``drained`` and the first
counterexample equal the sequential explorer's by construction
(``chunk=1`` is the sequential explorer).

**States as bytes.** A replica state is held on the host as its bytes
in the JAX package's leaf order and dtypes (votes/pvotes as uint16,
0-d scalars): ``Row``. The canonical key hashes those bytes, then the
links and budgets, exactly as the reference's ``_key`` hashes its
leaves, so the port's state keys are the reference's, byte for byte. A
batch goes to the device in one copy and comes back (new states and
outboxes) in one copy. Every batch is decoded into fresh tensors, so
the K4 insert, which updates the KV table in place on the card, never
touches a stored node.

**Counterexamples** are serializable action traces in the reference's
``paxmc-ce-v1`` format; ``replay_counterexample`` re-executes one and
re-derives its violation, so the reference's committed fixtures replay
through the port; ``counterexample_faultplan`` projects one onto a chaos
schedule a live cluster runs (``cli/chaos.py --plan-file``).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from minpaxos_tpu_torch.models.mencius import init_mencius, mencius_step_impl
from minpaxos_tpu_torch.models.minpaxos import (
    MinPaxosConfig,
    MsgBatch,
    become_leader,
    init_replica,
    replica_step_impl,
    to_numpy_state,
)
from minpaxos_tpu_torch.ops.kvstore import KVState
from minpaxos_tpu_torch.ops.packed import join_i64, split_i64
from minpaxos_tpu_torch.ops.util import I32
from minpaxos_tpu_torch.verify import invariants
from minpaxos_tpu_torch.wire.messages import COMMITTED, MsgKind, Op

PROTOCOLS = ("minpaxos", "classic", "mencius")

#: counterexample serialization format tag (tests/fixtures/mc_*.json)
CE_FORMAT = "paxmc-ce-v1"

#: client pseudo-source id in link keys (client ingress queues)
CLIENT = -1

#: the most stepping rows one step call takes (K10 ``slot_write``
#: refuses more than 65,535 rows)
CHUNK = 8192

#: fields carried as int32 on the device and uint16 in the JAX layout
_U16 = ("votes", "pvotes")


@dataclass(frozen=True)
class Bounds:
    """The exploration bounds (the reference's, field for field; the
    defaults are its tier-1 smoke bounds for the elected-leader
    protocols: 6,435 states / 18,809 transitions)."""

    max_depth: int = 5  # actions along any path
    drops: int = 1  # head-of-link drops per path
    dups: int = 1  # head-of-link duplications per path
    reorders: int = 0  # cross-stream reorders per path
    internal: int = 1  # internal ticks per replica per path
    elections: int = 1  # extra elections per path (beyond the boot one)
    electable: tuple[int, ...] = (1,)  # who the extra election may pick
    n_cmds: int = 2  # distinct client commands in the workload
    propose_to: tuple[int, ...] = (0,)  # ingress queues carrying them
    max_states: int = 400_000  # hard backstop: stop exploring
    max_transitions: int = 2_000_000

    def to_dict(self) -> dict:
        return asdict(self)


def model_config(protocol: str, majority_override: int | None = None,
                 n_replicas: int = 3, q1: int = 0,
                 q2: int = 0) -> MinPaxosConfig:
    """The small-configuration protocol config the checker drives.

    window=8 holds every slot the bounded runs can touch with the window
    slide off (absolute slot == window index). ``majority_override``
    replaces the certified n//2+1 threshold with a raw quorum size (the
    seeded-mutant hook) in a SUBCLASS whose ``majority``, ``quorum1``
    and ``quorum2`` return it: the step reads ``cfg.quorum1`` /
    ``cfg.quorum2``, and the tuple payload stays the healthy one.
    ``q1``/``q2`` set the flexible quorum fields directly (0 = the
    majority default), with no host-side quorum validation in the way,
    so planted non-intersecting pairs run too.
    """
    if protocol not in PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r}; "
                         f"have {PROTOCOLS}")
    base = dict(
        n_replicas=n_replicas, window=8, inbox=8, exec_batch=4,
        kv_pow2=3, catchup_rows=2, recovery_rows=2, noop_delay=2,
        slide_window=False, gossip_ticks=1, q1=q1, q2=q2,
        explicit_commit=(protocol == "classic"))
    if majority_override is None:
        return MinPaxosConfig(**base)
    cls = type("MutantQuorumConfig", (MinPaxosConfig,), {
        "majority": property(lambda self: majority_override),
        "quorum1": property(lambda self: majority_override),
        "quorum2": property(lambda self: majority_override),
        "__doc__": "MinPaxosConfig with a seeded quorum threshold",
    })
    return cls(**base)


# ------------------------------------------------------ states as bytes

class _Field:
    __slots__ = ("name", "off", "n", "dtype", "shape", "sub", "in_kv")

    def __init__(self, name, off, n, dtype=None, shape=(), sub=None,
                 in_kv=False):
        self.name, self.off, self.n = name, off, n
        self.dtype, self.shape, self.sub = dtype, shape, sub
        self.in_kv = in_kv  # a leaf of the KV table


class Layout:
    """Where each field of one replica's state lies in its bytes: the
    JAX package's leaf order and dtypes (``to_numpy_state`` of one row,
    the KV table's leaves in place of ``kv``)."""

    def __init__(self, sample):
        self.cls = type(sample)
        self.fields: dict[str, _Field] = {}
        self.leaves: list[_Field] = []  # in order, kv's leaves inline
        off = 0

        def leaf(name, arr, in_kv=False):
            nonlocal off
            arr = np.asarray(arr)
            f = _Field(name, off, arr.nbytes, arr.dtype, arr.shape,
                       in_kv=in_kv)
            off += arr.nbytes
            self.leaves.append(f)
            return f

        for name in self.cls._fields:
            v = getattr(sample, name)
            if name == "kv":
                start = off
                sub = [leaf(k, getattr(v, k), True) for k in KVState._fields]
                self.fields[name] = _Field(name, start, off - start, sub=sub)
            else:
                self.fields[name] = leaf(name, v)
        self.nbytes = off
        self.names = self.cls._fields

    def spans(self, skip=frozenset()) -> list[tuple[int, int]]:
        """Byte ranges of the fields not in ``skip``, adjacent ones
        merged, in order."""
        out: list[list[int]] = []
        for name in self.names:
            f = self.fields[name]
            if name in skip:
                continue
            if out and out[-1][1] == f.off:
                out[-1][1] = f.off + f.n
            else:
                out.append([f.off, f.off + f.n])
        return [(a, b) for a, b in out]


class Row:
    """One replica's state as its bytes in the JAX layout. Fields read
    as numpy views (0-d for scalars, ``kv`` as a ``KVState``); the bytes
    are what the canonical key hashes."""

    __slots__ = ("buf", "lay")

    def __init__(self, buf: np.ndarray, lay: Layout):
        self.buf = buf
        self.lay = lay

    def _get(self, f: _Field) -> np.ndarray:
        return self.buf[f.off:f.off + f.n].view(f.dtype).reshape(f.shape)

    def __getattr__(self, name):
        try:
            f = self.lay.fields[name]
        except KeyError:
            raise AttributeError(name) from None
        if f.sub is not None:
            return KVState(*[self._get(s) for s in f.sub])
        return self._get(f)

    @property
    def _fields(self) -> tuple[str, ...]:
        return self.lay.names

    def _replace(self, **kw) -> "Row":
        buf = self.buf.copy()
        for name, v in kw.items():
            f = self.lay.fields[name]
            if f.sub is not None:
                raise ValueError("kv is replaced leaf by leaf, not whole")
            buf[f.off:f.off + f.n] = np.asarray(
                v, dtype=f.dtype).reshape(f.shape).reshape(-1).view(np.uint8)
        return Row(buf, self.lay)


# ------------------------------------------------------- the step, batched

class Stepper:
    """Steps many replica states at once on one device: rows go to the
    device in one copy, through one call of the protocol's step (or of
    ``become_leader``), and back, new states and outbox rows, in one
    copy. At most ``chunk`` rows a call."""

    def __init__(self, protocol: str, cfg: MinPaxosConfig, device="cuda",
                 chunk: int = CHUNK):
        from minpaxos_tpu_torch.device import resolve_device

        if not 1 <= chunk <= 65535:
            raise ValueError(f"chunk must be in [1, 65535], got {chunk}")
        self.protocol, self.cfg, self.chunk = protocol, cfg, chunk
        self.dev = resolve_device(device)
        if protocol == "mencius":
            self._init, self._step_impl = init_mencius, mencius_step_impl
        else:
            self._init, self._step_impl = init_replica, replica_step_impl
        sample = to_numpy_state(self._init(cfg, [0], device="cpu"),
                                lead_shape=())
        self.lay = Layout(sample)
        self.calls = 0  # step and become_leader calls
        self.rows = 0  # rows stepped
        self.max_batch = 0
        # host-clock seconds from each call's upload to the end of its
        # download (the step, its launches and both copies); the rest of
        # an exploration's wall is host bookkeeping
        self.step_s = 0.0

    # ---- device codec ----

    def _decode(self, buf: torch.Tensor):
        """uint8 [B, T] on the device -> the port's batched state, every
        leaf a fresh contiguous tensor."""
        b = buf.shape[0]

        def leaf(f: _Field) -> torch.Tensor:
            x = buf[:, f.off:f.off + f.n].clone(
                memory_format=torch.contiguous_format)
            if f.name in _U16 and not f.in_kv:
                x = x.view(torch.int16).to(I32) & 0xFFFF
            elif f.dtype == np.bool_:
                x = x.view(torch.bool)
            elif f.dtype == np.int32:
                x = x.view(I32)
            elif f.dtype != np.uint8:
                raise TypeError(f"{f.name}: no device form for {f.dtype}")
            return x.reshape((b,) + f.shape)

        vals = {}
        for name in self.lay.names:
            f = self.lay.fields[name]
            vals[name] = (KVState(*[leaf(s) for s in f.sub])
                          if f.sub is not None else leaf(f))
        return self.lay.cls(**vals)

    def _encode(self, state) -> torch.Tensor:
        """The port's batched state -> uint8 [B, T] in the JAX layout."""
        b = state.me.shape[0]
        parts = []
        for f in self.lay.leaves:
            t = getattr(state.kv if f.in_kv else state, f.name)
            if f.name in _U16 and not f.in_kv:
                t = t.to(torch.int16)
            elif t.element_size() != f.dtype.itemsize:
                raise TypeError(f"{f.name}: {t.dtype} on the device, "
                                f"{f.dtype} in the JAX layout")
            parts.append(t.contiguous().view(torch.uint8).reshape(b, -1))
        return torch.cat(parts, 1)

    def _upload(self, rows: list[Row]):
        host = np.stack([r.buf for r in rows])
        return self._decode(torch.from_numpy(host).to(self.dev))

    def _download(self, parts: list[torch.Tensor]) -> np.ndarray:
        """One device-to-host copy of the rows' encoded results."""
        return torch.cat(parts, 1).cpu().numpy()

    def _rows(self, host: np.ndarray) -> list[Row]:
        t = self.lay.nbytes
        states = np.ascontiguousarray(host[:, :t])
        return [Row(states[i], self.lay) for i in range(states.shape[0])]

    def _count(self, b: int) -> None:
        self.calls += 1
        self.rows += b
        self.max_batch = max(self.max_batch, b)

    # ---- calls ----

    def initial(self) -> list[Row]:
        """Every replica's boot state."""
        st = self._init(self.cfg, list(range(self.cfg.n_replicas)),
                        device=self.dev)
        return self._rows(self._download([self._encode(st)]))

    def step(self, parents: list[Row], inbox: list[tuple | None]
             ) -> tuple[list[Row], list[list[tuple[int, tuple]]]]:
        """Step each parent state on its one-row inbox (None: an empty
        inbox, an internal tick). Returns the new states and, per row,
        its live outbox rows as (dst, 12-int row)."""
        new, outs = [], []
        for a in range(0, len(parents), self.chunk):
            n, o = self._step_chunk(parents[a:a + self.chunk],
                                    inbox[a:a + self.chunk])
            new += n
            outs += o
        return new, outs

    def _step_chunk(self, parents, inbox):
        b = len(parents)
        self._count(b)
        t0 = time.perf_counter()
        state = self._upload(parents)
        ib = np.zeros((12, b), np.int32)
        for i, row in enumerate(inbox):
            if row is not None:
                ib[:, i] = row
        ib_d = torch.from_numpy(ib).to(self.dev)
        box = MsgBatch(*[ib_d[j].clone()[:, None] for j in range(12)])
        st, outbox, _execr = self._step_impl(self.cfg, state, box)
        msgs = torch.stack(list(outbox.msgs) + [outbox.dst.to(I32)], 1)
        mo = msgs.shape[2]
        host = self._download([self._encode(st),
                               msgs.contiguous().view(torch.uint8)
                               .reshape(b, -1)])
        self.step_s += time.perf_counter() - t0
        ob = np.ascontiguousarray(host[:, self.lay.nbytes:]).view(
            np.int32).reshape(b, 13, mo)
        outs = []
        for i in range(b):
            live = np.flatnonzero(ob[i, 0])
            outs.append([(int(ob[i, 12, j]), tuple(ob[i, :12, j].tolist()))
                         for j in live])
        return self._rows(host), outs

    def elect(self, parents: list[Row]) -> tuple[list[Row], list[tuple]]:
        """``become_leader`` on every parent: the new states and each
        one's broadcast PREPARE row."""
        new, preps = [], []
        for a in range(0, len(parents), self.chunk):
            chunk = parents[a:a + self.chunk]
            b = len(chunk)
            self._count(b)
            t0 = time.perf_counter()
            st, out = become_leader(self.cfg, self._upload(chunk),
                                    torch.ones(b, dtype=torch.bool,
                                               device=self.dev))
            prep = torch.cat(list(out), 1)  # [B, 12], MsgBatch order
            host = self._download([self._encode(st),
                                   prep.contiguous().view(torch.uint8)])
            self.step_s += time.perf_counter() - t0
            rows = np.ascontiguousarray(host[:, self.lay.nbytes:]).view(
                np.int32)
            new += self._rows(host)
            preps += [tuple(rows[i].tolist()) for i in range(b)]
        return new, preps


# ------------------------------------------------------- results

@dataclass
class Counterexample:
    """A violating interleaving: the action trace from the initial
    state plus the invariant report it produces (the reference's
    ``paxmc-ce-v1`` format)."""

    protocol: str
    bounds: Bounds
    majority_override: int | None
    trace: list[dict]
    report: dict
    states_explored: int = 0
    q1: int = 0
    q2: int = 0
    n_replicas: int = 3
    # "invariant" | "refinement" (verify/refine.py) | "lasso"
    # (verify/liveness.py: trace[loop_start:] is a fair non-progress
    # cycle); `mutant` names a planted mutation replay re-installs
    kind: str = "invariant"
    mutant: str | None = None
    loop_start: int | None = None

    def to_dict(self) -> dict:
        return {"format": CE_FORMAT, "protocol": self.protocol,
                "bounds": self.bounds.to_dict(),
                "majority_override": self.majority_override,
                "q1": self.q1, "q2": self.q2,
                "n_replicas": self.n_replicas,
                "trace": self.trace, "report": self.report,
                "states_explored": self.states_explored,
                "kind": self.kind, "mutant": self.mutant,
                "loop_start": self.loop_start}

    @classmethod
    def from_dict(cls, d: dict) -> "Counterexample":
        if d.get("format") != CE_FORMAT:
            raise ValueError(f"not a {CE_FORMAT} counterexample: "
                             f"format={d.get('format')!r}")
        loop = d.get("loop_start")
        return cls(protocol=d["protocol"], bounds=Bounds(**d["bounds"]),
                   majority_override=d.get("majority_override"),
                   q1=int(d.get("q1", 0)), q2=int(d.get("q2", 0)),
                   n_replicas=int(d.get("n_replicas", 3)),
                   trace=list(d["trace"]), report=dict(d["report"]),
                   states_explored=int(d.get("states_explored", 0)),
                   kind=str(d.get("kind", "invariant")),
                   mutant=d.get("mutant"),
                   loop_start=None if loop is None else int(loop))


@dataclass
class McResult:
    protocol: str
    bounds: Bounds
    majority_override: int | None
    q1: int = 0
    q2: int = 0
    n_replicas: int = 3
    states: int = 0
    transitions: int = 0
    max_depth_seen: int = 0
    drained: bool = False
    invariants_checked: tuple[str, ...] = (
        "slot-agreement", "validity", "frontier-monotonic")
    counterexample: Counterexample | None = None
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.counterexample is None

    def to_dict(self) -> dict:
        return {"protocol": self.protocol, "bounds": self.bounds.to_dict(),
                "majority_override": self.majority_override,
                "q1": self.q1, "q2": self.q2,
                "n_replicas": self.n_replicas,
                "states": self.states, "transitions": self.transitions,
                "max_depth_seen": self.max_depth_seen,
                "drained": self.drained,
                "invariants_checked": list(self.invariants_checked),
                "ok": self.ok,
                "counterexample": (None if self.counterexample is None
                                   else self.counterexample.to_dict()),
                "wall_s": round(self.wall_s, 2)}


def state_digest(keys) -> str:
    """blake2b (16 bytes, hex) of a run's canonical state keys, sorted
    and concatenated: one digest for the set of states a run reached
    (tests/fixtures/paxmc_state_digests.json holds the reference's)."""
    return hashlib.blake2b(b"".join(sorted(keys)), digest_size=16).hexdigest()


# ------------------------------------------------------- the explorer

def _stepping(node: tuple, action: dict):
    """(replica, inbox row) of an action that steps a replica, else
    None."""
    a = action["a"]
    if a in ("deliver", "dup", "reorder"):
        src, to = action["link"]
        q = node[1][(src, to)]
        return to, (q[1] if a == "reorder" else q[0])
    if a == "tick":
        return action["r"], None
    return None


class Explorer:
    """One bounded exhaustive exploration of one protocol."""

    #: True in explorers whose check_edge is not a no-op — run() then
    #: pays the edge check even on seen-state-pruned transitions
    _edge_checked = False

    def __init__(self, protocol: str, bounds: Bounds | None = None,
                 majority_override: int | None = None, q1: int = 0,
                 q2: int = 0, n_replicas: int = 3, device="cuda",
                 chunk: int = CHUNK):
        self.protocol = protocol
        self.bounds = bounds or Bounds()
        self.majority_override = majority_override
        self.q1, self.q2 = q1, q2
        self.cfg = model_config(protocol, majority_override,
                                n_replicas=n_replicas, q1=q1, q2=q2)
        self.R = self.cfg.n_replicas
        self.stepper = Stepper(protocol, self.cfg, device, chunk)
        # the workload table (cmd_id == index), shared with validity
        n = self.bounds.n_cmds
        self.w_ops = np.full(n, int(Op.PUT), np.int32)
        self.w_keys = np.arange(n, dtype=np.int64)
        self.w_vals = np.arange(n, dtype=np.int64) * 7 + 1001

    # ---------------------------------------------------- initial state

    def initial(self) -> tuple:
        """(states, links, budgets): boot all replicas, run the boot
        election on replica 0 (minpaxos/classic; mencius needs none),
        and stage the client workload on the ingress queues."""
        states = self.stepper.initial()
        links: dict[tuple[int, int], tuple] = {}
        if self.protocol != "mencius":
            (st0,), (row,) = self.stepper.elect(states[:1])
            states[0] = st0
            for r in range(1, self.R):
                links[(0, r)] = (row,)
        k_hi, k_lo = split_i64(self.w_keys)
        v_hi, v_lo = split_i64(self.w_vals)
        for c in range(self.bounds.n_cmds):
            row = dict(zip(MsgBatch._fields, [0] * 12))
            row.update(kind=int(MsgKind.PROPOSE), src=-1, op=int(Op.PUT),
                       key_hi=int(k_hi[c]), key_lo=int(k_lo[c]),
                       val_hi=int(v_hi[c]), val_lo=int(v_lo[c]),
                       cmd_id=c, client_id=1)
            rt = tuple(int(row[f]) for f in MsgBatch._fields)
            for to in self.bounds.propose_to:
                links[(CLIENT, to)] = links.get((CLIENT, to), ()) + (rt,)
        budgets = (self.bounds.drops, self.bounds.dups,
                   self.bounds.reorders,
                   (self.bounds.internal,) * self.R, self.bounds.elections)
        return tuple(states), links, budgets

    # ------------------------------------------------------- mechanics

    def _expand_outbox(self, links: dict, out: list, src: int) -> dict:
        """Append a step's live outbox rows onto the link queues (dst -1
        = broadcast to every other replica, -2 = client-bound, ignored
        here — replies are not part of the safety state)."""
        if not out:
            return links
        links = dict(links)
        for d, row in out:
            if d == -2 or d == src:
                continue
            targets = ([r for r in range(self.R) if r != src]
                       if d == -1 else [d] if 0 <= d < self.R else [])
            for t in targets:
                links[(src, t)] = links.get((src, t), ()) + (row,)
        return links

    def _post_step(self, st: Row) -> Row:
        """Per-row hook on every stepped state (a planted mutant's
        post-step rewrite; identity here)."""
        return st

    def _apply_many(self, pairs: list[tuple[tuple, dict]]) -> list[tuple]:
        """Each (node, action) -> its successor (states, links,
        budgets): every stepping action of the list in one batched
        step, every election in one ``become_leader`` call."""
        steps, elects = [], []
        for i, (node, action) in enumerate(pairs):
            s = _stepping(node, action)
            if s is not None:
                steps.append((i, node[0][s[0]], s[1]))
            elif action["a"] == "elect":
                elects.append((i, node[0][action["r"]]))
            elif action["a"] != "drop":
                raise ValueError(f"unknown action {action!r}")
        done: dict[int, tuple] = {}
        if steps:
            new, outs = self.stepper.step([p for _i, p, _r in steps],
                                          [r for _i, _p, r in steps])
            for (i, _p, _r), st, out in zip(steps, new, outs):
                done[i] = (self._post_step(st), out)
        if elects:
            new, preps = self.stepper.elect([p for _i, p in elects])
            for (i, _p), st, prep in zip(elects, new, preps):
                done[i] = (st, prep)
        return [self._successor(node, action, done.get(i))
                for i, (node, action) in enumerate(pairs)]

    def _successor(self, node: tuple, action: dict, result) -> tuple:
        """The reference's ``_apply`` with the step already taken:
        ``result`` is (new state, outbox rows) for a stepping action,
        (new state, PREPARE row) for an election."""
        states, links, (drops, dups, reorders, internal, elects) = node
        a = action["a"]

        def stepped(to, links):
            st, out = result
            return (states[:to] + (st,) + states[to + 1:],
                    self._expand_outbox(links, out, to))

        if a in ("deliver", "drop"):
            src, to = action["link"]
            q = links[(src, to)]
            links = {**links}
            if len(q) == 1:
                del links[(src, to)]
            else:
                links[(src, to)] = q[1:]
            if a == "deliver":
                states, links = stepped(to, links)
            else:
                drops -= 1
        elif a == "dup":
            states, links = stepped(action["link"][1], links)
            dups -= 1
        elif a == "reorder":
            src, to = action["link"]
            q = links[(src, to)]
            links = {**links, (src, to): (q[0],) + q[2:]}
            states, links = stepped(to, links)
            reorders -= 1
        elif a == "tick":
            r = action["r"]
            internal = internal[:r] + (internal[r] - 1,) + internal[r + 1:]
            states, links = stepped(r, links)
        elif a == "elect":
            r = action["r"]
            st, row = result
            states = states[:r] + (st,) + states[r + 1:]
            links = {**links}
            for peer in range(self.R):
                if peer != r:
                    links[(r, peer)] = links.get((r, peer), ()) + (row,)
            elects -= 1
        else:
            raise ValueError(f"unknown action {action!r}")
        return states, links, (drops, dups, reorders, internal, elects)

    def _apply(self, node: tuple, action: dict) -> tuple:
        """One action -> successor (states, links, budgets)."""
        return self._apply_many([(node, action)])[0]

    def _actions(self, node: tuple) -> list[dict]:
        states, links, (drops, dups, reorders, internal, elects) = node
        out: list[dict] = []
        for link in sorted(links):
            out.append({"a": "deliver", "link": list(link)})
            if drops > 0:
                out.append({"a": "drop", "link": list(link)})
            if dups > 0:
                out.append({"a": "dup", "link": list(link)})
            if reorders > 0 and len(links[link]) >= 2:
                out.append({"a": "reorder", "link": list(link)})
        for r in range(self.R):
            if internal[r] > 0:
                out.append({"a": "tick", "r": r})
        if elects > 0 and self.protocol != "mencius":
            for r in self.bounds.electable:
                out.append({"a": "elect", "r": r})
        return out

    # ------------------------------------------------------ canonical

    def _key(self, node: tuple) -> bytes:
        """The reference's ``_key``: blake2b over every replica's leaves
        (here: its bytes, the same bytes in the same order), then the
        sorted links and the budgets."""
        states, links, budgets = node
        h = hashlib.blake2b(digest_size=16)
        for st in states:
            h.update(st.buf)
        h.update(repr(sorted(links.items())).encode())
        h.update(repr(budgets).encode())
        return h.digest()

    # ------------------------------------------------------ invariants

    def _records(self, st) -> tuple[np.ndarray, int]:
        """Committed slot records for one replica state (window slide
        is off, so window index == absolute slot)."""
        status = np.asarray(st.status)
        idx = np.nonzero(status >= COMMITTED)[0]
        base = int(st.window_base)
        return invariants.make_records(
            base + idx.astype(np.int64),
            np.asarray(st.op)[idx],
            join_i64(np.asarray(st.key_hi)[idx], np.asarray(st.key_lo)[idx]),
            join_i64(np.asarray(st.val_hi)[idx], np.asarray(st.val_lo)[idx]),
            np.asarray(st.cmd_id)[idx],
            np.asarray(st.client_id)[idx],
        ), int(st.committed_upto)

    def check_invariants(self, states: tuple, stepped: int | None = None,
                         pre_frontier: int | None = None
                         ) -> invariants.CheckReport:
        """The shared predicate suite over one model state."""
        report = invariants.CheckReport()
        recs: dict[int, np.ndarray] = {}
        fronts: dict[int, int] = {}
        for r, st in enumerate(states):
            recs[r], fronts[r] = self._records(st)
        invariants.check_slot_agreement(recs, fronts, report)
        for r in recs:
            invariants.check_validity(recs[r], self.w_ops, self.w_keys,
                                      self.w_vals, report,
                                      who=f"replica {r}")
        if stepped is not None and pre_frontier is not None:
            invariants.check_frontier_monotonic(
                {stepped: [pre_frontier, fronts[stepped]]}, report)
        return report

    @staticmethod
    def _stepped_replica(action: dict) -> int | None:
        if action["a"] in ("deliver", "dup", "reorder"):
            return action["link"][1]
        if action["a"] == "tick":
            return action["r"]
        return None  # drop / elect never advance a frontier

    # ------------------------------------------------------ paxref hooks

    def check_edge(self, pre_node: tuple, action: dict, post_node: tuple,
                   report: invariants.CheckReport) -> None:
        """Per-edge hook, called for EVERY explored transition (run and
        replay) with the pre/post cluster states; checks nothing here
        (``verify/refine.py`` fills it in)."""

    def _make_ce(self, trace: list[dict], report: dict,
                 states_explored: int) -> Counterexample:
        """Counterexample factory — subclasses stamp their kind/mutant
        so replay can rebuild the same explorer."""
        return Counterexample(
            self.protocol, self.bounds, self.majority_override, trace,
            report, states_explored=states_explored, q1=self.q1,
            q2=self.q2, n_replicas=self.R)

    # ------------------------------------------------------ exploration

    def _windows(self, plan: list[tuple]):
        """Consecutive slices of ``plan`` ((node, action, ...) items)
        holding at most ``chunk`` stepping actions and ``chunk``
        elections each."""
        chunk = self.stepper.chunk
        a, n_step, n_elect = 0, 0, 0
        for i, (node, action, *_rest) in enumerate(plan):
            s = _stepping(node, action) is not None
            e = action["a"] == "elect"
            if (s and n_step == chunk) or (e and n_elect == chunk):
                yield plan[a:i]
                a, n_step, n_elect = i, 0, 0
            n_step += s
            n_elect += e
        if a < len(plan):
            yield plan[a:]

    def run(self, log=None) -> McResult:
        """Breadth-first exhaustive exploration within the bounds, one
        batched step per chunk of a depth level."""
        b = self.bounds
        res = McResult(self.protocol, b, self.majority_override,
                       q1=self.q1, q2=self.q2, n_replicas=self.R)
        t0 = time.monotonic()
        root = self.initial()
        report = self.check_invariants(root[0])
        if not report.ok:  # a broken initial state: depth-0 violation
            res.counterexample = self._make_ce([], report.to_dict(), 1)
            res.wall_s = time.monotonic() - t0
            return res
        # the canonical keys of every reached state (state_digest)
        self.seen = seen = {self._key(root)}
        # parents: (parent index, action) chains the traces
        parents: list[tuple[int, dict | None]] = [(-1, None)]
        layer = [(root, 0)]  # (node, parent-chain index)
        res.states = 1
        depth = 0
        next_log = 5000

        def trace_to(action, pid):
            trace = [action]
            p = pid
            while p >= 0:
                par, act = parents[p]
                if act is not None:
                    trace.append(act)
                p = par
            trace.reverse()
            return trace

        while layer:
            res.max_depth_seen = max(res.max_depth_seen, depth)
            if depth >= b.max_depth:
                break
            plan = [(node, action, pid) for node, pid in layer
                    for action in self._actions(node)]
            nxt_layer = []
            for window in self._windows(plan):
                succ = self._apply_many([(n, a) for n, a, _p in window])
                for (node, action, pid), nxt in zip(window, succ):
                    res.transitions += 1
                    if res.transitions > b.max_transitions:
                        res.wall_s = time.monotonic() - t0
                        return res  # drained stays False
                    stepped = self._stepped_replica(action)
                    pre = (int(node[0][stepped].committed_upto)
                           if stepped is not None else None)
                    key = self._key(nxt)
                    if key in seen:
                        # the STATE was certified when first reached,
                        # but a refinement explorer must still check
                        # this EDGE
                        if self._edge_checked:
                            report = invariants.CheckReport()
                            self.check_edge(node, action, nxt, report)
                            if not report.ok:
                                res.counterexample = self._make_ce(
                                    trace_to(action, pid),
                                    report.to_dict(), res.states)
                                res.wall_s = time.monotonic() - t0
                                return res
                        continue
                    seen.add(key)
                    res.states += 1
                    report = self.check_invariants(nxt[0], stepped, pre)
                    self.check_edge(node, action, nxt, report)
                    if not report.ok:
                        res.counterexample = self._make_ce(
                            trace_to(action, pid), report.to_dict(),
                            res.states)
                        res.wall_s = time.monotonic() - t0
                        return res
                    if res.states >= b.max_states:
                        res.wall_s = time.monotonic() - t0
                        return res  # drained stays False
                    parents.append((pid, action))
                    nxt_layer.append((nxt, len(parents) - 1))
                if log is not None and res.states >= next_log:
                    next_log += 5000
                    log(f"[paxmc] {self.protocol}: {res.states} states, "
                        f"{res.transitions} transitions, depth {depth}")
            layer = nxt_layer
            depth += 1
        res.drained = True
        res.wall_s = time.monotonic() - t0
        return res


# ------------------------------------------------------------- replay

def replay_counterexample(ce: Counterexample | dict, device="cuda",
                          ) -> tuple[bool, invariants.CheckReport]:
    """Re-execute a counterexample trace action by action and re-derive
    its violation through the shared invariant predicates. Returns
    (reproduced, the first failing report — or the final clean one).

    Deterministic: the step functions are pure, the initial state
    depends only on (protocol, bounds, override), and the trace pins
    every scheduler choice, so a checked-in fixture
    (tests/fixtures/mc_*.json) replays the same on every device.
    """
    if isinstance(ce, dict):
        ce = Counterexample.from_dict(ce)
    if ce.kind == "lasso":
        from minpaxos_tpu_torch.verify.liveness import replay_lasso

        return replay_lasso(ce, device=device)
    ex = _explorer_for(ce, device)
    node = ex.initial()
    report = ex.check_invariants(node[0])
    if not report.ok:
        return True, report
    for action in ce.trace:
        stepped = Explorer._stepped_replica(action)
        pre = (int(node[0][stepped].committed_upto)
               if stepped is not None else None)
        prev = node
        node = ex._apply(node, action)
        report = ex.check_invariants(node[0], stepped, pre)
        ex.check_edge(prev, action, node, report)
        if not report.ok:
            return True, report
    return False, report


def _explorer_for(ce: Counterexample, device="cuda") -> Explorer:
    """Rebuild the explorer a counterexample was found by — the plain
    safety explorer for kind="invariant", the refinement explorer (its
    planted mutant re-installed) for kind="refinement"."""
    if ce.kind == "refinement":
        from minpaxos_tpu_torch.verify.refine import RefinementExplorer

        return RefinementExplorer(
            ce.protocol, ce.bounds, ce.majority_override, q1=ce.q1,
            q2=ce.q2, n_replicas=ce.n_replicas, mutant=ce.mutant,
            device=device)
    return Explorer(ce.protocol, ce.bounds, ce.majority_override,
                    q1=ce.q1, q2=ce.q2, n_replicas=ce.n_replicas,
                    device=device)


# ------------------------------------------------------- fault plans

def counterexample_faultplan(ce: Counterexample | dict,
                             duration_s: float = 1.5,
                             device="cuda") -> dict:
    """Project a counterexample onto a live-cluster chaos schedule.

    The trace's dropped replica->replica frames, and the frames still
    queued on a link at the violation (never delivered either), become
    ``block``ed links of a :class:`~minpaxos_tpu_torch.chaos.plan.
    FaultPlan`; returned as ``{"plan": <FaultPlan dict>, "events":
    [...], "protocol": ...}`` in the campaign runner's event format,
    runnable against a TCP cluster through ``cli/chaos.py --plan-file``.
    A projection, not a bisimulation: a live cluster cannot be forced
    through one interleaving, but the plan reproduces the trace's
    communication pattern (who could never hear whom). The trace is
    re-executed on ``device`` to find the queued links.
    """
    if isinstance(ce, dict):
        ce = Counterexample.from_dict(ce)
    from minpaxos_tpu_torch.chaos.plan import FaultPlan

    ex = Explorer(ce.protocol, ce.bounds, ce.majority_override,
                  q1=ce.q1, q2=ce.q2, n_replicas=ce.n_replicas,
                  device=device)
    node = ex.initial()
    blocked: set[tuple[int, int]] = set()
    for action in ce.trace:
        if action["a"] == "drop":
            src, dst = action["link"]
            if src != CLIENT:
                blocked.add((src, dst))
        node = ex._apply(node, action)
    _states, links, _budgets = node
    for (src, dst), q in links.items():
        if q and src != CLIENT:
            blocked.add((src, dst))
    plan = FaultPlan(ex.R, seed=0)
    for src, dst in sorted(blocked):
        plan.set_link(src, dst, block=True)
    events = [(0.0, "install", plan.to_dict()),
              (float(duration_s), "clear", None)]
    return {"plan": plan.to_dict(), "events": events,
            "protocol": ce.protocol}
