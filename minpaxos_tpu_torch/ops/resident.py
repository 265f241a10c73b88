"""The resident loop's per-round bookkeeping (kernel K9).

Around each round's cluster step, ``parallel/sharded.py
sharded_run_resident`` keeps three device buffers: the per-group inject
ring ``inj`` [G, W] (the round each in-flight slot was assigned), the
latency histogram ``hist`` [bins] and, when armed, the paxray telemetry
ring ``tel`` [rows, N_TEL_FIELDS]. K9 launches once a round:
``round_open`` before a dispatch's first step (and before each drain
sub-step when the ring is armed), then ``round_close`` after each
round's step, which also opens the next round of the same dispatch
(``next_kind``) and, after the dispatch's last round, writes its two
totals (``totals``). Both work on one int32 ``scratch`` per dispatch
(``new_scratch``):

    [u_prev (G) | c_prev (G) | e_prev (G) | acc (N_ACC)]

the cursors at the round's start per group, then acc = their sums over
groups (3), the (inbox_rows, inbox_hwm) pair of even rounds and that of
odd rounds (so the next round's pair fills while this round's row
reads its own), and last the dispatch's (committed_total, in_flight)
(``totals_of``). ``round_close`` zeroes its round's pair once it wrote
the row. On a CUDA tensor each call is one launch of
``kernels/csrc/resident.cu``; on the CPU the plain twins below update
the same buffers in place. The cursors are read at replica
``cursor_rep`` of every group.

``k9_families`` and ``chain_rounds`` make and drive chained inputs for
the CPU tests, the card tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops.telemetry import telemetry_row
from minpaxos_tpu_torch.ops.util import I32

A_SUMS, A_PAIRS, A_TOTALS = 0, 3, 7  # acc's slots (resident.cu names them)
N_ACC = 9


def new_scratch(n_shards: int, device) -> torch.Tensor:
    return torch.zeros(3 * n_shards + N_ACC, dtype=I32, device=device)


def totals_of(scratch: torch.Tensor) -> torch.Tensor:
    """The dispatch's [committed_total, in_flight], as ``round_close``
    wrote them with ``totals``: a view of the scratch."""
    return scratch[-2:]


def _check_scratch(scratch, n_shards: int, what: str) -> None:
    if scratch.shape != (3 * n_shards + N_ACC,):
        raise ValueError(f"{what}: scratch must be [3 * G + {N_ACC}] (new_scratch), "
                         f"got {tuple(scratch.shape)}")


def _ext_live(n_replicas: int, n_proposals: int, leader: int, device):
    rep = torch.arange(n_replicas, device=device)
    return torch.where((rep == leader) | (leader < 0), n_proposals, 0).to(I32)


def _pair(rnd: int) -> int:
    """acc's slot of round ``rnd``'s (inbox_rows, inbox_hwm)."""
    return A_PAIRS + 2 * (rnd & 1)


def _round_open_plain(scratch, states, pending_kind, cursor_rep, n_shards,
                      n_proposals, leader, first, tel_on, rnd):
    g = n_shards
    r = states.committed_upto.shape[0] // g
    acc = scratch[3 * g:]
    if first:
        for i, x in enumerate((states.committed_upto, states.crt_inst,
                               states.executed_upto)):
            scratch[i * g:(i + 1) * g] = x.view(g, r)[:, cursor_rep]
            acc[A_SUMS + i] = scratch[i * g:(i + 1) * g].sum(dtype=I32)
    if tel_on:
        live = (pending_kind != 0).sum(1, dtype=I32).view(g, r)
        ext = _ext_live(r, n_proposals if first else 0, leader, scratch.device)
        p = _pair(rnd)
        acc[p] += live.sum(dtype=I32)
        acc[p + 1] = torch.maximum(acc[p + 1], (live + ext[None, :]).max())
    return scratch


@K.kernel("round_open")
def _round_open_kernel(scratch, states, pending_kind, cursor_rep, n_shards,
                       n_proposals, leader, first, tel_on, rnd):
    b = states.committed_upto.shape[0]
    args = [K.cuda_arg(x, I32, "round_open")
            for x in (states.committed_upto, states.crt_inst, states.executed_upto,
                      pending_kind)]
    K.cuda_arg(scratch, I32, "round_open scratch")
    f_ = K.fn("resident", "mp_round_open",
              [K.P] * 5 + [K.I] * 9 + [K.P])
    rc = f_(K.ptr(scratch), *map(K.ptr, args), n_shards, b // n_shards,
            args[3].shape[1], cursor_rep, int(first), int(tel_on), n_proposals,
            leader, rnd, K.stream(scratch))
    K.check("resident", rc, "round_open")
    _round_open_kernel.launches += 1
    return scratch


def round_open(scratch, states, pending_kind, cursor_rep: int, n_shards: int,
               n_proposals: int, leader: int, first: bool, tel_on: bool, rnd: int):
    """Before round ``rnd``'s first step (``first``) or a drain sub-step
    of it: with ``first``, snapshot the cursor replica's committed_upto /
    crt_inst / executed_upto of every group, and their sums, into
    ``scratch``; with ``tel_on``, add the live pending rows of every
    replica into the round's inbox_rows and their max, plus the
    replica's injected rows on the round's step (``n_proposals`` where
    it is the leader, or every replica when ``leader`` < 0), into its
    inbox_hwm."""
    _check_scratch(scratch, n_shards, "round_open")
    if not (first or tel_on):
        return scratch
    if K.on_cpu(scratch, pending_kind):
        return _round_open_plain(scratch, states, pending_kind, cursor_rep,
                                 n_shards, n_proposals, leader, first, tel_on, rnd)
    return _round_open_kernel(scratch, states, pending_kind, cursor_rep,
                              n_shards, n_proposals, leader, first, tel_on, rnd)


def write_totals(scratch, states, cursor_rep, n_shards):
    """The dispatch's (committed_total, in_flight) into the scratch's
    last two words: sums over groups of u + 1 and c - 1 - u at the
    cursor replica."""
    r = states.committed_upto.shape[0] // n_shards
    u = states.committed_upto.view(n_shards, r)[:, cursor_rep]
    c = states.crt_inst.view(n_shards, r)[:, cursor_rep]
    totals_of(scratch).copy_(torch.stack(((u + 1).sum(dtype=I32),
                                          (c - 1 - u).sum(dtype=I32))))


def _round_close_plain(scratch, inj, hist, tel, states, cursor_rep, rnd,
                       tel_base, injected, next_kind=None, n_proposals=0,
                       leader=0, totals=False):
    g, w = inj.shape
    r = states.committed_upto.shape[0] // g
    u_prev, c_prev, e_prev = scratch[:g], scratch[g:2 * g], scratch[2 * g:3 * g]
    u_new = states.committed_upto.view(g, r)[:, cursor_rep]
    c_new = states.crt_inst.view(g, r)[:, cursor_rep]
    pos = torch.arange(w, dtype=I32, device=inj.device)[None, :]
    cp = c_prev[:, None]
    slot = cp + torch.remainder(pos - cp, w)
    inj.copy_(torch.where(slot < c_new[:, None], rnd, inj))
    up = u_prev[:, None] + 1
    cslot = up + torch.remainder(pos - up, w)
    sampled = (cslot <= u_new[:, None]) & (inj >= 0)
    bins = (rnd - inj).clamp(0, hist.shape[0] - 1)
    hist.scatter_add_(0, bins.reshape(-1).long(), sampled.reshape(-1).to(hist.dtype))
    if tel.shape[0]:
        prepared = getattr(states, "prepared", None)
        prep = (prepared.view(g, r)[:, cursor_rep].sum(dtype=I32)
                if prepared is not None else g)
        e_new = states.executed_upto.view(g, r)[:, cursor_rep]
        pair = scratch[3 * g + _pair(rnd):][:2]
        tel[(rnd - tel_base) % tel.shape[0]] = telemetry_row(
            rnd, (u_new - u_prev).sum(), (c_new - 1 - u_new).sum(),
            (c_new - c_prev).sum(), injected, pair[0], (e_new - e_prev).sum(),
            prep, pair[1], device=inj.device)
        pair.zero_()
    if totals:
        write_totals(scratch, states, cursor_rep, g)
    if next_kind is not None:
        _round_open_plain(scratch, states, next_kind, cursor_rep, g, n_proposals,
                          leader, True, tel.shape[0] > 0, rnd + 1)
    return inj, hist, tel


@K.kernel("round_close")
def _round_close_kernel(scratch, inj, hist, tel, states, cursor_rep, rnd,
                        tel_base, injected, next_kind, n_proposals, leader, totals):
    g, w = inj.shape
    b = states.committed_upto.shape[0]
    for t, what in ((scratch, "scratch"), (inj, "inject ring"), (hist, "histogram"),
                    (tel, "telemetry ring")):
        if K.cuda_arg(t, I32, f"round_close {what}") is not t:
            raise ValueError(f"round_close: the {what} must be contiguous")
    cur = [K.cuda_arg(x, I32, "round_close cursors")
           for x in (states.committed_upto, states.crt_inst, states.executed_upto)]
    prepared = getattr(states, "prepared", None)
    prep = (K.cuda_arg(prepared, torch.bool, "round_close prepared")
            if prepared is not None else None)
    # the next round's pending rows are read only with the ring armed
    kind = (K.cuda_arg(next_kind, I32, "round_close next_kind")
            if next_kind is not None and tel.shape[0] else None)
    f_ = K.fn("resident", "mp_round_close",
              [K.P] * 9 + [K.I] * 14 + [K.P])
    rc = f_(K.ptr(scratch), K.ptr(inj), K.ptr(hist),
            K.ptr(tel) if tel.shape[0] else None, *map(K.ptr, cur),
            K.ptr(prep) if prep is not None else None,
            K.ptr(kind) if kind is not None else None, g, b // g, w, hist.shape[0],
            tel.shape[0], cursor_rep, rnd, tel_base, injected,
            int(next_kind is not None), kind.shape[1] if kind is not None else 0,
            n_proposals, leader, int(totals), K.stream(inj))
    K.check("resident", rc, "round_close")
    _round_close_kernel.launches += 1
    return inj, hist, tel


def round_close(scratch, inj, hist, tel, states, cursor_rep: int, rnd: int,
                tel_base: int, injected: int, next_kind=None, n_proposals: int = 0,
                leader: int = 0, totals: bool = False):
    """After the round's step (and its drain sub-steps): stamp ``rnd``
    on the ring positions assigned this round, add the slots committed
    this round to ``hist`` by their latency, and, when ``tel`` has rows,
    write the round's telemetry row at ``(rnd - tel_base) mod rows``.

    ``next_kind`` (the pending inbox kinds, ``ss.pending.kind``, when
    another round follows in this dispatch) opens that round in the
    same launch, as ``round_open(..., n_proposals, leader, first=True,
    tel_on, rnd + 1)`` would; the round's row does not count it. ``totals``
    writes the dispatch's (committed_total, in_flight) into
    ``totals_of(scratch)``. ``inj``, ``hist`` and ``tel`` are updated in
    place and returned."""
    g = inj.shape[0]
    _check_scratch(scratch, g, "round_close")
    ts = (scratch, inj, hist, tel) + ((next_kind,) if next_kind is not None else ())
    if K.on_cpu(*ts):
        return _round_close_plain(scratch, inj, hist, tel, states, cursor_rep,
                                  rnd, tel_base, injected, next_kind, n_proposals,
                                  leader, totals)
    return _round_close_kernel(scratch, inj, hist, tel, states, cursor_rep, rnd,
                               tel_base, injected, next_kind, n_proposals, leader,
                               totals)


# ------------------------------------------------------- chained inputs

K9_FAMILIES = ("random", "one_bin", "edges")


def k9_families(rng, g: int, r: int, w: int, mp: int, rounds: int, p: int,
                names=None) -> dict:
    """Chained K9 inputs as numpy, drawn from the numpy generator
    ``rng``: per family a dict of

    * ``states``: [rounds + 1, 4, B] int32 (committed_upto, crt_inst,
      executed_upto, prepared), B = g x r rows group major, every
      replica of a group alike; set 0 is before the dispatch's first
      step, set i after round i - 1's step;
    * ``inj``: the inject ring [g, w] at the start;
    * ``kinds``: two pending-kind tables [2, B, mp] (the next round's
      step and a drain sub-step);
    * ``r0``: the first round's index.

    Families: ``random`` (cursors advance by random steps below 2p,
    crt_inst kept above committed_upto; a ring of random stamps below
    r0, a fifth of it -1, no sample), ``one_bin`` (every group commits
    and assigns p slots a round with 2p in flight, the ring holding the
    two rounds before: every sampled latency is 3 rounds, one bin, as in
    place; needs 3p <= w) and ``edges`` (groups that assign or commit
    nothing, fewer than, exactly or more than w slots in a round, or
    whose cursors go backwards)."""
    r0 = 300
    steps = np.array([-2, 0, 1, w // 4 + 1, w - 1, w, w + 1, 3 * w + 8, 3, 0, w,
                      1, 2 * w + 2, 7])
    i = np.arange(rounds + 1)[:, None]
    out = {}
    for name in names or K9_FAMILIES:
        u0 = rng.integers(1000, 6000, g)
        inj = np.where(rng.random((g, w)) < 0.8, rng.integers(0, r0, (g, w)), -1)
        if name == "random":
            u = u0 + np.cumsum(np.vstack([np.zeros((1, g), np.int64),
                                          rng.integers(0, 2 * p, (rounds, g))]), 0)
            c = u0 + 1 + rng.integers(0, 3 * p, g) + np.cumsum(np.vstack(
                [np.zeros((1, g), np.int64), rng.integers(0, 2 * p, (rounds, g))]), 0)
            c = np.maximum(c, u + 1)
            e = u - rng.integers(0, 300, (rounds + 1, g))
        elif name == "one_bin":
            if 3 * p > w:
                raise ValueError("one_bin needs 3p <= w")
            u = u0 + i * p
            c = u + 1 + 2 * p
            e = u.copy()
            inj = np.full((g, w), -1)
            j = np.arange(2 * p)
            pos = (c[0][:, None] - 2 * p + j) % w
            inj[np.arange(g)[:, None], pos] = r0 - 2 + j // p
        elif name == "edges":
            n = len(steps)
            gi = np.arange(g)
            su = steps[::-1][(gi[None, :] + 2 * i[:-1]) % n]
            sc = steps[(gi[None, :] + i[:-1]) % n]
            zero = np.zeros((1, g), np.int64)
            u = u0 + np.cumsum(np.vstack([zero, su]), 0)
            c = u0 + 1 + rng.integers(0, 90, g) + np.cumsum(np.vstack([zero, sc]), 0)
            e = u - rng.integers(-9, 30, (rounds + 1, g))
        else:
            raise ValueError(f"unknown K9 family {name!r}")
        prep = rng.random((rounds + 1, g)) < 0.9
        states = np.repeat(np.stack([u, c, e, prep], 1), r, axis=2).astype(np.int32)
        kinds = np.stack([np.where(rng.random((g * r, mp)) < q,
                                   rng.integers(1, 12, (g * r, mp)), 0)
                          for q in (0.3, 0.1)]).astype(np.int32)
        out[name] = dict(states=states, inj=inj.astype(np.int32), kinds=kinds, r0=r0)
    return out


def k9_on(fam: dict, device, with_prepared: bool = True) -> dict:
    """A family of ``k9_families`` as tensors on ``device``: ``states``
    a list of namespaces (committed_upto, crt_inst, executed_upto and,
    with ``with_prepared``, prepared as bool), ``inj``, ``kinds``."""
    st = torch.from_numpy(fam["states"]).to(device)
    states = []
    for x in st:
        ns = SimpleNamespace(committed_upto=x[0].contiguous(), crt_inst=x[1].contiguous(),
                             executed_upto=x[2].contiguous())
        if with_prepared:
            ns.prepared = x[3] != 0
        states.append(ns)
    return dict(states=states, inj=torch.from_numpy(fam["inj"]).to(device),
                kinds=torch.from_numpy(fam["kinds"]).to(device), r0=fam["r0"])


def chain_rounds(fam: dict, bufs, cursor_rep: int, n_proposals: int, leader: int,
                 tel_base: int = 0, *, fused: bool = True, plain: bool = False,
                 drain: bool = False):
    """Drive K9 over a family (``k9_on``) as the resident loop does, on
    ``bufs`` = (scratch, inj, hist, tel) updated in place: ``round_open``
    before the first step; per round, with ``drain`` and the ring armed,
    a drain sub-step's ``round_open`` (the second kind table), then the
    round's ``round_close``, which opens the next round itself
    (``fused``) or is followed by a ``round_open`` of it; the last close
    writes the totals. ``plain`` calls the plain twins. Yields after
    each round."""
    scratch, inj, hist, tel = bufs
    g = inj.shape[0]
    states, kinds = fam["states"], fam["kinds"]
    tel_on = tel.shape[0] > 0
    open_ = _round_open_plain if plain else round_open
    close = _round_close_plain if plain else round_close
    injected = g * n_proposals * (1 if leader >= 0 else
                                  states[0].committed_upto.shape[0] // g)
    open_(scratch, states[0], kinds[0], cursor_rep, g, n_proposals, leader, True, tel_on,
          fam["r0"])
    n = len(states) - 1
    for t in range(n):
        st, rnd, last = states[t + 1], fam["r0"] + t, t == n - 1
        if drain and tel_on:
            open_(scratch, st, kinds[1], cursor_rep, g, 0, leader, False, True, rnd)
        nk = None if last or not fused else kinds[0]
        close(scratch, inj, hist, tel, st, cursor_rep, rnd, tel_base, injected, nk,
              n_proposals, leader, last)
        if not fused and not last:
            open_(scratch, st, kinds[0], cursor_rep, g, n_proposals, leader, True, tel_on,
                  rnd + 1)
        yield t
