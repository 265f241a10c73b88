"""K9, the resident loop's bookkeeping, on the CPU (integers: tolerance 0).

1. The fused plain twin (``round_close`` that opens the next round and,
   on the last round, writes the dispatch's totals) against the old
   composition (a close, then ``_round_open_plain``), round by round
   over chains of 8 rounds of ``ops/resident.py k9_families``: random
   cursors, every latency in one bin, and the edge cursors (groups that
   assign or commit nothing, fewer than, exactly or more than W slots,
   cursors that go backwards); the telemetry ring off, armed, and
   wrapping; with and without a drain sub-step's open between closes.
2. The port's ``ShardedCluster.run_resident`` against the JAX
   package's: dispatches of k = 1, 2 and 8 rounds at substeps 1 and 2,
   MinPaxos (with a re-election between dispatches) and Mencius; the
   returned (committed_total, in_flight), the inject ring, the
   histogram, the telemetry rows and every state leaf must be equal.
   Each JAX configuration compiles once per file (module fixture).
3. K9's launches per dispatch: one ``round_open`` before the first step
   (and one per drain sub-step with the ring armed), one
   ``round_close`` per round.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from minpaxos_tpu.models.minpaxos import MinPaxosConfig as JaxCfg
from minpaxos_tpu.parallel.sharded import ShardedCluster as JaxSharded
from minpaxos_tpu_torch.models.cluster import to_numpy_state
from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
from minpaxos_tpu_torch.ops import resident
from minpaxos_tpu_torch.parallel import sharded
from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

torch.set_num_threads(1)

# ------------------------------------------------ 1. the plain twins

G9, R9, W9, MP9, ROUNDS, P9, BINS = 14, 3, 64, 40, 8, 12, 9


def _chain(fam, tel_rows, fused, drain, leader=1):
    bufs = (resident.new_scratch(G9, "cpu"), fam["inj"].clone(),
            torch.arange(BINS, dtype=torch.int32),
            torch.full((tel_rows, 9), -1, dtype=torch.int32))
    snaps = [tuple(t.clone() for t in bufs)
             for _ in resident.chain_rounds(fam, bufs, max(leader, 0), 11, leader, 3,
                                            fused=fused, plain=True, drain=drain)]
    return snaps


@pytest.mark.parametrize("drain", [False, True])
@pytest.mark.parametrize("tel_rows", [0, 5, 64])
@pytest.mark.parametrize("family", resident.K9_FAMILIES)
def test_fused_twin_equals_close_then_open(family, tel_rows, drain):
    rng = np.random.default_rng(9)
    fam = resident.k9_on(resident.k9_families(rng, G9, R9, W9, MP9, ROUNDS, P9,
                                              names=(family,))[family], "cpu")
    fused = _chain(fam, tel_rows, True, drain)
    old = _chain(fam, tel_rows, False, drain)
    assert len(fused) == len(old) == ROUNDS
    for a, b in zip(fused, old):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    scr, inj, hist, tel = fused[-1]
    # the last round's totals, as the JAX loop returns them
    last = fam["states"][-1]
    u = last.committed_upto.view(G9, R9)[:, 1]
    c = last.crt_inst.view(G9, R9)[:, 1]
    assert resident.totals_of(scr).tolist() == [int((u + 1).sum()),
                                                int((c - 1 - u).sum())]
    # both rounds' pairs are back to 0 after the last row
    if tel_rows:
        assert not scr[3 * G9 + resident.A_PAIRS:3 * G9 + resident.A_TOTALS].any()
        assert (tel[:, 0] >= 0).sum() == min(tel_rows, ROUNDS)
    if family == "one_bin":  # every sample in one bin
        d = hist - torch.arange(BINS, dtype=torch.int32)
        assert d.nonzero().flatten().tolist() == [2]
        assert int(d[2]) == G9 * P9 * ROUNDS
    if family == "edges":  # a group stamped the whole ring in the last round
        assert (inj == fam["r0"] + ROUNDS - 1).all(1).any()


def test_fused_twin_opens_the_next_round_like_round_open():
    """One close with ``next_kind``: the snapshot is the post-step
    cursors, and inbox_rows / inbox_hwm hold the next round's live rows
    (plus the leader's injected rows), not this round's."""
    rng = np.random.default_rng(4)
    fam = resident.k9_on(resident.k9_families(rng, G9, R9, W9, MP9, 1, P9,
                                              names=("random",))["random"], "cpu")
    st, kinds = fam["states"], fam["kinds"]
    scr = resident.new_scratch(G9, "cpu")
    tel = torch.full((4, 9), -1, dtype=torch.int32)
    resident.round_open(scr, st[0], kinds[1], 0, G9, 7, 0, True, True, 5)
    acc = scr[3 * G9:]
    before = acc[resident.A_PAIRS + 2:resident.A_PAIRS + 4].clone()  # round 5's pair
    assert before[0] > 0 and not acc[resident.A_PAIRS:resident.A_PAIRS + 2].any()
    resident.round_close(scr, fam["inj"].clone(), torch.zeros(BINS, dtype=torch.int32),
                         tel, st[1], 0, 5, 0, G9 * 7, kinds[0], 7, 0)
    assert tel[1, 5] == before[0] and tel[1, 8] == before[1]
    assert not acc[resident.A_PAIRS + 2:resident.A_PAIRS + 4].any()
    live = (kinds[0] != 0).sum(1).view(G9, R9)  # round 6's pair
    assert acc[resident.A_PAIRS] == live.sum()
    assert acc[resident.A_PAIRS + 1] == torch.maximum(live[:, 0] + 7,
                                                      live[:, 1:].amax(1)).max()
    u = st[1].committed_upto.view(G9, R9)[:, 0]
    assert torch.equal(scr[:G9], u) and acc[resident.A_SUMS] == u.sum()


def test_round_close_refuses_a_scratch_of_another_layout():
    fam = resident.k9_on(resident.k9_families(np.random.default_rng(0), G9, R9, W9,
                                              MP9, 1, P9, names=("random",))["random"],
                         "cpu")
    with pytest.raises(ValueError, match="new_scratch"):
        resident.round_close(torch.zeros(3 * G9 + 8, dtype=torch.int32), fam["inj"],
                             torch.zeros(BINS, dtype=torch.int32),
                             torch.zeros((0, 9), dtype=torch.int32), fam["states"][1],
                             0, 5, 0, 0)


# --------------------------------------- 2. the resident loop vs JAX

SHAPES = {
    "minpaxos": dict(n_replicas=5, window=64, inbox=40, exec_batch=16, kv_pow2=10,
                     catchup_rows=8, recovery_rows=8),
    "mencius": dict(n_replicas=5, window=256, inbox=128, exec_batch=40, kv_pow2=10,
                    catchup_rows=8, recovery_rows=8, noop_delay=8),
}
LOAD = {"minpaxos": (16, 12), "mencius": (8, 4)}  # ext rows, proposals per round
G, RING = 2, 96
LOADED = (1, 2, 8)  # k of the loaded dispatches, before and after the re-election
CASES = [(p, s) for p in SHAPES for s in (1, 2)]


def _drive(mod, proto, substeps):
    ext, p = LOAD[proto]
    cfg = (JaxCfg if mod == "jax" else MinPaxosConfig)(**SHAPES[proto])
    kw = dict(ext_rows=ext, key_space=64, seed=5, protocol=proto)
    sc = JaxSharded(cfg, G, **kw) if mod == "jax" else ShardedCluster(
        cfg, G, device="cpu", **kw)
    if proto == "minpaxos":
        sc.elect(0)
    sc.begin_resident(telemetry_rounds=RING)
    res = [sc.run_resident(k, p, substeps) for k in LOADED]
    if proto == "minpaxos":
        sc.elect(1)  # a re-election between dispatches: the cursor replica moves
    res += [sc.run_resident(k, p, substeps) for k in LOADED[::-1]]
    res += [sc.run_resident(8, 0, substeps) for _ in range(2)]
    tel = sc.resident_telemetry()
    inj = np.asarray(sc._inject_round.cpu() if mod == "port" else sc._inject_round)
    hist = sc.end_resident()
    if mod == "port":
        leaves = jax.tree_util.tree_leaves(to_numpy_state(sc.ss, single=False))
    else:
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(sc.ss)]
    return dict(res=res, tel=tel, inj=inj, hist=hist, leaves=leaves)


@pytest.fixture(scope="module")
def runs():
    return {(mod, proto, s): _drive(mod, proto, s)
            for proto, s in CASES for mod in ("jax", "port")}


@pytest.mark.parametrize("proto,substeps", CASES)
def test_resident_dispatches_match_jax(runs, proto, substeps):
    j, t = runs[("jax", proto, substeps)], runs[("port", proto, substeps)]
    assert j["res"] == t["res"]
    assert all(type(c) is int and type(f) is int for c, f in t["res"])
    assert t["res"][-1][1] == 0 and t["res"][-1][0] > 0  # drained
    np.testing.assert_array_equal(j["tel"], t["tel"])
    np.testing.assert_array_equal(j["inj"], t["inj"])
    np.testing.assert_array_equal(j["hist"], t["hist"])
    assert len(j["leaves"]) == len(t["leaves"])
    for a, b in zip(j["leaves"], t["leaves"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(t["tel"]) == 2 * sum(LOADED) + 16


def test_sharded_run_resident_returns_the_totals_at_zero_rounds():
    cfg = MinPaxosConfig(**SHAPES["minpaxos"])
    sc = ShardedCluster(cfg, G, ext_rows=16, key_space=64, seed=5, device="cpu")
    sc.elect(0)
    sc.begin_resident(telemetry_rounds=4)
    sc.run_resident(3, 12)
    inj = sc._inject_round.clone()
    out = sharded.sharded_run_resident(cfg, G, 16, 0, sc.ss, sc._inject_round,
                                       sc._lat_hist, sc._telemetry, 12, 0, sc._seed)
    u = sc.ss.states.committed_upto.view(G, 5)[:, 0]
    c = sc.ss.states.crt_inst.view(G, 5)[:, 0]
    assert (int(out[4]), int(out[5])) == (int((u + 1).sum()), int((c - 1 - u).sum()))
    assert torch.equal(out[1], inj)


# ------------------------------------------- 3. launches per dispatch

@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("ring", [0, 40])
def test_k9_runs_once_a_round(monkeypatch, substeps, ring):
    calls = {"open": [], "close": []}
    real_open, real_close = sharded.round_open, sharded.round_close

    def count_open(*a):
        calls["open"].append((a[7], a[9]))  # first, the round
        return real_open(*a)

    def count_close(*a):
        calls["close"].append((a[9] is not None, a[12]))  # next_kind, totals
        return real_close(*a)

    monkeypatch.setattr(sharded, "round_open", count_open)
    monkeypatch.setattr(sharded, "round_close", count_close)
    sc = ShardedCluster(MinPaxosConfig(**SHAPES["minpaxos"]), G, ext_rows=16,
                        key_space=64, seed=5, device="cpu")
    sc.elect(0)
    sc.begin_resident(telemetry_rounds=ring)
    k = 6
    sc.run_resident(k, 12, substeps)
    drains = (substeps - 1) if ring else 0
    r0 = sc._seed - k
    assert calls["open"] == [(True, r0)] + [(False, r0 + t) for t in range(k)
                                            for _ in range(drains)]
    assert calls["close"] == [(True, False)] * (k - 1) + [(False, True)]
