"""The port's verify package held against the JAX package's, on the CPU.

The invariant predicates, the quorum certificates and their ledger, the
abstract spec, and the explorers (safety, refinement, liveness) of
``minpaxos_tpu_torch/verify`` against ``minpaxos_tpu/verify`` on the
same seeded inputs and bounds; every comparison is exact. The explorers'
state keys hash the same bytes, so their digests are compared too.
"""

from __future__ import annotations

import json
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from minpaxos_tpu.analysis import quorum_golden as ref_golden
from minpaxos_tpu.verify import invariants as ref_inv
from minpaxos_tpu.verify import mc as ref_mc
from minpaxos_tpu.verify import quorum as ref_quorum
from minpaxos_tpu.verify import spec as ref_spec
from minpaxos_tpu.verify.refine import RefinementExplorer as RefRefinement
from minpaxos_tpu_torch.cli import mc as port_cli
from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
from minpaxos_tpu_torch.verify import invariants as inv
from minpaxos_tpu_torch.verify import mc
from minpaxos_tpu_torch.verify import quorum, quorum_golden, spec
from minpaxos_tpu_torch.verify.liveness import LivenessExplorer, fair_bounds
from minpaxos_tpu_torch.verify.refine import RefinementExplorer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = sorted((ROOT / "tests" / "fixtures").glob("mc_*.json"))


# ------------------------------------------------------------ invariants

class FakeStore:
    """The slice of StableStore the predicates read."""

    def __init__(self, rec, prefix, base=-1, snap_frontier=-1, pairs=None):
        self.rec, self.prefix, self.base = rec, prefix, base
        self.snap_frontier = snap_frontier
        self.snapshot_pairs = pairs

    def committed_prefix(self):
        return self.prefix

    def read_range(self, lo, hi):
        r = self.rec
        return r[(r["inst"] >= lo) & (r["inst"] <= hi)]


def _cols(rng, n):
    return (np.arange(n), rng.integers(0, 4, n).astype(np.uint8),
            rng.integers(0, 6, n), rng.integers(0, 1 << 40, n),
            rng.integers(-1, 8, n), rng.integers(-1, 3, n))


def _invariant_case(mod, pred: str, seed: int):
    """Run one predicate of module ``mod`` on inputs made from ``seed``
    with numpy; returns the report and anything else it produced."""
    rng = np.random.default_rng(seed)
    report = mod.CheckReport()
    n = 12
    cols = _cols(rng, n)
    base = mod.make_records(*cols)
    recs, fronts = {}, {}
    for r in range(3):
        rec = base.copy()
        if rng.random() < 0.6:  # a divergent field somewhere
            i = int(rng.integers(0, n))
            f = ("op", "key", "val", "cmd_id", "client_id")[int(rng.integers(0, 5))]
            rec[f][i] = rec[f][i] + 1
        if rng.random() < 0.4:  # a hole
            rec = np.delete(rec, int(rng.integers(0, n)))
        recs[r] = rec
        fronts[r] = int(rng.integers(-1, n))
    w_ops = rng.integers(1, 3, 6).astype(np.int32)
    w_keys = rng.integers(0, 6, 6)
    w_vals = rng.integers(0, 1 << 40, 6)
    if pred == "records":
        return report, base
    if pred == "agreement":
        bases = {r: int(rng.integers(-1, 3)) for r in recs}
        mod.check_slot_agreement(recs, fronts, report,
                                 bases=bases if seed % 2 else None)
    elif pred == "validity":
        for r in recs:
            mod.check_validity(recs[r], w_ops, w_keys, w_vals, report,
                               who=f"replica {r}")
    elif pred == "frontier":
        mod.check_frontier_monotonic(
            {r: list(rng.integers(-1, 6, 5)) for r in range(3)}, report)
    elif pred == "linearizable":
        replies = {int(c): {"val": int(v)} for c, v in
                   zip(rng.integers(0, 8, 5), rng.integers(0, 1 << 40, 5))}
        mod.check_linearizable(FakeStore(recs[0], fronts[0]), replies,
                               w_ops, w_keys, w_vals, report)
    elif pred == "cluster":
        pairs = np.zeros(2, [("key", "<i8"), ("val", "<i8")])
        pairs["key"] = rng.integers(0, 6, 2)
        pairs["val"] = rng.integers(0, 1 << 40, 2)
        stores = {0: FakeStore(recs[0], fronts[0]),
                  1: FakeStore(recs[1], fronts[1]),
                  2: FakeStore(recs[2], fronts[2], base=1, snap_frontier=1,
                               pairs=pairs)}
        replies = {int(c): {"val": int(v)} for c, v in
                   zip(rng.integers(0, 8, 4), rng.integers(0, 1 << 40, 4))}
        report = mod.check_cluster(
            stores, {0: [0, 2, 1]}, replies, (w_ops, w_keys, w_vals))
    return report, None


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pred", ["records", "agreement", "validity",
                                  "frontier", "linearizable", "cluster"])
def test_invariants_match_the_reference(pred, seed):
    mine, rec_mine = _invariant_case(inv, pred, seed)
    ref, rec_ref = _invariant_case(ref_inv, pred, seed)
    assert mine.to_dict() == ref.to_dict()
    if pred == "records":
        assert rec_mine.dtype == rec_ref.dtype
        assert rec_mine.tobytes() == rec_ref.tobytes()
    assert inv.VALUE_FIELDS == ref_inv.VALUE_FIELDS
    assert inv.SLOT_RECORD == ref_inv.SLOT_RECORD


# -------------------------------------------------------------- quorums

def _outcome(fn, *a):
    try:
        out = fn(*a)
    except ValueError:
        return "ValueError"
    return out.to_dict() if hasattr(out, "to_dict") else out


@pytest.mark.parametrize("n", range(1, 17))
def test_threshold_certificates_match_the_reference(n):
    assert quorum.certified_pairs(n) == ref_quorum.certified_pairs(n)
    assert quorum.majority(n) == ref_quorum.majority(n)
    golden = set(quorum.certified_pairs(n))
    for q1 in range(0, n + 2):
        for q2 in range(0, n + 2):
            mine = _outcome(quorum.certify_threshold, n, q1, q2)
            assert mine == _outcome(ref_quorum.certify_threshold, n, q1, q2)
            assert _outcome(quorum.certify_fast, n, q1, q2) == \
                _outcome(ref_quorum.certify_fast, n, q1, q2)
            assert (_outcome(quorum.spec_quorums, n, q1, q2)
                    == _outcome(ref_quorum.spec_quorums, n, q1, q2))
            if mine != "ValueError" and ((q1, q2) in golden
                                         or not mine["intersects"]):
                c = quorum.certify_threshold(n, q1, q2)
                assert quorum.verify_certificate(c) == \
                    ref_quorum.verify_certificate(
                        ref_quorum.certify_threshold(n, q1, q2))


@pytest.mark.parametrize("grid", quorum_golden.GOLDEN_GRIDS,
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_certificates_match_the_reference(grid):
    rows, cols = grid[:2]
    for a1 in ("row", "col"):
        for a2 in ("row", "col"):
            mine = quorum.certify_grid(rows, cols, a1, a2)
            ref = ref_quorum.certify_grid(rows, cols, a1, a2)
            assert mine.to_dict() == ref.to_dict()
            assert quorum.verify_certificate(mine) == \
                ref_quorum.verify_certificate(ref)
    assert _outcome(quorum.certify_grid, 0, cols) == \
        _outcome(ref_quorum.certify_grid, 0, cols)


def test_the_quorum_ledger_is_the_reference_ledger():
    assert quorum_golden.GOLDEN_MAX_N == ref_golden.GOLDEN_MAX_N
    assert quorum_golden.GOLDEN_THRESHOLDS == ref_golden.GOLDEN_THRESHOLDS
    assert quorum_golden.GOLDEN_GRIDS == ref_golden.GOLDEN_GRIDS
    assert set(quorum_golden.THRESHOLD_FORMULAS) == \
        set(ref_golden.THRESHOLD_FORMULAS)
    for name, f in quorum_golden.THRESHOLD_FORMULAS.items():
        for n in range(1, quorum_golden.GOLDEN_MAX_N + 1):
            assert f(n) == ref_golden.THRESHOLD_FORMULAS[name](n)


@pytest.mark.parametrize("kw", [
    dict(n_replicas=3), dict(n_replicas=5, q1=4, q2=2),
    dict(n_replicas=4, q1=2, q2=2), dict(n_replicas=3, fast_path=True),
    dict(n_replicas=3, fast_path=True, q_fast=2),
    dict(n_replicas=3, fast_path=True, explicit_commit=True)],
    ids=["majority", "flex", "refuted", "fast", "fast_q2", "fast_classic"])
def test_config_quorum_validation_matches_the_reference(kw):
    cfg = MinPaxosConfig(**kw)
    assert _outcome(quorum.validate_config_quorums, cfg) == \
        _outcome(ref_quorum.validate_config_quorums, cfg)


# ----------------------------------------------------------------- spec

def _spec_run(mod, seed: int):
    """A seeded random action sequence on the abstract machine; each
    action's outcome (applied, or the violation's text) and the end
    state."""
    rng = np.random.default_rng(seed)
    n = (3, 5)[seed % 2]
    pairs = list(ref_golden.GOLDEN_THRESHOLDS[n]) + [(1, 1)]
    q1, q2 = pairs[seed % len(pairs)]
    st = mod.SpecState(n=n, q1=q1, q2=q2)
    outcomes = []
    for _ in range(60):
        a = int(rng.integers(0, 7))
        ballot = int(rng.integers(-1, 4)) * 16 + int(rng.integers(0, n))
        acc, slot = int(rng.integers(0, n + 1)), int(rng.integers(0, 3))
        value = ("v", int(rng.integers(0, 2)))
        try:
            if a == 0:
                st.phase1a(ballot)
            elif a == 1:
                st.phase1b(acc, ballot)
            elif a == 2:
                st.phase2a(ballot, slot, value)
            elif a == 3:
                st.phase2b(min(acc, n - 1), ballot, slot)
            elif a == 4:
                st.commit(slot, value)
            elif a == 5:
                st.skip(acc, slot, ("noop",))
            else:
                st.check_agreement()
            outcomes.append("ok")
        except mod.SpecViolation as e:
            outcomes.append(str(e))
    return outcomes, asdict(st)


@pytest.mark.parametrize("seed", range(8))
def test_spec_actions_match_the_reference(seed):
    assert _spec_run(spec, seed) == _spec_run(ref_spec, seed)


def test_spec_tables_match_the_reference():
    assert spec.NO_BALLOT == ref_spec.NO_BALLOT
    assert spec.ABSTRACT_ACTIONS == ref_spec.ABSTRACT_ACTIONS
    assert spec.MSGKIND_ACTIONS == ref_spec.MSGKIND_ACTIONS
    for n in range(1, 8):
        for q1 in range(0, n + 1):
            for q2 in range(0, n + 1):
                try:
                    mine = asdict(spec.spec_for_model(n, q1, q2))
                except ValueError:
                    mine = "ValueError"
                try:
                    ref = asdict(ref_spec.spec_for_model(n, q1, q2))
                except ValueError:
                    ref = "ValueError"
                assert mine == ref, (n, q1, q2)


# ------------------------------------------------------------ explorers

def _ref_run(cls, protocol, bounds: mc.Bounds, **kw):
    """The JAX explorer's run, its keys recorded from ``_key``."""

    class Recording(cls):
        def _key(self, node):
            k = super()._key(node)
            self.keys.add(k)
            return k

    ex = Recording(protocol, ref_mc.Bounds(**bounds.to_dict()), **kw)
    ex.keys = set()
    return ex, ex.run()


def _result(res) -> dict:
    d = res.to_dict()
    d.pop("wall_s")
    return d


TINY = mc.Bounds(max_depth=4, drops=1, dups=0, internal=1, elections=0,
                 n_cmds=1, propose_to=(0,))  # tests/test_paxmc.py:241


@pytest.mark.parametrize("protocol", mc.PROTOCOLS)
def test_explorer_matches_the_reference(protocol):
    ref_ex, ref = _ref_run(ref_mc.Explorer, protocol, TINY)
    ex = mc.Explorer(protocol, TINY, device="cpu")
    res = ex.run()
    assert res.ok and res.drained
    assert _result(res) == _result(ref)
    assert mc.state_digest(ex.seen) == mc.state_digest(ref_ex.keys)


REFINE = {  # tests/test_paxref.py:205 and :221
    "minpaxos": mc.Bounds(max_depth=4, drops=1, dups=0, internal=1,
                          elections=1, n_cmds=1, propose_to=(0,)),
    "mencius": mc.Bounds(max_depth=4, drops=1, dups=0, internal=1,
                         elections=0, n_cmds=1, propose_to=(0, 1)),
}


@pytest.mark.parametrize("protocol", sorted(REFINE))
def test_refinement_matches_the_reference(protocol):
    ref_ex, ref = _ref_run(RefRefinement, protocol, REFINE[protocol])
    ex = RefinementExplorer(protocol, REFINE[protocol], device="cpu")
    res = ex.run()
    assert res.ok and res.drained
    assert _result(res) == _result(ref)
    assert ex.refine_stats() == ref_ex.refine_stats()
    assert ex.refine_stats()["edges_checked"] == res.transitions
    assert mc.state_digest(ex.seen) == mc.state_digest(ref_ex.keys)


@pytest.mark.parametrize("chunk", (1, 3))
@pytest.mark.parametrize("protocol", sorted(REFINE))
def test_small_chunks_equal_the_default_chunk(protocol, chunk):
    """chunk=1 steps one transition a call, as the reference does, and
    chunk=3 cuts every layer into many windows; the batched explorer
    must give the same result, states and edges (depth 3 of the
    refinement bounds, an election included for minpaxos)."""
    b = mc.Bounds(**{**REFINE[protocol].to_dict(), "max_depth": 3})
    runs = []
    for c in (chunk, mc.CHUNK):
        ex = RefinementExplorer(protocol, b, device="cpu", chunk=c)
        res = ex.run()
        runs.append((_result(res), ex.refine_stats(),
                     mc.state_digest(ex.seen)))
        assert ex.stepper.max_batch == min(c, ex.stepper.max_batch)
    assert runs[0] == runs[1]
    assert runs[0][0]["transitions"] > 100


def test_broken_quorum_mutant_gives_the_reference_counterexample():
    b = mc.Bounds(max_depth=6, drops=2, dups=0, internal=1, elections=1,
                  electable=(1,), n_cmds=2, propose_to=(0, 1))
    _ref_ex, ref = _ref_run(ref_mc.Explorer, "minpaxos", b,
                            majority_override=1)
    res = mc.Explorer("minpaxos", b, majority_override=1, device="cpu").run()
    assert res.counterexample is not None
    assert res.counterexample.to_dict() == ref.counterexample.to_dict()
    assert _result(res) == _result(ref)
    assert any("DIVERGENCE" in v
               for v in res.counterexample.report["violations"])


def test_skip_quorum2_mutant_gives_the_reference_counterexample():
    b = mc.Bounds(max_depth=5, drops=0, dups=0, internal=1, elections=0,
                  n_cmds=1, propose_to=(0,))  # tests/test_paxref.py:233
    _ref_ex, ref = _ref_run(RefRefinement, "minpaxos", b,
                            mutant="skip-quorum2")
    res = RefinementExplorer("minpaxos", b, mutant="skip-quorum2",
                             device="cpu").run()
    ce = res.counterexample
    assert ce is not None and ce.kind == "refinement"
    assert ce.to_dict() == ref.counterexample.to_dict()
    assert any("commit-no-quorum" in v for v in ce.report["violations"])


def test_mutant_config_overrides_every_threshold():
    healthy = mc.model_config("minpaxos")
    mutant = mc.model_config("minpaxos", majority_override=1)
    assert (healthy.quorum1, healthy.quorum2) == (2, 2)
    assert (mutant.majority, mutant.quorum1, mutant.quorum2) == (1, 1, 1)
    assert tuple(healthy) == tuple(mutant)
    ref = ref_mc.model_config("minpaxos")
    assert tuple(healthy) == tuple(getattr(ref, f) for f in healthy._fields)


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_reference_counterexample_fixture_replays_through_the_port(path):
    ce = json.loads(path.read_text())
    reproduced, report = mc.replay_counterexample(ce, device="cpu")
    assert reproduced, report.to_dict()
    if ce.get("kind") == "lasso":
        assert any("LASSO" in v for v in report.violations)
    else:
        # the same first failing report as the search recorded (the
        # fixtures predate the report's snapshot_pairs_checked field)
        got = report.to_dict()
        assert {k: got[k] for k in ce["report"]} == ce["report"]


def test_liveness_flexible_pair_proves_eventual_commit():
    """tests/test_paxref.py:261's leg; its counts are MC.json's."""
    r = LivenessExplorer("minpaxos", fair_bounds(n_cmds=1), q1=3, q2=1,
                         device="cpu").explore()
    assert r.ok and r.drained and r.goal_states > 0
    assert r.deadlocks == 0 and r.fair_lassos == 0 and r.cyclic_sccs == 0
    want = json.loads((ROOT / "MC.json").read_text())["liveness"]["legs"][1]
    got = r.to_dict()
    for k in ("q1", "q2", "states", "transitions", "sccs", "cyclic_sccs",
              "goal_states", "deadlocks", "fair_lassos", "drained", "ok"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("name", port_cli.REFUSED_OUTPUTS)
def test_cli_never_writes_the_committed_records(name, tmp_path):
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--smoke", "--device", "cpu", "--json",
                       str(tmp_path / name)])
    assert e.value.code == 2
    assert not (tmp_path / name).exists()


@pytest.mark.parametrize("argv,code", [
    (["--certify", "5,4,2"], 0),
    (["--certify", "4,2,2"], 1),
    (["--print-quorum-golden"], 0),
    (["--replay", "tests/fixtures/mc_refine_skip_quorum2_minpaxos.json"], 0),
    (["--protocol", "mencius", "--depth", "3"], 0),
    (["--mutant", "skip-quorum2"], 0),
    (["--refine", "--spec-pair", "1,3", "--depth", "2"], 0),
], ids=["certify", "refute", "ledger", "replay", "mencius_depth3",
        "mutant_skip_quorum2", "refine"])
def test_cli_modes_on_the_cpu(argv, code, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    out = tmp_path / "verdict.json"
    extra = ([] if argv[0] in ("--certify", "--print-quorum-golden")
             else ["--device", "cpu", "--json", str(out)])
    assert port_cli.main(argv + extra) == code
    text = capsys.readouterr().out
    if extra:
        assert json.loads(out.read_text())
    if argv[0] == "--mutant":
        assert '"found": true' in text and '"replay_reproduced": true' in text
