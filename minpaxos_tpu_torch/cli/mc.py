"""paxmc on the port — bounded model checking of the port's steps.

    python -m minpaxos_tpu_torch.cli.mc --smoke            # the smoke legs
    python -m minpaxos_tpu_torch.cli.mc --smoke --device cpu
    python -m minpaxos_tpu_torch.cli.mc --protocol mencius --depth 6
    python -m minpaxos_tpu_torch.cli.mc --mutant broken-quorum
    python -m minpaxos_tpu_torch.cli.mc --replay tests/fixtures/mc_broken_quorum_minpaxos.json
    python -m minpaxos_tpu_torch.cli.mc --emit-faultplan tests/fixtures/mc_broken_quorum_minpaxos.json > plan.json
    python -m minpaxos_tpu_torch.cli.mc --refine --liveness
    python -m minpaxos_tpu_torch.cli.mc --flex-certified
    python -m minpaxos_tpu_torch.cli.mc --certify 5,4,2

The port of the JAX package's ``tools/mc.py``, with its legs and
bounds: ``--smoke`` runs the three protocol legs and the flexible leg
(MC.json's ``runs``), the four seeded mutants (broken-quorum,
flex-broken, skip-quorum2, dueling-leaders; each must be found and
replay), the refinement legs and the liveness legs, and prints one
verdict line with MC.json's fields. ``--flex-certified`` is
MC_FLEX.json's sweep. Every step runs on the card (``--device cuda``,
the default) through the hand-written kernels, one batched step per
chunk of a BFS layer, or on the CPU with ``--device cpu``. A file is
written only under ``--json PATH``, never to the committed MC.json or
MC_FLEX.json.

Exit status: 0 = verified clean (or, in --mutant/--replay mode, the
expected counterexample found/reproduced), 1 = violation, undrained
frontier, or budget exceeded, 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

#: the smoke legs' wall budget after the first leg (which builds the
#: kernels on the card)
SMOKE_BUDGET_S = 180.0

#: the committed records of the JAX package's checker; never written here
REFUSED_OUTPUTS = ("MC.json", "MC_FLEX.json")

#: the planted non-intersecting FLEXIBLE pair (q1 + q2 = 3 <= N = 3)
FLEX_MUTANT = {"q1": 2, "q2": 1}

#: the default flexible (q1, q2) pair for refinement/liveness legs
SPEC_PAIR = (3, 1)


def _smoke_legs():
    """(label, protocol, bounds, explorer kwargs): MC.json's four runs."""
    from minpaxos_tpu_torch.verify.mc import Bounds

    minpaxos = Bounds(max_depth=5, drops=1, dups=1, internal=1,
                      elections=1, electable=(1,), n_cmds=2,
                      propose_to=(0,))
    classic = Bounds(max_depth=5, drops=1, dups=1, internal=1,
                     elections=0, n_cmds=2, propose_to=(0,))
    mencius = Bounds(max_depth=4, drops=1, dups=1, internal=1,
                     elections=0, n_cmds=1, propose_to=(0, 1))
    flex = Bounds(max_depth=5, drops=1, dups=0, internal=1,
                  elections=0, n_cmds=2, propose_to=(0,))
    return [("minpaxos", "minpaxos", minpaxos, {}),
            ("classic", "classic", classic, {}),
            ("mencius", "mencius", mencius, {}),
            ("minpaxos-flex-q1=3-q2=1", "minpaxos", flex,
             {"q1": 3, "q2": 1})]


def _mutant_bounds():
    from minpaxos_tpu_torch.verify.mc import Bounds

    # two drops + both ingress queues: the two-leaders split-brain
    # appears within depth 6
    return Bounds(max_depth=6, drops=2, dups=0, internal=1, elections=1,
                  electable=(1,), n_cmds=2, propose_to=(0, 1))


def _flex_mutant_bounds():
    from minpaxos_tpu_torch.verify.mc import Bounds

    # the known counterexample is 8 deliveries deep
    # (tests/fixtures/mc_flex_broken_minpaxos.json)
    return Bounds(max_depth=8, drops=0, dups=0, internal=0, elections=1,
                  electable=(1,), n_cmds=2, propose_to=(0, 1))


def _refine_legs(pair=SPEC_PAIR):
    from minpaxos_tpu_torch.verify.mc import Bounds

    minpaxos = Bounds(max_depth=4, drops=1, dups=0, internal=1,
                      elections=1, n_cmds=1, propose_to=(0,))
    classic = Bounds(max_depth=5, drops=1, dups=0, internal=1,
                     elections=0, n_cmds=1, propose_to=(0,))
    mencius = Bounds(max_depth=4, drops=1, dups=0, internal=1,
                     elections=0, n_cmds=1, propose_to=(0, 1))
    flex = Bounds(max_depth=4, drops=0, dups=0, internal=1,
                  elections=0, n_cmds=1, propose_to=(0,))
    q1, q2 = pair
    return [("refine-minpaxos", "minpaxos", minpaxos, {}),
            ("refine-classic", "classic", classic, {}),
            ("refine-mencius", "mencius", mencius, {}),
            (f"refine-minpaxos-flex-q1={q1}-q2={q2}", "minpaxos", flex,
             {"q1": q1, "q2": q2})]


def _skip_quorum2_bounds():
    from minpaxos_tpu_torch.verify.mc import Bounds

    # the leader commits its own slot off a single vote three
    # deliveries in (tests/fixtures/mc_refine_skip_quorum2_minpaxos.json)
    return Bounds(max_depth=5, drops=0, dups=0, internal=1,
                  elections=0, n_cmds=1, propose_to=(0,))


def _flex_certified_bounds(n: int):
    from minpaxos_tpu_torch.verify.mc import Bounds

    return Bounds(max_depth=5 if n == 3 else 4,
                  drops=1 if n == 3 else 0, dups=0,
                  internal=1 if n == 3 else 0, elections=0,
                  n_cmds=2 if n == 3 else 1, propose_to=(0,))


class Legs:
    """Runs legs on one device and keeps, per leg, its wall,
    transitions per second, step calls, largest batch, the launches of
    each hand-written kernel (on the card), peak device memory (on the
    card) and the digest of the states it reached (``verify/mc.py
    state_digest``; None for a liveness leg, whose keys are quotient
    keys)."""

    def __init__(self, device="cuda", log=print):
        from minpaxos_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.log = log
        self.stats: list[dict] = []

    def kw(self) -> dict:
        return {"device": self.device}

    def run(self, label: str, ex, fn):
        """``fn()`` (one exploration of ``ex``), measured."""
        import torch

        from minpaxos_tpu_torch import kernels as K
        from minpaxos_tpu_torch.verify.mc import state_digest

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        before = K.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        after = K.launch_counts()
        transitions = getattr(out, "transitions", 0)
        self.stats.append(dict(
            label=label, protocol=ex.protocol, wall_s=wall,
            transitions=transitions,
            transitions_per_s=transitions / wall if wall > 0 else 0.0,
            step_s=ex.stepper.step_s,
            step_calls=ex.stepper.calls, step_rows=ex.stepper.rows,
            max_batch=ex.stepper.max_batch,
            peak_mib=(torch.cuda.max_memory_allocated(self.device) / 2 ** 20
                      if cuda else None),
            launches={k: n - before[k] for k, n in after.items()
                      if n != before[k]},
            digest=(state_digest(ex.seen) if hasattr(ex, "seen") else None)))
        return out


def _run_refine(legs: Legs, pair=SPEC_PAIR):
    """The refinement legs: every edge of every leg maps onto an
    abstract spec action (or a stutter) with zero violations."""
    from minpaxos_tpu_torch.verify.refine import RefinementExplorer

    log = legs.log
    out, ok = [], True
    for label, proto, b, kw in _refine_legs(pair):
        log(f"[paxmc] {label} (depth {b.max_depth}) ...", flush=True)
        ex = RefinementExplorer(proto, b, **kw, **legs.kw())
        res = legs.run(label, ex, ex.run)
        stats = ex.refine_stats()
        ok = ok and res.ok and res.drained
        out.append({
            "label": label, "ok": res.ok, "drained": res.drained,
            "states": res.states, "wall_s": round(res.wall_s, 2),
            "spec_q1": stats["spec_q1"], "spec_q2": stats["spec_q2"],
            "edges_checked": stats["edges_checked"],
            "abstract_actions": stats["abstract_actions"],
            "counterexample": (None if res.counterexample is None
                               else res.counterexample.to_dict())})
        log(f"[paxmc]   -> {'ok' if res.ok else 'VIOLATION'} "
            f"edges={stats['edges_checked']} "
            f"actions={stats['abstract_actions']} "
            f"wall={res.wall_s:.1f}s", flush=True)
    return {"ok": ok,
            "edges_checked": sum(x["edges_checked"] for x in out),
            "legs": out}


def _mutant_self_test(legs: Legs, label: str, ex, **extra):
    """A seeded mutant's exploration: the counterexample must be found
    and replay on the same device."""
    from minpaxos_tpu_torch.verify.mc import replay_counterexample

    res = legs.run(label, ex, ex.run)
    found = res.counterexample is not None
    reproduced = found and replay_counterexample(
        res.counterexample.to_dict(), device=legs.device)[0]
    legs.log(f"[paxmc] {label}: found={found} replayed={reproduced} "
             f"states={res.states} wall={res.wall_s:.1f}s", flush=True)
    return dict(extra, found=found, replay_reproduced=reproduced,
                states=res.states, wall_s=round(res.wall_s, 1),
                trace_len=(len(res.counterexample.trace) if found else 0),
                counterexample=(res.counterexample.to_dict()
                                if found else None))


def _run_liveness(legs: Legs, pair=SPEC_PAIR):
    """Eventual commit under weak fairness for the default quorums and
    one certified flexible pair (minpaxos)."""
    from minpaxos_tpu_torch.verify.liveness import LivenessExplorer, fair_bounds

    log = legs.log
    q1, q2 = pair
    legs_spec = [("liveness-minpaxos-default", {}),
                 (f"liveness-minpaxos-flex-q1={q1}-q2={q2}",
                  {"q1": q1, "q2": q2})]
    out, ok = [], True
    for label, kw in legs_spec:
        log(f"[paxmc] {label} ...", flush=True)
        ex = LivenessExplorer("minpaxos", fair_bounds(n_cmds=1),
                              max_states=10_000, **kw, **legs.kw())
        r = legs.run(label, ex, ex.explore)
        ok = ok and r.ok
        out.append(dict(r.to_dict(), label=label))
        log(f"[paxmc]   -> {'ok' if r.ok else 'FAIL'} states={r.states} "
            f"goal={r.goal_states} deadlocks={r.deadlocks} "
            f"lassos={r.fair_lassos} drained={r.drained} "
            f"wall={r.wall_s:.1f}s", flush=True)
    return {"ok": ok, "legs": out}


def _lasso_mutant_self_test(legs: Legs):
    """Dueling leaders: a fair lasso must be found and its stem+cycle
    replay to the same quotient state with the command uncommitted."""
    from minpaxos_tpu_torch.verify.liveness import LivenessExplorer, dueling_bounds
    from minpaxos_tpu_torch.verify.mc import replay_counterexample

    ex = LivenessExplorer("minpaxos", dueling_bounds(),
                          mutant="dueling-leaders", max_states=3000,
                          max_queue_rows=10, **legs.kw())
    r = legs.run("liveness-mutant dueling-leaders", ex, ex.explore)
    found = r.fair_lassos > 0 and r.lasso is not None
    reproduced = found and replay_counterexample(
        r.lasso.to_dict(), device=legs.device)[0]
    legs.log(f"[paxmc] liveness-mutant dueling-leaders: found={found} "
             f"replayed={reproduced} states={r.states} "
             f"lassos={r.fair_lassos} wall={r.wall_s:.1f}s", flush=True)
    return {"mutant": "dueling-leaders", "found": found,
            "replay_reproduced": reproduced, "states": r.states,
            "fair_lassos": r.fair_lassos, "wall_s": round(r.wall_s, 1),
            "trace_len": (len(r.lasso.trace) if found else 0),
            "loop_start": (r.lasso.loop_start if found else None),
            "counterexample": (r.lasso.to_dict() if found else None)}


def smoke(legs: Legs, spec_pair=SPEC_PAIR) -> dict:
    """Every leg of ``--smoke``; the verdict in MC.json's layout (plus
    ``device`` and per-leg ``leg_stats``)."""
    from minpaxos_tpu_torch.verify.mc import Explorer
    from minpaxos_tpu_torch.verify.refine import RefinementExplorer

    log = legs.log
    t_start = time.monotonic()
    t_budget = None
    runs, ok = [], True
    for label, proto, b, kw in _smoke_legs():
        log(f"[paxmc] exploring {label} (depth {b.max_depth}, "
            f"{b.n_cmds} cmds, drops {b.drops}, dups {b.dups}) ...",
            flush=True)
        ex = Explorer(proto, b, **kw, **legs.kw())
        res = legs.run(label, ex, lambda: ex.run(log=log))
        if t_budget is None:
            t_budget = time.monotonic()  # the first leg built the kernels
        runs.append(res)
        ok = ok and res.ok and res.drained
        log(f"[paxmc]   -> {'ok' if res.ok else 'VIOLATION'} "
            f"states={res.states} transitions={res.transitions} "
            f"drained={res.drained} wall={res.wall_s:.1f}s", flush=True)
    verdict = {"ok": ok, "runs": [r.to_dict() for r in runs]}
    # a checker that cannot find a planted non-intersecting quorum
    # certifies nothing: each mutant must be found and replay
    m = _mutant_self_test(
        legs, "mutant broken-quorum",
        Explorer("minpaxos", _mutant_bounds(), majority_override=1,
                 **legs.kw()))
    m.pop("counterexample")
    verdict["mutant_self_test"] = m
    fm = _mutant_self_test(
        legs, "mutant flex-broken",
        Explorer("minpaxos", _flex_mutant_bounds(), **FLEX_MUTANT,
                 **legs.kw()), **FLEX_MUTANT)
    fm.pop("counterexample")
    verdict["flex_mutant_self_test"] = fm
    verdict["refine"] = _run_refine(legs, spec_pair)
    rm = _mutant_self_test(
        legs, "refine-mutant skip-quorum2",
        RefinementExplorer("minpaxos", _skip_quorum2_bounds(),
                           mutant="skip-quorum2", **legs.kw()),
        mutant="skip-quorum2")
    rm.pop("counterexample")
    verdict["refine_mutant_self_test"] = rm
    verdict["liveness"] = _run_liveness(legs, spec_pair)
    lm = _lasso_mutant_self_test(legs)
    lm.pop("counterexample")
    verdict["lasso_mutant_self_test"] = lm
    ok = (ok and m["found"] and m["replay_reproduced"]
          and fm["found"] and fm["replay_reproduced"]
          and verdict["refine"]["ok"]
          and rm["found"] and rm["replay_reproduced"]
          and verdict["liveness"]["ok"]
          and lm["found"] and lm["replay_reproduced"])
    checked_wall = time.monotonic() - (t_budget or t_start)
    verdict["budget_s"] = SMOKE_BUDGET_S
    verdict["within_budget"] = checked_wall <= SMOKE_BUDGET_S
    verdict["ok"] = ok and verdict["within_budget"]
    verdict["wall_s"] = round(time.monotonic() - t_start, 2)
    verdict["device"] = str(legs.device)
    verdict["leg_stats"] = legs.stats
    return verdict


def flex_certified(legs: Legs, spec_pair=SPEC_PAIR,
                   liveness: dict | None = None) -> dict:
    """One refinement-checked exploration per certified (q1, q2) ledger
    pair at N=3..5 (minpaxos), then the liveness legs (``liveness``: an
    already computed ``_run_liveness`` result, reused); the verdict in
    MC_FLEX.json's layout."""
    from minpaxos_tpu_torch.verify.quorum_golden import GOLDEN_THRESHOLDS
    from minpaxos_tpu_torch.verify.refine import RefinementExplorer

    log = legs.log
    runs = []
    for n in (3, 4, 5):
        b = _flex_certified_bounds(n)
        for q1, q2 in GOLDEN_THRESHOLDS.get(n, ()):
            label = f"flex-certified n={n} q1={q1} q2={q2}"
            log(f"[paxmc] {label} (depth {b.max_depth}) ...", flush=True)
            ex = RefinementExplorer("minpaxos", b, q1=q1, q2=q2,
                                    n_replicas=n, **legs.kw())
            res = legs.run(label, ex, ex.run)
            stats = ex.refine_stats()
            runs.append(dict(res.to_dict(),
                             edges_checked=stats["edges_checked"],
                             abstract_actions=stats["abstract_actions"]))
            log(f"[paxmc]   -> {'ok' if res.ok else 'VIOLATION'} "
                f"states={res.states} edges={stats['edges_checked']} "
                f"drained={res.drained} wall={res.wall_s:.1f}s", flush=True)
    if liveness is None:
        liveness = _run_liveness(legs, spec_pair)
    ok = all(r["ok"] and r["drained"] for r in runs) and liveness["ok"]
    return {"ok": ok, "flex_certified": True,
            "refined_edges": sum(r["edges_checked"] for r in runs),
            "runs": runs, "liveness": liveness,
            "device": str(legs.device), "leg_stats": legs.stats}


def smoke_line(verdict: dict) -> dict:
    """The one-line verdict of ``--smoke``."""
    runs = verdict["runs"]
    return {"ok": verdict["ok"],
            "states": sum(r["states"] for r in runs),
            "transitions": sum(r["transitions"] for r in runs),
            "violations": sum(0 if r["ok"] else 1 for r in runs),
            "drained": all(r["drained"] for r in runs),
            "wall_s": verdict["wall_s"],
            "mutant_self_test": verdict["mutant_self_test"]["found"],
            "flex_mutant_self_test":
                verdict["flex_mutant_self_test"]["found"],
            "refined_edges": verdict["refine"]["edges_checked"],
            "refine_mutant_self_test":
                verdict["refine_mutant_self_test"]["found"],
            "liveness_ok": verdict["liveness"]["ok"],
            "lasso_mutant_self_test":
                verdict["lasso_mutant_self_test"]["found"],
            "device": verdict["device"]}


def _print_quorum_golden() -> int:
    """Re-verify and emit the certified ledger."""
    from minpaxos_tpu_torch.verify.quorum import (
        certify_grid, certify_threshold, verify_certificate)
    from minpaxos_tpu_torch.verify.quorum_golden import (
        GOLDEN_GRIDS, GOLDEN_MAX_N, GOLDEN_THRESHOLDS)

    bad = 0
    print("GOLDEN_THRESHOLDS: dict[int, tuple[tuple[int, int], ...]] = {")
    for n in range(1, GOLDEN_MAX_N + 1):
        verified = []
        for q1, q2 in GOLDEN_THRESHOLDS.get(n, ()):
            cert = certify_threshold(n, q1, q2)
            if cert.intersects and verify_certificate(cert):
                verified.append((q1, q2))
            else:
                bad += 1
                print(f"    # DROPPED (fails to prove): ({q1}, {q2})")
        print(f"    {n}: {tuple(verified)!r},")
    print("}")
    print("GOLDEN_GRIDS = (")
    for rows, cols, q1, q2 in GOLDEN_GRIDS:
        cert = certify_grid(rows, cols, q1, q2)
        if cert.intersects and verify_certificate(cert):
            print(f"    ({rows}, {cols}, {q1!r}, {q2!r}),")
        else:
            bad += 1
            print(f"    # DROPPED (fails to prove): ({rows}, {cols}, "
                  f"{q1!r}, {q2!r})")
    print(")")
    return 1 if bad else 0


def _certify(spec: str) -> int:
    from minpaxos_tpu_torch.verify.quorum import (
        certify_threshold, verify_certificate)

    try:
        n, q1, q2 = (int(x) for x in spec.split(","))
        cert = certify_threshold(n, q1, q2)
    except ValueError as e:
        print(f"bad --certify spec {spec!r}: {e}", file=sys.stderr)
        return 2
    print(json.dumps(cert.to_dict(), indent=1))
    if cert.intersects and verify_certificate(cert):
        print(f"# certified — ledger line for GOLDEN_THRESHOLDS[{n}]: "
              f"({q1}, {q2})")
        return 0
    print("# REFUTED — do NOT add to the ledger; the witness above is "
          "a split-brain schedule seed")
    return 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "paxmc", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--smoke", action="store_true",
                   help="the smoke legs: MC.json's runs, the four seeded "
                        "mutants, refinement and liveness")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card, through the kernels) "
                        "or cpu")
    p.add_argument("--protocol", default="all",
                   help="minpaxos | classic | mencius | all")
    for name in ("depth", "cmds", "drops", "dups", "reorders", "internal"):
        p.add_argument(f"--{name}", type=int, default=None)
    p.add_argument("--mutant", choices=["broken-quorum", "flex-broken",
                                        "skip-quorum2",
                                        "dueling-leaders"],
                   default=None,
                   help="seeded mutant; exit 0 iff its counterexample is "
                        "found and replays")
    p.add_argument("--q1", type=int, default=0,
                   help="flexible phase-1 quorum (0 = majority)")
    p.add_argument("--q2", type=int, default=0,
                   help="flexible phase-2 quorum (0 = majority)")
    p.add_argument("--n", type=int, default=3, help="model replicas")
    p.add_argument("--flex-certified", action="store_true",
                   help="every certified (q1, q2) pair at N=3..5 with "
                        "per-edge refinement, then the liveness legs")
    p.add_argument("--refine", action="store_true",
                   help="the refinement legs")
    p.add_argument("--liveness", action="store_true",
                   help="the liveness legs")
    p.add_argument("--spec-pair", default=None, metavar="Q1,Q2",
                   help="certified (q1,q2) pair for the flexible "
                        f"refinement/liveness legs (default "
                        f"{SPEC_PAIR[0]},{SPEC_PAIR[1]})")
    p.add_argument("--replay", default=None, metavar="CE_JSON",
                   help="replay a counterexample; exit 0 iff the "
                        "violation reproduces")
    p.add_argument("--emit-faultplan", default=None, metavar="CE_JSON",
                   help="project a counterexample onto a chaos FaultPlan "
                        "schedule (stdout; cli/chaos.py --plan-file runs "
                        "it on a live cluster)")
    p.add_argument("--json", default="",
                   help="write the full verdict to this file (never "
                        "MC.json or MC_FLEX.json)")
    p.add_argument("--certify", default=None, metavar="N,Q1,Q2",
                   help="certify one threshold quorum pair")
    p.add_argument("--print-quorum-golden", action="store_true",
                   help="emit the re-verified certified quorum ledger")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.json and Path(args.json).name in REFUSED_OUTPUTS:
        p.error(f"--json {args.json}: {Path(args.json).name} is the JAX "
                f"package's committed record; write elsewhere")
    if args.print_quorum_golden:
        return _print_quorum_golden()
    if args.certify:
        return _certify(args.certify)

    from minpaxos_tpu_torch.verify.mc import (
        PROTOCOLS,
        Explorer,
        counterexample_faultplan,
        replay_counterexample,
    )

    try:
        spec_pair = (SPEC_PAIR if args.spec_pair is None
                     else tuple(int(x) for x in args.spec_pair.split(",")))
        if len(spec_pair) != 2:
            raise ValueError("need exactly Q1,Q2")
    except ValueError as e:
        p.error(f"bad --spec-pair {args.spec_pair!r}: {e}")

    legs = Legs(args.device)

    def write(verdict):
        if args.json:
            Path(args.json).write_text(json.dumps(verdict, indent=1))

    if args.emit_faultplan:
        ce = json.loads(Path(args.emit_faultplan).read_text())
        print(json.dumps(counterexample_faultplan(ce, device=legs.device),
                         indent=1))
        return 0

    if args.replay:
        ce = json.loads(Path(args.replay).read_text())
        reproduced, report = replay_counterexample(ce, device=legs.device)
        verdict = {"reproduced": reproduced, "report": report.to_dict()}
        print(json.dumps(verdict, indent=1))
        write(verdict)
        return 0 if reproduced else 1

    def override(b):
        kw = {}
        for name, val in (("max_depth", args.depth), ("n_cmds", args.cmds),
                          ("drops", args.drops), ("dups", args.dups),
                          ("reorders", args.reorders),
                          ("internal", args.internal)):
            if val is not None:
                kw[name] = val
        from dataclasses import replace
        return replace(b, **kw) if kw else b

    if args.smoke:
        verdict = smoke(legs, spec_pair)
        line = smoke_line(verdict)
        print(f"[paxmc] verdict: {json.dumps(line)}", flush=True)
        write(verdict)
        return 0 if verdict["ok"] else 1

    if args.flex_certified:
        verdict = flex_certified(legs, spec_pair)
        print(f"[paxmc] flex-certified verdict: "
              f"{json.dumps({'ok': verdict['ok'], 'pairs': len(verdict['runs']), 'refined_edges': verdict['refined_edges']})}",
              flush=True)
        write(verdict)
        return 0 if verdict["ok"] else 1

    if args.refine or args.liveness:
        verdict, ok = {}, True
        if args.refine:
            verdict["refine"] = _run_refine(legs, spec_pair)
            ok = ok and verdict["refine"]["ok"]
        if args.liveness:
            verdict["liveness"] = _run_liveness(legs, spec_pair)
            ok = ok and verdict["liveness"]["ok"]
        verdict["ok"] = ok
        line = {"ok": ok}
        if args.refine:
            line["refined_edges"] = verdict["refine"]["edges_checked"]
        if args.liveness:
            line["liveness_legs"] = len(verdict["liveness"]["legs"])
        print(f"[paxmc] verdict: {json.dumps(line)}", flush=True)
        write(verdict)
        return 0 if ok else 1

    if args.mutant:
        if args.mutant == "dueling-leaders":
            line = _lasso_mutant_self_test(legs)
        else:
            proto = "minpaxos" if args.protocol == "all" else args.protocol
            if args.mutant == "flex-broken":
                ex = Explorer(proto, override(_flex_mutant_bounds()),
                              **FLEX_MUTANT, **legs.kw())
            elif args.mutant == "skip-quorum2":
                from minpaxos_tpu_torch.verify.refine import RefinementExplorer
                ex = RefinementExplorer(proto, override(_skip_quorum2_bounds()),
                                        mutant="skip-quorum2", **legs.kw())
            else:
                ex = Explorer(proto, override(_mutant_bounds()),
                              majority_override=1, **legs.kw())
            line = _mutant_self_test(legs, f"mutant {args.mutant}", ex,
                                     mutant=args.mutant, protocol=proto)
        ce = line.pop("counterexample")
        print(f"[paxmc] {json.dumps(line)}", flush=True)
        write(dict(line, counterexample=ce))
        return 0 if line["found"] and line["replay_reproduced"] else 1

    runs_spec = _smoke_legs()
    if args.protocol != "all":
        if args.protocol not in PROTOCOLS:
            p.error(f"unknown protocol {args.protocol!r}")
        runs_spec = [r for r in runs_spec if r[1] == args.protocol]
    if args.q1 or args.q2 or args.n != 3:
        # ad-hoc flexible run: one leg at the requested (n, q1, q2)
        runs_spec = [(f"{label}-n={args.n}-q1={args.q1}-q2={args.q2}",
                      proto, b, dict(kw, q1=args.q1, q2=args.q2,
                                     n_replicas=args.n))
                     for label, proto, b, kw in runs_spec[:1]]
    t_start = time.monotonic()
    runs, ok = [], True
    for label, proto, b, kw in runs_spec:
        b = override(b)
        print(f"[paxmc] exploring {label} (depth {b.max_depth}, "
              f"{b.n_cmds} cmds, drops {b.drops}, dups {b.dups}) ...",
              flush=True)
        ex = Explorer(proto, b, **kw, **legs.kw())
        res = legs.run(label, ex, lambda: ex.run(log=print))
        runs.append(res)
        ok = ok and res.ok and res.drained
        print(f"[paxmc]   -> {'ok' if res.ok else 'VIOLATION'} "
              f"states={res.states} transitions={res.transitions} "
              f"drained={res.drained} wall={res.wall_s:.1f}s", flush=True)
    line = {"ok": ok,
            "states": sum(r.states for r in runs),
            "transitions": sum(r.transitions for r in runs),
            "violations": sum(0 if r.ok else 1 for r in runs),
            "drained": all(r.drained for r in runs),
            "wall_s": round(time.monotonic() - t_start, 2),
            "device": str(legs.device)}
    print(f"[paxmc] verdict: {json.dumps(line)}", flush=True)
    write({"ok": ok, "runs": [r.to_dict() for r in runs],
           "wall_s": line["wall_s"], "device": line["device"],
           "leg_stats": legs.stats})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
