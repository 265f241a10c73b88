"""paxchaos on the port: seeded fault campaigns against a port cluster.

    python -m minpaxos_tpu_torch.cli.chaos                 # all 11 schedules
    python -m minpaxos_tpu_torch.cli.chaos --smoke         # 2 fixed pairs, 60 s
    python -m minpaxos_tpu_torch.cli.chaos --smoke --device cpu
    python -m minpaxos_tpu_torch.cli.chaos --schedules isolated_leader --seeds 42
    python -m minpaxos_tpu_torch.cli.chaos --plan-file plan.json   # a paxmc replay
    python -m minpaxos_tpu_torch.cli.chaos --json out.json # the full verdict

The port's counterpart of the JAX package's ``tools/chaos.py``. Each run
boots a master and N of the port's replica servers in this process, all
stepping on ``--device`` (``cuda``, the default: the card, through the
hand-written kernels; ``cpu`` on request), drives checked load through a
seeded fault schedule, heals, and holds the quiesced stores to the
invariant checker (``chaos/campaign.py``). A failing (schedule, seed)
pair replays the identical schedule: event times, per-link decisions
and the client's backoff jitter all derive from the seed.

``--plan-file`` takes ``cli/mc.py --emit-faultplan`` output, or a raw
``paxmc-ce-v1`` counterexample (projected on the fly on ``--device``).

Exit status: 0 = every run ok, 1 = a run failed, 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

#: the smoke's schedules: one partition-heal and one loss/reorder soak,
#: each paired with one fixed seed (seed i drives schedule i)
SMOKE_SCHEDULES = ["partition_heal", "loss_reorder"]
SMOKE_SEEDS = [1009, 2003]
SMOKE_BUDGET_S = 60.0
SMOKE_OPS = 250


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "paxchaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--schedules", default="all",
                   help="comma-separated schedule names, or 'all'")
    p.add_argument("--seeds", default="1009",
                   help="comma-separated campaign seeds")
    p.add_argument("--n", type=int, default=3, help="replicas")
    p.add_argument("--ops", type=int, default=400,
                   help="sizes the closed-loop load chunks (the loader "
                        "proposes until the schedule's last fault event "
                        "has fired)")
    p.add_argument("--budget", type=float, default=0.0,
                   help="wall budget in seconds (0 = none), from the end "
                        "of the first run")
    p.add_argument("--json", default="",
                   help="also write the full verdict to this file")
    p.add_argument("--smoke", action="store_true",
                   help=f"the smoke: seeds {SMOKE_SEEDS} paired with "
                        f"schedules {SMOKE_SCHEDULES}, a "
                        f"{SMOKE_BUDGET_S:.0f} s budget")
    p.add_argument("--plan-file", default=None, metavar="FILE",
                   help="replay a paxmc counterexample's FaultPlan on a "
                        "live cluster: cli/mc.py --emit-faultplan output, "
                        "or a raw paxmc-ce-v1 trace")
    p.add_argument("--device", default="cuda",
                   help="every replica's step device: cuda (default) or "
                        "cpu")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)

    from minpaxos_tpu_torch.chaos.campaign import (
        SCHEDULES,
        run_campaign,
        run_schedule,
    )
    from minpaxos_tpu_torch.device import resolve_device

    device = str(resolve_device(args.device))

    if args.plan_file:
        doc = json.loads(Path(args.plan_file).read_text())
        if doc.get("format") == "paxmc-ce-v1":  # raw trace: project it
            from minpaxos_tpu_torch.verify.mc import counterexample_faultplan

            doc = counterexample_faultplan(doc, device=device)
        events = [tuple(e) for e in doc["events"]]
        seed = int(args.seeds.split(",")[0])
        r = run_schedule("mc_replay", seed, n=args.n, ops_n=args.ops,
                         events=events, device=device)
        line = {"ok": r["ok"], "acked": r.get("acked"),
                "faults": r.get("faults_injected"),
                "check": r.get("check", {}).get("ok"),
                "error": r.get("error"), "wall_s": r.get("wall_s")}
        print(f"[chaos] mc_replay verdict: {json.dumps(line)}", flush=True)
        if args.json:
            Path(args.json).write_text(json.dumps(r, indent=1))
        return 0 if r["ok"] else 1

    pairs = None
    if args.smoke:
        schedules, seeds = SMOKE_SCHEDULES, SMOKE_SEEDS
        pairs = list(zip(SMOKE_SEEDS, SMOKE_SCHEDULES))
        budget, ops_n = SMOKE_BUDGET_S, SMOKE_OPS
    else:
        schedules = (list(SCHEDULES) if args.schedules == "all"
                     else args.schedules.split(","))
        seeds = [int(s) for s in args.seeds.split(",")]
        budget = args.budget or None
        ops_n = args.ops
    for s in schedules:
        if s not in SCHEDULES:
            p.error(f"unknown schedule {s!r} (have: {', '.join(SCHEDULES)})")

    t0 = time.monotonic()
    verdict = run_campaign(schedules, seeds, n=args.n, ops_n=ops_n,
                           budget_s=budget, pairs=pairs, device=device)
    verdict["wall_s"] = round(time.monotonic() - t0, 2)
    verdict["device"] = device
    line = {"ok": verdict["ok"], "runs": len(verdict["runs"]),
            "failed": [
                {"schedule": r.get("schedule"), "seed": r.get("seed"),
                 "error": r.get("error"),
                 "violations": r.get("check", {}).get("violations"),
                 "stall_live": (r.get("watch") or {}).get("stall")}
                for r in verdict["runs"] if not r.get("ok")],
            "wall_s": verdict["wall_s"]}
    print(f"[chaos] verdict: {json.dumps(line)}", flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(verdict, indent=1))
        print(f"[chaos] full verdict written to {args.json}", flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
