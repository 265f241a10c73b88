#!/usr/bin/env python3
"""Alternating wall-time A/B of the resident paths between source trees.

    python3 wall_ab.py --pairs 10 TREE_A TREE_B [TREE_C ...] [--out FILE]

Each run is one process started in a tree's root (a checkout or a
``git archive`` of the repo): it builds that tree's kernels, then runs
that tree's ``chip_smoke.py`` ``main_path`` (the 1M-instance sharded
MinPaxos loop) and ``mencius_path`` (the 1M-instance Mencius loop) once
each, unprofiled, and reports their host-clock ms per round. The trees
take turns A B ... then ... B A, ``--pairs`` times over, so drift on the
card falls on every tree alike. Every run is one JSON line (also
appended to ``--out``); the last line gives each tree's median and
quartiles per path. A run whose path fails its checks exits non-zero
and is reported with ``rc``; it is left out of the summary.

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

PATHS = ("minpaxos_ms", "mencius_ms")


def one_run(tree: str) -> None:
    """The resident paths of ``tree`` once each; prints one JSON line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from minpaxos_tpu_torch import kernels as K

    K.build_all()
    dev = torch.device("cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        m = cs.main_path(dev, 0, cs.DISPATCHES)
        torch.cuda.empty_cache()
        n = cs.mencius_path(dev, 0, cs.DISPATCHES)
    print(json.dumps(dict(minpaxos_ms=m["ms_per_round"], mencius_ms=n["ms_per_round"])),
          flush=True)


def quartiles(v: list[float]) -> list[float]:
    if len(v) < 2:
        return [v[0], v[0], v[0]] if v else []
    q = statistics.quantiles(v, n=4, method="inclusive")
    return [q[0], statistics.median(v), q[2]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=None, help="append every JSON line here too")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds per run")
    ap.add_argument("--one", metavar="TREE", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_run(args.one)
        return
    if len(args.trees) < 2:
        ap.error("give at least two trees")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    runs = []
    for i in range(args.pairs):
        for tree in (args.trees if i % 2 == 0 else args.trees[::-1]):
            t0 = time.perf_counter()
            try:
                p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                                   capture_output=True, text=True, timeout=args.timeout)
                rc, out, err = p.returncode, p.stdout, p.stderr
            except subprocess.TimeoutExpired as e:
                rc, out, err = 124, e.stdout or "", e.stderr or ""
                out = out if isinstance(out, str) else out.decode(errors="replace")
                err = err if isinstance(err, str) else err.decode(errors="replace")
            row = dict(tree=tree, turn=i, rc=rc, secs=time.perf_counter() - t0)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if rc == 0 and lines:
                row.update(json.loads(lines[-1]))
            else:
                row["stderr_tail"] = err.strip().splitlines()[-3:]
            runs.append(row)
            emit(row)
    summary = {}
    for tree in args.trees:
        ok = [r for r in runs if r["tree"] == tree and r["rc"] == 0 and PATHS[0] in r]
        summary[tree] = dict(runs=len(ok), failed=sum(r["tree"] == tree for r in runs) - len(ok),
                             **{f"{k}_q1_median_q3": quartiles(sorted(r[k] for r in ok))
                                for k in PATHS})
    emit(dict(summary=summary))
    if any(r["rc"] != 0 for r in runs):
        sys.exit(1)


if __name__ == "__main__":
    main()
