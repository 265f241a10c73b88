#!/usr/bin/env python3
"""K5 device times of several source trees on the same inputs.

    python3 k5_ab.py [--rounds 2] [--out FILE] TREE_A TREE_B [...]

This tree's ``ops/ackruns.py ack_families`` makes, from ``--seed``, the
families of ``chip_smoke.py``'s K5 compare (``K5_CASES``) at its
MinPaxos, Mencius and TCP shapes (``PATHS``) and at the server's default
window of 16,384 slots (``SERVER``), saved once as numpy files in a
temporary directory. Each run is one process started in a tree's
root (a checkout or a ``git archive`` of the repo): it builds that tree's
``ackruns`` library and, for every path and family, holds that tree's
kernels against its own plain twins and times, by CUDA-graph replay
(that tree's ``chip_smoke.graph_ms``):

- ``ack_ms``: ``compress_ack_runs``;
- ``bits_ms``: ``range_vote_bits`` alone;
- ``fused_ms``: the step's whole vote update, ``votes | bits`` (under
  the driven-slot mask on the Mencius path, as ``models/mencius.py``
  takes it): one call where the tree's ``range_vote_bits`` takes
  ``into``, else its kernel followed by the eager ``|`` (and ``where``).

The trees take turns A B ... then ... B A, ``--rounds`` times. Every run
is one JSON line (also appended to ``--out``); the last line gives each
tree's median per path, family and time. A run whose kernels disagree
with their twins exits non-zero.

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TIMES = ("ack_ms", "bits_ms", "fused_ms")
# the server's default window, as chip_smoke.py's TCP compare times it:
# batch rows, inbox rows, window, replicas, stride
SERVER = {"server": (4, 4096, 16384, 5, 1), "server_stride5": (4, 4096, 16384, 5, 5)}
COLS = ("is_acc", "src", "inst", "ok", "ballot", "valid", "vsrc", "vinst", "count", "wb",
        "into", "mask")


def make_data(out_dir: str, seed: int) -> list[str]:
    """Every (path, family) input of this tree's families as
    ``out_dir/<path>_<family>.npz``; returns the case names."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from minpaxos_tpu_torch.ops import ackruns

    shapes = {path: (sh.batch or sh.groups * sh.replicas, sh.M, sh.S, sh.replicas, sh.stride)
              for path, sh in cs.PATHS.items()}
    cases = []
    for path, (b, m, s, r, d) in {**shapes, **SERVER}.items():
        fams = ackruns.ack_families(np.random.default_rng(seed), b, m, s, r, d,
                                    names=cs.K5_CASES)
        for name, fam in fams.items():
            arrs = dict(zip(COLS, fam["runs"] + fam["votes"] + (fam["into"], fam["mask"])))
            if arrs["ballot"] is None:
                del arrs["ballot"]
            np.savez(os.path.join(out_dir, f"{path}_{name}.npz"), S=s, R=r, d=d,
                     mencius=path == "mencius", **arrs)
            cases.append(f"{path}_{name}")
    return cases


def one_run(tree: str, data: str, cases: list[str]) -> None:
    """Times ``tree``'s K5 on every case in ``data``; prints one JSON line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.ops import ackruns as A

    K.build_all(("ackruns",))
    dev = torch.device("cuda")
    fused_call = "into" in inspect.signature(A.range_vote_bits).parameters
    out, bad = {}, []
    for case in cases:
        z = np.load(os.path.join(data, case + ".npz"))
        t = {k: torch.from_numpy(z[k]).to(dev) for k in COLS if k in z}
        S, R, d = int(z["S"]), int(z["R"]), int(z["d"])
        runs = (t["is_acc"], t["src"], t["inst"], t["ok"])
        votes = (t["valid"], t["vsrc"], t["vinst"], t["count"], t["wb"])
        into, mask = t["into"], t["mask"] if bool(z["mencius"]) else None

        def ack():
            return A.compress_ack_runs(*runs, ballot=t.get("ballot"), stride=d)

        def bits():
            return A.range_vote_bits(*votes, S, R, stride=d)

        def fused():
            if fused_call:
                return A.range_vote_bits(*votes, S, R, stride=d, into=into, mask=mask)
            b = bits()
            return into | (b if mask is None else torch.where(mask, b, 0))

        plain = A.pack_vote_bits(A.range_vote_coverage(*votes, S, R, stride=d))
        want = (A._compress_plain(*runs, t.get("ballot"), d), plain,
                into | (plain if mask is None else torch.where(mask, plain, 0)))
        for fn, w in zip((ack, bits, fused), want):
            for _ in range(3):
                got = fn()
                same = (all(torch.equal(a, b) for a, b in zip(got, w))
                        if isinstance(w, tuple) else torch.equal(got, w))
                if not same:
                    bad.append(f"{case}:{fn.__name__}")
        out[case] = dict(zip(TIMES, (cs.graph_ms(fn) for fn in (ack, bits, fused))))
    print(json.dumps(dict(fused_call=fused_call, bad=sorted(set(bad)), **out)), flush=True)
    if bad:
        sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="append every JSON line here too")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds per run")
    ap.add_argument("--one", metavar="TREE", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--data", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cases", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_run(args.one, args.data, args.cases.split(","))
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
    with tempfile.TemporaryDirectory() as data:
        cases = make_data(data, args.seed)
        for i in range(args.rounds):
            for tree in (args.trees if i % 2 == 0 else args.trees[::-1]):
                t0 = time.perf_counter()
                cmd = [sys.executable, os.path.abspath(__file__), "--one", tree,
                       "--data", data, "--cases", ",".join(cases)]
                try:
                    p = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=args.timeout)
                    rc, outp, err = p.returncode, p.stdout, p.stderr
                except subprocess.TimeoutExpired as e:
                    rc, outp, err = 124, e.stdout or "", e.stderr or ""
                    outp = outp if isinstance(outp, str) else outp.decode(errors="replace")
                    err = err if isinstance(err, str) else err.decode(errors="replace")
                row = dict(tree=tree, turn=i, rc=rc, secs=time.perf_counter() - t0)
                lines = [ln for ln in outp.splitlines() if ln.startswith("{")]
                if lines:
                    row.update(json.loads(lines[-1]))
                if rc != 0:
                    row["stderr_tail"] = err.strip().splitlines()[-3:]
                runs.append(row)
                emit(row)
    summary = {}
    for tree in args.trees:
        ok = [r for r in runs if r["tree"] == tree and r["rc"] == 0]
        summary[tree] = {c: {k: statistics.median(r[c][k] for r in ok) for k in TIMES}
                         for c in cases if ok}
    emit(dict(summary=summary))
    if any(r["rc"] != 0 for r in runs):
        sys.exit(1)


if __name__ == "__main__":
    main()
