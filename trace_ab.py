#!/usr/bin/env python3
"""Alternating A/B of the TCP deployment with the flight recorder and
paxtrace at their defaults against servers started -notrace -norecorder.

    python3 trace_ab.py [--pairs 4] [--ops 20000] [--out FILE]

Each run boots a master and three durable MinPaxos replica servers at
``chip_smoke.py``'s TCP shape (``TcpCluster``; one process a server, on
this card), warms them up and drives ``--ops`` checked PUTs closed loop
from one client, as the ``tcp`` phase's first leg does (``tcp_serve``;
the same ``gen_workload`` seed 42), then stops them. The two sides take
turns A B B A ..., ``--pairs`` times over, so drift on the card and host
falls on both alike. Every run is one JSON line (also appended to
``--out``): ops/s, client p50 / p99 ms and the servers' host wall per
dispatch; the last line gives each side's median and quartiles. A run
that loses or duplicates a PUT exits non-zero.

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import sys

SIDES = {"defaults": ["-min"], "notrace_norecorder": ["-min", "-notrace", "-norecorder"]}
METRICS = ("ops_per_s", "p50_latency_ms", "p99_latency_ms", "wall_ms_per_dispatch")


def one_run(side: str, ops: int) -> dict:
    import chip_smoke as cs

    cl = cs.TcpCluster(f"ab_{side}", SIDES[side], cs.TCP_LIMIT_S)
    try:
        wl = cs.tcp_workload((ops, 42))
        with contextlib.redirect_stdout(io.StringIO()):
            cli, _, rec = cs.tcp_serve(cl, wl, ops)
        cli.close_conn()
        stops = cs.stop_all(cl)
    finally:
        cl.close()
    lead = stops[cl.name[rec["leader"]]] or {}
    return dict(side=side, ops=ops, acked=rec["acked"], duplicates=rec["duplicates"],
                ops_per_s=rec["ops_per_s"], p50_latency_ms=rec["p50_latency_ms"],
                p99_latency_ms=rec["p99_latency_ms"],
                wall_ms_per_dispatch=lead.get("wall_ms_per_dispatch"), boot_s=rec["boot_s"])


def quartiles(v: list[float]) -> list[float]:
    if len(v) < 2:
        return [v[0], v[0], v[0]] if v else []
    q = statistics.quantiles(v, n=4, method="inclusive")
    return [q[0], statistics.median(v), q[2]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--ops", type=int, default=20000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from minpaxos_tpu_torch import kernels as K

    if not torch.cuda.is_available():
        sys.exit("trace_ab: no CUDA device")
    K.build_all()
    order = []
    for i in range(args.pairs):
        order += list(SIDES) if i % 2 == 0 else list(SIDES)[::-1]
    runs = []
    for side in order:
        r = one_run(side, args.ops)
        runs.append(r)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if r["acked"] != args.ops or r["duplicates"]:
            sys.exit(f"trace_ab: {side} run acked {r['acked']} of {args.ops}, "
                     f"{r['duplicates']} duplicates")
    print(json.dumps({side: {m: quartiles([r[m] for r in runs if r["side"] == side
                                           and r[m] is not None]) for m in METRICS}
                      for side in SIDES}), flush=True)


if __name__ == "__main__":
    main()
