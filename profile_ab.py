#!/usr/bin/env python3
"""Device-time A/B of the resident paths, or of K7 on the TCP path,
between source trees.

    python3 profile_ab.py [--turns 2] [--tcp] [--out FILE] [--trace-dir DIR] TREE_A TREE_B [...]

Each run is one process that takes a tree's package (a checkout or a
``git archive`` of the repo) and this tree's ``chip_smoke.py``
accounting: it builds that tree's kernels, boots the 1M-instance
MinPaxos cluster (elected) and the Mencius cluster at ``chip_smoke.py``'s
deployment shapes, runs one warm k-round dispatch of each, then traces 4
steady rounds of each with ``chip_smoke.profile_rounds``: device ms and
kernel launches per round, the port's kernels per round, and
``scatter_vote_bits_in_place`` (the kernel with the memset before it
and the eager OR after it counted, so a tree that zero-fills its delta
and ORs it into pvotes eagerly pays both). The trees take turns A B ...
then ... B A, ``--turns`` times. Every run is one JSON line (also
appended to ``--out``); the last line gives each tree's medians.

With ``--tcp`` each run measures K7 ``pack_outputs`` instead, by
``chip_smoke.compare_pack`` at one TCP server's shape (device ms by
graph replay, host-issued ms, the launch floor, and the B = 1,280 forms
where the tree has ``ops/substeps.py pack_cases``), then one server
dispatch by ``chip_smoke.dispatch_profile``: K7 in place, device ms,
kernel launches and the profiled wall per dispatch.

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the per-path numbers of a run summarised per tree (medians)
KEYS = {path: ("device_ms_per_round", "kernel_launches_per_round", "svb_in_place_ms")
        for path in ("minpaxos", "mencius")}
TCP_KEYS = {"tcp": ("ms", "host_ms", "floor_ms", "pack_in_place_ms", "dispatch_device_ms",
                    "dispatch_kernel_launches", "dispatch_wall_ms_profiled")}


def _load(tree: str):
    """This tree's ``chip_smoke.py`` as a module, with ``tree``'s package
    on the path and its kernels built."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from minpaxos_tpu_torch import kernels as K

    assert K.__file__.startswith(tree), K.__file__
    K.build_all()
    return cs


def one_tcp_run(tree: str) -> None:
    """K7 of ``tree``'s package at one TCP server's shape and in place in
    one server dispatch, by this tree's ``chip_smoke.py``; prints one
    JSON line."""
    cs = _load(tree)
    import torch

    dev = torch.device("cuda")
    row, errs, probe = cs.compare_pack(dev, 0)
    del errs["_calls"]
    torch.cuda.empty_cache()
    busy = cs.dispatch_profile(*probe)
    pack = busy["own_kernels_per_dispatch"].get("mp_pack_k", {})
    tcp = dict(row, **errs, pack_in_place_ms=pack.get("ms"),
               pack_launches_per_dispatch=pack.get("launches"),
               **{k: busy[k] for k in ("dispatch_device_ms", "dispatch_kernel_launches",
                                       "dispatch_wall_ms_profiled")})
    print(json.dumps(dict(tcp=tcp, card=cs.nvidia_smi_line())), flush=True)


def one_run(tree: str, trace_dir: str) -> None:
    """The two resident paths of ``tree``'s package, profiled by this
    tree's ``chip_smoke.py``; prints one JSON line."""
    cs = _load(tree)
    import torch

    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
    from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

    dev = torch.device("cuda")
    out = {}
    for path in ("minpaxos", "mencius"):
        if path == "minpaxos":
            cfg = MinPaxosConfig(n_replicas=cs.R, window=cs.W, inbox=cs.INBOX,
                                 exec_batch=cs.P, kv_pow2=cs.KV_POW2,
                                 catchup_rows=cs.CU_ROWS, recovery_rows=cs.REC_ROWS)
            sc = ShardedCluster(cfg, cs.G, ext_rows=cs.EXT, key_space=cs.KEY_SPACE,
                                seed=0, device=dev)
            sc.elect(0)
            p = cs.P
        else:
            cfg = MinPaxosConfig(n_replicas=cs.R, window=cs.W, inbox=cs.M_INBOX,
                                 exec_batch=cs.M_E, kv_pow2=cs.M_KV_POW2,
                                 catchup_rows=cs.M_CU, recovery_rows=cs.M_REC,
                                 noop_delay=cs.M_NOOP)
            sc = ShardedCluster(cfg, cs.G, ext_rows=cs.M_EXT, key_space=cs.M_KEY_SPACE,
                                seed=0, device=dev, protocol="mencius")
            p = cs.M_P
        sc.begin_resident()
        sc.run_resident(cs.K_ROUNDS, p)  # warm: windows and allocator in use
        sc.end_resident()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = cs.profile_rounds(sc, 4, p, trace_dir, path)
        out[path] = dict(
            device_ms_per_round=rec["device_ms_per_round"],
            kernel_launches_per_round=rec["kernel_launches_per_round"],
            wall_ms_per_round=rec["wall_ms_per_round"],
            svb_in_place_ms=rec["scatter_vote_bits_in_place"]["total_ms"],
            scatter_vote_bits_in_place=rec["scatter_vote_bits_in_place"],
            own_kernels_per_round=rec["own_kernels_per_round"])
        del sc
        torch.cuda.empty_cache()
    print(json.dumps(dict(out, card=cs.nvidia_smi_line())), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--tcp", action="store_true",
                    help="measure K7 at the TCP shape and one server dispatch instead")
    ap.add_argument("--out", default=None, help="append every JSON line here too")
    ap.add_argument("--trace-dir", default=None,
                    help="keep each run's traces here (default: a temporary directory)")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per run")
    ap.add_argument("--one", metavar="TREE", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--one-trace", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        if args.tcp:
            one_tcp_run(args.one)
        else:
            one_run(args.one, args.one_trace)
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
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.turns):
            for j, tree in enumerate(args.trees if i % 2 == 0 else args.trees[::-1]):
                trace = os.path.abspath(os.path.join(args.trace_dir or tmp, f"run{i}_{j}"))
                t0 = time.perf_counter()
                try:
                    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                                        "--one-trace", trace] + ["--tcp"] * args.tcp,
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
                    row["stderr_tail"] = err.strip().splitlines()[-5:]
                runs.append(row)
                emit(row)
    keys = TCP_KEYS if args.tcp else KEYS
    summary = {}
    for tree in args.trees:
        ok = [r for r in runs if r["tree"] == tree and r["rc"] == 0 and next(iter(keys)) in r]
        summary[tree] = dict(runs=len(ok), **{
            f"{path}_{k}_median": statistics.median(r[path][k] for r in ok) if ok else None
            for path, names in keys.items() for k in names})
    emit(dict(summary=summary))
    if any(r["rc"] != 0 for r in runs):
        sys.exit(1)


if __name__ == "__main__":
    main()
