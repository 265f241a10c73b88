"""tail — paxtrace tail-latency attribution for a live cluster.

The port's copy of the JAX package's ``tools/tail.py``: the same flags,
output and exit codes. It pulls every replica's paxtrace span rings
through the master's ``tracespans`` fan-out, aligns the per-process
clock anchors, joins spans into per-command chains, and prints the
stage-decomposition table: p50/p90/p99/p999 per stage (client send,
transport in, drain-queue wait, proposal->commit device rounds,
exec-backlog wait, reply serialization, transport out) plus the
worst stage of the commands in the end-to-end p99 tail.

    python -m minpaxos_tpu_torch.cli.tail -mport 7087                # one table
    python -m minpaxos_tpu_torch.cli.tail -mport 7087 --once --json  # machine output
    python -m minpaxos_tpu_torch.cli.tail -mport 7087 --watch -i 2   # refresh loop
    python -m minpaxos_tpu_torch.cli.tail -mport 7087 -dump-trace t.json

``-dump-trace`` merges the cluster's flight-recorder timeline (the
``trace`` verb) with per-command span tracks (reserved pid 9998),
validates the result and writes a file that loads in Perfetto.
``-spans-file`` analyzes saved raw collections (a JSON list of
``tracespans`` payloads) instead of polling a live cluster.

It imports neither torch nor the JAX package, so it runs cold.

Exit status: 0 = ok, 1 = cluster unreachable / invalid trace / no
complete chains.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from minpaxos_tpu_torch.obs.recorder import chrome_trace, validate_chrome_trace
from minpaxos_tpu_torch.obs.trace import analyze_collections as analyze
from minpaxos_tpu_torch.obs.trace import format_stage_table, span_events
from minpaxos_tpu_torch.runtime.master import cluster_trace, cluster_tracespans


def fetch_collections(maddr) -> list[dict]:
    """Every live replica's span collection via the master fan-out."""
    resp = cluster_tracespans(maddr)
    out = []
    for r in resp.get("replicas", []):
        if r.get("ok") and isinstance(r.get("trace"), dict):
            out.append(r["trace"])
        elif not r.get("ok"):
            print(f"tail: replica {r.get('id')} unreachable "
                  f"({r.get('error')})", file=sys.stderr)
    return out


def _dump_trace(maddr, path: str, last: int | None) -> int:
    table, decomp, chains = analyze(fetch_collections(maddr))
    resp = cluster_trace(maddr, last=last)
    trace = resp.get("trace") or {}
    events = list(trace.get("traceEvents", []))
    sp = span_events(decomp, chains)
    events.extend(sp)
    merged = chrome_trace(events)
    errs = validate_chrome_trace(merged)
    if errs:
        print(f"tail: INVALID merged trace ({len(errs)} schema errors):",
              file=sys.stderr)
        for e in errs[:10]:
            print(f"  {e}", file=sys.stderr)
        return 1
    Path(path).write_text(json.dumps(merged))
    print(f"tail: wrote {len(events)} events ({len(sp)} command spans, "
          f"{table['n_traced']} traced commands) to {path} "
          f"(open in ui.perfetto.dev)")
    # a merged file with no command chain means tracing was off or the
    # rings were empty: the step fails
    return 0 if table["n_traced"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "tail", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-maddr", default="127.0.0.1", help="master address")
    p.add_argument("-mport", type=int, default=7087, help="master port")
    p.add_argument("--once", action="store_true",
                   help="one sample (the default)")
    p.add_argument("--watch", action="store_true",
                   help="refresh the table on an interval")
    p.add_argument("-i", "--interval", type=float, default=2.0,
                   help="refresh interval for --watch (seconds)")
    p.add_argument("--json", action="store_true",
                   help="emit the stage table + per-trace decomposition "
                        "as JSON instead of the text table")
    p.add_argument("-dump-trace", default="",
                   help="merge flight-recorder timeline + command-span "
                        "tracks into a validated Perfetto file and exit")
    p.add_argument("-last", type=int, default=1024,
                   help="newest recorder ticks per replica for "
                        "-dump-trace")
    p.add_argument("-spans-file", default="",
                   help="analyze saved raw span collections (a JSON "
                        "list of tracespans payloads) instead of a live "
                        "cluster")
    args = p.parse_args(argv)
    maddr = (args.maddr, args.mport)

    if args.dump_trace:
        try:
            return _dump_trace(maddr, args.dump_trace, args.last)
        except (OSError, ValueError) as e:
            print(f"tail: trace fetch failed: {e!r}", file=sys.stderr)
            return 1

    while True:
        try:
            if args.spans_file:
                payload = json.loads(Path(args.spans_file).read_text())
                colls = payload if isinstance(payload, list) else [payload]
            else:
                colls = fetch_collections(maddr)
        except (OSError, ValueError) as e:
            print(f"tail: collection failed at {maddr}: {e!r}",
                  file=sys.stderr)
            return 1
        table, decomp, _ = analyze(colls)
        if args.json:
            print(json.dumps({"stage_table": table,
                              "per_trace": decomp}), flush=True)
        else:
            if args.watch:
                print("\x1b[2J\x1b[H", end="")
            print(format_stage_table(table), flush=True)
        if not args.watch:
            return 0 if table["n_traced"] else 1
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
