"""Replica server binary — reference src/server/server.go flags (:19-34).

    python -m minpaxos_tpu_torch.cli.server -port 7070 -mport 7087 -min -durable
    python -m minpaxos_tpu_torch.cli.server ... -device cpu   # no card

The JAX package's server flags for everything the port carries;
``-device`` (default ``cuda``) takes the place of ``-platform``. The
server steps its replica on the card unless ``-device cpu`` is given;
without a card the default raises at boot. Protocols: ``-min``
(default), ``-classic``, ``-m`` (Mencius). On a clean stop (SIGTERM or
SIGINT) the server prints one ``server-stop`` JSON line: its kernel
launch counts after the boot warm-up (and the warm-up's own), dispatch
count, host wall per dispatch, the span between CUDA events around each
dispatch's step and packing (device work plus the device's idle gaps
while the host issues launches), and peak device memory.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("minpaxos-torch-server")
    p.add_argument("-port", type=int, default=7070, help="data port")
    p.add_argument("-addr", default="127.0.0.1", help="listen address")
    p.add_argument("-maddr", default="127.0.0.1", help="master address")
    p.add_argument("-mport", type=int, default=7087, help="master port")
    p.add_argument("-min", action="store_true", default=True,
                   help="use MinPaxos (global-ballot Multi-Paxos)")
    p.add_argument("-classic", action="store_true",
                   help="use classic per-instance Multi-Paxos (explicit "
                        "Commit/CommitShort; overrides -min)")
    p.add_argument("-m", dest="mencius", action="store_true",
                   help="use Mencius rotating-ownership consensus "
                        "(overrides -min/-classic)")
    p.add_argument("-exec", dest="exec_", action="store_true", default=True,
                   help="execute committed commands (always on — "
                        "execution drives window reclamation)")
    p.add_argument("-dreply", action="store_true", default=True,
                   help="reply after execution with the value")
    p.add_argument("-durable", action="store_true",
                   help="fsync accepted slots to the stable store")
    p.add_argument("-thrifty", action="store_true",
                   help="send accepts to a bare quorum only")
    p.add_argument("-beacon", action="store_true",
                   help="RTT beacons; thrifty prefers fastest peers")
    p.add_argument("-kvpow2", type=int, default=16,
                   help="KV table capacity = 2^kvpow2 slots; size above "
                        "the workload's distinct-key count (saturation "
                        "fail-stops the replica)")
    p.add_argument("-window", type=int, default=1 << 14,
                   help="resident log window slots")
    p.add_argument("-inbox", type=int, default=4096,
                   help="message rows per protocol tick")
    p.add_argument("-execbatch", type=int, default=0,
                   help="max slots executed per tick (0 = inbox size)")
    p.add_argument("-noopdelay", type=int, default=50,
                   help="stalled protocol ticks before recovery kicks "
                        "in (Mencius takeover sweep, MinPaxos frontier "
                        "rescan / gap no-op fill)")
    p.add_argument("-gossipticks", type=int, default=4,
                   help="frontier-gossip cadence in ticks (1 = immediate)")
    p.add_argument("-fuseticks", type=int, default=3,
                   help="fused protocol substeps per device dispatch"
                        " when the batch will need follow-up ticks;"
                        " 1 disables fusion")
    p.add_argument("-noidlefast", action="store_true",
                   help="disable the idle fast path")
    p.add_argument("-idlemaxskip", type=float, default=0.25,
                   help="idle fast path safety net: one real device"
                        " tick at least this often (seconds)")
    p.add_argument("-nopipeline", action="store_true",
                   help="disable the depth-2 pipelined tick loop")
    p.add_argument("-nocoalesce", action="store_true",
                   help="disable the event-driven ingress coalescer")
    p.add_argument("-coalesce-wait-us", type=int, default=200,
                   help="coalescer max-wait (microseconds; 0 ="
                        " dispatch immediately)")
    p.add_argument("-coalesce-rows", type=int, default=0,
                   help="coalescer max-rows (0 = half the device inbox)")
    p.add_argument("-nooverlapexec", action="store_true",
                   help="disable the exec chase (committed slots then"
                        " wait a full extra tick before executing)")
    p.add_argument("-narrow", type=int, default=0,
                   help="small-window view: run low-occupancy ticks"
                        " through a resident view of this many slots"
                        " (0 = off)")
    p.add_argument("-keyhint", type=int, default=0,
                   help="expected distinct keys in the workload (logged"
                        " against -kvpow2 capacity at startup)")
    p.add_argument("-norecorder", action="store_true",
                   help="disable the flight recorder (the per-tick ring"
                        " the control socket's trace verb serves) — for"
                        " overhead A/Bs; the metrics registry stays on")
    p.add_argument("-notrace", action="store_true",
                   help="disable paxtrace sampled per-command tracing"
                        " (the span rings the control socket's"
                        " tracespans verb serves) — for overhead A/Bs")
    p.add_argument("-tracepow2", type=int, default=4,
                   help="paxtrace sampling exponent: 1 command in 2^k"
                        " is traced (0 = every command)")
    p.add_argument("-tracering", type=int, default=4096,
                   help="paxtrace span-ring capacity per writer thread"
                        " (5 int64 fields per span)")
    p.add_argument("-recring", type=int, default=4096,
                   help="flight-recorder ring capacity in ticks (18"
                        " int64 fields per row: 4096 = 576 KiB)")
    p.add_argument("-q1", type=int, default=0,
                   help="flexible phase-1 quorum size; 0 = majority")
    p.add_argument("-q2", type=int, default=0,
                   help="flexible phase-2 quorum size; 0 = majority")
    p.add_argument("-snap-every", dest="snap_every", type=int,
                   default=8 << 20,
                   help="snapshot + truncate once the stable store grows"
                        " this many bytes past the last snapshot (0"
                        " disables the size trigger)")
    p.add_argument("-snap-interval", dest="snap_interval", type=float,
                   default=0.0,
                   help="also snapshot every this many seconds (0 = size"
                        " trigger only)")
    p.add_argument("-nosnap", action="store_true",
                   help="disable snapshots + log truncation entirely")
    p.add_argument("-storedir", default=".",
                   help="stable store directory")
    p.add_argument("-device", default="cuda",
                   help="torch device of the replica step: cuda (the"
                        " default; raises without a card) or cpu")
    p.add_argument("-cpuprofile", default="",
                   help="write a cProfile dump of the protocol thread on"
                        " stop")
    return p


def _check_quorums(n: int, q1: int, q2: int) -> None:
    """Refuse a (q1, q2) pair whose quorums need not intersect."""
    maj = n // 2 + 1
    a, b = q1 or maj, q2 or maj
    if not (1 <= a <= n and 1 <= b <= n) or a + b <= n:
        raise SystemExit(f"server: quorums q1={a}, q2={b} do not intersect "
                         f"for {n} replicas (need q1 + q2 > {n})")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import torch

    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
    from minpaxos_tpu_torch.runtime.master import (
        get_replica_list,
        register_with_master,
    )
    from minpaxos_tpu_torch.runtime.replica import ReplicaServer, RuntimeFlags
    from minpaxos_tpu_torch.utils.dlog import set_dlog_id

    maddr = (args.maddr, args.mport)
    my_id = register_with_master(maddr, args.addr, args.port)
    nodes = get_replica_list(maddr)
    set_dlog_id(f"r{my_id}")
    print(f"server: registered as replica {my_id} of {len(nodes)}",
          flush=True)

    protocol = ("mencius" if args.mencius
                else "classic" if args.classic else "minpaxos")
    cfg = MinPaxosConfig(
        n_replicas=len(nodes), window=args.window, inbox=args.inbox,
        exec_batch=args.execbatch or args.inbox, kv_pow2=args.kvpow2,
        catchup_rows=256, recovery_rows=256,
        gossip_ticks=args.gossipticks, noop_delay=args.noopdelay,
        explicit_commit=args.classic and not args.mencius,
        q1=args.q1, q2=args.q2)
    _check_quorums(cfg.n_replicas, cfg.q1, cfg.q2)
    prof = cProfile.Profile() if args.cpuprofile else None
    flags = RuntimeFlags(dreply=args.dreply,
                         durable=args.durable, thrifty=args.thrifty,
                         beacon=args.beacon, store_dir=args.storedir,
                         fuse_ticks=args.fuseticks,
                         idle_fastpath=not args.noidlefast,
                         idle_skip_max_s=args.idlemaxskip,
                         narrow_window=args.narrow,
                         pipeline=not args.nopipeline,
                         coalesce=not args.nocoalesce,
                         coalesce_wait_us=args.coalesce_wait_us,
                         coalesce_rows=args.coalesce_rows,
                         overlap_exec=not args.nooverlapexec,
                         key_hint=args.keyhint,
                         warm_variants=True,
                         recorder=not args.norecorder,
                         recorder_ring=args.recring,
                         trace=not args.notrace,
                         trace_pow2=args.tracepow2,
                         trace_ring=args.tracering,
                         snapshots=not args.nosnap,
                         snap_every_bytes=args.snap_every,
                         snap_interval_s=args.snap_interval,
                         profile=prof, device=args.device)
    server = ReplicaServer(my_id, [tuple(n) for n in nodes], cfg, flags,
                           protocol=protocol)
    server.start()
    print(f"server: replica {my_id} serving on {args.addr}:{args.port} "
          f"({protocol}, device {server.dev})", flush=True)

    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.2)
    joined = server.stop()  # joins the protocol thread
    st = server.stats
    n = max(st["dispatches"], 1)
    cuda = server.dev.type == "cuda"
    print(json.dumps({
        "server-stop": my_id, "protocol": protocol, "device": str(server.dev),
        "joined": joined, "fatal": server.fatal,
        "launches": server.serving_launches(), "warm_launches": server.warm_launches,
        "dispatches": st["dispatches"], "fused_substeps": st["fused_substeps"],
        "executed": st["executed"], "skips_deferred": st["skips_deferred"],
        "wall_ms_per_dispatch": st["dispatch_wall_us"] / 1e3 / n,
        "device_span_ms_per_dispatch": (st["device_step_us"] / 1e3 / n
                                   if cuda else None),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(server.dev)
                                 if cuda else None)}), flush=True)
    if prof is not None:
        if joined:  # else the profiler is still live on that thread
            prof.dump_stats(args.cpuprofile)
            print(f"server: profile written to {args.cpuprofile}",
                  flush=True)
        else:
            print("server: protocol thread did not join; profile NOT "
                  "written", flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
