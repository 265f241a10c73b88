"""Benchmark client binary.

    python -m minpaxos_tpu_torch.cli.client -mport 7087 -q 1000 -check

Flag surface follows the reference client family (client.go:19-31,
clientretry.go, clientlat/clienttot/client-ol-lat — SURVEY.md section
2.4): ``-q`` requests per round, ``-r`` rounds, ``-c`` conflict
percent, ``-z`` Zipfian exponent, ``-w`` write percent, ``-check``
exactly-once validation, ``-lat`` per-request latency mode (clientlat's
one-outstanding-request probe, clientlat/client.go:134-160), ``-tot``
throughput-over-time (clienttot's 10ms buckets smoothed over 50,
clienttot/client.go:278-300), ``-ol`` open-loop paced submission with
reply-timestamp latency (client-ol-lat/client.go:153-183; ``-ns``
paces one ``-batch`` per interval).
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np


def _tot_sampler(clients, stop, counts, interval_s=0.01):
    """clienttot: sample cumulative acked every 10ms
    (clienttot/client.go:229-238). ``clients``: every connection the
    driver acks on — with -e/-f that is the MultiClient's sub-clients
    (sampling the unused single connection would print zeros)."""
    while not stop.is_set():
        counts.append((time.monotonic(),
                       sum(len(c.replies) for c in clients)))
        time.sleep(interval_s)


def _propose_retrying(cli, cmd_ids, ops, keys, vals,
                      timeout_s: float) -> bool:
    """Propose with failover retries until ``timeout_s`` elapses.

    Returns False if every attempt raised (cluster unreachable for the
    whole budget) — ``_failover()`` itself can return without a live
    connection when no replica accepts TCP, so a bare retry after it
    would crash the benchmark loop on the same OSError.
    """
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            cli.propose(cmd_ids, ops, keys, vals)
            return True
        except OSError:
            if time.monotonic() >= deadline:
                return False
            cli._failover()  # sleeps 0.5s itself when nothing accepts


def _propose_until_acked(cli, cmd_ids, ops, keys, vals,
                         timeout_s: float) -> bool:
    """Propose + wait for the ack, failing over on BOTH connection
    errors AND no-ack. A non-leader REJECTS proposals without any
    socket error (ProposeReplyTS{OK:FALSE, Leader} — the reply sets
    cli.leader_hint), so an error-only retry loop would wait out its
    whole budget measuring nothing; re-proposing with the SAME cmd_id
    through ``_failover`` (hint first) is the clientretry semantics
    the closed-loop driver already uses."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            cli.propose(cmd_ids, ops, keys, vals)
        except OSError:
            if time.monotonic() >= deadline:
                return False
            cli._failover()
            continue
        left = deadline - time.monotonic()
        if cli.wait(cmd_ids, timeout_s=max(min(1.0, left), 0.05)):
            return True
        if time.monotonic() >= deadline:
            return False
        cli._failover()  # rejected or lost: re-route via the hint


def _print_tot(counts, window=50):
    """Smoothed ops/s per 10ms bucket over a 50-bucket moving window
    (clienttot/client.go:278-300)."""
    for i in range(window, len(counts), window // 2):
        t1, c1 = counts[i]
        t0, c0 = counts[i - window]
        if t1 > t0:
            print(f"t={t1 - counts[0][0]:7.2f}s  "
                  f"{(c1 - c0) / (t1 - t0):10.0f} ops/s (smoothed)",
                  flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("minpaxos-client")
    p.add_argument("-maddr", default="127.0.0.1")
    p.add_argument("-mport", type=int, default=7087)
    p.add_argument("-q", type=int, default=1000, help="requests per round")
    p.add_argument("-r", type=int, default=1, help="rounds")
    p.add_argument("-c", type=int, default=0, help="conflict percent")
    p.add_argument("-sr", type=int, default=30000,
                   help="key range (reference clientlat -sr). Size it "
                        "below the servers' KV capacity (-kvpow2, "
                        "default 2^16): the runtime fail-stops on table "
                        "saturation rather than silently dropping "
                        "acknowledged writes")
    p.add_argument("-z", type=float, default=0.0, help="Zipfian s (0=uniform)")
    p.add_argument("-w", type=int, default=100, help="write percent")
    p.add_argument("-check", action="store_true",
                   help="verify exactly-once replies")
    p.add_argument("-batch", type=int, default=512)
    p.add_argument("-lat", action="store_true",
                   help="closed-loop per-request latency mode")
    p.add_argument("-tot", action="store_true",
                   help="throughput-over-time: 10ms buckets, 50-smoothed")
    p.add_argument("-ol", action="store_true",
                   help="open-loop: paced submission, reply-ts latency")
    p.add_argument("-ns", type=int, default=1_000_000,
                   help="open-loop pacing: ns between batches")
    p.add_argument("-e", dest="rr", action="store_true",
                   help="leaderless round-robin sends across all "
                        "replicas (reference client.go -e; the natural "
                        "Mencius driver)")
    p.add_argument("-f", dest="fast", action="store_true",
                   help="fast mode: send to ALL replicas, first reply "
                        "wins (reference client.go -f; paxos family "
                        "only)")
    p.add_argument("-barOne", dest="bar_one", action="store_true",
                   help="send to all replicas except the last "
                        "(clienttot/client.go:31; implies -e)")
    p.add_argument("-waitLess", dest="wait_less", action="store_true",
                   help="wait for all but one partition to finish "
                        "(clienttot/client.go:32; implies -e)")
    p.add_argument("-timeout", type=float, default=60.0)
    args = p.parse_args(argv)
    if args.bar_one or args.wait_less:
        if args.fast:
            p.error("-barOne/-waitLess are round-robin knobs; "
                    "they conflict with -f")
        args.rr = True  # reference: noLeader multi-target send path

    from minpaxos_tpu_torch.runtime.client import (
        Client,
        MultiClient,
        gen_workload,
    )

    multi = None
    if args.rr or args.fast:
        if args.lat or args.ol:
            p.error("-e/-f apply to the closed-loop mode only")
        multi = MultiClient((args.maddr, args.mport), check=args.check,
                            mode="rr" if args.rr else "fast",
                            bar_one=args.bar_one,
                            wait_less=args.wait_less)
    cli = Client((args.maddr, args.mport), check=args.check)

    total_acked = 0
    t_all = time.monotonic()
    for rnd in range(args.r):
        ops, keys, vals = gen_workload(
            args.q, conflict_pct=args.c, key_range=args.sr, zipf_s=args.z,
            write_pct=args.w, seed=42 + rnd)
        if args.lat:
            # clientlat mode: one outstanding request, per-op latency,
            # UNIQUE cmd_ids (a reused id would match a stale reply);
            # failover on conn loss like the closed-loop driver
            cli.connect()
            lats = []
            for i in range(args.q):
                cid = np.asarray([i])
                t0 = time.monotonic()
                if _propose_until_acked(cli, cid, ops[i:i + 1],
                                        keys[i:i + 1], vals[i:i + 1],
                                        args.timeout):
                    lats.append(time.monotonic() - t0)
                    total_acked += 1
            if lats:
                lats_ms = np.asarray(lats) * 1e3
                print(f"round {rnd}: p50 {np.percentile(lats_ms, 50):.3f} ms"
                      f"  p99 {np.percentile(lats_ms, 99):.3f} ms  "
                      f"mean {lats_ms.mean():.3f} ms", flush=True)
            else:
                print(f"round {rnd}: 0/{args.q} acked (no latency sample)",
                      flush=True)
        elif args.ol:
            # open-loop: send one -batch every -ns nanoseconds without
            # waiting; latency = reply arrival - send time per command.
            # Arrival is stamped by the client's reader thread
            # (replies[cmd]["t_arrive"]) — exact, not poll-quantized.
            cli.connect()
            send_ts: dict[int, float] = {}
            pace = args.ns / 1e9
            next_t = time.monotonic()
            for lo in range(0, args.q, args.batch):
                idx = np.arange(lo, min(lo + args.batch, args.q))
                now = time.monotonic()
                if now < next_t:
                    time.sleep(next_t - now)
                for cid in idx:
                    send_ts[int(cid)] = time.monotonic()
                # bounded failover retries: open-loop pacing must not
                # block indefinitely, but the budget tracks -timeout
                # (an election longer than a fixed 2s would drop whole
                # paced batches and skew the sample via the straggler
                # sweep's original-send_ts resends); commands lost here
                # are still re-sent by the straggler sweep below
                _propose_retrying(cli, idx, ops[idx], keys[idx],
                                  vals[idx],
                                  timeout_s=min(max(2.0, args.timeout / 4.0),
                                                args.timeout))
                next_t += pace
            # stragglers: re-send unacked through failover (the paced
            # send is fire-and-forget; a dropped conn would otherwise
            # zero the sample) — but ONLY when replies have stalled; a
            # healthy cluster still draining the backlog keeps its
            # connection (failover would discard in-flight replies and
            # re-execute). Re-sent ops keep their original send_ts —
            # honestly worse, never better.
            deadline = time.monotonic() + args.timeout
            last_done = -1
            while time.monotonic() < deadline:
                if cli.wait(np.arange(args.q), timeout_s=2.0):
                    break
                done = len(cli.replies)
                if done > last_done:
                    last_done = done
                    continue  # progress: still draining, don't thrash
                missing = np.asarray(
                    [c for c in range(args.q) if c not in cli.replies],
                    dtype=np.int64)
                if missing.size == 0:
                    break
                try:
                    cli._failover()
                    cli.propose(missing, ops[missing], keys[missing],
                                vals[missing])
                except OSError:
                    time.sleep(0.5)
            lats = [(e["t_arrive"] - send_ts[c]) * 1e6
                    for c, e in list(cli.replies.items())
                    if c in send_ts and "t_arrive" in e]
            total_acked += len(lats)
            if lats:
                lq = np.asarray(sorted(lats))
                print(f"round {rnd}: open-loop {len(lats)}/{args.q} acked, "
                      f"p50 {np.percentile(lq, 50):.0f} us  "
                      f"p99 {np.percentile(lq, 99):.0f} us  "
                      f"pace {args.ns} ns/batch", flush=True)
        else:
            counts: list = []
            stop = threading.Event()
            if args.tot:
                sampled = multi.clients if multi is not None else [cli]
                sampler = threading.Thread(
                    target=_tot_sampler, args=(sampled, stop, counts),
                    daemon=True)
                sampler.start()
            t0 = time.monotonic()
            driver = multi if multi is not None else cli
            stats = driver.run_workload(ops, keys, vals, batch=args.batch,
                                        timeout_s=args.timeout)
            wall = time.monotonic() - t0
            if args.tot:
                stop.set()
                sampler.join(timeout=1.0)
                _print_tot(counts)
            total_acked += stats["acked"]
            print(f"round {rnd}: {stats['acked']}/{args.q} acked in "
                  f"{wall:.3f}s  ({stats['ops_per_s']:.0f} ops/s)",
                  flush=True)
            if args.check:
                if stats["missing"]:
                    print(f"CHECK FAILED: didn't receive "
                          f"{stats['missing']} replies", flush=True)
                if stats["duplicates"]:
                    print(f"CHECK: {stats['duplicates']} duplicate replies",
                          flush=True)
                if not stats["missing"] and not stats["duplicates"]:
                    print("CHECK OK: exactly-once for all commands",
                          flush=True)
        # fresh cmd_id space per round
        cli.replies.clear()
        cli.rejected.clear()
        if multi is not None:
            for c in multi.clients:
                c.replies.clear()
                c.rejected.clear()
    wall_all = time.monotonic() - t_all
    print(f"total: {total_acked} acked in {wall_all:.3f}s "
          f"({total_acked / wall_all:.0f} ops/s)", flush=True)
    if multi is not None:
        multi.close()
    cli.close_conn()


if __name__ == "__main__":
    main()
