#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, each printing one JSON line:

1. env      — the card (nvidia-smi name and power limit), torch/CUDA
              versions, and the kernels' build from kernels/csrc.
2. compare  — every hand-written kernel against its plain PyTorch twin
              on the card, at the shapes of each path below (MinPaxos,
              Mencius, then one TCP replica server: B = 1, 2^18-way KV
              table, K7 on the leader's outputs of a live exchange, one
              Mencius TCP server (tcp_mencius, below), then
              one server of the chaos campaign's cluster (chaos: B = 1,
              S = 1,024, inbox 1,024, E = 512, 2^12 ways, K7 on the
              leader's outputs of a live exchange at that config), then
              the model checker's step: S=8, a one-row inbox, exec 4,
              2^3 KV ways, R=3, MinPaxos and Mencius forms, at its
              chunk of 8,192 rows and at a small odd B), on
              seeded inputs; integer results, compared for equality
              (on repeated launches where named, so a race shows).
              K4 lookup on three cases: random (tables a quarter
              full, half the queries present, rows unsorted), and two
              families of ops/kvstore.py lookup_families: all_miss and
              last_way (every key in bucket 2's last way); kv_segments
              (the KV apply's segments, one launch) on four families of
              ops/scan.py segment_families, each timed, and the same
              function as the apply composed it before (eager segment
              starts and flips around three seg_scan_max launches) as
              unfused_ms; seg_scan_max stands alone (no path launches it).
              K3 advance_frontier (the steps' frontier update in one
              launch: operand, start, scan and max) on five families of
              ops/scan.py frontier_families (a round's run then a gap,
              the headline), in the COMMITTED form and the EXECUTED form
              with executed, each timed beside unfused_ms (the eager
              operand and start around a commit_frontier launch, then
              the eager max); commit_frontier stands alone (no path
              launches it since the fusion). K5 scatter_vote_bits fused
              with the OR into pvotes on the four families of
              ops/ackruns.py pvote_families (no valid row, the steady
              state, the headline), each timed beside unfused_ms (the
              form without into, then the eager OR); the form without
              into stands alone as scatter_vote_bits_alone.
              K1, K3, K4 lookup, K5 and K6 on 11 launches each.
              K5 ack_runs and vote_bits (fused with the OR into the
              votes table as the steps call it, under the driven-slot
              mask on the Mencius path, and alone) run on three input
              families of ops/ackruns.py ack_families (random, the
              headline row; leader_only, the main path's; one_long_run),
              each timed, the eager OR's time beside the fused call's.
              K7 at the TCP shape beside floor_ms (a one-element
              zero_() in a graph: the least a launch takes), then at a
              batch of 1,280 replicas on ops/substeps.py pack_cases (both
              anchor forms, timed beside their bytes bound, and the
              Mencius edge rows), then over 10 rounds of all these
              launches in turns, its layout cache emptied before every
              other round. Besides: K4 insert on
              2^18-way tables 90% full, K4 insert at each path's shapes
              on keys that share their first candidate bucket in groups
              of 2, 4 and 6 (the phase fails if no block contended, or
              no bucket overflowed into pass B), K5 vote bits (fused)
              with five replicas at the server's default window of
              16,384 slots, timed, K6 at the server's default window of 16,384
              slots, and K6 on windows with no NONE slot (every
              committed slot above the frontier a candidate) and with
              every slot one key, at the Mencius shape and at 16,384
              slots, each timed. K8
              (the round's PROPOSE rows: a round where cmd_id wraps, a
              hot-key batch, the numpy twin too), K9 (chains of 20
              rounds of ops/resident.py k9_families: random latencies,
              one bin as in place, edge cursors; each round's close
              opening the next round, ring armed with a drain sub-step's
              open, and off; held to the twins after every round; the
              fused close timed beside unfused_ms, a close then a
              round_open, and the close alone) and K10
              (slot_write in modes A and B, gather_rows in every form,
              on adversarial inboxes) at each path's shapes.
              Device times of kernel, plain version and, where one
              PyTorch call computes the same function, that call: each
              captured N times in one CUDA graph and replayed between
              two CUDA events. The kernel's host-issued time (eager
              calls back to back) is kept beside it as host_ms.
3. golden   — the port's Cluster and MenciusCluster on the card
              reproduce every per-step state digest of the JAX
              package's golden fixture (tests/fixtures/kernel_golden.json)
              for minpaxos, classic and mencius.
4. mc       — the model checker (minpaxos_tpu_torch/verify, the legs of
              ``python -m minpaxos_tpu_torch.cli.mc --smoke`` and
              ``--flex-certified``) on the card: every BFS layer's
              stepping actions as batched calls of the port's step
              (S=8, one-row inboxes, exec 4, 2^3 KV ways, B from 1 to
              8,192 rows), through the hand-written kernels. Held to
              every count field of MC.json and MC_FLEX.json (read, never
              written), to the JAX explorer's state digests
              (tests/fixtures/paxmc_state_digests.json), the four seeded
              mutants found and replayed, the four committed
              counterexamples (tests/fixtures/mc_*.json) replayed to their
              violations; every kernel each protocol's step launches must
              launch in its legs; per leg the wall, its part in step
              calls (step_s), transitions/s, step calls, largest batch
              and peak memory; a limit of its own
              (MC_LIMIT_S).
5. mainpath — ShardedCluster at the 1M-instance deployment (G=256
              groups x R=5 replicas x W=4096 slots, p=512 proposals per
              round per group, k=32 rounds per dispatch), with the
              telemetry ring armed as bench.py arms it: elect, run the
              measured dispatches, drain, then check the ring (a row
              per round run, committed_delta and injected_rows summing
              to the run's counts, in_flight 0 at the end), committed ==
              injected, the latency histogram's count, replica
              agreement, and every acknowledged write of every group
              read back, with its last value, from all five replicas'
              KV tables against a host replay of the Threefry workload.
              Launch counts of each kernel over the run show the path
              went through the kernels; K9 must launch k + 1 times per
              k-round dispatch (k9_launches_per_dispatch). Then the K4
              lookup compare's "path" case on the run's own tables: per
              table, keys drawn from its LIVE keys with a few misses,
              sorted by key, valid
              where no earlier row has the key, as the apply asks; it
              is the kernels line's kv_lookup row (the random case
              keeps its hits in each table's first ways, which stay in
              L2, so it is no reading against device memory).
6. mencius  — ShardedCluster(protocol="mencius") at the Mencius
              deployment (bench.py mencius_64k per group, G=256 groups x
              5 owners x W=4096, p=64 proposals per owner per round, to
              every owner, k=32 rounds per dispatch): the same checks,
              plus that every owner proposed exactly p rows in every
              round (its crt_own), so slot order equals round order for
              the read-back's replay; counts set to 0 just before it.
7. variants — at the MinPaxos widths cut to 16 groups: the resident
              loop with substeps=2 drains with committed == injected,
              and run_fused from the same seed gives the resident loop's
              commit stream (per-round cursors against the ring's rows)
              and its final state.
8. tcp      — the TCP serving deployment, BASELINE config 1 at the shape
              bench_tcp.py runs: a master and three durable MinPaxos
              replica servers (-window 2048 -inbox 1024 -kvpow2 18
              -execbatch 128), each its own process and CUDA context on
              this card, 20,000 checked PUTs closed loop (batch 512) from
              this process, then a follower stopped, 2,000 more PUTs,
              the follower revived from its stable store until it
              catches up; every written key read back through READ
              frames; the three stable stores' committed prefixes held
              against each other; ops/s, client p50/p99, wall and device
              ms per dispatch, peak memory and kernel launches of every
              server (printed by each server on stop). Between the
              revive and the read-back, the leader leg: 4,000 checked
              PUTs from a client thread, the leader's process SIGKILLed
              a quarter in, every PUT acked exactly once through the
              master's promotion and the client's failover (failover_s:
              the kill to the first ack the new leader served; the new
              leader and its elections), the old leader revived from its
              store as the kill left it until it reaches the new
              leader's frontier; the stores then also pass the port's
              check_cluster. Before it, the
              dispatch_profile line: one server dispatch at this shape
              (the step and K7 on the leader's inbox from the compare
              phase's exchange) under torch.profiler in this process —
              device busy ms and kernel launches per dispatch.
9. tcp_mencius — bench_tcp.py's mencius_tcp_3rep_durable: three
              -m -durable servers at the tcp shape, the round-robin
              MultiClient with -check; 10,000 PUTs (ops/s, p50/p99), an
              owner SIGKILLed and 2,000 more PUTs through the takeover
              of its slots, the owner revived until it heals to the
              cluster's frontier (heal_s), every key so far read back,
              the replica a single client proposes to SIGKILLed under
              1,000 PUTs, every PUT acked exactly once; the stores held as in
              tcp; every server's stop line must show every kernel of
              KERNELS["tcp_mencius"] (K2-K7 with K6 and K7's Mencius
              form, K10 gather_rows). The compare line tcp_mencius holds
              those kernels to their twins at that server's shape (B = 1,
              S = 2,048, inbox 1,024, E = 128, 2^18 ways, stride 3; K7 on
              the outputs of a live three-owner exchange).
10. chaos   — seeded fault campaigns (minpaxos_tpu_torch/chaos, the
              port of the JAX package's paxchaos) against a master and
              three in-process MinPaxos replica servers stepping on this
              card at the campaign's config (W = 1,024, inbox 1,024, exec
              512, 2^12 ways, 64 catch-up and recovery rows): the smoke's
              pairs (partition_heal seed 1009, loss_reorder seed 2003),
              isolated_leader seed 42, and the broken-quorum
              counterexample's fault plan (tests/fixtures/
              mc_broken_quorum_minpaxos.json through verify/mc.py
              counterexample_faultplan) replayed. Each run: checked load
              through the schedule's faults (blocked, dropped, delayed,
              duplicated, reordered peer frames), the live health
              watcher's stall verdict, the heal, resumed commits,
              convergence, and check_cluster over the quiesced stores;
              one chaos_run line each (ok, acked/expected, faults, the
              stall verdict, check, the journals' event kinds, wall).
              The phase line carries every kernel's launches over the
              runs; any run not ok, a kernel of KERNELS["chaos"] never
              launched, or the phase over CHAOS_LIMIT_S fails it.

With --profile DIR, 4 steady rounds of each resident path after its run
are traced with torch.profiler into DIR (profile lines: device ms and
launches per round, the port's kernels per round). The profile lines and
dispatch_profile carry scatter_vote_bits_in_place: the kernel with a
memset launched just before it and an int32 OR just after it counted
(what the form before the fusion paid; profile_ab.py reads a parent
tree's rounds with this script's accounting).

Then the contract lines: the kernels table, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failed phase
exits non-zero. Without a card the script fails before any phase.

"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the 1M-instance deployment (the JAX bench's TPU headline shape)
G, R, W, P, K_ROUNDS = 256, 5, 4096, 512, 32
CU_ROWS, REC_ROWS, KV_POW2, KEY_SPACE = 512, 64, 15, 16384
INBOX = P + 2 * CU_ROWS + 64 + 64  # 1664
EXT = 512
# the Mencius deployment: bench.py mencius_64k per group (5 rotating
# owners, W=4096, inbox 2048, exec 320, kv 2^14, catch-up 128, recovery
# 64, no-op delay 8, ext = p = 64, key space half the KV capacity),
# G raised from 16 to 256 for the same 1,048,576 concurrent instances
M_P, M_INBOX, M_EXT, M_E = 64, 2048, 64, 320
M_CU, M_REC, M_NOOP, M_KV_POW2, M_KEY_SPACE = 128, 64, 8, 14, 8192
DISPATCHES = 4  # measured k-round dispatches; the rate skips the first
MAX_DRAIN = 12  # drain dispatches a resident run may take
VG, V_DISPATCHES = 16, 2  # the variants phase: groups, loaded dispatches
K9_ROUNDS = 20  # K9's compare chains: rounds, each held to the twin
# the TCP deployment: BASELINE config 1 at the shape bench_tcp.py:56 runs
# (master + 3 durable MinPaxos replica servers, one process each),
# gen_workload(20000, seed=42) PUTs closed loop in batches of 512 with
# -check, then a follower stop / 2,000 PUTs / revive leg; the server
# CLI's catch-up and recovery rows (256) and its other defaults
TCP_N, TCP_W, TCP_INBOX, TCP_E, TCP_KV_POW2 = 3, 2048, 1024, 128, 18
TCP_CU = TCP_REC = 256
TCP_OPS, TCP_EXTRA, TCP_BATCH = 20000, 2000, 512
TCP_FAIL = 4000  # the leader leg's PUTs (the leader killed a quarter in)
TCP_SHAPE = ["-window", str(TCP_W), "-inbox", str(TCP_INBOX),
             "-kvpow2", str(TCP_KV_POW2), "-execbatch", str(TCP_E)]
TCP_LIMIT_S = 420.0  # the phase's own time limit
# the Mencius TCP deployment: bench_tcp.py's mencius_tcp_3rep_durable
# (3 servers -m -durable at TCP_SHAPE, the round-robin MultiClient):
# PUTs, then the owner leg's, then the proposer leg's; its own limit
TCP_M_OPS, TCP_M_EXTRA, TCP_M_FAIL = 10000, 2000, 1000
TCP_M_LIMIT_S = 480.0
WARM = 300  # each TCP leg's warm-up PUTs (cmd_ids 0..299)
MC_LIMIT_S = 180.0  # the mc phase's own time limit
# the chaos phase: the campaign cluster (chaos/campaign.py
# campaign_config: 3 replicas, W=1024, inbox 1024, exec 512, 2^12 KV
# ways, 64 catch-up and 64 recovery rows; three in-process servers on
# this card), the smoke's (seed, schedule) pairs, the reference
# partition-the-leader run, and the broken-quorum counterexample's
# fault plan replayed; its own limit
CH_N, CH_W, CH_INBOX, CH_E, CH_KV_POW2, CH_CU, CH_REC = 3, 1024, 1024, 512, 12, 64, 64
CHAOS_PAIRS = [(1009, "partition_heal"), (2003, "loss_reorder"), (42, "isolated_leader")]
CHAOS_OPS = 250  # the smoke's load size (cli/chaos.py SMOKE_OPS)
CHAOS_REPLAY = ("mc_broken_quorum_minpaxos.json", 1009)
CHAOS_LIMIT_S = 120.0
# the mc phase: the kernels each protocol's step launches at the model
# checker's shapes (S=8, a one-row inbox, exec 4, 2^3 KV ways)
MC_KERNELS = {
    "minpaxos": ("scatter_max", "kv_segments", "advance_frontier", "kv_lookup",
                 "kv_insert", "ack_runs", "vote_bits", "scatter_vote_bits",
                 "slot_write"),
    "mencius": ("scatter_max", "kv_segments", "advance_frontier", "kv_lookup",
                "kv_insert", "ack_runs", "vote_bits", "scatter_vote_bits",
                "exec_select", "gather_rows"),
}
MC_KERNELS["classic"] = MC_KERNELS["minpaxos"]
MC_R, MC_S, MC_E, MC_KV_POW2 = 3, 8, 4, 3  # verify/mc.py model_config
MC_CHUNK = 8192  # the explorer's largest step call (verify/mc.py CHUNK)
# the count fields of MC.json and MC_FLEX.json the mc phase holds the
# port's verdicts to (walls are not compared)
MC_COUNT_FIELDS = ("states", "transitions", "max_depth_seen", "drained", "ok",
                   "edges_checked", "refined_edges", "abstract_actions", "spec_q1",
                   "spec_q2", "sccs", "cyclic_sccs", "goal_states", "deadlocks",
                   "fair_lassos", "trace_len", "loop_start", "found",
                   "replay_reproduced")


class Shapes(NamedTuple):
    """One path's kernel shapes: B = groups x replicas rows (``batch``
    when set), S window slots, M inbox rows, E exec rows, C = 2^kv_pow2
    KV ways, m_out outbox rows per replica, cap inbox capacity, stride of
    the range acks; ``protocol`` picks the step's forms (Mencius: the
    driven-slot mask, K6), ``routed`` the resident loop's kernels (K1,
    K8, K9)."""

    path: str
    groups: int
    replicas: int
    S: int
    M: int
    E: int
    kv_pow2: int
    m_out: int
    cap: int
    stride: int
    batch: int = 0
    protocol: str = "minpaxos"
    routed: bool = True


PATHS = {
    "minpaxos": Shapes("minpaxos", G, R, W, INBOX + EXT, P, KV_POW2,
                       INBOX + EXT + REC_ROWS + 1 + 2 * CU_ROWS, INBOX, 1),
    "mencius": Shapes("mencius", G, R, W, M_INBOX + M_EXT, M_E, M_KV_POW2,
                      M_INBOX + M_EXT + 1 + 3 * M_CU + 3 * M_REC, M_INBOX, R,
                      protocol="mencius"),
    # one replica server of the TCP deployment (B = 1 of 3 replicas)
    "tcp": Shapes("tcp", 1, TCP_N, TCP_W, TCP_INBOX, TCP_E, TCP_KV_POW2,
                  TCP_INBOX + TCP_REC + 1 + 2 * TCP_CU, TCP_INBOX, 1, batch=1,
                  routed=False),
    # one Mencius replica server of the Mencius TCP deployment: its
    # outbox is the inbox, the SKIP row, three catch-up and three
    # recovery sections (models/mencius.py step 10)
    "tcp_mencius": Shapes("tcp_mencius", 1, TCP_N, TCP_W, TCP_INBOX, TCP_E, TCP_KV_POW2,
                          TCP_INBOX + 1 + 3 * TCP_CU + 3 * TCP_REC, TCP_INBOX, TCP_N,
                          batch=1, protocol="mencius", routed=False),
    # one replica server of the chaos campaign's cluster (the chaos
    # phase; its outbox by the tcp entry's formula)
    "chaos": Shapes("chaos", 1, CH_N, CH_W, CH_INBOX, CH_E, CH_KV_POW2,
                    CH_INBOX + CH_REC + 1 + 2 * CH_CU, CH_INBOX, 1, batch=1,
                    routed=False),
    # the model checker's step (the mc phase): one-row inboxes, its
    # largest chunk and a small odd batch, each protocol's forms
    "mc": Shapes("mc", 1, MC_R, MC_S, 1, MC_E, MC_KV_POW2, 1, 1, 1,
                 batch=MC_CHUNK, routed=False),
    "mc_b7": Shapes("mc_b7", 1, MC_R, MC_S, 1, MC_E, MC_KV_POW2, 1, 1, 1,
                    batch=7, routed=False),
    "mc_mencius": Shapes("mc_mencius", 1, MC_R, MC_S, 1, MC_E, MC_KV_POW2, 1, 1,
                         MC_R, batch=MC_CHUNK, protocol="mencius", routed=False),
    "mc_mencius_b5": Shapes("mc_mencius_b5", 1, MC_R, MC_S, 1, MC_E, MC_KV_POW2, 1,
                            1, MC_R, batch=5, protocol="mencius", routed=False),
}
# the kernels each path launches, as registered in minpaxos_tpu_torch.kernels
KERNELS = {
    "minpaxos": ("route", "scatter_max", "kv_segments", "advance_frontier",
                 "kv_lookup", "kv_insert", "ack_runs", "vote_bits",
                 "scatter_vote_bits", "propose_rows", "round_open",
                 "round_close", "slot_write"),
    "mencius": ("route", "scatter_max", "kv_segments", "advance_frontier",
                "kv_lookup", "kv_insert", "ack_runs", "vote_bits",
                "scatter_vote_bits", "exec_select", "propose_rows",
                "round_open", "round_close", "gather_rows"),
    # every replica server's step and packing (no routing: the
    # transport delivers the rows)
    "tcp": ("scatter_max", "kv_segments", "advance_frontier", "kv_lookup",
            "kv_insert", "ack_runs", "vote_bits", "scatter_vote_bits",
            "pack_outputs", "slot_write"),
    # every Mencius replica server's step (K6, K10 gather_rows, no
    # slot_write) and packing (K7's Mencius form)
    "tcp_mencius": ("scatter_max", "kv_segments", "advance_frontier", "kv_lookup",
                    "kv_insert", "ack_runs", "vote_bits", "scatter_vote_bits",
                    "exec_select", "gather_rows", "pack_outputs"),
    # the chaos campaign's in-process MinPaxos servers: the tcp set
    "chaos": ("scatter_max", "kv_segments", "advance_frontier", "kv_lookup",
              "kv_insert", "ack_runs", "vote_bits", "scatter_vote_bits",
              "pack_outputs", "slot_write"),
}
# K5's compare families (ops/ackruns.py ack_families); the first is the
# headline row of the kernels line
K5_CASES = ("random", "leader_only", "one_long_run")
# K4 lookup's compare families besides the headline's random tables
# (ops/kvstore.py lookup_families); the resident run's own tables add
# the "path" case after the mainpath phase
K4_LOOKUP_CASES = ("all_miss", "last_way")
# kv_segments' compare families (ops/scan.py segment_families); the
# first, the apply's own sorted rows, is the headline
SEG_CASES = ("apply_sorted", "distinct", "one_key", "put_get_delete_runs")
# the fused pvotes scatter's compare families (ops/ackruns.py
# pvote_families); the first, the steady state (no valid row), is the
# headline
PVOTE_CASES = ("no_valid", "random", "prepare", "edges")
# advance_frontier's compare families (ops/scan.py frontier_families);
# the first, a round's run of done slots then a gap, is the headline
FRONTIER_CASES = ("path", "gap_at_start", "no_gap", "unaligned_start", "executed")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
# the published non-tensor-core rate (float32, 67 TFLOP/s); the kernels'
# integer ALU work runs at most this fast, so ops / this is a lower bound
ALU_OPS_PER_S = 67e12


EMPTY_GRAPHS: list[str] = []  # timed calls whose CUDA graph captured nothing


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    print(f"chip_smoke: phase {phase} FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-issued ms per call: ``iters`` eager calls back to back
    between two CUDA events, after warmup (launch overhead included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int = 20, reset=None) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed between two CUDA events, so the host's launch cost is not
    counted. ``reset`` runs outside the graph before the timed replay,
    to restore what the calls update in place."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    if any("Graph is empty" in str(w.message) for w in caught):
        # nothing was launched on the capture stream: no time to report
        # (the compare phase fails on any such call)
        EMPTY_GRAPHS.append(getattr(fn, "__qualname__", str(fn)))
        return None
    graph.replay()
    if reset is not None:
        reset()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


def times(fn_k, fn_p, fn_lib=None, iters: int = 20, plain_iters: int = 5,
          reset=None) -> dict:
    """Device ms of kernel, plain twin and library call, plus the
    kernel's host-issued ms."""
    return dict(ms=graph_ms(fn_k, iters, reset),
                host_ms=cuda_ms(fn_k, iters),
                plain_ms=graph_ms(fn_p, plain_iters),
                library_ms=graph_ms(fn_lib, iters) if fn_lib else None)


def max_abs_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        return float("inf")
    if a.dtype == torch.bool:
        return float((a != b).sum().item() > 0)
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0.0


# ---------------------------------------------------------------- phase 2

def repeat_err(fn_k, want, n: int = 10) -> float:
    """The largest difference from ``want`` over ``n`` more launches of a
    kernel: a race between its threads shows as a launch that differs."""
    return max(max_abs_err(fn_k(), want) for _ in range(n))


def claim_contention(kv, k_hi, k_lo, delete, valid) -> dict:
    """How much the claim logic of an insert has to resolve: the rows to
    place whose pass-A bucket (the emptier candidate) another such row
    of the same table shares, and the pass-A buckets with more
    contenders than free ways, whose overflow goes to pass B."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    b, c = kv.slot.shape
    pos = kvs._cand_pos(c, k_hi, k_lo)
    s, th, tl = kvs._probe(kv, pos)
    match = ((s == kvs.LIVE) & (th == k_hi[..., None]) & (tl == k_lo[..., None])).any(-1)
    f1 = (s[..., :kvs.WAYS] == kvs.EMPTY).sum(-1)
    f2 = (s[..., kvs.WAYS:] == kvs.EMPTY).sum(-1)
    bkt = torch.where(f2 > f1, pos[..., kvs.WAYS], pos[..., 0]) // kvs.WAYS
    place = valid & ~match & ~delete
    rows = torch.arange(b, device=bkt.device)[:, None]
    key = torch.where(place, rows * (c // kvs.WAYS) + bkt, -1)
    u, inv, cnt = torch.unique(key, return_inverse=True, return_counts=True)
    nfree = torch.zeros_like(cnt).scatter_(0, inv.flatten(), torch.maximum(f1, f2).flatten())
    return dict(contended_rows=int((place & (cnt[inv] >= 2)).sum().item()),
                oversubscribed_buckets=int(((u >= 0) & (cnt > nfree)).sum().item()))


def insert_bytes(kv, after, k_hi, k_lo, delete, valid) -> int:
    """The bytes K4 insert must move for these rows into ``kv``, counted
    from the data (``after``: the plain twin's result): every row's valid
    flag; a valid row's key and delete flag, both candidate buckets of
    slot, key_lo of each candidate bucket holding a LIVE way and key_hi
    of each whose key_lo matched; a matched row's value read and written
    (and its slot on a delete); a placed row's value read and its whole
    entry written; a displaced resident's key and value read and its
    entry written again; the drop count of a table that lost a row."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    b, c = kv.slot.shape
    lanes = kv.val.shape[-1]
    s, th, tl = kvs._probe(kv, kvs._cand_pos(c, k_hi, k_lo))
    live = (s == kvs.LIVE) & valid[..., None]
    lo_eq = live & (tl == k_lo[..., None])
    match = (lo_eq & (th == k_hi[..., None])).any(-1)

    def buckets(m):
        return int(m.view(*m.shape[:-1], 2, kvs.WAYS).any(-1).sum().item())

    lost = after.dropped - kv.dropped
    placed = int((valid & ~match & ~delete).sum().item()) - int(lost.sum().item())
    moved = int(((kv.slot == kvs.LIVE) & (after.slot == kvs.LIVE)
                 & (kv.key_lo != after.key_lo)).sum().item())
    entry = 3 * 4 + 4 * lanes  # key_hi, key_lo, slot, value
    return (k_hi.numel() + int(valid.sum().item()) * (4 + 4 + 1 + 2 * kvs.WAYS * 4)
            + 16 * buckets(live) + 16 * buckets(lo_eq)
            + int(match.sum().item()) * 8 * lanes + int((match & delete).sum().item()) * 4
            + placed * (4 * lanes + entry) + moved * (8 + 4 * lanes + entry)
            + 8 * int((lost > 0).sum().item()))


def exec_bytes(key_hi, key_lo, status, op, executed, wb, cu, eu, e) -> int:
    """The bytes K6 must move for these windows, counted from the data:
    the status, op and executed bytes of every slot, the 8-byte key of
    each poisoned slot at or below its row's last candidate (no other
    key can change the answer), the three cursors, and slot_of and
    newly_exec written once."""
    from minpaxos_tpu_torch.wire.messages import ACCEPTED, COMMITTED, EXECUTED, NONE, Op

    b, s = status.shape
    idx = torch.arange(s, device=status.device)[None]
    a = wb[:, None] + idx
    rel0 = (eu + 1 - wb)[:, None]
    pre = (idx >= rel0) & (idx < rel0 + (cu - eu).clamp(0, e)[:, None])
    poison = (((status >= ACCEPTED) & (status < EXECUTED) & ~executed & ~pre)
              | ((status == ACCEPTED) & ((op == int(Op.PUT)) | (op == int(Op.DELETE)))))
    gap = torch.where((a > cu[:, None]) & (status == NONE), a, 2 ** 30).amin(1, keepdim=True)
    cand = (status == COMMITTED) & ~executed & ~pre & (a > cu[:, None]) & (a < gap)
    last = torch.where(cand, idx, -1).amax(1, keepdim=True)
    keys = int((poison & (idx <= last)).sum().item())
    return b * s * 3 + keys * 8 + b * 12 + b * e * 4 + b * s


def ack_bytes(is_acc, ballot) -> int:
    """The bytes K5 ack_runs must move for these rows, counted from the
    data: every row's ACCEPT flag; an ACCEPT row's sender, instance and ok
    flag (and ballot, in the run key at stride R); run_start and run_len
    written for every row."""
    n_acc = int(is_acc.sum().item())
    return is_acc.numel() * (1 + 1 + 4) + n_acc * (4 + 4 + 1 + (4 if ballot is not None else 0))


def vote_bytes(valid, s: int, into, mask) -> int:
    """The bytes K5 vote_bits must move, counted from the data: every
    row's valid flag; a valid row's sender, instance and count; the window
    bases; the [B, S] votes written once, and read once when fused
    (``into``), with the mask read once when given."""
    b = valid.shape[0]
    return (valid.numel() + int(valid.sum().item()) * 12 + b * 4
            + b * s * 4 * (2 if into is not None else 1) + (b * s if mask is not None else 0))


def pvote_bytes(valid, s: int, into) -> int:
    """The bytes K5 scatter_vote_bits must move, counted from the data:
    every row's valid flag; a valid row's index and sender; the [B, S]
    pvotes written once, and read once when fused (``into``)."""
    b = valid.shape[0]
    return (valid.numel() + int(valid.sum().item()) * 8
            + b * s * 4 * (2 if into is not None else 1))


def frontier_bytes(status, threshold, upto, wb, executed) -> int:
    """The bytes K3 advance_frontier must move, counted from the data:
    per row the status bytes from the start through the first slot that
    is not done (the executed bytes too when given), upto and the window
    base read and the frontier written."""
    from minpaxos_tpu_torch.ops import scan

    b, s = status.shape
    done = status >= threshold
    if executed is not None:
        done = executed | done
    start32 = upto + 1 - wb  # int32, wrapping as the steps' arithmetic does
    start = start32.to(torch.int64)
    rel = scan._commit_frontier_plain(done, start32).to(torch.int64)
    i0 = start.clamp(min=0)
    gap = torch.where(rel >= i0, rel + 1, i0)  # the first slot not done (or s)
    n = torch.where(i0 < s, (gap + 1).clamp(max=s) - i0, 0)
    return int(n.sum().item()) * (2 if executed is not None else 1) + b * 12


def unfused_frontier(status, threshold, upto, wb, executed=None):
    """``ops/scan.py advance_frontier``'s function as the steps composed
    it before the fusion, timed beside it as ``unfused_ms``: the eager
    operand and start around a ``commit_frontier`` launch, then the eager
    max."""
    from minpaxos_tpu_torch.ops import scan

    done = status >= threshold
    if executed is not None:
        done = executed | done
    rel = scan.commit_frontier(done, upto + 1 - wb)
    return torch.maximum(upto, rel + wb)


def exec_cases(b: int, s: int, e: int, seed: int, dev) -> dict:
    """K6's adversarial windows, [b, s] with budget e, from the families
    the card tests run (``ops/mencius_exec.py exec_families``):
    ``no_gap`` (no NONE slot in the window, so every committed slot above
    the frontier is a candidate and the E budget binds) and ``one_key``
    (every slot the same key: every candidate's key is hot)."""
    from minpaxos_tpu_torch.ops import mencius_exec

    fam = mencius_exec.exec_families(np.random.default_rng(seed), b, s, e,
                                     names=("no_gap", "one_key"))
    return {name: tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs) + (e,)
            for name, arrs in fam.items()}


def unfused_segments(s_khi, s_klo, s_valid, s_write):
    """``ops/scan.py kv_segments``' function as the apply composed it
    before the fusion, timed beside it as ``unfused_ms``: eager segment
    starts from rolled keys and flips around three launches of the
    standalone K3 scans."""
    from minpaxos_tpu_torch.ops import scan

    e = s_khi.shape[-1]
    pos = torch.arange(e, dtype=torch.int32, device=s_khi.device).expand_as(s_khi)
    seg_start = ((pos == 0) | (s_khi != torch.roll(s_khi, 1, 1))
                 | (s_klo != torch.roll(s_klo, 1, 1))
                 | (s_valid != torch.roll(s_valid, 1, 1)))
    wpos = torch.where(s_write, pos, -1)
    prev_w = scan.exclusive_segmented_scan_max(wpos, seg_start, -1)
    seg_max_w = scan.segmented_scan_max(wpos, seg_start)
    seg_end = torch.roll(seg_start, -1, 1)
    seg_end[:, -1] = True
    seg_total = scan.segmented_scan_max(seg_max_w.flip(1), seg_end.flip(1)).flip(1)
    return prev_w, s_write & (pos == seg_total)


def lookup_bytes(kv, q_hi, q_lo, q_ok, found) -> int:
    """The bytes K4 lookup must move for these queries, counted from the
    data: every query's key and valid flag; for a valid query, the
    16-byte key_lo of bucket 1, and its slot and key_hi as well where a
    way's key_lo matches; then bucket 2 the same way only when bucket 1
    holds no live match (it never does when b2 == b1); a found query's
    value; every query's value and found flag written."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    c, lanes = kv.val.shape[1:]
    n = q_ok.numel()
    pos = kvs._cand_pos(c, q_hi, q_lo)
    st, kh, kl = kvs._probe(kv, pos)
    lo_eq = (kl == q_lo[..., None]).view(*q_ok.shape, 2, kvs.WAYS)
    live = (lo_eq & (st == kvs.LIVE).view_as(lo_eq)
            & (kh == q_hi[..., None]).view_as(lo_eq)).any(-1)
    lo_any = lo_eq.any(-1)
    own_b2 = pos[..., kvs.WAYS] != pos[..., 0]
    b1_bytes = 16 + 32 * lo_any[..., 0].long()
    b2_bytes = torch.where(own_b2 & ~live[..., 0], 16 + 32 * lo_any[..., 1].long(), 0)
    tables = int(torch.where(q_ok, b1_bytes + b2_bytes, 0).sum().item())
    return (n * (4 + 4 + 1) + tables + int(found.sum().item()) * lanes * 4
            + n * (lanes * 4 + 1))


def lookup_case(kv, q_hi, q_lo, q_ok, full: bool = False) -> dict:
    """K4 lookup on one case: held to the twin over repeated launches,
    timed (``full``: with the host-issued and plain times too), the
    bound counted from the data (``lookup_bytes``; integer operations:
    two hashes and eight compares a valid query)."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    lk_k = lambda: kvs.kv_lookup_lanes(kv, q_hi, q_lo, q_ok)  # noqa: E731
    lk_p = lambda: kvs._kv_lookup_plain(kv, q_hi, q_lo, q_ok)  # noqa: E731
    want = lk_p()
    n_ok = int(q_ok.sum().item())
    return dict(err=max(max_abs_err(lk_k(), want), repeat_err(lk_k, want)),
                **(times(lk_k, lk_p) if full else dict(ms=graph_ms(lk_k))),
                bytes=lookup_bytes(kv, q_hi, q_lo, q_ok, want[0]), ops=n_ok * (24 + 8 * 4),
                valid=n_ok, found=int(want[0].sum().item()))


def lookup_path_case(kv, seed: int, e: int = P) -> dict:
    """K4 lookup on the MinPaxos resident run's own tables (``kv``, after
    its last dispatch), with queries as the apply makes them: per table,
    ``e`` keys drawn with repeats from its LIVE keys, one in 32 replaced
    by a key outside the workload's key space (a miss), sorted by key as
    ``sort_order`` sorts them, valid where no earlier row has the key
    (the apply's no-earlier-writer mask: every row of the path is a
    PUT)."""
    from minpaxos_tpu_torch.ops import kvstore as kvs

    dev = kv.slot.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b, c = kv.slot.shape
    live = kv.slot == kvs.LIVE
    first_live = torch.argsort((~live).to(torch.uint8), dim=1, stable=True)
    rank = (torch.rand((b, e), device=dev, generator=g) * live.sum(1, keepdim=True)).long()
    at = torch.gather(first_live, 1, rank.clamp(max=c - 1))
    miss = torch.rand((b, e), device=dev, generator=g) < 1 / 32
    q_lo = torch.where(miss, torch.randint(KEY_SPACE, 1 << 30, (b, e), device=dev,
                                           dtype=torch.int32, generator=g),
                       torch.gather(kv.key_lo, 1, at))
    q_hi = torch.where(miss, 0, torch.gather(kv.key_hi, 1, at))
    srt = kvs.sort_order(q_hi, q_lo, torch.ones_like(miss))
    q_hi, q_lo = torch.gather(q_hi, 1, srt).contiguous(), torch.gather(q_lo, 1, srt).contiguous()
    q_ok = torch.ones_like(miss)
    q_ok[:, 1:] = (q_hi[:, 1:] != q_hi[:, :-1]) | (q_lo[:, 1:] != q_lo[:, :-1])
    row = lookup_case(kv, q_hi, q_lo, q_ok, full=True)
    return dict(row, table_load=float(live.float().mean().item()),
                shapes=f"tables [{b},{c}] (the resident run's), rows [{b},{e}]")


def compare_kernels(dev, seed: int, sh: Shapes) -> tuple[dict, float]:
    """Each kernel of the path vs its plain twin at the path's shapes;
    also the whole KV apply (sort + K3 + K4) on the card against the CPU
    path. Returns (per-kernel results, the KV apply's max abs error)."""
    from minpaxos_tpu_torch.ops import ackruns, mencius_exec, scan, segscatter, winner
    from minpaxos_tpu_torch.ops import kvstore as kvs

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    G, R = sh.groups, sh.replicas
    B = sh.batch or G * R
    M = sh.M  # inbox rows the step consumes
    S = sh.S
    E = sh.E  # exec_batch
    M_OUT = sh.m_out  # outbox rows per replica
    N = R * M_OUT
    CAP = sh.cap  # inbox capacity of the routing fabric
    KVP = sh.kv_pow2
    C = 1 << KVP

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, device=dev, dtype=torch.int32, generator=g)

    def rb(p, shape):
        return torch.rand(shape, device=dev, generator=g) < p

    res = {}

    # K2: keyed scatter-max into [B, S+1] (write A key: section*M + row)
    tgt = ri(0, S + 1, (B, M))
    val = ri(0, 2 * M, (B, M))
    ok = rb(0.5, (B, M))
    fn_k = lambda: winner.scatter_max(S, tgt, val, ok, -1)  # noqa: E731
    fn_p = lambda: winner._scatter_max_plain(S, tgt, val, ok, -1)  # noqa: E731
    idx = winner._targets(S, tgt, ok).long()

    def fn_lib():
        return torch.full((B, S + 1), -1, dtype=torch.int32, device=dev).scatter_reduce_(
            1, idx, val, reduce="amax", include_self=True)

    err = max_abs_err(fn_k(), fn_p())
    # the step's other forms: signed ballots into [B, S+1] with the
    # NO_BALLOT fill and out-of-window targets, and the peer-frontier
    # max of signed last_committed into [B, R+1] with fill -2^30
    for size, lo, hi, fill, t_lo, p_ok in ((S, -3, 64, -1, -8, 0.5),
                                           (R, -(2 ** 30), 1 << 20, -(2 ** 30), 0, 1.0)):
        t2 = ri(t_lo, size + 8 if t_lo else size + 1, (B, M))
        v2 = ri(lo, hi, (B, M))
        ok2 = rb(p_ok, (B, M))
        err = max(err, max_abs_err(winner.scatter_max(size, t2, v2, ok2, fill),
                                   winner._scatter_max_plain(size, t2, v2, ok2, fill)))
    # the narrow form's device ms (kept beside the window form's row)
    narrow_ms = graph_ms(lambda: winner.scatter_max(size, t2, v2, ok2, fill))
    res["scatter_max"] = dict(
        err=err, **times(fn_k, fn_p, fn_lib), narrow_ms=narrow_ms,
        bytes=B * M * (4 + 4 + 1) + B * (S + 1) * 4,
        ops=B * M * 4 + B * (S + 1),  # select, bound check, address, max; fill
        shapes=f"tgt/val/ok [{B},{M}] -> [{B},{S + 1}]; also signed ballots "
               f"(fill -1) -> [{B},{S + 1}], signed frontiers (fill -2^30) -> [{B},{R + 1}]")

    # K3: the standalone segmented max-scans over [B, E] (off the paths
    # since the apply takes kv_segments; kept as JAX ops/scan.py's
    # counterparts)
    vals = ri(-1, E, (B, E))
    seg = rb(0.3, (B, E))
    inc_k = lambda: scan.segmented_scan_max(vals, seg)  # noqa: E731
    exc_k = lambda: scan.exclusive_segmented_scan_max(vals, seg, -1)  # noqa: E731
    inc_want = scan._segmented_scan_max_plain(vals, seg)
    exc_want = scan._exclusive_plain(vals, seg, -1)
    err = max(max_abs_err(inc_k(), inc_want), repeat_err(inc_k, inc_want),
              max_abs_err(exc_k(), exc_want), repeat_err(exc_k, exc_want))
    res["seg_scan_max"] = dict(
        err=err, **times(inc_k, lambda: scan._segmented_scan_max_plain(vals, seg)),
        bytes=B * E * (4 + 1 + 4),
        ops=B * E * 3,  # one combine (select + max + or) per element
        shapes=f"values/seg [{B},{E}] -> [{B},{E}]")

    # K3: the KV apply's segments in one launch, on the families of
    # ops/scan.py segment_families (the apply's sorted rows the
    # headline), each held to the twin over repeated launches and timed;
    # unfused_ms: the same function as the apply composed it before, the
    # eager segment starts and flips around three seg_scan_max launches
    fams = scan.segment_families(np.random.default_rng(seed), B, E, names=SEG_CASES)
    for name in SEG_CASES:
        arrs = tuple(torch.from_numpy(x).to(dev) for x in fams[name])
        sg_k = lambda a=arrs: scan.kv_segments(*a)  # noqa: E731
        sg_p = lambda a=arrs: scan._kv_segments_plain(*a)  # noqa: E731
        want = sg_p()
        row = dict(err=max(max_abs_err(sg_k(), want), repeat_err(sg_k, want)),
                   **(times(sg_k, sg_p) if name == SEG_CASES[0] else dict(ms=graph_ms(sg_k))),
                   unfused_ms=graph_ms(lambda a=arrs: unfused_segments(*a)),
                   final_writers=int(want[1].sum().item()))
        if name == SEG_CASES[0]:
            res["kv_segments"] = dict(
                row, cases={},
                # keys, valid and write flags read once; prev_w and
                # is_final_writer written once
                bytes=B * E * (4 + 4 + 1 + 1) + B * E * (4 + 1),
                # per element: the neighbour compare (3 compares, 2 ors),
                # the forward and the backward step (3 each)
                ops=B * E * 11,
                shapes=f"sorted key_hi/key_lo/valid/write [{B},{E}] -> prev_w, "
                       f"is_final_writer [{B},{E}]")
        else:
            res["kv_segments"]["cases"][name] = row
            res["kv_segments"]["err"] = max(res["kv_segments"]["err"], row["err"])

    # K3: commit frontier over [B, S] (a committed prefix, then a gap)
    start = ri(0, S // 2, (B,))
    run = ri(0, S // 2, (B,))
    ix = torch.arange(S, device=dev)[None, :]
    committed = ((ix >= start[:, None]) & (ix < (start + run)[:, None])) | rb(0.5, (B, S))
    cf_k = lambda: scan.commit_frontier(committed, start)  # noqa: E731
    cf_p = lambda: scan._commit_frontier_plain(committed, start)  # noqa: E731
    got = cf_k()
    res["commit_frontier"] = dict(
        err=max_abs_err(got, cf_p()), **times(cf_k, cf_p),
        # bytes the frontier needs: from start through the first gap
        bytes=int((got.to(torch.int64) - start + 2).clamp(min=1).sum().item()) + B * 8,
        ops=int((got.to(torch.int64) - start + 2).clamp(min=1).sum().item()),
        shapes=f"committed [{B},{S}], start [{B}] -> [{B}]")

    # K3: the steps' frontier update in one launch (the operand, the
    # start, the scan and the max), on the families of ops/scan.py
    # frontier_families (a round's run then a gap the headline), the
    # COMMITTED form and the EXECUTED form with ``executed`` (Mencius's
    # executed frontier), each held to the twin over repeated launches
    # and timed beside unfused_ms, the same function as the steps
    # composed it before
    from minpaxos_tpu_torch.wire.messages import COMMITTED, EXECUTED

    fams = scan.frontier_families(np.random.default_rng(seed), B, S, names=FRONTIER_CASES)
    for name in FRONTIER_CASES:
        st_, up_, wb_, ex_ = (torch.from_numpy(x).to(dev) for x in fams[name])
        for form, thr, ex in (("", COMMITTED, None), ("_executed", EXECUTED, ex_)):
            af_k = lambda a=(st_, thr, up_, wb_, ex): scan.advance_frontier(*a)  # noqa: E731
            af_p = lambda a=(st_, thr, up_, wb_, ex): scan._advance_frontier_plain(*a)  # noqa: E731
            want = af_p()
            nb = frontier_bytes(st_, thr, up_, wb_, ex)
            row = dict(err=max(max_abs_err(af_k(), want), repeat_err(af_k, want)),
                       **(times(af_k, af_p) if name + form == FRONTIER_CASES[0]
                          else dict(ms=graph_ms(af_k))),
                       unfused_ms=graph_ms(lambda a=(st_, thr, up_, wb_, ex):
                                           unfused_frontier(*a)),
                       bytes=nb, advanced=int((want > up_).sum().item()))
            if name + form == FRONTIER_CASES[0]:
                res["advance_frontier"] = dict(
                    row, cases={},
                    ops=nb,  # a compare per status byte read
                    shapes=f"status u8 [{B},{S}], upto/window_base [{B}] -> [{B}]; "
                           f"threshold COMMITTED (cases: EXECUTED with executed "
                           f"bool [{B},{S}])")
            else:
                res["advance_frontier"]["cases"][name + form] = row
                res["advance_frontier"]["err"] = max(res["advance_frontier"]["err"],
                                                     row["err"])

    # K1: the routing fabric over [12, G, N] pooled rows (not on the
    # TCP and mc paths: there the transport or the explorer delivers
    # the rows)
    if sh.routed:
        cols = ri(-5, 1 << 20, (12, G, N))
        cols[0] = torch.where(rb(0.6, (G, N)), ri(1, 30, (G, N)), 0)
        u = torch.rand((G, N), device=dev, generator=g)
        dst = torch.where(u < 0.5, -1, torch.where(u < 0.8, ri(0, R, (G, N)), -2)).to(torch.int32)
        alive = ~rb(0.05, (G, R))
        rt_k = lambda: segscatter.route(cols, dst, alive, M_OUT, CAP)  # noqa: E731

        def rt_p():
            win, hit = segscatter.route_plan(cols[0], dst, alive, M_OUT, CAP)
            return segscatter.gather_rows(cols, win, hit), hit

        want = rt_p()
        res["route"] = dict(
            err=max(max_abs_err(rt_k(), want), repeat_err(rt_k, want)), **times(rt_k, rt_p),
            bytes=G * N * 4 * 2 + G * R + 12 * G * R * CAP * 4 + G * R * CAP,
            ops=G * N * R * 8,  # destined test per (row, destination)
            shapes=f"cols [12,{G},{N}], dst [{G},{N}] -> [12,{G},{R},{CAP}]")

    # K4: the KV engine on [B, C] tables (a quarter full at the MinPaxos
    # shape), [B, E] rows
    kv = kvs.kv_init(KVP, B, dev)

    def prefill_keys(i):
        k64 = torch.arange(E, device=dev, dtype=torch.int64) * 64 + i
        return ((k64 * 2654435761) % (1 << 30)).to(torch.int32)

    def prefill(kv, batches):
        for i in batches:
            keys = prefill_keys(i)[None].expand(B, E).contiguous()
            kv = kvs._kv_insert_plain(kv, torch.zeros_like(keys), keys,
                                      ri(0, 1 << 30, (B, E, 2)),
                                      torch.zeros((B, E), dtype=torch.bool, device=dev),
                                      torch.ones((B, E), dtype=torch.bool, device=dev))
        return kv

    kv = prefill(kv, range(16))
    q_lo = torch.where(rb(0.5, (B, E)), kv.key_lo[:, :E], ri(0, 1 << 30, (B, E)))
    q_hi = torch.zeros_like(q_lo)
    q_ok = rb(0.9, (B, E))
    res["kv_lookup"] = dict(
        lookup_case(kv, q_hi, q_lo, q_ok, full=True), cases={},
        shapes=f"tables [{B},{C}], rows [{B},{E}]")
    # and the families of ops/kvstore.py lookup_families: no key present;
    # every key in bucket 2's last way, the ways before it LIVE (the
    # longest walk in probe order)
    for name, (tabs, qs) in kvs.lookup_families(np.random.default_rng(seed), B, E, C,
                                                names=K4_LOOKUP_CASES).items():
        kv_f = kvs.KVState(*(torch.from_numpy(x).to(dev) for x in tabs), kv.dropped)
        row = lookup_case(kv_f, *(torch.from_numpy(x).to(dev) for x in qs))
        res["kv_lookup"]["cases"][name] = row
        res["kv_lookup"]["err"] = max(res["kv_lookup"]["err"], row["err"])
        del kv_f

    # insert: distinct keys per row (final writers), some present, some deletes
    ins_lo = torch.unique(torch.cat([prefill_keys(3)[:E // 2], ri(0, 1 << 30, (E,))]))
    ins_lo = ins_lo[:E][None].expand(B, E).contiguous()
    ins_hi = torch.zeros_like(ins_lo)
    ins_v = ri(0, 1 << 30, (B, E, 2))
    ins_del = rb(0.1, (B, E))
    ins_ok = rb(0.8, (B, E))

    def clone_kv():
        return kvs.KVState(*[t.clone() for t in kv])

    kv_a = kvs.kv_insert_unique(clone_kv(), ins_hi, ins_lo, ins_v, ins_del, ins_ok)
    kv_b = kvs._kv_insert_plain(kv, ins_hi, ins_lo, ins_v, ins_del, ins_ok)
    err = max(max_abs_err(a, b) for a, b in zip(kv_a, kv_b))
    ins_bytes = insert_bytes(kv, kv_b, ins_hi, ins_lo, ins_del, ins_ok)
    # and on tables three-quarters full, where rows overflow both
    # candidate buckets and the displacement pass runs
    full = prefill(clone_kv(), range(16, 48))
    pre = kvs.KVState(*[t.clone() for t in full])
    kv_a = kvs.kv_insert_unique(full, ins_hi, ins_lo, ins_v, ins_del, ins_ok)
    kv_b = kvs._kv_insert_plain(pre, ins_hi, ins_lo, ins_v, ins_del, ins_ok)
    err = max([err] + [max_abs_err(a, b) for a, b in zip(kv_a, kv_b)])
    # a way LIVE before and after under another key took a displaced row
    displaced = int(((pre.slot == 1) & (kv_a.slot == 1)
                     & (pre.key_lo != kv_a.key_lo)).sum().item())
    full_load = dict(load=int((pre.slot == 1).sum().item()) / (B * C),
                     displaced=displaced,
                     dropped=int((kv_a.dropped - pre.dropped).sum().item()))
    del full, pre, kv_a, kv_b
    # and keys that share their first candidate bucket in groups of 2, 4
    # and 6, rows shuffled per table: the claim rounds after the first
    # and pass B run in every block
    c_lo = kvs._grouped_keys(C, E, g)
    c_lo = c_lo[torch.argsort(torch.rand((B, E), device=dev, generator=g), 1)]
    c_del, c_ok = rb(0.05, (B, E)), rb(0.95, (B, E))
    c_args = (torch.zeros_like(c_lo), c_lo, ri(0, 1 << 30, (B, E, 2)), c_del, c_ok)
    contended = claim_contention(kv, c_args[0], c_lo, c_del, c_ok)
    kv_a = kvs.kv_insert_unique(clone_kv(), *c_args)
    kv_b = kvs._kv_insert_plain(kv, *c_args)
    contended["err"] = max(max_abs_err(a, b) for a, b in zip(kv_a, kv_b))
    err = max(err, contended["err"])
    del kv_a, kv_b
    pool = [clone_kv() for _ in range(8)]
    it = iter(range(10 ** 9))

    def restore():
        for p in pool:
            for a, b in zip(p, kv):
                a.copy_(b)

    ins_k = lambda: kvs.kv_insert_unique(pool[next(it) % 8], ins_hi, ins_lo, ins_v,  # noqa: E731
                                         ins_del, ins_ok)
    ins_p = lambda: kvs._kv_insert_plain(kv, ins_hi, ins_lo, ins_v, ins_del, ins_ok)  # noqa: E731
    contended["ms"] = graph_ms(lambda: kvs.kv_insert_unique(pool[next(it) % 8], *c_args),
                               8, reset=restore)
    n_ok = int(ins_ok.sum().item())
    res["kv_insert"] = dict(
        err=err, **times(ins_k, ins_p, iters=8, reset=restore), full_load=full_load,
        contended=contended,
        bytes=ins_bytes,
        ops=n_ok * (24 + 8 * 4 + 2 * 4 * 6),  # hashes, probes, claim rounds
        shapes=f"tables [{B},{C}], rows [{B},{E}]")

    # the whole KV apply (sort + K3 + K4) against the plain path
    ops = torch.where(rb(0.7, (B, E)), 1, torch.where(rb(0.5, (B, E)), 2, 3)).to(torch.int32)
    ak_lo = ri(0, 64, (B, E))
    a_v = ri(0, 1 << 30, (B, E, 2))
    a_ok = rb(0.9, (B, E))
    kv_c, out_c, f_c = kvs.kv_apply_batch_lanes(clone_kv(), ops, torch.zeros_like(ak_lo),
                                                ak_lo, a_v, a_ok)
    cpu = [t.cpu() for t in (ops, ak_lo, a_v, a_ok)]
    kv_cpu = kvs.KVState(*[t.cpu() for t in kv])
    kv_d, out_d, f_d = kvs.kv_apply_batch_lanes(kv_cpu, cpu[0], torch.zeros_like(cpu[1]),
                                                cpu[1], cpu[2], cpu[3])
    apply_err = max([max_abs_err(a.cpu(), b) for a, b in zip(kv_c, kv_d)]
                    + [max_abs_err(out_c.cpu(), out_d), max_abs_err(f_c.cpu(), f_d)])
    del kv, pool, kv_c, kv_d

    # K5: ack-run compression over [B, M] rows (Mencius echoes the ballot
    # into the run key) and the range-ack vote bits fused with the OR into
    # the [B, S] votes table (under the driven-slot mask on the Mencius
    # path, as the step calls them), on the input families of
    # ops/ackruns.py ack_families: random (the headline row), leader_only
    # (the main path's: a run in every follower row, acks only in the
    # leader rows) and one_long_run; every family held to the twins over
    # repeated launches, the unfused form too, and timed
    d = sh.stride
    def on_dev(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    fams = ackruns.ack_families(np.random.default_rng(seed), B, M, S, R, d, names=K5_CASES)
    for name in K5_CASES:
        runs, votes = (tuple(map(on_dev, fams[name][k])) for k in ("runs", "votes"))
        into = on_dev(fams[name]["into"])
        mask = on_dev(fams[name]["mask"]) if sh.protocol == "mencius" else None
        ar_k = lambda r=runs: ackruns.compress_ack_runs(*r[:4], ballot=r[4], stride=d)  # noqa: E731
        ar_p = lambda r=runs: ackruns._compress_plain(*r, d)  # noqa: E731
        vb_k = lambda v=votes, i=into, k=mask: ackruns.range_vote_bits(  # noqa: E731
            *v, S, R, stride=d, into=i, mask=k)
        vb_p = lambda v=votes, i=into, k=mask: ackruns._vote_bits_plain(  # noqa: E731
            *v, S, R, d, i, k)
        bits_k = lambda v=votes: ackruns.range_vote_bits(*v, S, R, stride=d)  # noqa: E731
        runs_want, want = ar_p(), vb_p()
        bits = ackruns._vote_bits_plain(*votes, S, R, d, None, None)
        if mask is None:
            eager = lambda i=into, b=bits: i | b  # noqa: E731
        else:
            eager = lambda i=into, b=bits, k=mask: i | torch.where(k, b, 0)  # noqa: E731
        headline = name == "random"
        ack = dict(err=max(max_abs_err(ar_k(), runs_want), repeat_err(ar_k, runs_want)),
                   **(times(ar_k, ar_p) if headline else dict(ms=graph_ms(ar_k))),
                   bytes=ack_bytes(runs[0], runs[4]), max_run=int(runs_want[1].max().item()))
        hit = int(votes[0].any(1).sum().item())
        vote = dict(err=max(max_abs_err(vb_k(), want), repeat_err(vb_k, want),
                            max_abs_err(bits_k(), bits), repeat_err(bits_k, bits)),
                    **(times(vb_k, vb_p) if headline else dict(ms=graph_ms(vb_k))),
                    bits_ms=graph_ms(bits_k), eager_or_ms=graph_ms(eager),
                    bytes=vote_bytes(votes[0], S, into, mask),
                    bits_bytes=vote_bytes(votes[0], S, None, None),
                    rows_with_acks=hit, voted_slots=int((bits != 0).sum().item()))
        if headline:
            res["ack_runs"] = dict(
                ack, ops=B * M * 8, cases={},  # run test, two scans, a length
                shapes=f"rows [{B},{M}] -> run_start, run_len [{B},{M}]; stride {d}"
                       + (", ballot in the run key" if d > 1 else ""))
            res["vote_bits"] = dict(
                vote, cases={},
                # per valid row: clip, ranks, two adds; per plane cell of a
                # row with acks: a prefix add; per slot: a compare and an or
                # per replica in a row with acks, else a copy
                ops=int(votes[0].sum().item()) * 12 + hit * R * (S + d) + hit * S * R * 2
                + (B - hit) * S,
                shapes=f"rows [{B},{M}], window_base [{B}], votes [{B},{S}]"
                       + (f", mask [{B},{S}]" if mask is not None else "")
                       + f" -> votes [{B},{S}]; stride {d}; fused with the OR"
                       + (" under the mask" if mask is not None else ""))
        else:
            res["ack_runs"]["cases"][name] = ack
            res["vote_bits"]["cases"][name] = vote
        res["ack_runs"]["err"] = max(res["ack_runs"]["err"], ack["err"])
        res["vote_bits"]["err"] = max(res["vote_bits"]["err"], vote["err"])
    a_src = on_dev(fams["random"]["runs"][1])
    sv_idx = ri(-2, S + 3, (B, M))
    sv_ok = rb(0.3, (B, M))
    sv_k = lambda: ackruns.scatter_vote_bits(S, sv_idx, a_src, sv_ok, R)  # noqa: E731
    sv_p = lambda: ackruns._scatter_vote_bits_plain(S, sv_idx, a_src, sv_ok, R)  # noqa: E731
    # the form without ``into`` (no path launches it), as it stood alone
    res["scatter_vote_bits_alone"] = dict(
        err=max(max_abs_err(sv_k(), sv_p()), repeat_err(sv_k, sv_p())), **times(sv_k, sv_p),
        bytes=B * M * (4 + 4 + 1) + B * S * 4,
        ops=B * M * 4 + B * S,  # bound checks, shift, or; the zero fill
        shapes=f"idx/src/valid [{B},{M}] -> [{B},{S}]")
    # K5: the pvotes scatter fused with the OR into the [B, S] pvotes
    # table, as the steps call it, on the families of ops/ackruns.py
    # pvote_families (the steady state, no valid row, the headline),
    # each held to the twin over repeated launches and timed beside
    # unfused_ms: the form without ``into`` followed by the eager OR
    fams = ackruns.pvote_families(np.random.default_rng(seed), B, M, S, R, names=PVOTE_CASES)
    for name in PVOTE_CASES:
        idx_, src_, ok_, into_ = (torch.from_numpy(x).to(dev) for x in fams[name])
        pv_k = lambda a=(idx_, src_, ok_, into_): ackruns.scatter_vote_bits(  # noqa: E731
            S, *a[:3], R, into=a[3])
        pv_p = lambda a=(idx_, src_, ok_, into_): ackruns._scatter_vote_bits_plain(  # noqa: E731
            S, *a[:3], R, a[3])
        want = pv_p()
        row = dict(err=max(max_abs_err(pv_k(), want), repeat_err(pv_k, want)),
                   **(times(pv_k, pv_p) if name == PVOTE_CASES[0] else dict(ms=graph_ms(pv_k))),
                   unfused_ms=graph_ms(lambda a=(idx_, src_, ok_, into_):
                                       a[3] | ackruns.scatter_vote_bits(S, *a[:3], R)),
                   bytes=pvote_bytes(ok_, S, into_), valid_rows=int(ok_.sum().item()))
        if name == PVOTE_CASES[0]:
            res["scatter_vote_bits"] = dict(
                row, cases={},
                ops=int(ok_.sum().item()) * 4,  # per valid row: bound checks, shift, or
                shapes=f"idx/src/valid [{B},{M}], pvotes [{B},{S}] -> pvotes [{B},{S}]; "
                       f"fused with the OR")
        else:
            res["scatter_vote_bits"]["cases"][name] = row
            res["scatter_vote_bits"]["err"] = max(res["scatter_vote_bits"]["err"], row["err"])

    if sh.protocol == "mencius":
        # K6: the exec selector over [B, S] windows: duplicate keys from
        # the deployment's key space, NONE gaps, uncommitted writes,
        # executed slots, more candidates than the E budget in some rows
        code = torch.multinomial(torch.tensor([0.02, 0.1, 0.5, 0.2, 0.0, 0.18], device=dev),
                                 B * S, replacement=True, generator=g).view(B, S)
        x_status = torch.tensor([0, 3, 4, 4, 4, 5], device=dev, dtype=torch.uint8)[code]
        x_op = ri(0, 4, (B, S)).to(torch.uint8)
        x_hi = torch.zeros((B, S), dtype=torch.int32, device=dev)
        x_lo = ri(0, M_KEY_SPACE, (B, S))
        x_exec = (x_status == 5) | rb(0.02, (B, S))
        x_wb = ri(0, 1 << 20, (B,))
        x_eu = x_wb + ri(-1, S // 2, (B,))
        x_cu = x_eu + ri(-1, 2 * E, (B,))
        x_args = (x_hi, x_lo, x_status, x_op, x_exec, x_wb, x_cu, x_eu, E)
        ex_k = lambda: mencius_exec.exec_select(*x_args)  # noqa: E731
        ex_p = lambda: mencius_exec._exec_select_plain(*x_args)  # noqa: E731
        got = ex_k()
        want = ex_p()
        err = max(max_abs_err(got, want), repeat_err(ex_k, want))
        # one PyTorch call for part of the function: the stable sort of
        # the window's composite keys (signed key_hi, then signed key_lo)
        comp = (x_hi.to(torch.int64) << 32) + (x_lo.to(torch.int64) + 2 ** 31)
        lib_sort = lambda: torch.sort(comp, dim=1, stable=True)  # noqa: E731
        # adversarial windows, each timed and held against the twin: no
        # NONE slot (every committed slot above the frontier a candidate,
        # the E budget binding) and every slot one key
        cases = {}
        for name, args in exec_cases(B, S, E, seed, dev).items():
            k_out = mencius_exec.exec_select(*args)
            cases[name] = dict(err=max_abs_err(k_out, mencius_exec._exec_select_plain(*args)),
                               ms=graph_ms(lambda a=args: mencius_exec.exec_select(*a)),
                               bytes=exec_bytes(*args),
                               ranked=int((k_out[0] < S).sum().item()))
            err = max(err, cases[name]["err"])
        res["exec_select"] = dict(
            err=err, **times(ex_k, ex_p, lib_sort),
            library_what="torch.sort(stable) of the [B, S] int64 composite keys: "
                         "the sort only, a partial function",
            bytes=exec_bytes(*x_args),
            # per slot: flags, gap, candidate test, the rank count; per
            # poisoned key: a hash and a probe
            ops=B * S * 8,
            ranked=int((got[0] < S).sum().item()), cases=cases,
            shapes=f"window [{B},{S}] (keys, status, op, executed), cursors [{B}] "
                   f"-> slot_of [{B},{E}], newly_exec [{B},{S}]")
    res.update(compare_loop_kernels(dev, g, sh, seed))
    torch.cuda.synchronize()
    return res, apply_err


def chain_ms(calls, reset) -> tuple[float, float]:
    """Device ms per call of ``calls``, a chain in which each call goes on
    from the state the one before left (so none repeats another's work):
    captured once in a CUDA graph and replayed between two CUDA events
    after ``reset`` restored the chain's start; and the host-issued ms
    per call of the same calls made eagerly."""
    reset()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    out = []
    for run in (graph.replay, lambda: [c() for c in calls]):
        run()  # warm
        reset()
        torch.cuda.synchronize()
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / len(calls))
    del graph
    return out[0], out[1]


def compare_k9(dev, sh: Shapes, seed: int, leader: int, n_prop: int) -> dict:
    """K9 on chained rounds of ops/resident.py k9_families at the path's
    widths (ring [G, W], pending kinds [B, cap], 512 bins): random
    latencies, one bin (every sampled latency 3 rounds, as in place) and
    the edge cursors, each chain of K9_ROUNDS rounds held to the plain
    twins after every round, the ring armed (8 rows: it wraps; a drain
    sub-step's round_open before each close) and off. Times: round_open
    (first round, ring armed); round_close fused with the next round's
    open, ring armed, on one_bin (the headline: the main path's launch)
    and random, each beside ``unfused_ms`` (the same rounds as the loop
    ran them before: a close, then a round_open); round_close alone
    (no next round), ring armed and off, random and one_bin. The bound
    counts, per round, the stamps written, the samples read that were
    not stamped this round, the touched bins, the cursors, the row, and
    with the next round opened the [B, cap] pending kinds."""
    from minpaxos_tpu_torch.ops import resident

    G, R, W, Mp, bins = sh.groups, sh.replicas, sh.S, sh.cap, 512
    B = G * R
    per_round = P if sh.path == "minpaxos" else R * M_P  # slots a group assigns
    cur = max(leader, 0)
    injected = G * n_prop * (1 if leader >= 0 else R)
    fams = {k: resident.k9_on(f, dev, sh.path == "minpaxos") for k, f in
            resident.k9_families(np.random.default_rng(seed), G, R, W, Mp, K9_ROUNDS,
                                 per_round).items()}

    def bufs(fam, rows):
        return (resident.new_scratch(G, dev), fam["inj"].clone(),
                torch.zeros(bins, dtype=torch.int32, device=dev),
                torch.full((rows, 9), -1, dtype=torch.int32, device=dev))

    # equality over the chains; per round of the armed chains, the bins
    # the round touched
    err, touched = 0.0, {}
    for name, fam in fams.items():
        for rows in (8, 0):
            a, b = bufs(fam, rows), bufs(fam, rows)
            hist0, t_bins = b[2].clone(), []
            for _ in zip(resident.chain_rounds(fam, a, cur, n_prop, leader, 3, drain=True),
                         resident.chain_rounds(fam, b, cur, n_prop, leader, 3, drain=True,
                                               plain=True)):
                err = max(err, max_abs_err(a, b))
                t_bins.append(int((b[2] != hist0).sum().item()))
                hist0 = b[2].clone()
            if rows:
                touched[name] = t_bins

    def round_bytes(name, t, opened):
        """Bytes round t of family ``name`` must move, and its operations."""
        pre, post = fams[name]["states"][t], fams[name]["states"][t + 1]
        up = pre.committed_upto.view(G, R)[:, cur, None]
        cp = pre.crt_inst.view(G, R)[:, cur, None]
        n_st = (post.crt_inst.view(G, R)[:, cur, None] - cp).clamp(0, W)
        n_sa = (post.committed_upto.view(G, R)[:, cur, None] - up).clamp(0, W)
        k = torch.arange(W, device=dev)[None, :]
        read = (k < n_sa) & (torch.remainder(up + 1 + k - cp, W) >= n_st)
        stamps, samples = int(n_st.sum().item()), int(n_sa.sum().item())
        nbytes = (4 * (stamps + int(read.sum().item())) + 8 * touched[name][t]
                  + G * 9 * 4 + (G if sh.path == "minpaxos" else 0) + 9 * 4
                  + (B * Mp * 4 if opened else 0))
        return nbytes, stamps * 2 + samples * 6 + (B * Mp * 2 if opened else 0)

    tel = torch.full((8, 9), -1, dtype=torch.int32, device=dev)

    def k9_rounds(fam, fused=True, plain=False, rounds=K9_ROUNDS):
        """The chain's rounds, ring armed, on one set of buffers, each
        round's close opening the next round (``fused``) or followed by a
        round_open of it; and the reset to the chain's start."""
        scr, inj, hist, _ = bufs(fam, 0)
        resident.round_open(scr, fam["states"][0], fam["kinds"][0], cur, G, n_prop, leader,
                            True, True, fam["r0"])
        scr0, inj0 = scr.clone(), inj.clone()
        close = resident._round_close_plain if plain else resident.round_close

        def one(t):
            st = fam["states"][t + 1]
            close(scr, inj, hist, tel, st, cur, fam["r0"] + t, 3, injected,
                  fam["kinds"][0] if fused else None, n_prop, leader)
            if not fused:
                resident.round_open(scr, st, fam["kinds"][0], cur, G, n_prop, leader,
                                    True, True, fam["r0"] + t + 1)

        return ([lambda t=t: one(t) for t in range(rounds)],
                lambda: (scr.copy_(scr0), inj.copy_(inj0)))

    cases = {}
    for name in ("one_bin", "random"):
        fam = fams[name]
        ms, host = chain_ms(*k9_rounds(fam))
        unfused, _ = chain_ms(*k9_rounds(fam, fused=False))
        per = [round_bytes(name, t, True) for t in range(K9_ROUNDS)]
        cases[f"fused_{name}"] = dict(ms=ms, host_ms=host, unfused_ms=unfused,
                                      bytes=sum(x[0] for x in per) / K9_ROUNDS,
                                      ops=sum(x[1] for x in per) / K9_ROUNDS)
        # alone (no next round): every launch repeats round 0's work
        for rows in (8, 0):
            scr, inj, hist, tb = bufs(fam, rows)
            resident.round_open(scr, fam["states"][0], fam["kinds"][0], cur, G, n_prop,
                                leader, True, rows > 0, fam["r0"])
            inj0 = inj.clone()
            cases[f"alone_{name}" + ("" if rows else "_ring_off")] = dict(
                ms=graph_ms(lambda: resident.round_close(
                    scr, inj, hist, tb, fam["states"][1], cur, fam["r0"], 3, injected),
                    reset=lambda: inj.copy_(inj0)),
                bytes=round_bytes(name, 0, False)[0])
    head = cases.pop("fused_one_bin")
    fam = fams["one_bin"]
    plain_ms, _ = chain_ms(*k9_rounds(fam, plain=True, rounds=5))
    # the histogram part alone, as one library call (torch.bincount
    # sizes its output from the data, so it cannot be graph-captured:
    # its time is host-issued), on round 0 of the headline
    pre, post = fam["states"][0], fam["states"][1]
    pos = torch.arange(W, device=dev)[None, :]
    u_prev = pre.committed_upto.view(G, R)[:, cur, None]
    c_prev = pre.crt_inst.view(G, R)[:, cur, None]
    inj1 = torch.where(c_prev + torch.remainder(pos - c_prev, W)
                       < post.crt_inst.view(G, R)[:, cur, None], fam["r0"], fam["inj"])
    up = u_prev + 1
    wts = ((up + torch.remainder(pos - up, W) <= post.committed_upto.view(G, R)[:, cur, None])
           & (inj1 >= 0)).flatten().float()
    hbins = (fam["r0"] - inj1).clamp(0, bins - 1).flatten().long()
    open_scr = resident.new_scratch(G, dev)
    st0, kind0 = fam["states"][0], fam["kinds"][0]
    out = dict(
        round_open=dict(
            err=err, **times(
                lambda: resident.round_open(open_scr, st0, kind0, cur, G, n_prop, leader,
                                            True, True, fam["r0"]),
                lambda: resident._round_open_plain(open_scr, st0, kind0, cur, G, n_prop,
                                                   leader, True, True, fam["r0"])),
            library_what="none",
            bytes=B * Mp * 4 + 3 * G * 4 * 2,
            ops=B * Mp * 2,  # a compare and an add per pending row
            shapes=f"pending kind [{B},{Mp}], cursors [{B}] -> scratch [{3 * G}+acc]"),
        round_close=dict(
            err=err, ms=head["ms"], host_ms=head["host_ms"], plain_ms=plain_ms,
            library_ms=cuda_ms(lambda: torch.bincount(hbins, weights=wts, minlength=bins)),
            unfused_ms=head["unfused_ms"], bytes=head["bytes"], ops=head["ops"],
            library_what="torch.bincount with weights: the histogram part only, "
                         "host-issued",
            chain_rounds=K9_ROUNDS, touched_bins=touched, cases=cases,
            shapes=f"ring [{G},{W}], {per_round} slots a group a round, histogram "
                   f"[{bins}], telemetry ring [8,9], next round's pending kind "
                   f"[{B},{Mp}]; fused with the next round's open, one_bin"))
    return out


def compare_loop_kernels(dev, g, sh: Shapes, seed: int) -> dict:
    """K8 (the round's PROPOSE rows), K9 (the round's bookkeeping) and
    K10 (both slot-write forms) against their plain twins at the path's
    shapes, on adversarial inputs; K8 and K9 only on the resident paths."""
    from minpaxos_tpu_torch.models.minpaxos import MsgBatch
    from minpaxos_tpu_torch.ops import winner
    from minpaxos_tpu_torch.ops import workload as wl

    G, R = sh.groups, sh.replicas
    B = sh.batch or G * R
    M, S = sh.M, sh.S

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, device=dev, dtype=torch.int32, generator=g)

    def rb(p, shape):
        return torch.rand(shape, device=dev, generator=g) < p

    res = {}
    if sh.routed:
        # K8: the deployment's rows (MinPaxos: p = ext to the leader;
        # Mencius: p = ext to every owner), a round where cmd_id wraps in
        # int32, and a hot-key batch; the numpy twin too
        ext, count, leader, ks = ((EXT, P, 0, KEY_SPACE) if sh.path == "minpaxos"
                                  else (M_EXT, M_P, -1, M_KEY_SPACE))
        err = 0.0
        for rnd, hot in ((7, 0), (2 ** 31 // ext + 1, 0), (3, 30)):
            args = (R, G, ext, count, leader, rnd, 11, ks, hot, 8)
            got = wl.propose_batch(*args, device=dev)
            err = max(err, max_abs_err(tuple(got), tuple(wl._propose_rows_plain(*args, dev))))
            host = wl.propose_batch_host(*args)
            err = max(err, max_abs_err(tuple(got), tuple(torch.from_numpy(x).to(dev)
                                                         for x in host)))
        args = (R, G, ext, count, leader, 7, 11, ks, 0, 8)
        res["propose_rows"] = dict(
            err=err, **times(lambda: wl.propose_batch(*args, device=dev),
                             lambda: wl._propose_rows_plain(*args, dev)),
            library_what="none: no PyTorch call computes Threefry-2x32",
            bytes=12 * B * ext * 4,
            # three Threefry-2x32 of ~110 integer operations per (group,
            # row) and a select per written word
            ops=G * ext * 330 + 12 * B * ext,
            shapes=f"[12,{B},{ext}] rows, {count} live per replica, hot_pct 0 / 30")

        res.update(compare_k9(dev, sh, seed, leader, count))

    # K10: slot_write (fused writes A and B) and gather_rows (Mencius's
    # writes) on adversarial inboxes: many rows on four slots in both
    # sections, targets outside the window, sections mixed (keys at
    # M + row), op values above 255, statuses around COMMITTED
    hot = ri(0, S, (B, 4))
    tgt = torch.where(rb(0.5, (B, M)), torch.gather(hot, 1, ri(0, 4, (B, M)).long()),
                      ri(-3, S + 5, (B, M)))
    sec, ok = rb(0.5, (B, M)), rb(0.7, (B, M))
    inbox = MsgBatch(*[ri(-2, 300, (B, M)) for _ in range(12)])
    old = [ri(-1, 1 << 20, (B, S)) for _ in winner.SLOT_COLS]
    old[1] = torch.tensor([0, 2, 3, 4, 5], dtype=torch.uint8, device=dev)[ri(0, 5, (B, S)).long()]
    old[2] = ri(0, 4, (B, S)).to(torch.uint8)
    old = tuple(old)
    me, dball = ri(0, R, (B,)), ri(0, 99, (B,))
    err = 0.0
    for modes, cb in ((winner.WRITE_A, None), (winner.WRITE_B, dball)):
        err = max(err, max_abs_err(
            winner.slot_write(modes, S, tgt, sec, ok, inbox, old, me, cb, n_replicas=R),
            winner._slot_write_plain(modes, S, tgt, sec, ok, inbox, old, me, cb, R)))
    keyval = torch.where(sec, M + torch.arange(M, device=dev, dtype=torch.int32), torch.arange(
        M, device=dev, dtype=torch.int32))
    hits = int((winner._scatter_max_plain(S, tgt, keyval, ok, -1)[:, :S] >= 0).sum().item())
    tidx = winner._targets(S, tgt, ok).long()
    in_cols = [getattr(inbox, f) for f in winner.IN_COLS]

    def lib_sw():
        k = torch.full((B, S + 1), -1, dtype=torch.int32, device=dev).scatter_reduce_(
            1, tidx, keyval, reduce="amax", include_self=True)
        rw = torch.remainder(k[:, :S], M).long()
        return [torch.gather(c, 1, rw) for c in in_cols]

    slot_bytes = 8 * 4 + 2  # eight int32 and two uint8 columns per slot
    res["slot_write"] = dict(
        err=err, **times(
            lambda: winner.slot_write(winner.WRITE_A, S, tgt, sec, ok, inbox, old, me,
                                      n_replicas=R),
            lambda: winner._slot_write_plain(winner.WRITE_A, S, tgt, sec, ok, inbox, old,
                                             me, None, R), lib_sw),
        library_what="scatter_reduce_ (amax) + one gather per inbox column "
                     "(a composition, no select)",
        hit_slots=hits,
        bytes=B * S * 2 * slot_bytes + B * M * 6 + hits * 9 * 4,
        ops=B * M * 3 + B * S * 12,
        shapes=f"inbox [{B},{M}] x 9 cols, window [{B},{S}] x 10 cols (write A)")
    win, whit = winner.slot_winner(S, torch.where(ok, tgt, S), ok)
    err = 0.0
    for mode in (winner.SlotMode(winner.BAL_ROW, winner.ST_ACCEPTED, winner.V_KEEP),
                 winner.SlotMode(winner.BAL_ROW, winner.ST_COMMIT, winner.V_KEEP),
                 winner.SlotMode(winner.BAL_ROW, winner.ST_ACCEPTED, winner.V_ME),
                 winner.SlotMode(winner.BAL_CONST, winner.ST_ACCEPTED, winner.V_ME)):
        err = max(err, max_abs_err(
            winner.gather_rows(mode, win, whit, inbox, old, me, n_replicas=R),
            winner._gather_rows_plain(mode, win, whit, inbox, old, me, None, R)))
    mode = winner.SlotMode(winner.BAL_ROW, winner.ST_ACCEPTED, winner.V_KEEP)
    err = max(err, repeat_err(
        lambda: winner.gather_rows(mode, win, whit, inbox, old, me, n_replicas=R),
        winner._gather_rows_plain(mode, win, whit, inbox, old, me, None, R)))
    wr = win.clamp(min=0).long()
    hits = int(whit.sum().item())
    res["gather_rows"] = dict(
        err=err, **times(
            lambda: winner.gather_rows(mode, win, whit, inbox, old, me, n_replicas=R),
            lambda: winner._gather_rows_plain(mode, win, whit, inbox, old, me, None, R),
            lambda: [torch.gather(c, 1, wr) for c in in_cols[:8]]),
        library_what="one gather per inbox column (no select)",
        hit_slots=hits,
        bytes=B * S * (4 + 1) + B * S * 2 * (slot_bytes - 4) + hits * 8 * 4,
        ops=B * S * 11,
        shapes=f"win/hit [{B},{S}], inbox [{B},{M}] x 8 cols -> window [{B},{S}] x 9 cols "
               f"(Mencius write_rows)")
    return res


def tcp_cfg(n_replicas: int = TCP_N):
    """The replica servers' MinPaxosConfig at TCP_SHAPE (cli/server.py's
    construction with its defaults)."""
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig

    return MinPaxosConfig(n_replicas=n_replicas, window=TCP_W, inbox=TCP_INBOX,
                          exec_batch=TCP_E, kv_pow2=TCP_KV_POW2, catchup_rows=TCP_CU,
                          recovery_rows=TCP_REC, gossip_ticks=4, noop_delay=50)


def _exchange(dev, cfg, seed: int, steps: int, per_step: int):
    """A three-replica MinPaxos exchange at ``cfg`` on the card: replica
    0 leads (prepared at ballot 16), takes ``per_step`` seeded PUTs per
    step, and rows route between the replicas as the transport delivers
    them. Yields (state, outbox, exec result) after every step."""
    from minpaxos_tpu_torch.models import minpaxos as tmp
    from minpaxos_tpu_torch.wire.messages import MsgKind, Op

    r, m = cfg.n_replicas, cfg.inbox
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    st = tmp.init_replica(cfg, list(range(r)), device=dev)._replace(
        default_ballot=torch.full((r,), 16, dtype=torch.int32, device=dev),
        max_recv_ballot=torch.full((r,), 16, dtype=torch.int32, device=dev),
        leader_id=torch.zeros(r, dtype=torch.int32, device=dev),
        prepared=torch.arange(r, device=dev) == 0,
        prepare_oks=torch.ones((r, r), dtype=torch.bool, device=dev))
    st, ob, ex = tmp.replica_step_impl(cfg, st, tmp.MsgBatch.empty(r, m, dev))
    for it in range(steps):
        prev = st
        cols = torch.zeros((12, r, m), dtype=torch.int32, device=dev)
        stacked = torch.stack(list(ob.msgs))
        for q in range(r):
            rows = [stacked[:, s_, (ob.msgs.kind[s_] != 0)
                            & ((ob.dst[s_] == q) | (ob.dst[s_] == -1))]
                    for s_ in range(r) if s_ != q]
            if q == 0:
                p = torch.zeros((12, per_step), dtype=torch.int32, device=dev)
                p[0], p[1], p[5] = int(MsgKind.PROPOSE), -1, int(Op.PUT)
                p[7] = torch.randint(0, 100000, (per_step,), device=dev,
                                     dtype=torch.int32, generator=g)
                p[9] = torch.randint(1, 1 << 20, (per_step,), device=dev,
                                     dtype=torch.int32, generator=g)
                p[10] = per_step * it + torch.arange(per_step, device=dev)
                p[11] = 7
                rows.append(p)
            x = torch.cat(rows, 1)[:, :m]
            cols[:, q, :x.shape[1]] = x
        inbox = tmp.MsgBatch(*cols.unbind(0))
        st, ob, ex = tmp.replica_step_impl(cfg, st, inbox)
        yield prev, inbox, st, ob, ex


def _row_of(t, r):
    return type(t)(*[_row_of(x, r) if isinstance(x, tuple) else x[r:r + 1]
                     for x in t])


def dispatch_profile(cfg, state, inbox, n: int = 10) -> dict:
    """One replica server's dispatch (runtime/replica.py _packed_step:
    the step and K7, k = 1) on ``inbox``, each from a fresh copy of
    ``state``, n times under torch.profiler: device busy ms and CUDA
    kernel launches per dispatch (the profiler's device events) and the
    host wall per dispatch (to a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    from minpaxos_tpu_torch.models.minpaxos import replica_step_impl
    from minpaxos_tpu_torch.runtime.replica import _packed_step

    def copy(t):
        return type(t)(*[copy(x) if isinstance(x, tuple) else x.clone() for x in t])

    buf = {}

    def alloc(k, b, w):
        if (k, b, w) not in buf:
            buf[(k, b, w)] = torch.empty((k, b, w), dtype=torch.int32, device=inbox.kind.device)
        return buf[(k, b, w)]

    for _ in range(3):
        _packed_step(cfg, copy(state), inbox, replica_step_impl, 1, alloc=alloc)
    states = [copy(state) for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s_ in states:
            _packed_step(cfg, s_, inbox, replica_step_impl, 1, alloc=alloc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    return dict(dispatch_device_ms=dev_us / 1e3 / n,
                dispatch_wall_ms_profiled=1e3 * wall / n,
                dispatch_kernel_launches=sum(e.count for e in events) / n,
                own_kernels_per_dispatch=own_kernels(events, n),
                scatter_vote_bits_in_place=scatter_in_place(prof, n),
                dispatch_inbox_rows=int((inbox.kind != 0).sum().item()))


def pack_bytes(st, ob, ex) -> int:
    """The bytes K7 must move for these inputs: each source column read
    once to its valid length (int32, or one byte), each scalar source
    once, the R peer commits, Mencius's status byte on the rows whose
    rel the data puts in the window, and the packed row written once."""
    from minpaxos_tpu_torch.ops import substeps

    b, m_out = ob.msgs.kind.shape
    e, r = ex.val_hi.shape[1], st.peer_commits.shape[1]
    cols = [*ob.msgs, ob.dst] + [getattr(ex, c) for c in substeps.EXEC_COLS]
    n = sum(c.numel() * c.element_size() for c in cols)
    n += b * min(ob.acked.shape[1], m_out) * ob.acked.element_size()
    men = not hasattr(st, "leader_id")
    scal = [st.committed_upto, st.window_base, st.crt_inst, st.kv.dropped, ex.lo,
            ex.count, st.executed_upto, st.me] + (
        [st.commit_sent, st.tk_anchor, st.crt_own] if men
        else [st.leader_id, st.prepared, st.gossip_upto])
    n += sum(t.numel() * t.element_size() for t in scal) + b * r * 4
    if men:
        nxt = st.commit_sent + 1
        rel = nxt + torch.remainder(st.me - nxt, r) - st.window_base
        n += int(((rel >= 0) & (rel < st.status.shape[1])).sum().item())
    return n + 4 * b * substeps.row_width(m_out, e, r)


# K7's batch compare: B = 1,280 replicas, outbox and inbox rows of the
# MinPaxos path's inbox (M = 2,176, M_in = 1,664), S = 4,096, E = 512
PACK_B, PACK_MO, PACK_MI = 1280, INBOX + EXT, INBOX


def compare_pack(dev, seed: int) -> tuple[dict, dict, tuple]:
    """K7 against its plain twin at one replica server's shapes (the
    leader's row of a live exchange at TCP_SHAPE): device ms by graph
    replay, host-issued ms, the plain twin's and torch.cat's, and
    floor_ms, a one-element int32 zero_() in a graph, the least a
    launch takes there. Where the package has ops/substeps.py
    pack_cases (an older tree that profile_ab.py compares may not), at
    B = 1,280 on its cases (both anchor forms and the Mencius edge
    rows), each compared, the two forms timed beside their bytes.
    Returns (the K7 row, the batch errors and, under ``_calls``, each
    compared call with its plain result, and the dispatch probe: the
    config, the leader's state before the step and its inbox)."""
    from minpaxos_tpu_torch.ops import substeps

    cfg = tcp_cfg()
    best = None
    for prev, inbox, st, ob, ex in _exchange(dev, cfg, seed, 6, TCP_BATCH):
        if best is None or int(ex.count[0]) >= int(best[2].count[0]):
            best = (_row_of(st, 0), _row_of(ob, 0), _row_of(ex, 0),
                    _row_of(prev, 0), _row_of(inbox, 0))
    st, ob, ex, prev, inbox = best
    out = torch.empty((1, substeps.row_width(ob.msgs.kind.shape[1], TCP_E, TCP_N)),
                      dtype=torch.int32, device=dev)
    pk = lambda: substeps.pack_outputs(st, ob, ex, out)  # noqa: E731
    pp = lambda: substeps._pack_plain(st, ob, ex, torch.empty_like(out), st.window_base)  # noqa: E731
    # one PyTorch call for the same function: torch.cat of the pre-cast columns
    m_out, m_in = ob.msgs.kind.shape[1], ob.acked.shape[1]
    ack = torch.zeros((1, m_out), dtype=torch.int32, device=dev)
    ack[:, :m_in] = ob.acked.to(torch.int32)
    pre = ([c.to(torch.int32) for c in ob.msgs] + [ob.dst.to(torch.int32), ack]
           + [getattr(ex, c).to(torch.int32) for c in substeps.EXEC_COLS]
           + [torch.stack([x.to(torch.int32) for x in substeps._scalar_columns(
               st, ex, st.window_base)], 1), st.peer_commits])
    lib = lambda: torch.cat(pre, 1)  # noqa: E731
    want = pp()
    err = max_abs_err(pk().clone(), want)
    w = out.shape[1]
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    row = dict(err=err, **times(pk, pp, lib), floor_ms=graph_ms(one.zero_),
               bytes=pack_bytes(st, ob, ex),
               ops=w + 64,  # one move per output word; the anchor arithmetic
               executed_in_row=int(ex.count[0]),
               shapes=f"outbox [1,{m_out}] x 14, exec [1,{TCP_E}] x 6, scalars "
                      f"-> packed row [1,{w}]")
    errs = {"_calls": {"tcp": (pk, want)}}
    if hasattr(substeps, "pack_cases"):
        rng = np.random.default_rng(seed + 1)
        mo, e = PACK_MO, P
        for name, c in substeps.pack_cases(rng, PACK_B, W, R, mo, PACK_MI, e).items():
            stb, obb, exb = substeps.pack_case_tensors(c, dev)
            outb = torch.empty((PACK_B, substeps.row_width(mo, e, R)), dtype=torch.int32,
                               device=dev)
            fn = lambda a=(stb, obb, exb, outb): substeps.pack_outputs(*a)  # noqa: E731
            wb = substeps._pack_plain(stb, obb, exb, torch.empty_like(outb), stb.window_base)
            errs[f"pack_outputs_batch_{name}"] = max_abs_err(fn().clone(), wb)
            errs["_calls"][f"batch_{name}"] = (fn, wb)
            if name in ("minpaxos", "mencius"):
                row[f"batch_ms_{name}"] = graph_ms(fn)
                row[f"batch_bytes_{name}"] = pack_bytes(stb, obb, exb)
                row[f"batch_bound_ms_{name}"] = 1e3 * row[f"batch_bytes_{name}"] / HBM_BYTES_PER_S
    return row, errs, (cfg, prev, inbox)


def pack_interleaved(calls: dict, rounds: int = 10) -> float:
    """K7 over ``rounds`` rounds of the compared calls in turns, the
    layout cache emptied before every other round so hits and misses
    alternate: the largest difference from the plain results."""
    from minpaxos_tpu_torch.ops import substeps

    err = 0.0
    for rnd in range(rounds):
        if rnd % 2 == 0:
            substeps._launch.layouts.clear()
        for fn, want in calls.values():
            err = max(err, max_abs_err(fn(), want))
    return err


def _mencius_exchange(dev, cfg, seed: int, steps: int, per_step: int):
    """Three Mencius owners at ``cfg`` on the card, each taking
    ``per_step`` seeded PUTs into its own slots every step, rows routed
    between them as the transport delivers them. Yields (state, outbox,
    exec result) after every step."""
    from minpaxos_tpu_torch.models import mencius as mm
    from minpaxos_tpu_torch.models.minpaxos import MsgBatch
    from minpaxos_tpu_torch.wire.messages import MsgKind, Op

    r, m = cfg.n_replicas, cfg.inbox
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    st = mm.init_mencius(cfg, list(range(r)), device=dev)
    st, ob, ex = mm.mencius_step_impl(cfg, st, MsgBatch.empty(r, m, dev))
    for it in range(steps):
        cols = torch.zeros((12, r, m), dtype=torch.int32, device=dev)
        stacked = torch.stack(list(ob.msgs))
        for q in range(r):
            rows = [stacked[:, s_, (ob.msgs.kind[s_] != 0)
                            & ((ob.dst[s_] == q) | (ob.dst[s_] == -1))]
                    for s_ in range(r) if s_ != q]
            p = torch.zeros((12, per_step), dtype=torch.int32, device=dev)
            p[0], p[1], p[5] = int(MsgKind.PROPOSE), -1, int(Op.PUT)
            p[7] = torch.randint(0, 100000, (per_step,), device=dev,
                                 dtype=torch.int32, generator=g)
            p[9] = torch.randint(1, 1 << 20, (per_step,), device=dev,
                                 dtype=torch.int32, generator=g)
            p[10] = per_step * (r * it + q) + torch.arange(per_step, device=dev)
            p[11] = 7
            rows.append(p)
            x = torch.cat(rows, 1)[:, :m]
            cols[:, q, :x.shape[1]] = x
        st, ob, ex = mm.mencius_step_impl(cfg, st, MsgBatch(*cols.unbind(0)))
        yield st, ob, ex


def pack_row(dev, st, ob, ex, e: int, r: int, what: str = "") -> dict:
    """K7 against its plain twin on one replica server's outputs (state,
    outbox, exec result of a live exchange), held over repeated
    launches, timed beside the plain twin and torch.cat of the pre-cast
    columns."""
    from minpaxos_tpu_torch.ops import substeps

    m_out = ob.msgs.kind.shape[1]
    out = torch.empty((1, substeps.row_width(m_out, e, r)), dtype=torch.int32, device=dev)
    pk = lambda: substeps.pack_outputs(st, ob, ex, out)  # noqa: E731
    pp = lambda: substeps._pack_plain(st, ob, ex, torch.empty_like(out), st.window_base)  # noqa: E731
    m_in = ob.acked.shape[1]
    ack = torch.zeros((1, m_out), dtype=torch.int32, device=dev)
    ack[:, :m_in] = ob.acked.to(torch.int32)
    pre = ([c.to(torch.int32) for c in ob.msgs] + [ob.dst.to(torch.int32), ack]
           + [getattr(ex, c).to(torch.int32) for c in substeps.EXEC_COLS]
           + [torch.stack([x.to(torch.int32) for x in substeps._scalar_columns(
               st, ex, st.window_base)], 1), st.peer_commits])
    want = pp()
    err = max(max_abs_err(pk().clone(), want), repeat_err(lambda: pk().clone(), want))
    w = out.shape[1]
    return dict(err=err, **times(pk, pp, lambda: torch.cat(pre, 1)),
                bytes=pack_bytes(st, ob, ex), ops=w + 64,
                executed_in_row=int(ex.count[0]),
                shapes=f"{what}outbox [1,{m_out}] x 14, exec [1,{e}] x 6, "
                       f"scalars -> packed row [1,{w}]")


def compare_pack_mencius(dev, seed: int) -> dict:
    """K7's Mencius form (``pack_row``) at one Mencius replica server's
    shapes: the outputs of the owner that executed most in a live
    exchange at TCP_SHAPE (three owners, a third of a client batch each
    a step)."""
    best = None
    for st, ob, ex in _mencius_exchange(dev, tcp_cfg(), seed, 8, TCP_BATCH // TCP_N):
        for r in range(TCP_N):
            if best is None or int(ex.count[r]) >= int(best[2].count[0]):
                best = (_row_of(st, r), _row_of(ob, r), _row_of(ex, r))
    m_out = best[1].msgs.kind.shape[1]
    assert m_out == PATHS["tcp_mencius"].m_out, (m_out, PATHS["tcp_mencius"].m_out)
    return pack_row(dev, *best, TCP_E, TCP_N, "Mencius ")


def compare_pack_chaos(dev, seed: int) -> dict:
    """K7 (``pack_row``) at one chaos campaign server's shapes
    (``chaos/campaign.py campaign_config``): the leader's outputs of a
    live three-replica exchange at that config, the client's batches of
    64 PUTs a step."""
    from minpaxos_tpu_torch.chaos.campaign import campaign_config

    best = None
    for _prev, _inbox, st, ob, ex in _exchange(dev, campaign_config(CH_N), seed, 6, 64):
        if best is None or int(ex.count[0]) >= int(best[2].count[0]):
            best = (_row_of(st, 0), _row_of(ob, 0), _row_of(ex, 0))
    m_out = best[1].msgs.kind.shape[1]
    assert m_out == PATHS["chaos"].m_out, (m_out, PATHS["chaos"].m_out)
    return pack_row(dev, *best, CH_E, CH_N)


def compare_tcp(dev, seed: int) -> tuple[dict, dict]:
    """K7 (``compare_pack``, then over its calls in turns,
    ``pack_interleaved``); K4 insert on 2^18-way tables 90% full; K5
    vote bits with five replicas and K6 at the server's default window
    (16,384 slots), timed, also on ``exec_cases``' windows.
    Returns (the pack_outputs row, the extra checks, and under
    ``_dispatch_probe`` the leader's state and real inbox of that
    exchange for ``dispatch_profile``)."""
    from minpaxos_tpu_torch.ops import ackruns, mencius_exec
    from minpaxos_tpu_torch.ops import kvstore as kvs

    row, extra, probe = compare_pack(dev, seed)
    extra["pack_outputs_interleaved"] = pack_interleaved(extra.pop("_calls"))
    extra["_dispatch_probe"] = probe
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, device=dev, dtype=torch.int32, generator=g)

    # K4 insert on 2^18-way tables 90% full: rows overflow, displace, drop
    C = 1 << TCP_KV_POW2
    kv = kvs.kv_init(TCP_KV_POW2, 2, dev)
    n_fill = int(0.9 * C)
    fill = torch.unique(ri(0, 1 << 30, (n_fill + n_fill // 8,)))[:n_fill]
    fill = fill[None].expand(2, -1).contiguous()
    kv = kvs._kv_insert_plain(kv, torch.zeros_like(fill), fill,
                              torch.ones(fill.shape + (2,), dtype=torch.int32, device=dev),
                              torch.zeros_like(fill, dtype=torch.bool),
                              torch.ones_like(fill, dtype=torch.bool))
    lo = torch.unique(ri(0, 1 << 30, (TCP_E,)))[None].expand(2, -1).contiguous()
    args = (torch.zeros_like(lo), lo, ri(0, 1 << 30, lo.shape + (2,)),
            ri(0, 20, lo.shape) == 0, ri(0, 20, lo.shape) != 0)
    pre = kvs.KVState(*[t.clone() for t in kv])
    want = kvs._kv_insert_plain(pre, *args)
    got = kvs.kv_insert_unique(kv, *args)
    extra["kv_insert_2^18_at_0.9_load"] = max(max_abs_err(a, b) for a, b in zip(got, want))
    extra["kv_insert_2^18_at_0.9_load_displaced"] = int(
        ((pre.slot == 1) & (got.slot == 1) & (pre.key_lo != got.key_lo)).sum().item())
    del kv, pre, want, got
    # K5 vote bits with five replicas at the server's default window
    Sd, Md = 16384, 4096
    for d in (1, R):
        src = ri(0, R, (4, Md))
        wb = ri(0, 1 << 20, (4,))
        inst = wb[:, None] + ri(-300, Sd + 300, (4, Md))
        cnt = ri(0, 3000, (4, Md))
        okv = ri(0, 10, (4, Md)) < 3
        votes = ri(0, 1 << R, (4, Sd))
        vb_args = (okv, src, inst, cnt, wb)
        vb_k = lambda a=vb_args, v=votes, d=d: ackruns.range_vote_bits(  # noqa: E731
            *a, Sd, R, stride=d, into=v)
        want = ackruns._vote_bits_plain(*vb_args, Sd, R, d, votes, None)
        extra[f"vote_bits_R5_S16384_stride{d}"] = max(max_abs_err(vb_k(), want),
                                                      repeat_err(vb_k, want))
        extra[f"vote_bits_R5_S16384_stride{d}_ms"] = graph_ms(vb_k)
    # K6 at the server's default window
    code = torch.multinomial(torch.tensor([0.02, 0.1, 0.5, 0.2, 0.0, 0.18], device=dev),
                             8 * Sd, replacement=True, generator=g).view(8, Sd)
    x_status = torch.tensor([0, 3, 4, 4, 4, 5], device=dev, dtype=torch.uint8)[code]
    x_wb = ri(0, 1 << 20, (8,))
    x_eu = x_wb + ri(-1, Sd // 2, (8,))
    x_args = (torch.zeros((8, Sd), dtype=torch.int32, device=dev), ri(0, 8192, (8, Sd)),
              x_status, ri(0, 4, (8, Sd)).to(torch.uint8), x_status == 5, x_wb,
              x_eu + ri(-1, 2 * 512, (8,)), x_eu, 512)
    extra["exec_select_S16384"] = max_abs_err(mencius_exec.exec_select(*x_args),
                                              mencius_exec._exec_select_plain(*x_args))
    # its device ms and its bound from the data, beside the check
    extra["exec_select_S16384_ms"] = graph_ms(lambda: mencius_exec.exec_select(*x_args))
    extra["exec_select_S16384_bound_ms"] = 1e3 * exec_bytes(*x_args) / HBM_BYTES_PER_S
    for name, args in exec_cases(8, Sd, 512, seed, dev).items():
        extra[f"exec_select_S16384_{name}"] = max_abs_err(
            mencius_exec.exec_select(*args), mencius_exec._exec_select_plain(*args))
        extra[f"exec_select_S16384_{name}_ms"] = graph_ms(
            lambda a=args: mencius_exec.exec_select(*a))
    torch.cuda.synchronize()
    return row, extra

REPLACES = {
    "route": ("minpaxos_tpu_torch/kernels/csrc/route.cu",
              "minpaxos_tpu/ops/segscatter.py:45"),
    "scatter_max": ("minpaxos_tpu_torch/kernels/csrc/winner.cu",
                    "minpaxos_tpu/models/minpaxos.py:534"),
    "seg_scan_max": ("minpaxos_tpu_torch/kernels/csrc/scan.cu",
                     "minpaxos_tpu/ops/scan.py:21"),
    "commit_frontier": ("minpaxos_tpu_torch/kernels/csrc/scan.cu",
                        "minpaxos_tpu/ops/scan.py:50"),
    "advance_frontier": ("minpaxos_tpu_torch/kernels/csrc/scan.cu",
                         "minpaxos_tpu/models/minpaxos.py:900"),
    "kv_segments": ("minpaxos_tpu_torch/kernels/csrc/scan.cu",
                    "minpaxos_tpu/ops/kvstore.py:276"),
    "kv_lookup": ("minpaxos_tpu_torch/kernels/csrc/kvstore.cu",
                  "minpaxos_tpu/ops/kvstore.py:111"),
    "kv_insert": ("minpaxos_tpu_torch/kernels/csrc/kvstore.cu",
                  "minpaxos_tpu/ops/kvstore.py:138"),
    "ack_runs": ("minpaxos_tpu_torch/kernels/csrc/ackruns.cu",
                 "minpaxos_tpu/ops/ackruns.py:25"),
    "vote_bits": ("minpaxos_tpu_torch/kernels/csrc/ackruns.cu",
                  "minpaxos_tpu/ops/ackruns.py:64"),
    "scatter_vote_bits": ("minpaxos_tpu_torch/kernels/csrc/ackruns.cu",
                          "minpaxos_tpu/ops/ackruns.py:140"),
    "exec_select": ("minpaxos_tpu_torch/kernels/csrc/mencius_exec.cu",
                    "minpaxos_tpu/models/mencius.py:810"),
    "pack_outputs": ("minpaxos_tpu_torch/kernels/csrc/substeps.cu",
                     "minpaxos_tpu/ops/substeps.py:112"),
    "propose_rows": ("minpaxos_tpu_torch/kernels/csrc/workload.cu",
                     "minpaxos_tpu/ops/workload.py:106"),
    "round_open": ("minpaxos_tpu_torch/kernels/csrc/resident.cu",
                   "minpaxos_tpu/parallel/sharded.py:303"),
    "round_close": ("minpaxos_tpu_torch/kernels/csrc/resident.cu",
                    "minpaxos_tpu/parallel/sharded.py:336"),
    "slot_write": ("minpaxos_tpu_torch/kernels/csrc/slotwrite.cu",
                   "minpaxos_tpu/models/minpaxos.py:546"),
    "gather_rows": ("minpaxos_tpu_torch/kernels/csrc/slotwrite.cu",
                    "minpaxos_tpu/ops/winner.py:40"),
}


# ---------------------------------------------------------------- phase 4

def own_kernels(events, n: int) -> dict:
    """The port's own kernels (names starting mp_) among the profiler's
    device events: device ms and launches per round (or dispatch) over
    ``n`` of them, by kernel name without its parameter list."""
    out = {}
    for e in events:
        name = e.key.removeprefix("void ").split("(")[0]
        if name.startswith("mp_"):
            ms, k = out.get(name, (0.0, 0))
            out[name] = (ms + getattr(e, "self_device_time_total", 0) / 1e3 / n,
                         k + e.count / n)
    return {k: dict(ms=ms, launches=c) for k, (ms, c) in sorted(out.items())}


def scatter_in_place(prof, n: int) -> dict:
    """K5 scatter_vote_bits in place, per round over ``n`` rounds, from
    the profiler's device events in stream order: the kernel, a memset
    launched just before it and an int32 bitwise OR just after it (a
    form that zero-fills its delta and leaves the OR into pvotes to an
    eager op pays both; the fused form neither)."""
    evs = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                 key=lambda e: e.time_range.start)

    def us(e):
        return e.time_range.end - e.time_range.start

    k = m = o = 0.0
    count = 0
    for i, e in enumerate(evs):
        if e.name.removeprefix("void ").startswith("mp_scatter_vote_bits_k"):
            count += 1
            k += us(e)
            if i > 0 and "Memset" in evs[i - 1].name:
                m += us(evs[i - 1])
            if i + 1 < len(evs) and "BitwiseOrFunctor<int>" in evs[i + 1].name:
                o += us(evs[i + 1])
    return dict(launches=count / n, kernel_ms=k / 1e3 / n, memset_ms=m / 1e3 / n,
                eager_or_ms=o / 1e3 / n, total_ms=(k + m + o) / 1e3 / n)


def profile_rounds(sc, rounds: int, p: int, out_dir: str, tag: str) -> dict:
    """torch.profiler over ``rounds`` steady rounds of the resident loop
    at ``p`` proposals: device time by kernel name and the device busy
    share of the wall time. Writes the Chrome trace and the table under
    ``out_dir``, file names prefixed with ``tag``."""
    from torch.profiler import ProfilerActivity, profile

    sc.begin_resident(telemetry_rounds=rounds + 2)
    sc.run_resident(2, p)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sc.run_resident(rounds, p)
        wall = time.perf_counter() - t0
    sc.end_resident()
    # kernel-level events only (a CPU op's device time repeats its kernels')
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0) for e in events}
    total_us = sum(dev_us.values())
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:25]
    own = own_kernels(events, rounds)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_round_trace.json"))
    with open(os.path.join(out_dir, f"{tag}_round_table.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return dict(phase="profile", path=tag, rounds=rounds, wall_ms_per_round=1e3 * wall / rounds,
                device_ms_per_round=total_us / 1e3 / rounds,
                kernel_launches_per_round=sum(e.count for e in events) / rounds,
                device_busy_share=(total_us / 1e6) / wall if wall else None,
                top_kernels_ms_per_round={k: v / 1e3 / rounds for k, v in top},
                own_kernels_per_round=own,
                scatter_vote_bits_in_place=scatter_in_place(prof, rounds))


def read_back(sc, dev, seed: int, round0: int, rounds: int, p: int, ext: int,
              key_space: int) -> tuple[int, int, int]:
    """Every acknowledged write of every group read back, with its last
    value, from all of the group's replicas (K4's probe): the host
    replays each group's Threefry PUT stream (rows [0, p) of each
    round's ``ext`` lanes) and keeps each key's last write. Returns
    (keys checked, absent, wrong)."""
    from minpaxos_tpu_torch.ops.kvstore import kv_lookup_lanes
    from minpaxos_tpu_torch.ops.workload import workload_lanes_host

    g, r = sc.ss.alive.shape
    stream_k = np.empty((g, rounds * p), np.int32)
    stream_v = np.empty_like(stream_k)
    for j, rnd in enumerate(range(round0, round0 + rounds)):
        keys, vals = workload_lanes_host(g, ext, rnd, seed, key_space)
        stream_k[:, j * p:(j + 1) * p] = keys[:, :p]
        stream_v[:, j * p:(j + 1) * p] = vals[:, :p]
    want_k = np.zeros((g, key_space), np.int32)
    want_v = np.zeros_like(want_k)
    want_ok = np.zeros((g, key_space), bool)
    for gi in range(g):
        # first occurrence in the reversed stream = the key's last write
        k, at = np.unique(stream_k[gi, ::-1], return_index=True)
        want_k[gi, :len(k)] = k
        want_v[gi, :len(k)] = stream_v[gi, ::-1][at]
        want_ok[gi, :len(k)] = True

    def per_replica(x):
        return torch.from_numpy(np.repeat(x, r, axis=0)).to(dev)

    found, v = kv_lookup_lanes(sc.ss.states.kv, torch.zeros_like(per_replica(want_k)),
                               per_replica(want_k), per_replica(want_ok))
    ok_r = np.repeat(want_ok, r, axis=0)
    found = found.cpu().numpy()
    v = v.cpu().numpy()
    absent = int((ok_r & ~found).sum())
    wrong = int((ok_r & found & ((v[..., 0] != 0)
                                 | (v[..., 1] != np.repeat(want_v, r, axis=0)))).sum())
    return int(ok_r.sum()), absent, wrong


def latency_stats(hist: np.ndarray):
    """(count, p50, p99) of the resident loop's round-latency histogram."""
    n = int(hist.sum())
    cdf = np.cumsum(hist)
    p50 = int(np.searchsorted(cdf, 0.5 * n) + 1) if n else None
    p99 = int(np.searchsorted(cdf, 0.99 * n) + 1) if n else None
    return n, p50, p99


def settle(sc, rounds: int = 4):
    """Step with no proposals until every replica of every group agrees
    on committed_upto and has executed through it (followers learn the
    last commits a round late); returns (rounds stepped, agree)."""
    g, r = sc.ss.alive.shape

    def agree():
        upto = sc.ss.states.committed_upto.view(g, r)
        exe = sc.ss.states.executed_upto.view(g, r)
        return bool((upto == upto[:, :1]).all()) and bool((exe == upto).all())

    n = 0
    while n < rounds and not agree():
        sc.step(0)
        n += 1
    return n, agree()


def telemetry_summary(tel: np.ndarray, rounds_run: int, committed_gain: int,
                      injected: int) -> tuple[dict, list]:
    """The telemetry ring's readback against the run: the fields the
    resident lines print, and the checks that failed (rows written ==
    rounds run since arming, committed_delta sums to the committed
    count gained, the last row's in_flight is 0 after the drain,
    injected_rows sums to the injected count)."""
    from minpaxos_tpu_torch.obs import recorder as rc

    rec = dict(tel_rows_written=len(tel),
               tel_committed_sum=int(tel[:, rc.TEL_COMMITTED].sum()) if len(tel) else 0,
               tel_injected_sum=int(tel[:, rc.TEL_INJECTED].sum()) if len(tel) else 0,
               tel_last_in_flight=int(tel[-1, rc.TEL_IN_FLIGHT]) if len(tel) else None,
               tel_max_inbox_hwm=int(tel[:, rc.TEL_INBOX_HWM].max()) if len(tel) else None,
               tel_prepared_shards_last=int(tel[-1, rc.TEL_PREPARED]) if len(tel) else None)
    bad = []
    if rec["tel_rows_written"] != rounds_run:
        bad.append(f"telemetry rows {rec['tel_rows_written']} != rounds run {rounds_run}")
    if rec["tel_committed_sum"] != committed_gain:
        bad.append(f"telemetry committed {rec['tel_committed_sum']} != gained {committed_gain}")
    if rec["tel_last_in_flight"] != 0:
        bad.append(f"telemetry's last in_flight is {rec['tel_last_in_flight']}")
    if rec["tel_injected_sum"] != injected:
        bad.append(f"telemetry injected {rec['tel_injected_sum']} != injected {injected}")
    return rec, bad


def k9_per_dispatch(launches: dict, n_dispatches: int) -> float:
    """K9's launches (round_open + round_close) per k-round dispatch:
    k + 1 with the ring armed and substeps 1."""
    return (launches.get("round_open", 0) + launches.get("round_close", 0)) / n_dispatches


def main_path(dev, seed: int, dispatches: int, profile_dir: str | None = None) -> dict:
    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
    from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

    cfg = MinPaxosConfig(n_replicas=R, window=W, inbox=INBOX, exec_batch=P,
                         kv_pow2=KV_POW2, catchup_rows=CU_ROWS,
                         recovery_rows=REC_ROWS)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    sc = ShardedCluster(cfg, G, ext_rows=EXT, key_space=KEY_SPACE, seed=seed,
                        device=dev)
    sc.elect(0)
    committed0 = sc.committed()[0]
    # the telemetry ring armed as bench.py arms it: every round the run
    # can take (measured + the drain budget) fits
    sc.begin_resident(telemetry_rounds=(dispatches + MAX_DRAIN) * K_ROUNDS)
    round0 = sc._seed
    # dispatch 1 warms the allocator; the rate is taken over the rest
    marks = []
    for _ in range(dispatches):
        committed, in_flight = sc.run_resident(K_ROUNDS, P)
        marks.append((time.perf_counter(), committed))
    t_meas = marks[-1][0] - marks[0][0]
    measured_rounds = dispatches * K_ROUNDS
    steady_rounds = (dispatches - 1) * K_ROUNDS
    committed_measured = marks[-1][1] - marks[0][1]
    drain_dispatches = 0
    while in_flight and drain_dispatches < MAX_DRAIN:
        committed, in_flight = sc.run_resident(K_ROUNDS, 0)
        drain_dispatches += 1
    launches = K.launch_counts()
    tel = sc.resident_telemetry()
    hist = sc.end_resident()
    if in_flight:
        fail("mainpath", f"did not drain: in_flight={in_flight}")
    settled, agree = settle(sc)
    injected = G * P * measured_rounds
    tel_rec, tel_bad = telemetry_summary(
        tel, (dispatches + drain_dispatches) * K_ROUNDS, committed - committed0, injected)
    drops = sc.ss.states.kv.dropped.view(G, R).cpu().numpy()
    dropped = int(drops.sum())

    checked, absent, wrong = read_back(sc, dev, seed, round0, measured_rounds, P,
                                       EXT, KEY_SPACE)
    readback_ok = absent == 0 and wrong == 0 and checked > 0
    n, p50, p99 = latency_stats(hist)
    rec = dict(
        phase="mainpath", groups=G, replicas=R, window=W, proposals_per_round=P,
        rounds_per_dispatch=K_ROUNDS, measured_dispatches=dispatches,
        drain_dispatches=drain_dispatches, settle_rounds=settled,
        injected=injected, committed=committed, hist_count=n,
        latency_overflow=int(hist[-1]), replicas_agree=agree, kv_dropped=dropped,
        kv_inserts_dropped_replicas=int((drops > 0).sum()),
        readback_groups=G, readback_keys_checked=checked,
        readback_absent=absent, readback_wrong=wrong, readback_ok=readback_ok,
        ms_per_round=1e3 * t_meas / steady_rounds,
        rate_window_rounds=steady_rounds,
        committed_inst_per_s=committed_measured / t_meas,
        p50_latency_rounds=p50, p99_latency_rounds=p99,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        k9_launches_per_dispatch=k9_per_dispatch(launches, dispatches + drain_dispatches),
        **tel_rec, launches=launches)
    emit(rec)
    if tel_bad:
        fail("mainpath", "; ".join(tel_bad))
    if rec["k9_launches_per_dispatch"] != K_ROUNDS + 1:
        fail("mainpath", f"K9 launched {rec['k9_launches_per_dispatch']} times per "
                       f"dispatch, not once a round and once before the first step")
    if committed != injected:
        fail("mainpath", f"committed {committed} != injected {injected}")
    if n != committed:
        fail("mainpath", f"latency histogram counts {n}, committed {committed}")
    if not agree:
        fail("mainpath", "replicas disagree on committed_upto/executed_upto")
    if not readback_ok:
        fail("mainpath", f"read-back failed: {wrong} wrong values and {absent} "
                         f"absent keys among {checked} acknowledged writes")
    missing = [k for k in KERNELS["minpaxos"] if not launches.get(k)]
    if missing:
        fail("mainpath", f"kernels never launched on the main path: {missing}")
    # K4 lookup on the run's own tables: the compare case that looks
    # like the path
    path_case = lookup_path_case(sc.ss.states.kv, seed)
    emit(dict(phase="compare", path="minpaxos_resident_tables", card=nvidia_smi_line(),
              kernels={"kv_lookup": dict(cases={"path": path_case},
                                         equal=path_case["err"] == 0)}))
    if path_case["err"]:
        fail("compare", f"kv_lookup disagrees with its twin on the resident run's tables: "
                        f"{path_case['err']}")
    if profile_dir:
        emit(profile_rounds(sc, 4, P, profile_dir, "minpaxos"))
    return dict(rec, kv_lookup_path=path_case)


def mencius_path(dev, seed: int, dispatches: int, profile_dir: str | None = None) -> dict:
    """The Mencius deployment through ShardedCluster(protocol="mencius"):
    every owner of every group gets the round's p proposals (the same
    Threefry rows), k rounds per dispatch, then a drain; the same gates
    as the MinPaxos path. The read-back replays writes in round order,
    which is slot order only if every owner proposed exactly p rows in
    every round (owner r's round-t rows at slots [R*p*t, R*p*(t+1)));
    that is checked on the card after every dispatch through each
    owner's crt_own, not assumed."""
    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
    from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

    cfg = MinPaxosConfig(n_replicas=R, window=W, inbox=M_INBOX, exec_batch=M_E,
                         kv_pow2=M_KV_POW2, catchup_rows=M_CU,
                         recovery_rows=M_REC, noop_delay=M_NOOP)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    sc = ShardedCluster(cfg, G, ext_rows=M_EXT, key_space=M_KEY_SPACE, seed=seed,
                        device=dev, protocol="mencius")
    sc.begin_resident(telemetry_rounds=(dispatches + MAX_DRAIN) * K_ROUNDS)
    round0 = sc._seed
    owner = torch.arange(R, dtype=torch.int32, device=dev)
    aligned = True
    marks = []
    for d in range(dispatches):
        committed, in_flight = sc.run_resident(K_ROUNDS, M_P)
        marks.append((time.perf_counter(), committed))
        want_own = owner + R * M_P * K_ROUNDS * (d + 1)
        aligned &= bool((sc.ss.states.crt_own.view(G, R) == want_own).all())
    t_meas = marks[-1][0] - marks[0][0]
    measured_rounds = dispatches * K_ROUNDS
    steady_rounds = (dispatches - 1) * K_ROUNDS
    committed_measured = marks[-1][1] - marks[0][1]
    drain_dispatches = 0
    while in_flight and drain_dispatches < MAX_DRAIN:
        committed, in_flight = sc.run_resident(K_ROUNDS, 0)
        drain_dispatches += 1
    launches = K.launch_counts()
    tel = sc.resident_telemetry()
    hist = sc.end_resident()
    if in_flight:
        fail("mencius", f"did not drain: in_flight={in_flight}")
    settled, agree = settle(sc)
    injected = G * M_P * R * measured_rounds
    tel_rec, tel_bad = telemetry_summary(
        tel, (dispatches + drain_dispatches) * K_ROUNDS, committed, injected)
    # slots in the frontier that hold no proposal: skip-cede and takeover
    # no-op fills (none expected with every owner alive and aligned)
    noop_fills = committed - injected
    takeovers = int((sc.ss.states.tk_anchor >= 0).sum().item())
    drops = sc.ss.states.kv.dropped.view(G, R).cpu().numpy()
    dropped = int(drops.sum())
    checked, absent, wrong = read_back(sc, dev, seed, round0, measured_rounds, M_P,
                                       M_EXT, M_KEY_SPACE)
    readback_ok = absent == 0 and wrong == 0 and checked > 0
    n, p50, p99 = latency_stats(hist)
    rec = dict(
        phase="mencius", groups=G, owners=R, window=W, proposals_per_owner_per_round=M_P,
        rounds_per_dispatch=K_ROUNDS, measured_dispatches=dispatches,
        drain_dispatches=drain_dispatches, settle_rounds=settled,
        owners_aligned_every_dispatch=aligned, injected=injected, committed=committed,
        noop_fills=noop_fills, takeover_episodes=takeovers, hist_count=n,
        latency_overflow=int(hist[-1]), replicas_agree=agree, kv_dropped=dropped,
        readback_groups=G, readback_keys_checked=checked,
        readback_absent=absent, readback_wrong=wrong, readback_ok=readback_ok,
        ms_per_round=1e3 * t_meas / steady_rounds,
        rate_window_rounds=steady_rounds,
        committed_inst_per_s=committed_measured / t_meas,
        p50_latency_rounds=p50, p99_latency_rounds=p99,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        k9_launches_per_dispatch=k9_per_dispatch(launches, dispatches + drain_dispatches),
        **tel_rec, launches=launches)
    emit(rec)
    if tel_bad:
        fail("mencius", "; ".join(tel_bad))
    if rec["k9_launches_per_dispatch"] != K_ROUNDS + 1:
        fail("mencius", f"K9 launched {rec['k9_launches_per_dispatch']} times per "
                       f"dispatch, not once a round and once before the first step")
    if not aligned:
        fail("mencius", "an owner did not propose exactly p rows in every round")
    if committed != injected:
        fail("mencius", f"committed {committed} != injected {injected}")
    if n != committed:
        fail("mencius", f"latency histogram counts {n}, committed {committed}")
    if not agree:
        fail("mencius", "replicas disagree on committed_upto/executed_upto")
    if dropped:
        fail("mencius", f"{dropped} KV inserts dropped")
    if not readback_ok:
        fail("mencius", f"read-back failed: {wrong} wrong values and {absent} "
                        f"absent keys among {checked} acknowledged writes")
    missing = [k for k in KERNELS["mencius"] if not launches.get(k)]
    if missing:
        fail("mencius", f"kernels never launched on the Mencius path: {missing}")
    if profile_dir:
        emit(profile_rounds(sc, 4, M_P, profile_dir, "mencius"))
    return rec



def variants(dev, seed: int) -> dict:
    """The resident loop's other forms at the MinPaxos deployment's
    widths, cut to VG groups: (a) ``run_resident(..., substeps=2)``
    must drain with committed == injected; (b) ``run_fused`` from the
    same seed as a resident run (telemetry ring armed) must give the
    same commit stream: its per-round [k, G] cursor histories summed
    over groups equal the ring's committed_delta, in_flight and
    assigned of every round, and both runs end in the same state."""
    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.models.cluster import numpy_leaves
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
    from minpaxos_tpu_torch.obs import recorder as rc
    from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

    cfg = MinPaxosConfig(n_replicas=R, window=W, inbox=INBOX, exec_batch=P,
                         kv_pow2=KV_POW2, catchup_rows=CU_ROWS,
                         recovery_rows=REC_ROWS)
    injected = VG * P * V_DISPATCHES * K_ROUNDS

    def boot():
        sc = ShardedCluster(cfg, VG, ext_rows=EXT, key_space=KEY_SPACE, seed=seed,
                            device=dev)
        sc.elect(0)
        return sc

    def resident(substeps):
        sc = boot()
        sc.begin_resident(telemetry_rounds=(V_DISPATCHES + MAX_DRAIN) * K_ROUNDS)
        K.reset_launches()
        t0 = time.perf_counter()
        res = [sc.run_resident(K_ROUNDS, P, substeps) for _ in range(V_DISPATCHES)]
        while res[-1][1] and len(res) < V_DISPATCHES + MAX_DRAIN:
            res.append(sc.run_resident(K_ROUNDS, 0, substeps))
        wall = time.perf_counter() - t0
        tel = sc.resident_telemetry()
        hist = sc.end_resident()
        return sc, res, tel, hist, K.launch_counts(), wall

    rec: dict = dict(phase="variants", groups=VG, replicas=R, window=W,
                     proposals_per_round=P, rounds_per_dispatch=K_ROUNDS,
                     injected=injected)
    bad = []
    sc2, res2, tel2, hist2, l2, wall2 = resident(2)
    rec.update(substeps2_dispatches=len(res2), substeps2_committed=res2[-1][0],
               substeps2_in_flight=res2[-1][1], substeps2_hist_count=int(hist2.sum()),
               substeps2_p50_rounds=latency_stats(hist2)[1],
               substeps2_ms_per_round=1e3 * wall2 / (len(res2) * K_ROUNDS),
               substeps2_tel_inbox_rows=int(tel2[:, rc.TEL_INBOX_ROWS].sum()))
    if res2[-1] != (injected, 0) or int(hist2.sum()) != injected:
        bad.append(f"substeps=2: {res2[-1]} (committed, in_flight), histogram "
                   f"{int(hist2.sum())}, injected {injected}")
    del sc2
    sc1, res1, tel1, hist1, l1, _ = resident(1)
    scf = boot()
    c0 = scf.committed()[0]
    hists = [scf.run_fused(K_ROUNDS, P if i < V_DISPATCHES else 0)
             for i in range(len(res1))]
    ups = np.concatenate([h[0] for h in hists]).astype(np.int64)
    crts = np.concatenate([h[1] for h in hists]).astype(np.int64)
    tot = (ups + 1).sum(1)
    stream_eq = (
        np.array_equal(np.diff(np.concatenate([[c0], tot])), tel1[:, rc.TEL_COMMITTED])
        and np.array_equal((crts - 1 - ups).sum(1), tel1[:, rc.TEL_IN_FLIGHT])
        and np.array_equal(np.diff(crts.sum(1)), tel1[1:, rc.TEL_ASSIGNED])
        and [r[0] for r in res1] == [int(tot[(i + 1) * K_ROUNDS - 1])
                                     for i in range(len(res1))])
    state_eq = all(np.array_equal(a, b) for a, b in zip(numpy_leaves(sc1.ss),
                                                        numpy_leaves(scf.ss)))
    rec.update(fused_rounds=len(ups), fused_committed=int(tot[-1]),
               resident_committed=res1[-1][0], commit_stream_equal=stream_eq,
               final_state_equal=state_eq,
               launches_resident={k: v for k, v in l1.items() if v})
    if not (stream_eq and state_eq and res1[-1] == (injected, 0)):
        bad.append(f"run_fused vs resident: stream equal {stream_eq}, state equal "
                   f"{state_eq}, resident {res1[-1]}")
    for name in ("propose_rows", "round_open", "round_close", "slot_write"):
        if not (l1.get(name) and l2.get(name)):
            bad.append(f"{name} never launched in a variants run")
    emit(rec)
    if bad:
        fail("variants", "; ".join(bad))
    return rec


def _pctl(x, q):
    return float(np.percentile(np.asarray(x), q)) if len(x) else None


class TcpCluster:
    """A master and TCP_N replica servers of the port on this card, each
    its own process and CUDA context (python -m
    minpaxos_tpu_torch.cli.{master,server}), stores under
    .tcp_smoke/<pid>/<tag>, logs under .tcp_smoke_logs/<tag> (kept).
    ``name[i]`` is replica i's live process; a process that was stopped
    or killed keeps its log under a name of its own."""

    def __init__(self, tag: str, flags: list[str], limit_s: float):
        import shutil

        from minpaxos_tpu_torch.utils.netutil import CONTROL_OFFSET, free_ports

        self.tag, self.flags, self.limit_s = tag, flags, limit_s
        self.t0 = time.monotonic()
        self.deadline = self.t0 + limit_s
        self.work = os.path.join(HERE, ".tcp_smoke", str(os.getpid()), tag)
        self.logs = os.path.join(HERE, ".tcp_smoke_logs", tag)
        for d in (self.work, self.logs):
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
        self.env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))
        self.procs: dict[str, tuple] = {}
        self.ended: set[str] = set()  # stopped or killed on purpose
        self.mport = free_ports(1)[0]
        self.ports = free_ports(TCP_N, sibling_offset=CONTROL_OFFSET)
        self.offset = CONTROL_OFFSET
        self.name: dict[int, str] = {}
        self.port_of: dict[int, int] = {}
        self.lives: dict[int, int] = {}

    def left(self) -> float:
        rest = self.deadline - time.monotonic()
        if rest <= 0:
            raise TimeoutError(f"{self.tag} phase exceeded its {self.limit_s:.0f} s limit")
        return rest

    def spawn(self, name: str, args: list[str]) -> None:
        log = open(os.path.join(self.logs, name + ".log"), "wb")
        p = subprocess.Popen([sys.executable, "-u", "-m", *args], cwd=HERE, env=self.env,
                             stdout=log, stderr=subprocess.STDOUT)
        self.procs[name] = (p, log)

    def log_text(self, name: str) -> str:
        with open(os.path.join(self.logs, name + ".log")) as f:
            return f.read()

    def master_rpc(self, req: dict) -> dict:
        from minpaxos_tpu_torch.runtime.master import _rpc

        return _rpc(("127.0.0.1", self.mport), req)

    def ctl(self, i: int, req: dict, timeout: float = 2.0) -> dict:
        """One request to replica i's control port."""
        from minpaxos_tpu_torch.runtime.master import _rpc

        return _rpc(("127.0.0.1", self.port_of[i] + self.offset), req, timeout=timeout)

    def wait_for(self, pred, what: str, limit: float):
        end = min(self.deadline, time.monotonic() + limit)
        while time.monotonic() < end:
            for name, (p, _) in self.procs.items():
                if p.poll() is not None and name not in self.ended:
                    raise RuntimeError(f"{name} exited ({p.returncode}) while waiting "
                                       f"for {what}:\n{self.log_text(name)[-3000:]}")
            try:
                v = pred()
            except (OSError, ValueError, KeyError):
                v = None
            if v:
                return v
            time.sleep(0.05)
        raise TimeoutError(f"{self.tag}: timed out waiting for {what}")

    def start_server(self, i: int | None = None, port: int | None = None) -> None:
        """Start replica i (revived from its store) or, at boot, the
        server on ``port``."""
        if i is not None:
            port = self.port_of[i]
            self.lives[i] = self.lives.get(i, 1) + 1
            name = f"replica{i}_life{self.lives[i]}"
            self.name[i] = name
        else:
            name = f"server{port}"
        self.spawn(name, ["minpaxos_tpu_torch.cli.server", "-port", str(port),
                          "-mport", str(self.mport), *self.flags, "-durable",
                          "-storedir", self.work, *TCP_SHAPE])

    def boot(self) -> None:
        """The master (-ping 0.5: a replica three pings silent is dead),
        every server, the registration, every control port."""
        self.spawn("master", ["minpaxos_tpu_torch.cli.master", "-port", str(self.mport),
                              "-N", str(TCP_N), "-ping", "0.5"])
        for port in self.ports:
            self.start_server(port=port)
        nodes = self.wait_for(lambda: (lambda r: r["ok"] and r["nodes"])(
            self.master_rpc({"m": "get_replica_list"})), "all replicas to register", 120)
        for i, (_, p) in enumerate(nodes):
            self.port_of[i] = int(p)
            self.name[i] = f"server{int(p)}"
        self.wait_for(lambda: all(self.ctl(i, {"m": "ping"})["ok"] for i in range(TCP_N)),
                      "every control port", 120)

    def stop(self, i: int) -> dict | None:
        """SIGTERM replica i's process: its server-stop line, or None."""
        import signal

        name = self.name[i]
        p, log = self.procs[name]
        self.ended.add(name)
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
            try:
                p.wait(timeout=max(5.0, min(60.0, self.left())))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for line in self.log_text(name).splitlines():
            if line.startswith("{") and '"server-stop"' in line:
                return json.loads(line)
        return None

    def kill(self, i: int) -> None:
        """SIGKILL replica i's process: a crash, its store as it was left."""
        name = self.name[i]
        p, _ = self.procs[name]
        self.ended.add(name)
        p.kill()
        p.wait()

    def stop_master(self) -> None:
        import signal

        p, _ = self.procs["master"]
        self.ended.add("master")
        p.send_signal(signal.SIGTERM)
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()

    def frontier(self, i: int) -> int:
        return int(self.ctl(i, {"m": "ping"})["frontier"])

    def stores(self) -> dict:
        """Every replica's stable store (close them), after the stops."""
        from minpaxos_tpu_torch.runtime.stable import StableStore

        return {i: StableStore(os.path.join(self.work, f"stable-store-replica{i}"),
                               sync=False) for i in range(TCP_N)}

    def close(self) -> None:
        """Kill whatever still runs and remove the stores."""
        import shutil

        for p, log in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(self.work, ignore_errors=True)


def timed_client_class():
    """The port's client, stamping each command's first send and, per
    success frame, its arrival time, the replica that served it and its
    rows (``served``)."""
    from minpaxos_tpu_torch.runtime.client import Client
    from minpaxos_tpu_torch.wire.messages import MsgKind

    class TimedClient(Client):
        def propose(self, cmd_ids, ops, keys, vals):
            t = time.monotonic()
            for c in np.asarray(cmd_ids).tolist():
                self.sent.setdefault(c, t)
            super().propose(cmd_ids, ops, keys, vals)

        def _on_frame(self, kind, rows, closed):
            if kind == MsgKind.PROPOSE_REPLY and not closed.is_set():
                ok = rows[rows["ok"] != 0]
                if len(ok):
                    self.served.append((time.monotonic(), int(ok["leader"][0]), len(ok)))
            super()._on_frame(kind, rows, closed)

    return TimedClient


def timed(cli):
    """``cli`` (or a MultiClient's connections) timed as TimedClient."""
    cls = timed_client_class()
    for c in getattr(cli, "clients", [cli]):
        c.__class__ = cls
        c.sent, c.served = {}, []
    return cli


def tcp_drive(cli, ids, wl, timeout_s: float) -> dict:
    """Drive cmd_ids ``ids`` of the workload ``wl`` (ops, keys, vals)
    through a client, or through a MultiClient round-robin (id j of the
    list to connection j mod N, each connection's retry driver in a
    thread, as MultiClient.run_workload does): acked of these ids and
    the duplicates this drive added."""
    import threading

    clients = getattr(cli, "clients", [cli])
    dups0 = sum(c.dup_replies for c in clients)
    parts = [np.asarray(ids)[r::len(clients)] for r in range(len(clients))]
    out: list = [None] * len(clients)

    def run(r):
        out[r] = clients[r].run_partition(parts[r], *wl, batch=TCP_BATCH, timeout_s=timeout_s)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s + 10)
    return dict(acked=sum(o["acked"] for o in out if o),
                duplicates=sum(c.dup_replies for c in clients) - dups0)


def latencies(cli, ids) -> list:
    clients = getattr(cli, "clients", [cli])
    out = []
    for c in clients:
        for i in ids:
            if i in c.replies and i in c.sent:
                out.append((c.replies[i]["t_arrive"] - c.sent[i]) * 1e3)
    return out


def tcp_workload(*parts) -> tuple:
    """One table (ops, keys, vals) for a leg's commands, cmd_id = row: a
    300-PUT warm-up on keys outside the measured range, then
    ``gen_workload`` for each (n, seed) of ``parts``."""
    from minpaxos_tpu_torch.runtime.client import gen_workload

    wops, wkeys, wvals = gen_workload(WARM, seed=1)
    drawn = [(wops, wkeys + 1_000_000, wvals)] + [gen_workload(n, seed=sd)
                                                  for n, sd in parts]
    return tuple(np.concatenate([d[j] for d in drawn]) for j in range(3))


def warm_up(cl: TcpCluster, make_client, wl) -> tuple[int, dict]:
    """Drive the warm-up rows of ``wl`` from a fresh client until one run
    acks them all, as bench_tcp.py does (the boot election settles
    before the measurement): the runs it took and their replies."""
    runs, replies = 0, {}
    while True:
        runs += 1
        c = make_client()
        w = tcp_drive(c, np.arange(WARM), wl, min(60.0, cl.left()))
        for sub in getattr(c, "clients", [c]):
            replies.update(sub.replies)
            sub.close_conn()
        if w["acked"] == WARM:
            return runs, replies


def tcp_read_back(cl: TcpCluster, cli, wl, lo: int, hi: int, last: bool,
                  batch: int = TCP_BATCH) -> tuple[tuple, dict]:
    """Every key the commands [lo, hi) of ``wl`` wrote, read back through
    READ frames on ``cli``: GETs appended to the workload, their cmd_ids
    the new rows, ``batch`` at a time (a Mencius owner places its reads
    in its own slots, every R-th, and bounces those past its window).
    Reads a replica bounced are sent again (after a failover when it
    named another leader). Returns the extended workload and the
    counts; with ``last`` (one sequential client, so command order is
    commit order), the reads that differ from the key's last write.
    check_cluster holds every read to the committed log's order."""
    from minpaxos_tpu_torch.wire.messages import Op

    lastv: dict[int, int] = {}
    for k, v in zip(wl[1][lo:hi].tolist(), wl[2][lo:hi].tolist()):
        lastv[k] = v
    want_k = np.fromiter(lastv.keys(), np.int64, len(lastv))
    want_v = np.fromiter(lastv.values(), np.int64, len(lastv))
    base = len(wl[0])
    wl = (np.concatenate([wl[0], np.full(len(want_k), int(Op.GET), np.int64)]),
          np.concatenate([wl[1], want_k]),
          np.concatenate([wl[2], np.zeros(len(want_k), np.int64)]))
    for lo_ in range(0, len(want_k), batch):
        ids = base + np.arange(lo_, min(lo_ + batch, len(want_k)))
        end = time.monotonic() + min(60.0, cl.left())
        while time.monotonic() < end:
            need = np.asarray([i for i in ids.tolist() if i not in cli.replies], np.int64)
            if not len(need):
                break
            n_bounced = len(cli.rejected)
            cli.read(need, wl[1][need])
            if cli.wait(need, timeout_s=min(10.0, cl.left()), held=True):
                break
            if (len(cli.rejected) > n_bounced
                    and cli.leader_hint in (-1, cli.connected_to)):
                time.sleep(cli.BOUNCE_PAUSE_S)  # no room for them yet
            else:
                cli._failover()  # silent, or bounced toward another leader
    got = np.asarray([cli.replies.get(int(base + i), {}).get("val", -1)
                      for i in range(len(want_k))], np.int64)
    out = dict(readback_keys=len(want_k),
               readback_missing=int(sum(int(base + i) not in cli.replies
                                        for i in range(len(want_k)))))
    if last:
        out["readback_wrong"] = int(((got != want_v) & (got != -1)).sum())
    return wl, out


def hold_stores(cl: TcpCluster, need: int, live: list[int], replies: dict,
                wl) -> dict:
    """The stable stores after every stop: the replicas' committed
    prefixes agree record for record, the ``live`` replicas' cover at
    least ``need`` slots, and the port's check_cluster passes over all
    of them with every reply and the leg's workload (committed-slot and
    snapshot agreement, every committed command one of the workload's,
    every acked command in the log, every read's value one that the
    log's order explains)."""
    from minpaxos_tpu_torch.verify.invariants import check_cluster

    stores = cl.stores()
    try:
        prefixes = [stores[i].committed_prefix() for i in range(TCP_N)]
        upto = min(prefixes)
        recs = [stores[i].read_range(0, upto) for i in range(TCP_N)]
        agree = all(len(r) == upto + 1 for r in recs) and all(
            np.array_equal(r[f], recs[0][f]) for r in recs[1:]
            for f in ("inst", "op", "key", "val", "cmd_id", "client_id"))
        report = check_cluster(stores, replies=replies, workload=wl)
    finally:
        for s_ in stores.values():
            s_.close()
    return dict(store_committed_prefixes=prefixes, stores_agree=agree,
                stores_cover=min(prefixes[i] for i in live) >= need - 1,
                check_cluster_ok=report.ok, check_cluster_slots=report.compared_slots,
                check_cluster_gets=report.checked_gets,
                check_cluster_violations=report.violations[:3])


def serving_stats(cl: TcpCluster, i: int) -> dict:
    """Replica i's serving counters through its control port, in the
    server-stop line's terms (for a process about to be killed)."""
    st = cl.ctl(i, {"m": "ping"})["stats"]
    n = max(st["dispatches"], 1)
    return dict(dispatches=st["dispatches"], fused_substeps=st["fused_substeps"],
                executed=st["executed"], elections=st["elections"],
                wall_ms_per_dispatch=st["dispatch_wall_us"] / 1e3 / n,
                device_span_ms_per_dispatch=st["device_step_us"] / 1e3 / n,
                max_memory_allocated=st.get("max_memory_allocated"))


def kill_under_load(cl: TcpCluster, cli, ids, wl, victim: int, timeout_s: float) -> dict:
    """Drive ``ids`` from a thread; once a quarter of them is acked,
    SIGKILL replica ``victim``. Returns the drive's acked/duplicates and
    the kill's monotonic time."""
    import threading

    res: dict = {}
    t = threading.Thread(target=lambda: res.update(tcp_drive(cli, ids, wl, timeout_s)),
                         daemon=True)
    t.start()
    clients = getattr(cli, "clients", [cli])
    cl.wait_for(lambda: sum(sum(int(i) in c.replies for i in ids[::97]) for c in clients)
                >= len(ids[::97]) // 4, "a quarter of the run acked", 120)
    t_kill = time.monotonic()
    cl.kill(victim)
    t.join(timeout=timeout_s + 20)
    return dict(res, t_kill=t_kill)


def tcp_path(seed: int, busy: dict) -> dict:
    """The TCP serving deployment (BASELINE config 1 at TCP_SHAPE): a
    master and three durable MinPaxos replica servers (TcpCluster) and
    the port's client in this process. Drives TCP_OPS checked PUTs
    closed loop, stops a follower, drives TCP_EXTRA more, revives the
    follower from its stable store until it catches up; then the leader
    leg: TCP_FAIL checked PUTs from a client thread, the leader's
    process SIGKILLed once a quarter of them is acked, the master
    promoting the highest-frontier live replica and the client failing
    over, every PUT acked exactly once; failover_s from the kill to the
    first ack the new leader served; the old leader revived from its
    store as the kill left it, until it reaches the new leader's
    frontier. Then every written key read back through READ frames,
    every server stopped, and the three stable stores held against each
    other (hold_stores). Each server's kernel launches (after its boot
    warm-up) come from the line it prints on stop; the killed leader's
    serving counters are read through its control port just before the
    kill. ``busy``: the compare phase's profile of one server dispatch
    at this shape, carried into the line."""
    from minpaxos_tpu_torch.runtime.client import Client

    cl = TcpCluster("tcp", ["-min"], TCP_LIMIT_S)
    rec: dict = dict(phase="tcp", deployment="BASELINE config 1: master + "
                     f"{TCP_N} MinPaxos replica servers -min -durable "
                     + " ".join(TCP_SHAPE), client_batch=TCP_BATCH)
    stops: dict[str, dict] = {}
    try:
        cl.boot()

        def leader_ready():
            r = cl.master_rpc({"m": "get_leader"})
            if not r.get("ok"):
                return None
            ping = cl.ctl(int(r["leader"]), {"m": "ping"})
            ok = ping["leader"] == int(r["leader"]) and ping["prepared"]
            return int(r["leader"]) + 1 if ok else None

        cl.wait_for(leader_ready, "a prepared leader", 120)
        # warm-up, as bench_tcp.py does: 300 checked PUTs on keys outside
        # the measured range, until one run completes — the boot
        # election (replica 0's own, or the master's promotion when it
        # pinged before replica 0 was up) settles before the measurement
        wl = tcp_workload((TCP_OPS, 42), (TCP_EXTRA, 43), (TCP_FAIL, 44))
        o2, o3 = WARM + TCP_OPS, WARM + TCP_OPS + TCP_EXTRA
        n_all = o3 + TCP_FAIL
        warm_runs, replies = warm_up(cl, lambda: Client(("127.0.0.1", cl.mport), check=True),
                                     wl)
        lead_id = cl.wait_for(leader_ready, "a prepared leader", 120) - 1
        rec.update(boot_s=time.monotonic() - cl.t0, warmup_runs=warm_runs, leader=lead_id)
        cli = timed(Client(("127.0.0.1", cl.mport), check=True))
        t0 = time.perf_counter()
        st1 = tcp_drive(cli, np.arange(WARM, o2), wl, cl.left())
        wall = time.perf_counter() - t0
        lat = latencies(cli, range(WARM, o2))
        rec.update(acked=st1["acked"], duplicates=st1["duplicates"], wall_s=wall,
                   ops_per_s=st1["acked"] / wall,
                   p50_latency_ms=_pctl(lat, 50), p99_latency_ms=_pctl(lat, 99))
        # the follower leg: stop a follower (the highest id that does not
        # lead), commit more, revive it
        fid = max(i for i in range(TCP_N) if i != lead_id)
        stops[f"replica{fid}_life1"] = cl.stop(fid)
        st2 = tcp_drive(cli, np.arange(o2, o3), wl, cl.left())
        rec.update(fault_leg_acked=st2["acked"], fault_leg_duplicates=st2["duplicates"])
        t_rev = time.monotonic()
        cl.start_server(fid)
        target = cl.frontier(lead_id)
        cl.wait_for(lambda: cl.frontier(fid) >= target,
                    f"the revived follower to reach frontier {target}", 180)
        rec.update(leader_frontier_at_revive=target,
                   revived_catchup_s=time.monotonic() - t_rev)
        # the leader leg: SIGKILL the leader under load
        lead_serving = serving_stats(cl, lead_id)
        st3 = kill_under_load(cl, cli, np.arange(o3, n_all), wl, lead_id, cl.left())
        new_lead = cl.wait_for(leader_ready, "a prepared new leader", 60) - 1
        after = [t for t, who, _ in cli.served if who == new_lead and t > st3["t_kill"]]
        rec.update(leader_leg_acked=st3["acked"], leader_leg_duplicates=st3["duplicates"],
                   new_leader=new_lead,
                   failover_s=(min(after) - st3["t_kill"]) if after else None,
                   new_leader_elections=cl.ctl(new_lead, {"m": "ping"})["stats"]["elections"],
                   client_failovers=cli.metrics.counters()["failovers"])
        t_rev = time.monotonic()
        cl.start_server(lead_id)
        target = cl.frontier(new_lead)
        cl.wait_for(lambda: cl.frontier(lead_id) >= target,
                    f"the revived old leader to reach frontier {target}", 180)
        rec.update(new_leader_frontier_at_revive=target,
                   old_leader_catchup_s=time.monotonic() - t_rev,
                   leader_after_revive=cl.wait_for(leader_ready, "a prepared leader", 60) - 1)
        wl, rb = tcp_read_back(cl, cli, wl, WARM, n_all, last=True)
        rec.update(rb)
        cli.close_conn()
        replies.update(cli.replies)
        for i in range(TCP_N):
            stops[cl.name[i]] = cl.stop(i)
        cl.stop_master()
        rec.update(hold_stores(cl, n_all, list(range(TCP_N)), replies, wl))
    finally:
        cl.close()
    rec.update(
        dispatches=lead_serving.get("dispatches"),
        wall_ms_per_dispatch=lead_serving.get("wall_ms_per_dispatch"),
        device_span_ms_per_dispatch=lead_serving.get("device_span_ms_per_dispatch"),
        device_busy_ms_per_dispatch=busy.get("dispatch_device_ms"),
        kernel_launches_per_dispatch=busy.get("dispatch_kernel_launches"),
        killed_leader_serving=lead_serving,
        servers={k: {f: v.get(f) for f in (
            "dispatches", "fused_substeps", "executed", "wall_ms_per_dispatch",
            "device_span_ms_per_dispatch", "max_memory_allocated", "launches", "fatal")}
            if v else None for k, v in stops.items()},
        phase_s=time.monotonic() - cl.t0)
    rec["launches"] = sum_launches(stops)
    emit(rec)
    bad = []
    for leg, n, acked, dups in (("", TCP_OPS, "acked", "duplicates"),
                                ("follower leg ", TCP_EXTRA, "fault_leg_acked",
                                 "fault_leg_duplicates"),
                                ("leader leg ", TCP_FAIL, "leader_leg_acked",
                                 "leader_leg_duplicates")):
        if rec[acked] != n or rec[dups]:
            bad.append(f"{leg}{rec[acked]}/{n} acked, {rec[dups]} duplicates")
    if rec["new_leader"] == lead_id or rec["failover_s"] is None:
        bad.append(f"no failover: new leader {rec['new_leader']}, "
                   f"failover_s {rec['failover_s']}")
    bad += store_faults(rec)
    bad += stop_faults(stops, "tcp")
    if bad:
        fail("tcp", "; ".join(bad))
    return rec


def sum_launches(stops: dict) -> dict:
    launches: dict[str, int] = {}
    for v in stops.values():
        for k, n in ((v or {}).get("launches") or {}).items():
            launches[k] = launches.get(k, 0) + n
    return launches


def store_faults(rec: dict) -> list[str]:
    """The read-back's and hold_stores' failures in ``rec``."""
    bad = []
    if rec["readback_missing"] or rec.get("readback_wrong"):
        bad.append(f"read-back: {rec['readback_missing']} missing, "
                   f"{rec.get('readback_wrong')} wrong of {rec['readback_keys']}")
    if not (rec["stores_agree"] and rec["stores_cover"] and rec["check_cluster_ok"]):
        bad.append(f"stable stores: prefixes {rec['store_committed_prefixes']}, "
                   f"agree {rec['stores_agree']}, cover {rec['stores_cover']}, "
                   f"check_cluster {rec['check_cluster_violations']}")
    return bad


def stop_faults(stops: dict, path: str) -> list[str]:
    """Every stop line clean, and every kernel of ``path`` launched in
    each server's life while it served."""
    bad = []
    for k, v in stops.items():
        if not v or v.get("fatal") or not v.get("joined", False):
            bad.append(f"{k}: no clean stop ({v})")
            continue
        missing = [n for n in KERNELS[path] if not v["launches"].get(n)]
        if missing:
            bad.append(f"{k}: kernels never launched while serving: {missing}")
    return bad


def tcp_mencius_path(seed: int) -> dict:
    """The Mencius TCP deployment (bench_tcp.py's
    mencius_tcp_3rep_durable): a master and three durable Mencius
    replica servers (-m -durable at TCP_SHAPE, TcpCluster), driven by
    the round-robin MultiClient with check=True (every owner proposes
    into its own slots). TCP_M_OPS checked PUTs; an owner SIGKILLed and
    TCP_M_EXTRA more driven through the takeover of its slots; the
    owner revived from its store as the kill left it, until it heals to
    the cluster's frontier (heal_s, boot included); every key those
    legs wrote read back; then a single client proposing to the
    master's hint, TCP_M_FAIL PUTs, that replica SIGKILLed once a
    quarter is acked, commits going on exactly once through the
    failover and the dead owner's takeover; every server stopped and
    the stores held (hold_stores; the last victim's store agrees up to
    its prefix).
    Every stop line must show each kernel of KERNELS["tcp_mencius"]."""
    from minpaxos_tpu_torch.runtime.client import Client, MultiClient

    cl = TcpCluster("tcp_mencius", ["-m"], TCP_M_LIMIT_S)
    rec: dict = dict(phase="tcp_mencius", deployment="mencius_tcp_3rep_durable "
                     "(bench_tcp.py): master + "
                     f"{TCP_N} Mencius replica servers -m -durable " + " ".join(TCP_SHAPE),
                     client="MultiClient rr check=True", client_batch=TCP_BATCH)
    stops: dict[str, dict] = {}
    try:
        cl.boot()
        maddr = ("127.0.0.1", cl.mport)
        wl = tcp_workload((TCP_M_OPS, 52), (TCP_M_EXTRA, 53), (TCP_M_FAIL, 54))
        o2, o3 = WARM + TCP_M_OPS, WARM + TCP_M_OPS + TCP_M_EXTRA
        n_all = o3 + TCP_M_FAIL
        warm_runs, replies = warm_up(cl, lambda: MultiClient(maddr, check=True, mode="rr"),
                                     wl)
        rec.update(boot_s=time.monotonic() - cl.t0, warmup_runs=warm_runs)
        mc = timed(MultiClient(maddr, check=True, mode="rr"))
        t0 = time.perf_counter()
        st1 = tcp_drive(mc, np.arange(WARM, o2), wl, cl.left())
        wall = time.perf_counter() - t0
        lat = latencies(mc, range(WARM, o2))
        rec.update(acked=st1["acked"], duplicates=st1["duplicates"], wall_s=wall,
                   ops_per_s=st1["acked"] / wall,
                   p50_latency_ms=_pctl(lat, 50), p99_latency_ms=_pctl(lat, 99))
        # the owner leg: the highest id is not the master's hint
        hint = int(cl.master_rpc({"m": "get_leader"})["leader"])
        owner = max(i for i in range(TCP_N) if i != hint)
        cl.kill(owner)
        t_leg = time.monotonic()
        st2 = tcp_drive(mc, np.arange(o2, o3), wl, cl.left())
        rec.update(killed_owner=owner, takeover_leg_acked=st2["acked"],
                   takeover_leg_duplicates=st2["duplicates"],
                   takeover_leg_s=time.monotonic() - t_leg)
        t_rev = time.monotonic()
        cl.start_server(owner)
        others = [i for i in range(TCP_N) if i != owner]
        target = max(cl.frontier(i) for i in others)
        cl.wait_for(lambda: cl.frontier(owner) >= target,
                    f"the revived owner to heal to frontier {target}", 180)
        rec.update(frontier_at_revive=target, heal_s=time.monotonic() - t_rev)
        # read back while every owner lives: with one dead, each slot of
        # its interleaved slots waits for a takeover sweep
        t_leg = time.monotonic()
        wl, rb = tcp_read_back(cl, mc.clients[0], wl, WARM, o3, last=False,
                               batch=TCP_BATCH // TCP_N)
        rec.update(rb, readback_s=time.monotonic() - t_leg)
        mc.close()
        for c in mc.clients:
            replies.update(c.replies)
        # the proposer leg: one client on the master's hint, which dies
        cli = timed(Client(maddr, check=True))
        cli.connect()
        victim = cli.connected_to
        t_leg = time.monotonic()
        st3 = kill_under_load(cl, cli, np.arange(o3, n_all), wl, victim, cl.left())
        after = [t for t, who, _ in cli.served if who != victim and t > st3["t_kill"]]
        rec.update(killed_proposer=victim, proposer_leg_acked=st3["acked"],
                   proposer_leg_duplicates=st3["duplicates"],
                   proposer_leg_s=time.monotonic() - t_leg,
                   failover_s=(min(after) - st3["t_kill"]) if after else None,
                   client_failovers=cli.metrics.counters()["failovers"])
        live = [i for i in range(TCP_N) if i != victim]
        # the dead owner's slots taken over: every live replica commits
        # every slot either has seen (Mencius acks a committed slot above
        # a gap, so the stores' prefixes cover every ack only then)
        def settled():
            pings = [cl.ctl(i, {"m": "ping"}) for i in live]
            return min(p["frontier"] for p in pings) >= max(p["crt_inst"] for p in pings) - 1

        t_leg = time.monotonic()
        cl.wait_for(settled, "the live replicas to settle", 120)
        rec.update(settle_s=time.monotonic() - t_leg)
        cli.close_conn()
        replies.update(cli.replies)
        for i in live:
            stops[cl.name[i]] = cl.stop(i)
        cl.stop_master()
        rec.update(hold_stores(cl, n_all, live, replies, wl))
    finally:
        cl.close()
    rec.update(servers={k: {f: v.get(f) for f in (
        "dispatches", "fused_substeps", "executed", "skips_deferred",
        "wall_ms_per_dispatch",
        "device_span_ms_per_dispatch", "max_memory_allocated", "launches", "fatal")}
        if v else None for k, v in stops.items()},
        phase_s=time.monotonic() - cl.t0)
    rec["launches"] = sum_launches(stops)
    emit(rec)
    bad = []
    for leg, n, acked, dups in (("", TCP_M_OPS, "acked", "duplicates"),
                                ("takeover leg ", TCP_M_EXTRA, "takeover_leg_acked",
                                 "takeover_leg_duplicates"),
                                ("proposer leg ", TCP_M_FAIL, "proposer_leg_acked",
                                 "proposer_leg_duplicates")):
        if rec[acked] != n or rec[dups]:
            bad.append(f"{leg}{rec[acked]}/{n} acked, {rec[dups]} duplicates")
    if rec["failover_s"] is None:
        bad.append("no ack served by another replica after the proposer's kill")
    bad += store_faults(rec)
    bad += stop_faults(stops, "tcp_mencius")
    if bad:
        fail("tcp_mencius", "; ".join(bad))
    return rec


def chaos_phase(dev, smi: str) -> dict:
    """Seeded fault campaigns on this card (``chaos/campaign.py``): for
    each of CHAOS_PAIRS and the broken-quorum counterexample's fault
    plan (``verify/mc.py counterexample_faultplan``, projected before
    the counts are set to 0), a master and three in-process replica
    servers stepping here through the kernels, checked load through the
    schedule, heal, and the invariant checker over the quiesced stores.
    One ``chaos_run`` line per run; the phase line carries the launches
    of every kernel over the runs. Any run not ok, a kernel of
    KERNELS["chaos"] never launched, or the phase over its limit fails
    the script."""
    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.chaos.campaign import run_campaign, run_schedule
    from minpaxos_tpu_torch.verify.mc import counterexample_faultplan

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    fixture, replay_seed = CHAOS_REPLAY
    with open(os.path.join(HERE, "tests", "fixtures", fixture)) as f:
        plan = counterexample_faultplan(json.load(f), device=dev)
    events = [tuple(e) for e in plan["events"]]
    t0 = time.monotonic()
    K.reset_launches()
    verdict = run_campaign([n for _, n in CHAOS_PAIRS], [s for s, _ in CHAOS_PAIRS],
                           ops_n=CHAOS_OPS, pairs=CHAOS_PAIRS, log=log, device=str(dev))
    runs = list(verdict["runs"])
    runs.append(run_schedule("mc_replay", replay_seed, ops_n=CHAOS_OPS, events=events,
                             log=log, device=str(dev)))
    wall = time.monotonic() - t0
    launches = K.launch_counts()
    for r in runs:
        stall = (r.get("watch") or {}).get("stall")
        emit(dict(phase="chaos_run", schedule=r.get("schedule"), seed=r.get("seed"),
                  ok=r.get("ok"), acked=r.get("acked"), expected=r.get("expected"),
                  faults_injected=r.get("faults_injected"),
                  stall_observed=r.get("stall_observed"),
                  stall=None if stall is None else {
                      k: stall[k] for k in ("fired_in_window", "attributed", "cleared",
                                            "n_alarms")},
                  alarms=(r.get("watch") or {}).get("alarm_counts"),
                  duplicates=r.get("duplicates"), resumed=r.get("resumed_commits"),
                  converged=r.get("converged"), check_ok=(r.get("check") or {}).get("ok"),
                  violations=(r.get("check") or {}).get("violations"),
                  cluster_events=r.get("cluster_events"), wall_s=r.get("wall_s"),
                  error=r.get("error")))
    bad = [f"{r.get('schedule')} seed {r.get('seed')} not ok: {r.get('error')}"
           for r in runs if not r.get("ok")]
    missing = [k for k in KERNELS["chaos"] if not launches.get(k)]
    if missing:
        bad.append(f"kernels never launched: {missing}")
    if wall > CHAOS_LIMIT_S:
        bad.append(f"the phase took {wall:.1f} s, over its {CHAOS_LIMIT_S:.0f} s limit")
    rec = dict(phase="chaos", card=smi, device=torch.cuda.get_device_name(0),
               wall_s=wall, limit_s=CHAOS_LIMIT_S, runs=len(runs),
               runs_ok=sum(bool(r.get("ok")) for r in runs),
               replay_blocked=sorted(plan["plan"]["links"]),
               launches=launches, mismatches=bad)
    emit(rec)
    if bad:
        fail("chaos", "; ".join(bad[:20]))
    return rec


def count_diffs(got, want, where: str = "") -> list[str]:
    """Every MC_COUNT_FIELDS entry of ``want`` (a committed verdict)
    that ``got`` (the port's) does not equal, recursively."""
    out = []
    if isinstance(want, dict):
        if not isinstance(got, dict):
            return [f"{where}: {'missing' if got is None else repr(got)} "
                    f"where a section is recorded"]
        for k, w in want.items():
            if k in MC_COUNT_FIELDS:
                if got.get(k) != w:
                    out.append(f"{where}{k}: {got.get(k)!r} != {w!r}")
            elif isinstance(w, (dict, list)):
                out += count_diffs(got.get(k), w, f"{where}{k}.")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{where}: {len(got) if isinstance(got, list) else got!r} "
                    f"entries != {len(want)}"]
        for i, (g, w) in enumerate(zip(got, want)):
            out += count_diffs(g, w, f"{where}{i}.")
    return out


def mc_phase(dev, smi: str) -> dict:
    """The model checker on the card: ``cli/mc.py --smoke``'s legs and
    ``--flex-certified``'s sweep through the port's batched step (the
    liveness legs run once, for both), held to MC.json's and
    MC_FLEX.json's count fields (read, never written), to the reference
    explorer's state digests (tests/fixtures/paxmc_state_digests.json),
    and the four committed counterexamples replayed to their violations.
    Every kernel each protocol's step launches must launch in its legs."""
    import glob

    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.cli import mc as mc_cli
    from minpaxos_tpu_torch.verify.mc import replay_counterexample

    t0 = time.monotonic()
    K.reset_launches()
    legs = mc_cli.Legs(dev, log=lambda *a, **k: None)
    smoke = mc_cli.smoke(legs)
    flex = mc_cli.flex_certified(legs, liveness=smoke["liveness"])
    replays = {}
    for path in sorted(glob.glob(os.path.join(HERE, "tests", "fixtures", "mc_*.json"))):
        with open(path) as f:
            ce = json.load(f)
        ok, report = replay_counterexample(ce, device=dev)
        marker = "LASSO" if ce.get("kind") == "lasso" else (
            "REFINEMENT" if ce.get("kind") == "refinement" else "DIVERGENCE")
        replays[os.path.basename(path)] = ok and any(marker in v for v in report.violations)
    wall = time.monotonic() - t0
    launches = K.launch_counts()

    with open(os.path.join(HERE, "MC.json")) as f:
        ref_smoke = json.load(f)
    with open(os.path.join(HERE, "MC_FLEX.json")) as f:
        ref_flex = json.load(f)
    with open(os.path.join(HERE, "tests", "fixtures", "paxmc_state_digests.json")) as f:
        ref_digests = json.load(f)["runs"]
    # (through JSON, as the committed records were written: tuples as lists)
    bad = (count_diffs(json.loads(json.dumps(smoke)), ref_smoke, "MC.json ")
           + count_diffs(json.loads(json.dumps(flex)), ref_flex, "MC_FLEX.json "))
    digests = {}
    for st in legs.stats:
        want = ref_digests.get(st["label"])
        if want is None:
            continue
        digests[st["label"]] = st["digest"] == want["digest"]
        if (st["digest"], st["transitions"]) != (want["digest"], want["transitions"]):
            bad.append(f"digest of {st['label']}: {st['digest']} != {want['digest']}")
    wanted = {k for k, v in ref_digests.items() if not k.startswith("tiny-")}
    if set(digests) != wanted:
        bad.append(f"legs without a digest compare: {sorted(wanted - set(digests))}")
    bad += [f"replay of {k} did not reproduce" for k, ok in replays.items() if not ok]
    if len(replays) != 4:
        bad.append(f"{len(replays)} counterexample fixtures replayed, not 4")
    missing = {}
    for proto, names in MC_KERNELS.items():
        got = {}
        for st in legs.stats:
            if st["protocol"] == proto:
                for k, n in st["launches"].items():
                    got[k] = got.get(k, 0) + n
        missing[proto] = [k for k in names if not got.get(k)]
    bad += [f"{p} legs never launched {m}" for p, m in missing.items() if m]
    if wall > MC_LIMIT_S:
        bad.append(f"the phase took {wall:.1f} s, over its {MC_LIMIT_S:.0f} s limit")
    rec = dict(
        phase="mc", card=smi, device=torch.cuda.get_device_name(0),
        wall_s=wall, limit_s=MC_LIMIT_S, smoke_ok=smoke["ok"], flex_ok=flex["ok"],
        refined_edges=flex["refined_edges"], digests_equal=sum(digests.values()),
        digests_compared=len(digests), replays=replays, launches=launches,
        legs=[{k: st[k] for k in ("label", "wall_s", "step_s", "transitions",
                                 "transitions_per_s", "step_calls", "max_batch",
                                 "peak_mib")}
              for st in legs.stats],
        mismatches=bad)
    emit(rec)
    if bad:
        fail("mc", "; ".join(bad[:20]))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after each path, trace 4 steady rounds with "
                         "torch.profiler into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.golden import PROTOCOLS, drive, first_divergence, load_fixture

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build = K.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in K.BUILD_LOG.get(n, {}).get("log", "").splitlines()
                 if "registers" in ln or "smem" in ln]
             for n in build}
    smi = nvidia_smi_line()
    emit(dict(phase="env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              kernel_build_s=round(build_s, 2), ptxas=ptxas))

    res, apply_err, extra = {}, {}, {}
    for path, sh in PATHS.items():
        res[path], apply_err[path] = compare_kernels(dev, args.seed, sh)
        if path == "tcp":
            res[path]["pack_outputs"], extra = compare_tcp(dev, args.seed)
            probe = extra.pop("_dispatch_probe")
        elif path == "tcp_mencius":
            res[path]["pack_outputs"] = compare_pack_mencius(dev, args.seed)
        elif path == "chaos":
            res[path]["pack_outputs"] = compare_pack_chaos(dev, args.seed)
        emit(dict(phase="compare", path=path, card=smi,
                  kv_apply_max_abs_err=apply_err[path],
                  **(extra if path == "tcp" else {}),
                  kernels={k: dict(v, equal=v["err"] == 0)
                           for k, v in res[path].items()}))
        torch.cuda.empty_cache()
    bad = [f"{k}@{p}" for p, r in res.items() for k, v in r.items() if v["err"] != 0]
    bad += [k for k, v in extra.items() if k.startswith(("pack_outputs", "kv_insert",
            "vote_bits", "exec_select")) and "displaced" not in k
            and not k.endswith("_ms") and v != 0]
    if EMPTY_GRAPHS:
        fail("compare", f"timed calls launched nothing on the capture stream: "
                        f"{EMPTY_GRAPHS}")
    if bad or any(apply_err.values()):
        fail("compare", f"kernels disagree with their plain versions: {bad}, "
                        f"kv_apply err {apply_err}")
    if not res["minpaxos"]["kv_insert"]["full_load"]["displaced"]:
        fail("compare", "the full-load kv_insert compare displaced no row, so "
                        "it did not hold the displacement pass to its twin")
    for path, r in res.items():
        c = r["kv_insert"]["contended"]
        if not (c["contended_rows"] and c["oversubscribed_buckets"]):
            fail("compare", f"the contended kv_insert compare at the {path} shape "
                            f"contended nothing: {c}")
    if not extra["kv_insert_2^18_at_0.9_load_displaced"]:
        fail("compare", "the 2^18-way kv_insert compare at 0.9 load displaced no row")
    gold = load_fixture(os.path.join(HERE, "tests", "fixtures", "kernel_golden.json"))
    golden = {}
    for proto in PROTOCOLS:
        got = drive(proto, device=dev)
        div = first_divergence(got, gold[proto])
        golden[proto] = dict(steps=len(got), first_divergence=div)
    emit(dict(phase="golden", **golden))
    if any(v["first_divergence"] is not None for v in golden.values()):
        fail("golden", f"digests diverge: {golden}")
    mc_rec = mc_phase(dev, smi)
    torch.cuda.empty_cache()

    recs = {"minpaxos": main_path(dev, args.seed, DISPATCHES, args.profile)}
    torch.cuda.empty_cache()
    recs["mencius"] = mencius_path(dev, args.seed, DISPATCHES, args.profile)
    torch.cuda.empty_cache()
    variants(dev, args.seed)
    torch.cuda.empty_cache()
    # the profiler runs after the resident paths, so it cannot weigh on
    # their timing
    busy = dispatch_profile(*probe)
    emit(dict(phase="dispatch_profile", **busy))
    del probe
    recs["tcp"] = tcp_path(args.seed, busy)
    recs["tcp_mencius"] = tcp_mencius_path(args.seed)
    recs["chaos"] = chaos_phase(dev, smi)

    # one row per (kernel, path): a kernel's first path's row under the
    # kernel's name, its later paths' as name@path; TCP launches are
    # summed over the servers' stop lines
    table = []
    named: set[str] = set()
    for path, names in KERNELS.items():
        for name in names:
            src, repl = REPLACES[name]
            v = res[path][name]
            if (path, name) == ("minpaxos", "kv_lookup"):
                # K4 lookup's headline: the case on the run's own tables
                v = dict(recs[path]["kv_lookup_path"], library_ms=None,
                         err=max(v["err"], recs[path]["kv_lookup_path"]["err"]))
            t_bytes = 1e3 * v["bytes"] / HBM_BYTES_PER_S
            t_ops = 1e3 * v["ops"] / ALU_OPS_PER_S
            table.append(dict(
                name=f"{name}@{path}" if name in named else name,
                route="cuda", source=src, replaces=repl, path=path,
                launches=recs[path]["launches"].get(name, 0), max_abs_err=v["err"],
                ms=v["ms"], host_ms=v["host_ms"], plain_ms=v["plain_ms"],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=v["library_ms"]))
            for key in ("library_what", "unfused_ms", "floor_ms", "batch_ms_minpaxos",
                        "batch_bound_ms_minpaxos", "batch_ms_mencius",
                        "batch_bound_ms_mencius"):
                if v.get(key) is not None:
                    table[-1][key] = v[key]
            named.add(name)
    # the mc phase's rows (name@mc): each kernel at the model checker's
    # chunk of 8,192 rows (K6 in the Mencius form),
    # launches summed over the phase's legs
    for name in dict.fromkeys(MC_KERNELS["minpaxos"] + MC_KERNELS["mencius"]):
        src, repl = REPLACES[name]
        v = res["mc"].get(name) or res["mc_mencius"][name]
        t_bytes = 1e3 * v["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * v["ops"] / ALU_OPS_PER_S
        table.append(dict(
            name=f"{name}@mc", route="cuda", source=src, replaces=repl, path="mc",
            launches=mc_rec["launches"].get(name, 0), max_abs_err=v["err"],
            ms=v["ms"], host_ms=v["host_ms"], plain_ms=v["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=v["library_ms"]))
    emit({"kernels": table})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
