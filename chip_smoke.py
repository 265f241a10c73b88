#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, each printing one JSON line:

1. env      — the card (nvidia-smi name and power limit), torch/CUDA
              versions, and the kernels' build from kernels/csrc.
2. compare  — every hand-written kernel against its plain PyTorch twin
              on the card, at the shapes of each path below (MinPaxos,
              Mencius, then one TCP replica server: B = 1, 2^18-way KV
              table, K7 on the leader's outputs of a live exchange), on
              seeded inputs; integer results, compared for equality.
              Besides: K7 at a batch of 1,280 replicas, K4 insert on
              2^18-way tables 90% full, K5 vote bits with five replicas
              and K6 at the server's default window of 16,384 slots.
              Device times of kernel, plain version and, where one
              PyTorch call computes the same function, that call: each
              captured N times in one CUDA graph and replayed between
              two CUDA events. The kernel's host-issued time (eager
              calls back to back) is kept beside it as host_ms.
3. golden   — the port's Cluster and MenciusCluster on the card
              reproduce every per-step state digest of the JAX
              package's golden fixture (tests/fixtures/kernel_golden.json)
              for minpaxos, classic and mencius.
4. mainpath — ShardedCluster at the 1M-instance deployment (G=256
              groups x R=5 replicas x W=4096 slots, p=512 proposals per
              round per group, k=32 rounds per dispatch): elect, run the
              measured dispatches, drain, then check committed ==
              injected, the latency histogram's count, replica
              agreement, and every acknowledged write of every group
              read back, with its last value, from all five replicas'
              KV tables against a host replay of the Threefry workload.
              Launch counts of each kernel over the run show the path
              went through the kernels.
5. mencius  — ShardedCluster(protocol="mencius") at the Mencius
              deployment (bench.py mencius_64k per group, G=256 groups x
              5 owners x W=4096, p=64 proposals per owner per round, to
              every owner, k=32 rounds per dispatch): the same checks,
              plus that every owner proposed exactly p rows in every
              round (its crt_own), so slot order equals round order for
              the read-back's replay; counts set to 0 just before it.
6. tcp      — the TCP serving deployment, BASELINE config 1 at the shape
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
              server (printed by each server on stop). Before it, the
              dispatch_profile line: one server dispatch at this shape
              (the step and K7 on the leader's inbox from the compare
              phase's exchange) under torch.profiler in this process —
              device busy ms and kernel launches per dispatch.

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
# the TCP deployment: BASELINE config 1 at the shape bench_tcp.py:56 runs
# (master + 3 durable MinPaxos replica servers, one process each),
# gen_workload(20000, seed=42) PUTs closed loop in batches of 512 with
# -check, then a follower stop / 2,000 PUTs / revive leg; the server
# CLI's catch-up and recovery rows (256) and its other defaults
TCP_N, TCP_W, TCP_INBOX, TCP_E, TCP_KV_POW2 = 3, 2048, 1024, 128, 18
TCP_CU = TCP_REC = 256
TCP_OPS, TCP_EXTRA, TCP_BATCH = 20000, 2000, 512
TCP_SHAPE = ["-window", str(TCP_W), "-inbox", str(TCP_INBOX),
             "-kvpow2", str(TCP_KV_POW2), "-execbatch", str(TCP_E)]
TCP_LIMIT_S = 420.0  # the phase's own time limit


class Shapes(NamedTuple):
    """One path's kernel shapes: B = groups x replicas rows (``batch``
    when set), S window slots, M inbox rows, E exec rows, C = 2^kv_pow2
    KV ways, m_out outbox rows per replica, cap inbox capacity, stride of
    the range acks."""

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


PATHS = {
    "minpaxos": Shapes("minpaxos", G, R, W, INBOX + EXT, P, KV_POW2,
                       INBOX + EXT + REC_ROWS + 1 + 2 * CU_ROWS, INBOX, 1),
    "mencius": Shapes("mencius", G, R, W, M_INBOX + M_EXT, M_E, M_KV_POW2,
                      M_INBOX + M_EXT + 1 + 3 * M_CU + 3 * M_REC, M_INBOX, R),
    # one replica server of the TCP deployment (B = 1 of 3 replicas)
    "tcp": Shapes("tcp", 1, TCP_N, TCP_W, TCP_INBOX, TCP_E, TCP_KV_POW2,
                  TCP_INBOX + TCP_REC + 1 + 2 * TCP_CU, TCP_INBOX, 1, batch=1),
}
# the kernels each path launches, as registered in minpaxos_tpu_torch.kernels
KERNELS = {
    "minpaxos": ("route", "scatter_max", "seg_scan_max", "commit_frontier",
                 "kv_lookup", "kv_insert", "ack_runs", "vote_bits",
                 "scatter_vote_bits"),
    "mencius": ("route", "scatter_max", "seg_scan_max", "commit_frontier",
                "kv_lookup", "kv_insert", "ack_runs", "vote_bits",
                "scatter_vote_bits", "exec_select"),
    # every replica server's step and packing (no routing: the
    # transport delivers the rows)
    "tcp": ("scatter_max", "seg_scan_max", "commit_frontier", "kv_lookup",
            "kv_insert", "ack_runs", "vote_bits", "scatter_vote_bits",
            "pack_outputs"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
# the published non-tensor-core rate (float32, 67 TFLOP/s); the kernels'
# integer ALU work runs at most this fast, so ops / this is a lower bound
ALU_OPS_PER_S = 67e12


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
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
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
    res["scatter_max"] = dict(
        err=err, **times(fn_k, fn_p, fn_lib),
        bytes=B * M * (4 + 4 + 1) + B * (S + 1) * 4,
        ops=B * M * 4 + B * (S + 1),  # select, bound check, address, max; fill
        shapes=f"tgt/val/ok [{B},{M}] -> [{B},{S + 1}]; also signed ballots "
               f"(fill -1) -> [{B},{S + 1}], signed frontiers (fill -2^30) -> [{B},{R + 1}]")

    # K3: segmented max-scans over [B, E] (the KV apply's three scans)
    vals = ri(-1, E, (B, E))
    seg = rb(0.3, (B, E))
    inc_k = lambda: scan.segmented_scan_max(vals, seg)  # noqa: E731
    exc_k = lambda: scan.exclusive_segmented_scan_max(vals, seg, -1)  # noqa: E731
    err = max(max_abs_err(inc_k(), scan._segmented_scan_max_plain(vals, seg)),
              max_abs_err(exc_k(), scan._exclusive_plain(vals, seg, -1)))
    res["seg_scan_max"] = dict(
        err=err, **times(inc_k, lambda: scan._segmented_scan_max_plain(vals, seg)),
        bytes=B * E * (4 + 1 + 4),
        ops=B * E * 3,  # one combine (select + max + or) per element
        shapes=f"values/seg [{B},{E}] -> [{B},{E}]")

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

    # K1: the routing fabric over [12, G, N] pooled rows (not on the
    # TCP path: there the transport delivers the rows)
    if sh.path != "tcp":
        cols = ri(-5, 1 << 20, (12, G, N))
        cols[0] = torch.where(rb(0.6, (G, N)), ri(1, 30, (G, N)), 0)
        u = torch.rand((G, N), device=dev, generator=g)
        dst = torch.where(u < 0.5, -1, torch.where(u < 0.8, ri(0, R, (G, N)), -2)).to(torch.int32)
        alive = ~rb(0.05, (G, R))
        rt_k = lambda: segscatter.route(cols, dst, alive, M_OUT, CAP)  # noqa: E731

        def rt_p():
            win, hit = segscatter.route_plan(cols[0], dst, alive, M_OUT, CAP)
            return segscatter.gather_rows(cols, win, hit), hit

        res["route"] = dict(
            err=max_abs_err(rt_k(), rt_p()), **times(rt_k, rt_p),
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
    lk_k = lambda: kvs.kv_lookup_lanes(kv, q_hi, q_lo, q_ok)  # noqa: E731
    lk_p = lambda: kvs._kv_lookup_plain(kv, q_hi, q_lo, q_ok)  # noqa: E731
    found, _ = lk_p()
    res["kv_lookup"] = dict(
        err=max_abs_err(lk_k(), lk_p()), **times(lk_k, lk_p),
        bytes=B * E * (4 + 4 + 1) + int(q_ok.sum().item()) * 8 * 12
        + int(found.sum().item()) * 8 + B * E * (8 + 1),
        ops=int(q_ok.sum().item()) * (24 + 8 * 4),  # two hashes, 8 compares
        shapes=f"tables [{B},{C}], rows [{B},{E}]")

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
    pool = [clone_kv() for _ in range(8)]
    it = iter(range(10 ** 9))

    def restore():
        for p in pool:
            for a, b in zip(p, kv):
                a.copy_(b)

    ins_k = lambda: kvs.kv_insert_unique(pool[next(it) % 8], ins_hi, ins_lo, ins_v,  # noqa: E731
                                         ins_del, ins_ok)
    ins_p = lambda: kvs._kv_insert_plain(kv, ins_hi, ins_lo, ins_v, ins_del, ins_ok)  # noqa: E731
    n_ok = int(ins_ok.sum().item())
    res["kv_insert"] = dict(
        err=err, **times(ins_k, ins_p, iters=8, reset=restore), full_load=full_load,
        bytes=B * E * (4 + 4 + 8 + 1 + 1) + n_ok * (8 * 12 + 20) + B * 4,
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

    # K5: ack-run compression over [B, M] rows (bursts of one sender's
    # instances, `stride` apart; Mencius echoes the ballot into the run
    # key), the fused range-ack vote bits into [B, S], the vote-bit scatter
    d = sh.stride
    is_acc = rb(0.8, (B, M))
    a_src = torch.repeat_interleave(ri(0, R, (B, M // 8 + 1)), 8, dim=1)[:, :M].contiguous()
    a_step = torch.where(rb(0.85, (B, M)), d, ri(1, 2 * R, (B, M))).to(torch.int32)
    a_inst = torch.cumsum(a_step, 1, dtype=torch.int32) + ri(0, S, (B, 1))
    a_ok = rb(0.9, (B, M))
    a_bal = ri(0, 2, (B, M)) if d > 1 else None
    ar_k = lambda: ackruns.compress_ack_runs(is_acc, a_src, a_inst, a_ok,  # noqa: E731
                                             ballot=a_bal, stride=d)
    ar_p = lambda: ackruns._compress_plain(is_acc, a_src, a_inst, a_ok, a_bal, d)  # noqa: E731
    res["ack_runs"] = dict(
        err=max_abs_err(ar_k(), ar_p()), **times(ar_k, ar_p),
        bytes=B * M * (1 + 4 + 4 + 1 + (4 if d > 1 else 0)) + B * M * (1 + 4),
        ops=B * M * 8,  # run test (5 compares), scan add, count, readback
        shapes=f"rows [{B},{M}] -> run_start, run_len [{B},{M}]; stride {d}"
               + (", ballot in the run key" if d > 1 else ""))
    v_valid = rb(0.25, (B, M))
    v_cnt = ri(0, 64, (B, M))
    v_wb = ri(0, 1 << 20, (B,))
    v_inst = v_wb[:, None] + ri(-64, S + 64, (B, M))
    vb_k = lambda: ackruns.range_vote_bits(v_valid, a_src, v_inst, v_cnt, v_wb,  # noqa: E731
                                           S, R, stride=d)

    def vb_p():
        return ackruns.pack_vote_bits(ackruns.range_vote_coverage(
            v_valid, a_src, v_inst, v_cnt, v_wb, S, R, stride=d))

    n_valid = int(v_valid.sum().item())
    plane_cells = R * (S + 1) if d == 1 else R * d * (S // d + 3)
    got = vb_k()
    res["vote_bits"] = dict(
        err=max_abs_err(got, vb_p()), **times(vb_k, vb_p),
        bytes=B * M * (1 + 4 + 4 + 4) + B * 4 + B * S * 4,
        # per valid row: clip, ranks, two adds; per plane cell: one
        # prefix add; per slot and replica: a compare and an or
        ops=n_valid * 12 + B * plane_cells + B * S * R * 2,
        voted_slots=int((got != 0).sum().item()),
        shapes=f"rows [{B},{M}], window_base [{B}] -> votes [{B},{S}]; stride {d}")
    sv_idx = ri(-2, S + 3, (B, M))
    sv_ok = rb(0.3, (B, M))
    sv_k = lambda: ackruns.scatter_vote_bits(S, sv_idx, a_src, sv_ok, R)  # noqa: E731
    sv_p = lambda: ackruns._scatter_vote_bits_plain(S, sv_idx, a_src, sv_ok, R)  # noqa: E731
    res["scatter_vote_bits"] = dict(
        err=max_abs_err(sv_k(), sv_p()), **times(sv_k, sv_p),
        bytes=B * M * (4 + 4 + 1) + B * S * 4,
        ops=B * M * 4 + B * S,  # bound checks, shift, or; the zero fill
        shapes=f"idx/src/valid [{B},{M}] -> [{B},{S}]")

    if sh.path == "mencius":
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
        res["exec_select"] = dict(
            err=max_abs_err(got, ex_p()), **times(ex_k, ex_p),
            bytes=B * S * (4 + 4 + 1 + 1 + 1) + B * 12 + B * E * 4 + B * S,
            # a comparison sort's n log2 n compares, plus the scans
            ops=B * S * (int(np.log2(S)) + 4),
            ranked=int((got[0] < S).sum().item()),
            shapes=f"window [{B},{S}] (keys, status, op, executed), cursors [{B}] "
                   f"-> slot_of [{B},{E}], newly_exec [{B},{S}]")
    torch.cuda.synchronize()
    return res, apply_err



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
                dispatch_inbox_rows=int((inbox.kind != 0).sum().item()))


def compare_tcp(dev, seed: int) -> tuple[dict, dict]:
    """K7 against its plain twin at one replica server's shapes (the
    leader's row of a live exchange at TCP_SHAPE, timed), and at a batch
    of 1,280 replicas with random anchor inputs of both protocol forms;
    K4 insert on 2^18-way tables 90% full; K5 vote bits with five
    replicas and K6 at the server's default window (16,384 slots).
    Returns (the pack_outputs row, the extra checks, and under
    ``_dispatch_probe`` the leader's state and real inbox of that
    exchange for ``dispatch_profile``)."""
    from types import SimpleNamespace as NS

    from minpaxos_tpu_torch.models import minpaxos as tmp
    from minpaxos_tpu_torch.ops import ackruns, mencius_exec, substeps
    from minpaxos_tpu_torch.ops import kvstore as kvs

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
    err = max_abs_err(pk().clone(), pp())
    w = out.shape[1]
    row = dict(err=err, **times(pk, pp, lib),
               # each source column read once (12 + dst int32 at Mout, acked
               # 1 B at M_in, 5 int32 + 1 bool exec columns at E, ~20 scalars,
               # R peer commits), the row written once
               bytes=13 * 4 * m_out + m_in + TCP_E * 21 + 20 * 4
               + TCP_N * 4 + w * 4,
               ops=w + 64,  # one move per output word; the anchor arithmetic
               executed_in_row=int(ex.count[0]),
               shapes=f"outbox [1,{m_out}] x 14, exec [1,{TCP_E}] x 6, scalars "
                      f"-> packed row [1,{w}]")
    extra = {"_dispatch_probe": (cfg, prev, inbox)}
    # K7 at a batch: random state scalars in both anchor forms
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    B, S, R, Mo, Mi, E = 1280, 4096, 5, 2176, 1664, 512

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, device=dev, dtype=torch.int32, generator=g)

    fr = ri(100, 5000, (B,))
    common = dict(committed_upto=fr, window_base=fr - ri(0, 300, (B,)),
                  crt_inst=fr + ri(-2, 40, (B,)), executed_upto=fr - ri(0, 30, (B,)),
                  me=ri(0, R, (B,)), peer_commits=fr[:, None] + ri(-600, 3, (B, R)),
                  kv=NS(dropped=ri(0, 2, (B,))))
    states = [NS(**common, leader_id=ri(0, R, (B,)), prepared=ri(0, 2, (B,)) == 1,
                 gossip_upto=fr - ri(-1, 3, (B,))),
              NS(**common, status=ri(0, 6, (B, S)).to(torch.uint8),
                 commit_sent=fr - ri(-3, 20, (B,)),
                 tk_anchor=torch.where(ri(0, 2, (B,)) == 1, fr - ri(0, 50, (B,)), -1),
                 crt_own=fr + ri(-5, 60, (B,)))]
    obb = tmp.Outbox(tmp.MsgBatch(*[ri(-3, 1 << 20, (B, Mo)) for _ in range(12)]),
                     ri(-2, R, (B, Mo)), ri(0, 2, (B, Mi)) == 1)
    exb = tmp.ExecResult(ri(0, 100, (B,)), ri(0, E, (B,)), ri(-5, 5, (B, E)),
                         ri(-5, 5, (B, E)), ri(0, 2, (B, E)) == 1, ri(0, 4, (B, E)),
                         ri(0, 1 << 20, (B, E)), ri(-1, 9, (B, E)))
    for name, stb in zip(("minpaxos", "mencius"), states):
        got = substeps.pack_outputs(stb, obb, exb)
        extra[f"pack_outputs_batch_{name}"] = max_abs_err(
            got, substeps._pack_plain(stb, obb, exb, torch.empty_like(got),
                                      stb.window_base))
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
        extra[f"vote_bits_R5_S16384_stride{d}"] = max_abs_err(
            ackruns.range_vote_bits(okv, src, inst, cnt, wb, Sd, R, stride=d),
            ackruns.pack_vote_bits(ackruns.range_vote_coverage(
                okv, src, inst, cnt, wb, Sd, R, stride=d)))
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
    torch.cuda.synchronize()
    return row, extra

REPLACES = {
    "route": ("minpaxos_tpu_torch/kernels/csrc/route.cu",
              "minpaxos_tpu/ops/segscatter.py:45"),
    "scatter_max": ("minpaxos_tpu_torch/kernels/csrc/winner.cu",
                    "minpaxos_tpu/models/minpaxos.py:546"),
    "seg_scan_max": ("minpaxos_tpu_torch/kernels/csrc/scan.cu",
                     "minpaxos_tpu/ops/scan.py:21"),
    "commit_frontier": ("minpaxos_tpu_torch/kernels/csrc/scan.cu",
                        "minpaxos_tpu/ops/scan.py:50"),
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
}


# ---------------------------------------------------------------- phase 4

def profile_rounds(sc, rounds: int, p: int, out_dir: str, tag: str) -> dict:
    """torch.profiler over ``rounds`` steady rounds of the resident loop
    at ``p`` proposals: device time by kernel name and the device busy
    share of the wall time. Writes the Chrome trace and the table under
    ``out_dir``, file names prefixed with ``tag``."""
    from torch.profiler import ProfilerActivity, profile

    sc.begin_resident()
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
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_round_trace.json"))
    with open(os.path.join(out_dir, f"{tag}_round_table.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return dict(phase="profile", path=tag, rounds=rounds, wall_ms_per_round=1e3 * wall / rounds,
                device_ms_per_round=total_us / 1e3 / rounds,
                kernel_launches_per_round=sum(e.count for e in events) / rounds,
                device_busy_share=(total_us / 1e6) / wall if wall else None,
                top_kernels_ms_per_round={k: v / 1e3 / rounds for k, v in top})


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
    sc.begin_resident()
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
    while in_flight and drain_dispatches < 12:
        committed, in_flight = sc.run_resident(K_ROUNDS, 0)
        drain_dispatches += 1
    launches = K.launch_counts()
    hist = sc.end_resident()
    if in_flight:
        fail("mainpath", f"did not drain: in_flight={in_flight}")
    settled, agree = settle(sc)
    injected = G * P * measured_rounds
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
        launches=launches)
    emit(rec)
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
    if profile_dir:
        emit(profile_rounds(sc, 4, P, profile_dir, "minpaxos"))
    return rec


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
    sc.begin_resident()
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
    while in_flight and drain_dispatches < 12:
        committed, in_flight = sc.run_resident(K_ROUNDS, 0)
        drain_dispatches += 1
    launches = K.launch_counts()
    hist = sc.end_resident()
    if in_flight:
        fail("mencius", f"did not drain: in_flight={in_flight}")
    settled, agree = settle(sc)
    injected = G * M_P * R * measured_rounds
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
        launches=launches)
    emit(rec)
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



def _pctl(x, q):
    return float(np.percentile(np.asarray(x), q)) if len(x) else None


def tcp_path(seed: int, busy: dict) -> dict:
    """The TCP serving deployment (BASELINE config 1 at TCP_SHAPE): a
    master and three durable MinPaxos replica servers, each its own
    process and CUDA context on this card (python -m
    minpaxos_tpu_torch.cli.{master,server}), and the port's client in
    this process. Drives TCP_OPS checked PUTs closed loop, stops a
    follower, drives TCP_EXTRA more, revives the follower from its
    stable store and waits for it to catch up, reads every written key
    back through READ frames, stops everything and holds the three
    stable stores' committed prefixes against each other. Each server's
    kernel launches (after its boot warm-up: the counts start at 0 in
    every server process) come from the line it prints on stop.
    ``busy``: the compare phase's profile of one server dispatch at this
    shape (device busy ms and launches per dispatch), carried into the
    line beside the servers' own host wall and event span."""
    import shutil
    import signal

    from minpaxos_tpu_torch.runtime.client import Client, gen_workload
    from minpaxos_tpu_torch.runtime.master import _rpc
    from minpaxos_tpu_torch.runtime.stable import StableStore
    from minpaxos_tpu_torch.utils.netutil import CONTROL_OFFSET, free_ports

    t_phase = time.monotonic()
    deadline = t_phase + TCP_LIMIT_S
    work = os.path.join(HERE, ".tcp_smoke", str(os.getpid()))
    logs = os.path.join(HERE, ".tcp_smoke_logs")  # kept after the run
    for d in (work, logs):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs: dict[str, tuple] = {}
    mport = free_ports(1)[0]
    ports = free_ports(TCP_N, sibling_offset=CONTROL_OFFSET)

    def left() -> float:
        rest = deadline - time.monotonic()
        if rest <= 0:
            raise TimeoutError(f"tcp phase exceeded its {TCP_LIMIT_S:.0f} s limit")
        return rest

    def spawn(name, args):
        log = open(os.path.join(logs, name + ".log"), "wb")
        p = subprocess.Popen([sys.executable, "-u", "-m", *args], cwd=HERE, env=env,
                             stdout=log, stderr=subprocess.STDOUT)
        procs[name] = (p, log)

    def log_text(name):
        with open(os.path.join(logs, name + ".log")) as f:
            return f.read()

    def ctl(port, req, timeout=2.0):
        return _rpc(("127.0.0.1", port + CONTROL_OFFSET), req, timeout=timeout)

    def wait_for(pred, what, limit):
        end = min(deadline, time.monotonic() + limit)
        while time.monotonic() < end:
            for name, (p, _) in procs.items():
                if p.poll() is not None and not name.endswith("stopped"):
                    raise RuntimeError(f"{name} exited ({p.returncode}) while waiting "
                                       f"for {what}:\n{log_text(name)[-3000:]}")
            try:
                v = pred()
            except (OSError, ValueError, KeyError):
                v = None
            if v:
                return v
            time.sleep(0.1)
        raise TimeoutError(f"tcp: timed out waiting for {what}")

    def server_args(port):
        return ["minpaxos_tpu_torch.cli.server", "-port", str(port), "-mport", str(mport),
                "-min", "-durable", "-storedir", work, *TCP_SHAPE]

    def stop(name):
        p, log = procs.pop(name)
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
            try:
                p.wait(timeout=max(5.0, min(60.0, left())))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        log.close()
        procs[name + " stopped"] = (p, log)
        for line in log_text(name).splitlines():
            if line.startswith("{") and '"server-stop"' in line:
                return json.loads(line)
        return None

    class TimedClient(Client):
        """The port's client, stamping each command's first send."""

        def propose(self, cmd_ids, ops, keys, vals):
            t = time.monotonic()
            for c in np.asarray(cmd_ids).tolist():
                self.sent.setdefault(c, t)
            super().propose(cmd_ids, ops, keys, vals)

    rec: dict = dict(phase="tcp", deployment="BASELINE config 1: master + "
                     f"{TCP_N} MinPaxos replica servers -min -durable "
                     + " ".join(TCP_SHAPE), client_batch=TCP_BATCH)
    stops: dict[str, dict] = {}
    try:
        spawn("master", ["minpaxos_tpu_torch.cli.master", "-port", str(mport),
                         "-N", str(TCP_N), "-ping", "0.5"])
        for port in ports:
            spawn(f"server{port}", server_args(port))
        nodes = wait_for(lambda: (lambda r: r["ok"] and r["nodes"])(
            _rpc(("127.0.0.1", mport), {"m": "get_replica_list"})),
            "all replicas to register", 120)
        rid = {int(p): i for i, (_, p) in enumerate(nodes)}
        port_of = {i: p for p, i in rid.items()}
        # every server answers ping; the master's leader leads, prepared
        # (replica 0 self-elects at boot unless the master, finding it
        # not yet up, promoted another replica first)
        wait_for(lambda: all(ctl(p, {"m": "ping"})["ok"] for p in ports),
                 "every control port", 120)

        def leader_ready():
            r = _rpc(("127.0.0.1", mport), {"m": "get_leader"})
            if not r.get("ok"):
                return None
            ping = ctl(port_of[int(r["leader"])], {"m": "ping"})
            ok = ping["leader"] == int(r["leader"]) and ping["prepared"]
            return int(r["leader"]) + 1 if ok else None

        wait_for(leader_ready, "a prepared leader", 120)
        # warm-up, as bench_tcp.py does: 300 checked PUTs on keys outside
        # the measured range, until one run completes — the boot
        # election (replica 0's own, or the master's promotion when it
        # pinged before replica 0 was up) settles before the measurement
        wops, wkeys, wvals = gen_workload(300, seed=1)
        warm_runs = 0
        while True:
            warm_runs += 1
            wc = Client(("127.0.0.1", mport), check=True)
            w = wc.run_workload(wops, wkeys + 1_000_000, wvals, timeout_s=min(60.0, left()))
            wc.close_conn()
            if w["acked"] == len(wops):
                break
        lead_id = wait_for(leader_ready, "a prepared leader", 120) - 1
        rec.update(boot_s=time.monotonic() - t_phase, warmup_runs=warm_runs, leader=lead_id)
        ops1, keys1, vals1 = gen_workload(TCP_OPS, seed=42)
        ops2, keys2, vals2 = gen_workload(TCP_EXTRA, seed=43)
        ops = np.concatenate([ops1, ops2])
        keys = np.concatenate([keys1, keys2])
        vals = np.concatenate([vals1, vals2])
        cli = TimedClient(("127.0.0.1", mport), check=True)
        cli.sent = {}
        t0 = time.perf_counter()
        st1 = cli.run_partition(np.arange(TCP_OPS), ops, keys, vals, batch=TCP_BATCH,
                                timeout_s=left())
        wall = time.perf_counter() - t0
        lat = [(cli.replies[c]["t_arrive"] - cli.sent[c]) * 1e3
               for c in range(TCP_OPS) if c in cli.replies and c in cli.sent]
        rec.update(acked=st1["acked"], duplicates=st1["duplicates"], wall_s=wall,
                   ops_per_s=st1["acked"] / wall,
                   p50_latency_ms=_pctl(lat, 50), p99_latency_ms=_pctl(lat, 99))
        # the fault leg: stop a follower (the highest id that does not
        # lead), commit more, revive it
        fid = max(i for i in range(TCP_N) if i != lead_id)
        follower = f"server{port_of[fid]}"
        stops[f"replica{fid}_first_life"] = stop(follower)
        st2 = cli.run_partition(np.arange(TCP_OPS, TCP_OPS + TCP_EXTRA), ops, keys, vals,
                                batch=TCP_BATCH, timeout_s=left())
        rec.update(fault_leg_acked=st2["acked"], fault_leg_duplicates=st2["duplicates"])
        t_rev = time.monotonic()
        spawn(follower + "_revived", server_args(port_of[fid]))
        target = ctl(port_of[lead_id], {"m": "ping"})["frontier"]
        wait_for(lambda: ctl(port_of[fid], {"m": "ping"})["frontier"] >= target,
                 f"the revived follower to reach frontier {target}", 180)
        rec.update(leader_frontier_at_revive=target,
                   revived_catchup_s=time.monotonic() - t_rev)
        # every written key read back through READ frames
        last: dict[int, int] = {}
        for k, v in zip(keys.tolist(), vals.tolist()):
            last[k] = v
        want_k = np.fromiter(last.keys(), np.int64, len(last))
        want_v = np.fromiter(last.values(), np.int64, len(last))
        base = 1 << 24
        for lo in range(0, len(want_k), TCP_BATCH):
            ids = base + np.arange(lo, min(lo + TCP_BATCH, len(want_k)))
            cli.read(ids, want_k[lo:lo + TCP_BATCH])
            if not cli.wait(ids, timeout_s=min(60.0, left())):
                break
        got = np.asarray([cli.replies.get(int(base + i), {}).get("val", -1)
                          for i in range(len(want_k))], np.int64)
        rec.update(readback_keys=len(want_k),
                   readback_missing=int(sum(int(base + i) not in cli.replies
                                            for i in range(len(want_k)))),
                   readback_wrong=int(((got != want_v) & (got != -1)).sum()))
        cli.close_conn()
        for i in range(TCP_N):
            name = f"server{port_of[i]}" + ("_revived" if i == fid else "")
            stops[f"replica{i}"] = stop(name)
        stop("master")
        # the three durable logs agree on their committed prefix
        stores = [StableStore(os.path.join(work, f"stable-store-replica{i}"), sync=False)
                  for i in range(TCP_N)]
        try:
            prefixes = [s_.committed_prefix() for s_ in stores]
            upto = min(prefixes)
            recs = [s_.read_range(0, upto) for s_ in stores]
            agree = all(len(r) == upto + 1 for r in recs) and all(
                np.array_equal(r[f], recs[0][f]) for r in recs[1:]
                for f in ("inst", "op", "key", "val", "cmd_id", "client_id"))
        finally:
            for s_ in stores:
                s_.close()
        rec.update(store_committed_prefixes=prefixes, stores_agree=agree)
    finally:
        for name, (p, log) in list(procs.items()):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(os.path.join(HERE, ".tcp_smoke"), ignore_errors=True)
    lead = stops.get(f"replica{rec.get('leader')}") or {}
    rec.update(
        dispatches=lead.get("dispatches"),
        wall_ms_per_dispatch=lead.get("wall_ms_per_dispatch"),
        device_span_ms_per_dispatch=lead.get("device_span_ms_per_dispatch"),
        device_busy_ms_per_dispatch=busy.get("dispatch_device_ms"),
        kernel_launches_per_dispatch=busy.get("dispatch_kernel_launches"),
        servers={k: {f: v.get(f) for f in (
            "dispatches", "fused_substeps", "executed", "wall_ms_per_dispatch",
            "device_span_ms_per_dispatch", "max_memory_allocated", "launches", "fatal")}
            if v else None for k, v in stops.items()},
        phase_s=time.monotonic() - t_phase)
    launches: dict[str, int] = {}
    for v in stops.values():
        for k, n in ((v or {}).get("launches") or {}).items():
            launches[k] = launches.get(k, 0) + n
    rec["launches"] = launches
    emit(rec)
    bad = []
    if rec["acked"] != TCP_OPS or rec["duplicates"]:
        bad.append(f"{rec['acked']}/{TCP_OPS} acked, {rec['duplicates']} duplicates")
    if rec["fault_leg_acked"] != TCP_EXTRA or rec["fault_leg_duplicates"]:
        bad.append(f"fault leg {rec['fault_leg_acked']}/{TCP_EXTRA} acked, "
                   f"{rec['fault_leg_duplicates']} duplicates")
    if rec["readback_missing"] or rec["readback_wrong"]:
        bad.append(f"read-back: {rec['readback_missing']} missing, "
                   f"{rec['readback_wrong']} wrong of {rec['readback_keys']}")
    if not rec["stores_agree"] or min(rec["store_committed_prefixes"]) < TCP_OPS + TCP_EXTRA - 1:
        bad.append(f"stable stores: prefixes {rec['store_committed_prefixes']}, "
                   f"agree {rec['stores_agree']}")
    for k, v in stops.items():
        if not v or v.get("fatal") or not v.get("joined", False):
            bad.append(f"{k}: no clean stop ({v})")
            continue
        missing = [n for n in KERNELS["tcp"] if not v["launches"].get(n)]
        if missing:
            bad.append(f"{k}: kernels never launched while serving: {missing}")
    if bad:
        fail("tcp", "; ".join(bad))
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
        emit(dict(phase="compare", path=path, card=smi,
                  kv_apply_max_abs_err=apply_err[path],
                  **(extra if path == "tcp" else {}),
                  kernels={k: dict(v, equal=v["err"] == 0)
                           for k, v in res[path].items()}))
        torch.cuda.empty_cache()
    bad = [f"{k}@{p}" for p, r in res.items() for k, v in r.items() if v["err"] != 0]
    bad += [k for k, v in extra.items() if k.startswith(("pack_outputs", "kv_insert",
            "vote_bits", "exec_select")) and "displaced" not in k and v != 0]
    if bad or any(apply_err.values()):
        fail("compare", f"kernels disagree with their plain versions: {bad}, "
                        f"kv_apply err {apply_err}")
    if not res["minpaxos"]["kv_insert"]["full_load"]["displaced"]:
        fail("compare", "the full-load kv_insert compare displaced no row, so "
                        "it did not hold the displacement pass to its twin")
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

    recs = {"minpaxos": main_path(dev, args.seed, DISPATCHES, args.profile)}
    torch.cuda.empty_cache()
    recs["mencius"] = mencius_path(dev, args.seed, DISPATCHES, args.profile)
    torch.cuda.empty_cache()
    # the profiler runs after the resident paths, so it cannot weigh on
    # their timing
    busy = dispatch_profile(*probe)
    emit(dict(phase="dispatch_profile", **busy))
    del probe
    recs["tcp"] = tcp_path(args.seed, busy)

    # one row per (kernel, path): the MinPaxos path's rows under the
    # kernel's name, the other paths' as name@path (a kernel of one path
    # only keeps its bare name); TCP launches are summed over the servers
    table = []
    for path, names in KERNELS.items():
        for name in names:
            src, repl = REPLACES[name]
            v = res[path][name]
            t_bytes = 1e3 * v["bytes"] / HBM_BYTES_PER_S
            t_ops = 1e3 * v["ops"] / ALU_OPS_PER_S
            table.append(dict(
                name=name if path == "minpaxos" or name in ("exec_select", "pack_outputs")
                else f"{name}@{path}",
                route="cuda", source=src, replaces=repl, path=path,
                launches=recs[path]["launches"].get(name, 0), max_abs_err=v["err"],
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
