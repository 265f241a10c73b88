#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, each printing one JSON line:

1. env      — the card (nvidia-smi name and power limit), torch/CUDA
              versions, and the kernels' build from kernels/csrc.
2. compare  — every hand-written kernel against its plain PyTorch twin
              on the card, at the shapes of each path below (MinPaxos,
              then Mencius), on seeded inputs; integer results,
              compared for equality.
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


class Shapes(NamedTuple):
    """One path's kernel shapes: B = groups x replicas rows, S window
    slots, M inbox rows, E exec rows, C = 2^kv_pow2 KV ways, m_out outbox
    rows per replica, cap inbox capacity, stride of the range acks."""

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


PATHS = {
    "minpaxos": Shapes("minpaxos", G, R, W, INBOX + EXT, P, KV_POW2,
                       INBOX + EXT + REC_ROWS + 1 + 2 * CU_ROWS, INBOX, 1),
    "mencius": Shapes("mencius", G, R, W, M_INBOX + M_EXT, M_E, M_KV_POW2,
                      M_INBOX + M_EXT + 1 + 3 * M_CU + 3 * M_REC, M_INBOX, R),
}
# the kernels each path launches, as registered in minpaxos_tpu_torch.kernels
KERNELS = {
    "minpaxos": ("route", "scatter_max", "seg_scan_max", "commit_frontier",
                 "kv_lookup", "kv_insert", "ack_runs", "vote_bits",
                 "scatter_vote_bits"),
    "mencius": ("route", "scatter_max", "seg_scan_max", "commit_frontier",
                "kv_lookup", "kv_insert", "ack_runs", "vote_bits",
                "scatter_vote_bits", "exec_select"),
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
    B = G * R
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

    # K1: the routing fabric over [12, G, N] pooled rows
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

    # K4: the KV engine on [B, C] tables a quarter full, [B, E] rows
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

    res, apply_err = {}, {}
    for path, sh in PATHS.items():
        res[path], apply_err[path] = compare_kernels(dev, args.seed, sh)
        emit(dict(phase="compare", path=path, card=smi,
                  kv_apply_max_abs_err=apply_err[path],
                  kernels={k: dict(v, equal=v["err"] == 0)
                           for k, v in res[path].items()}))
        torch.cuda.empty_cache()
    bad = [f"{k}@{p}" for p, r in res.items() for k, v in r.items() if v["err"] != 0]
    if bad or any(apply_err.values()):
        fail("compare", f"kernels disagree with their plain versions: {bad}, "
                        f"kv_apply err {apply_err}")
    if not res["minpaxos"]["kv_insert"]["full_load"]["displaced"]:
        fail("compare", "the full-load kv_insert compare displaced no row, so "
                        "it did not hold the displacement pass to its twin")
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

    # one row per (kernel, path): the MinPaxos path's rows under the
    # kernel's name, the Mencius path's as name@mencius
    table = []
    for path, names in KERNELS.items():
        for name in names:
            src, repl = REPLACES[name]
            v = res[path][name]
            t_bytes = 1e3 * v["bytes"] / HBM_BYTES_PER_S
            t_ops = 1e3 * v["ops"] / ALU_OPS_PER_S
            table.append(dict(
                name=name if path == "minpaxos" or name == "exec_select"
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
