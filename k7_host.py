#!/usr/bin/env python3
"""Host time of one K7 ``pack_outputs`` launch, step by step.

    python3 k7_host.py [--calls 2000] [--repeats 5] [--seed 0]

At one TCP server's shape (``chip_smoke.py``'s ``compare_pack`` input:
the leader's row of a live three-replica exchange at ``TCP_SHAPE``),
times on the host's clock, in microseconds per call (the median of
``--repeats`` runs of ``--calls`` calls back to back, the card synced
before each run and not inside it):

- ``pack_outputs``: the public entry, as the serving path calls it;
- ``pack_kernel``: the wrapper under it (sources, launch, count);
- ``launcher``: ``ops/substeps.py _launch`` on ready sources;
- ``pack_sources``: the 36 source slots in order;
- ``layout_key``: the cache key (37 tensors' metadata);
- ``entry``: key and cache hit, what a launch pays for its layout;
- ``no_cache``: what a launch without the cache would pay instead,
  ``pack_layout`` and the device check (a fresh ``PackLayout``);
- ``layout_alloc``: that fresh ``PackLayout`` alone, so that
  ``no_cache - layout_alloc`` is a fill of one preallocated layout;
- ``ptr_fill``: the 36 data pointers into the cached array;
- ``c_call``: the ctypes call that launches the kernel;
- ``stream``: ``kernels.stream``, the raw stream handle;
- ``stream_obj``: ``torch.cuda.current_stream().cuda_stream``;
- ``on_cpu``: ``kernels.on_cpu``'s check of three tensors;
- ``zero_1``: an eager ``zero_()`` of one int32, a PyTorch launch.

Prints one JSON line, then the card's name and power limit. Needs one
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

import chip_smoke as cs
from minpaxos_tpu_torch import kernels as K
from minpaxos_tpu_torch.ops import substeps


def host_us(fn, calls: int, repeats: int) -> float:
    """Median host microseconds per call of ``fn``."""
    for _ in range(20):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k7_host.py: needs a CUDA card")
    K.build_all()
    dev = torch.device("cuda")
    best = None
    for _, _, st, ob, ex in cs._exchange(dev, cs.tcp_cfg(), args.seed, 6, cs.TCP_BATCH):
        if best is None or int(ex.count[0]) >= int(best[2].count[0]):
            best = (cs._row_of(st, 0), cs._row_of(ob, 0), cs._row_of(ex, 0))
    st, ob, ex = best
    out = substeps.pack_outputs(st, ob, ex)
    base = st.window_base
    srcs = substeps.pack_sources(st, ob, ex, base)
    launch = substeps._launch
    launch(srcs, out)
    _, ptrs, lay_at, ptrs_at = launch.entry(srcs, out)
    one = torch.zeros(1, dtype=torch.int32, device=dev)

    def no_cache():
        substeps.pack_layout(srcs, out)
        for t in (out, *srcs):
            if t is not None and (t.device.type != "cuda" or t.device != out.device):
                raise RuntimeError("pack_outputs: source off the card")

    def ptr_fill():
        ptrs[:] = [None if t is None else t.data_ptr() for t in srcs]

    parts = {
        "pack_outputs": lambda: substeps.pack_outputs(st, ob, ex, out),
        "pack_kernel": lambda: substeps._pack_kernel(st, ob, ex, out, base),
        "launcher": lambda: launch(srcs, out),
        "pack_sources": lambda: substeps.pack_sources(st, ob, ex, base),
        "layout_key": lambda: substeps.layout_key(srcs, out),
        "entry": lambda: launch.entry(srcs, out),
        "no_cache": no_cache,
        "layout_alloc": substeps.PackLayout,
        "ptr_fill": ptr_fill,
        "c_call": lambda: launch.fn(lay_at, ptrs_at, out.data_ptr(), K.stream(out)),
        "stream": lambda: K.stream(out),
        "stream_obj": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "on_cpu": lambda: K.on_cpu(out, ob.msgs.kind, st.committed_upto),
        "zero_1": one.zero_,
    }
    want = substeps._pack_plain(st, ob, ex, torch.empty_like(out), base)
    res = {k: round(host_us(fn, args.calls, args.repeats), 3) for k, fn in parts.items()}
    err = cs.max_abs_err(substeps.pack_outputs(st, ob, ex, out), want)
    print(json.dumps(dict(host_us=res, max_abs_err=err, calls=args.calls,
                          repeats=args.repeats)), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    if err != 0:
        raise SystemExit("k7_host.py: K7 disagrees with its plain twin")


if __name__ == "__main__":
    main()
