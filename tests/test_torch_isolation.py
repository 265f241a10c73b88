"""The port stands alone: no JAX, nothing of minpaxos_tpu, the card by default."""

from __future__ import annotations

import ast
import os
import pkgutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "minpaxos_tpu_torch")


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "wall_ab.py")
    yield os.path.join(ROOT, "k5_ab.py")
    yield os.path.join(ROOT, "profile_ab.py")
    yield os.path.join(ROOT, "k7_host.py")
    yield os.path.join(ROOT, "trace_ab.py")


def _modules():
    import minpaxos_tpu_torch

    yield "minpaxos_tpu_torch"
    for m in pkgutil.walk_packages(minpaxos_tpu_torch.__path__, "minpaxos_tpu_torch."):
        yield m.name


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['minpaxos_tpu'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import importlib\n"
        f"for name in {sorted(_modules())!r} + ['chip_smoke', 'wall_ab', 'profile_ab', 'k7_host', 'trace_ab']:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_walk_covers_the_soak_package():
    """The import walk above reaches the soak harness's modules."""
    mods = set(_modules())
    assert {"minpaxos_tpu_torch.soak", "minpaxos_tpu_torch.soak.profiles",
            "minpaxos_tpu_torch.soak.swarm"} <= mods
    files = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"soak/__init__.py", "soak/profiles.py", "soak/swarm.py"} <= files


def test_no_jax_or_reference_imports_in_the_port():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "minpaxos_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from minpaxos_tpu_torch.models.cluster import Cluster
    from minpaxos_tpu_torch.models.minpaxos import MinPaxosConfig
    from minpaxos_tpu_torch.parallel.sharded import ShardedCluster

    cfg = MinPaxosConfig(n_replicas=3, window=16, inbox=8, exec_batch=4, kv_pow2=4,
                         catchup_rows=2, recovery_rows=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedCluster(cfg, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        Cluster(cfg)
    from minpaxos_tpu_torch.models.mencius import MenciusCluster

    with pytest.raises(RuntimeError, match="cuda"):
        MenciusCluster(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedCluster(cfg, 2, protocol="mencius")


def test_kernel_wrappers_never_fall_back_for_non_cpu_tensors():
    """The CPU path is taken only for CPU tensors; a mix raises."""
    from minpaxos_tpu_torch import kernels as K

    cpu = torch.zeros(2)
    assert K.on_cpu(cpu, cpu)
    meta = torch.zeros(2, device="meta")
    with pytest.raises(RuntimeError):
        K.on_cpu(cpu, meta)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        K.cuda_arg(cpu, torch.float32, "x")

    # K5 (ackruns) and K6 (exec selector): a tensor off the CPU takes the
    # kernel or raises, and the kernel wrappers refuse CPU tensors
    from minpaxos_tpu_torch.ops import ackruns, mencius_exec

    def ts(device):
        i = torch.zeros((2, 8), dtype=torch.int32, device=device)
        b = torch.zeros((2, 8), dtype=torch.bool, device=device)
        u = torch.zeros((2, 8), dtype=torch.uint8, device=device)
        v = torch.zeros(2, dtype=torch.int32, device=device)
        return i, b, u, v

    i, b, u, v = ts("cpu")
    mi, mb, mu, _ = ts("meta")
    with pytest.raises(RuntimeError):
        ackruns.compress_ack_runs(mb, i, i, b)
    with pytest.raises(RuntimeError):
        ackruns.compress_ack_runs(b, i, i, b, ballot=mi, stride=5)
    with pytest.raises(RuntimeError):
        ackruns.range_vote_bits(b, i, mi, i, v, 8, 5, stride=5)
    with pytest.raises(RuntimeError):
        ackruns.range_vote_bits(b, i, i, i, v, 8, 5, into=mi, mask=b)
    with pytest.raises(RuntimeError):
        ackruns.scatter_vote_bits(8, i, mi, b, 5)
    with pytest.raises(RuntimeError):
        ackruns.scatter_vote_bits(8, i, i, b, 5, into=mi)
    with pytest.raises(RuntimeError):
        mencius_exec.exec_select(i, i, mu, u, b, v, v, v, 4)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ackruns._compress_kernel(b, i, i, b, None, 1)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ackruns._vote_bits_kernel(b, i, i, i, v, 8, 5, 5)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ackruns._vote_bits_kernel(b, i, i, i, v, 8, 5, 5, into=i, mask=b)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ackruns._scatter_vote_bits_kernel(8, i, i, b, 5)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ackruns._scatter_vote_bits_kernel(8, i, i, b, 5, into=i)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        mencius_exec._exec_select_kernel(i, i, u, u, b, v, v, v, 4)

    # K3's frontier update: the same for its status, cursors and flags
    from minpaxos_tpu_torch.ops import scan

    with pytest.raises(RuntimeError):
        scan.advance_frontier(mu, 4, v, v)
    with pytest.raises(RuntimeError):
        scan.advance_frontier(u, 5, v, v, executed=mb)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        scan._advance_frontier_kernel(u, 4, v, v)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        scan._advance_frontier_kernel(u, 5, v, v, executed=b)


def test_serving_path_modules_are_walked():
    """Every module of the serving path, the CLI entry points included,
    is among those imported with JAX blocked above."""
    walked = set(_modules())
    for name in ("wire.codec", "wire.messages", "utils.netutil", "utils.clock",
                 "utils.dlog", "obs.metrics", "runtime.stable", "runtime.batches",
                 "runtime.transport", "runtime.replica", "runtime.master",
                 "runtime.client", "ops.substeps", "cli.master", "cli.server",
                 "cli.client"):
        assert f"minpaxos_tpu_torch.{name}" in walked, name


def test_chip_smoke_launches_no_module_of_the_jax_package():
    """chip_smoke.py starts the port's processes only: it names no
    dotted module of the JAX package (``python -m minpaxos_tpu.cli...``);
    the JAX package's files appear only as the text of ``replaces``."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "minpaxos_tpu." not in src.replace("minpaxos_tpu_torch", ""), \
        "chip_smoke.py names a module of the JAX package"


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from minpaxos_tpu_torch.cli.server import build_parser
    from minpaxos_tpu_torch.runtime.replica import ReplicaServer, RuntimeFlags

    assert build_parser().parse_args([]).device == "cuda"
    assert RuntimeFlags().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicaServer(0, [("127.0.0.1", 1)])
    for flag in ("-platform", "-nowatch"):
        with pytest.raises(SystemExit):
            build_parser().parse_args([flag] if flag != "-platform" else [flag, "cpu"])
    # the recorder and paxtrace flags, with the JAX package's defaults
    args = build_parser().parse_args([])
    assert (args.norecorder, args.notrace, args.tracepow2, args.tracering,
            args.recring) == (False, False, 4, 4096, 4096)
    f = RuntimeFlags()
    assert (f.recorder, f.trace, f.trace_pow2, f.trace_ring, f.recorder_ring) == (
        True, True, 4, 4096, 4096)
    args = build_parser().parse_args(["-norecorder", "-notrace", "-tracepow2", "0"])
    assert args.norecorder and args.notrace and args.tracepow2 == 0


def test_pack_outputs_never_falls_back_for_non_cpu_tensors():
    """K7's wrapper takes the plain twin only for CPU tensors."""
    from minpaxos_tpu_torch.models.minpaxos import (
        ExecResult,
        MinPaxosConfig,
        MsgBatch,
        Outbox,
        init_replica,
    )
    from minpaxos_tpu_torch.ops import substeps

    cfg = MinPaxosConfig(n_replicas=3, window=8, inbox=4, exec_batch=2, kv_pow2=4,
                         catchup_rows=2, recovery_rows=2)
    st = init_replica(cfg, [0], device="cpu")
    ob = Outbox(MsgBatch.empty(1, 4, "cpu"), torch.zeros((1, 4), dtype=torch.int32),
                torch.zeros((1, 4), dtype=torch.bool))
    z = torch.zeros((1, 2), dtype=torch.int32)
    ex = ExecResult(torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                    z, z, z.bool(), z, z, z)
    row = substeps.pack_outputs(st, ob, ex)
    assert row.shape == (1, substeps.row_width(4, 2, 3))
    with pytest.raises(RuntimeError):
        substeps.pack_outputs(st, ob, ex, out=torch.empty(row.shape, dtype=torch.int32,
                                                          device="meta"))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        substeps._pack_kernel(st, ob, ex, row, st.window_base)


def test_loop_kernels_never_fall_back():
    """K8, K9 and K10: a device other than the CPU takes the kernel or
    raises; every kernel source is listed and present."""
    from minpaxos_tpu_torch import kernels as K
    from minpaxos_tpu_torch.models.minpaxos import MsgBatch
    from minpaxos_tpu_torch.ops import resident, winner, workload

    assert all((K.CSRC / f"{n}.cu").exists() for n in K.SOURCES)
    assert {"workload", "resident", "slotwrite"} <= set(K.SOURCES)
    for name in ("propose_rows", "round_open", "round_close", "slot_write", "gather_rows"):
        assert name in K.launch_counts()
    with pytest.raises(RuntimeError):
        workload.propose_batch(5, 2, 8, 4, 0, 1, 0, 64, device="meta")
    st = SimpleNamespace(**{f: torch.zeros(10, dtype=torch.int32)
                            for f in ("committed_upto", "crt_inst", "executed_upto")})
    with pytest.raises(RuntimeError):
        resident.round_open(resident.new_scratch(2, "cpu"), st,
                            torch.zeros((10, 4), dtype=torch.int32, device="meta"),
                            0, 2, 4, 0, True, True, 1)
    with pytest.raises(RuntimeError):
        resident.round_close(resident.new_scratch(2, "cpu"),
                             torch.zeros((2, 8), dtype=torch.int32, device="meta"),
                             torch.zeros(4, dtype=torch.int32),
                             torch.zeros((0, 9), dtype=torch.int32), st, 0, 1, 0, 0)
    inbox = MsgBatch.empty(2, 4, "cpu")
    old = tuple(torch.zeros((2, 8), dtype=torch.uint8 if f in ("status", "op")
                            else torch.int32) for f in winner.SLOT_COLS)
    me = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError):
        winner.slot_write(winner.WRITE_A, 8, torch.zeros((2, 4), dtype=torch.int32,
                                                         device="meta"),
                          torch.zeros((2, 4), dtype=torch.bool),
                          torch.zeros((2, 4), dtype=torch.bool), inbox, old, me,
                          n_replicas=5)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        winner._slot_write_kernel(winner.WRITE_A, 8, torch.zeros((2, 4), dtype=torch.int32),
                                  torch.zeros((2, 4), dtype=torch.bool),
                                  torch.zeros((2, 4), dtype=torch.bool), inbox, old, me,
                                  None, 5)


def test_verify_modules_are_walked():
    """The model checker's modules and its CLI are among those imported
    with JAX blocked above (and so import nothing of the JAX package)."""
    walked = set(_modules())
    for name in ("verify", "verify.invariants", "verify.quorum", "verify.quorum_golden",
                 "verify.spec", "verify.mc", "verify.refine", "verify.liveness", "cli.mc"):
        assert f"minpaxos_tpu_torch.{name}" in walked, name


def test_chaos_and_watch_modules_are_walked():
    """The fault campaigns, the health watcher and their CLI are among
    those imported with JAX blocked above (and so import nothing of the
    JAX package, not even its numpy-only chaos and watch modules)."""
    walked = set(_modules())
    for name in ("chaos", "chaos.plan", "chaos.shim", "chaos.check", "chaos.campaign",
                 "obs.watch", "cli.chaos"):
        assert f"minpaxos_tpu_torch.{name}" in walked, name


def test_trace_and_recorder_modules_are_walked():
    """paxtrace, the flight recorder and the tail CLI are among those
    imported with JAX blocked above (and so import nothing of the JAX
    package)."""
    walked = set(_modules())
    for name in ("obs.trace", "obs.recorder", "obs.watch", "cli.tail",
                 "runtime.master", "parallel.sharded"):
        assert f"minpaxos_tpu_torch.{name}" in walked, name
