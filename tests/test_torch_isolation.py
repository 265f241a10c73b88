"""The port stands alone: no JAX, nothing of minpaxos_tpu, the card by default."""

from __future__ import annotations

import ast
import os
import pkgutil
import subprocess
import sys

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
        f"for name in {sorted(_modules())!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


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
        ackruns.scatter_vote_bits(8, i, mi, b, 5)
    with pytest.raises(RuntimeError):
        mencius_exec.exec_select(i, i, mu, u, b, v, v, v, 4)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ackruns._compress_kernel(b, i, i, b, None, 1)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ackruns._vote_bits_kernel(b, i, i, i, v, 8, 5, 5)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ackruns._scatter_vote_bits_kernel(8, i, i, b, 5)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        mencius_exec._exec_select_kernel(i, i, u, u, b, v, v, v, 4)
