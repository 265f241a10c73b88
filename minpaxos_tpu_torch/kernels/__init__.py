"""Build, load and count the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, under
``kernels/build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. Nothing is built or loaded at import time: the first launch
of a kernel builds its library, and ``build_all()`` builds every library
at once, one ``nvcc`` process per source, all started together.

Every wrapper that launches a kernel is registered here with
``@kernel("name")``: it carries a plain integer ``launches`` that the
wrapper bumps once per launch, so a run can show which kernels its path
went through (``reset_launches`` / ``launch_counts``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD = HERE / "build"
SOURCES = ("route", "winner", "scan", "kvstore", "ackruns", "mencius_exec",
           "substeps")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: per source: the compiler's stderr (ptxas register / shared-memory
#: report) and the build seconds of the last build in this process
BUILD_LOG: dict[str, dict] = {}

_REGISTRY: dict[str, object] = {}


def kernel(name: str):
    """Register a launching wrapper under ``name`` with a launch count."""

    def deco(fn):
        fn.launches = 0
        _REGISTRY[name] = fn
        return fn

    return deco


def reset_launches() -> None:
    for fn in _REGISTRY.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _REGISTRY.items()}


def nvcc_path() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or CUDA_HOME)")


def _so_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` not built yet, one ``nvcc``
    per source, all in parallel. Returns build seconds per source
    (0.0 for one already built). Raises on the first failed build."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _so_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), tmp, out)
    secs = {n: 0.0 for n in names}
    errors = []
    for name, (p, tmp, out) in procs.items():
        so, se = p.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = dict(seconds=secs[name], log=(so or "") + (se or ""))
        if p.returncode != 0:
            errors.append(f"{name}.cu: nvcc exit {p.returncode}\n{se}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return secs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build_all((name,))
            so = ctypes.CDLL(str(_so_path(name)))
            so.mp_error_string.restype = ctypes.c_char_p
            so.mp_error_string.argtypes = [ctypes.c_int]
            _libs[name] = so
        return _libs[name]


def fn(libname: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argument types set (pointers and the
    stream as ``c_void_p``, so ctypes never truncates them)."""
    f = getattr(lib(libname), symbol)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def check(libname: str, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (or the kernel refused
    its shape)."""
    if rc != 0:
        msg = lib(libname).mp_error_string(rc).decode()
        raise RuntimeError(f"{what}: kernel launch failed ({rc}: {msg})")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def cuda_arg(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    """Validate a kernel argument: on a CUDA device with the exact dtype;
    returned contiguous. Anything else raises — no silent conversion to
    the CPU path."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    return t.contiguous()


def on_cpu(*ts: torch.Tensor) -> bool:
    """True iff the call takes the plain PyTorch path: every tensor lies
    on the CPU. A CUDA tensor takes the kernel; a mix, or another
    device, raises."""
    types = {t.device.type for t in ts}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return False
    raise RuntimeError(f"tensors on unsupported/mixed devices: {types}")
