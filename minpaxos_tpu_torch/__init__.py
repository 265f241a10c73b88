"""PyTorch/CUDA port of minpaxos_tpu for NVIDIA Hopper.

A package of its own beside ``minpaxos_tpu`` (the JAX reference). It
imports ``torch`` and numpy only — nothing of JAX and nothing of the
reference package — and keeps its own copies of the enums, wire codec,
stable store and host runtime it needs (``runtime/``: the TCP serving
path's replica server, master and client; ``cli/``: their binaries).
Device code is written over an explicit leading batch axis (B = groups
x replicas) instead of ``vmap``; the hot scatters, scans, routing, KV
engine and the serving step's output packing are CUDA C++ kernels for
``sm_90a`` (``kernels/csrc``), each with a plain PyTorch twin that the
CPU path and the tests use.

Entry points take ``device=`` and default to ``"cuda"``; without a card
that default raises instead of falling back to the CPU.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # lazy, so the package's numpy-only modules (``obs/``, the master's
    # RPC helpers, ``cli/tail.py``) import without torch
    if name == "resolve_device":
        from minpaxos_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'minpaxos_tpu_torch' has no attribute {name!r}")
