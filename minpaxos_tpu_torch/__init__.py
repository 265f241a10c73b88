"""PyTorch/CUDA port of minpaxos_tpu for NVIDIA Hopper.

A package of its own beside ``minpaxos_tpu`` (the JAX reference). It
imports ``torch`` and numpy only — nothing of JAX and nothing of the
reference package — and keeps its own copies of the enums and host
helpers it needs. Device code is written over an explicit leading batch
axis (B = groups x replicas) instead of ``vmap``; the hot scatters,
scans, routing and KV engine are CUDA C++ kernels for ``sm_90a``
(``kernels/csrc``), each with a plain PyTorch twin that the CPU path
and the tests use.

Entry points take ``device=`` and default to ``"cuda"``; without a card
that default raises instead of falling back to the CPU.
"""

from minpaxos_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
