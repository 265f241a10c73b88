"""Device selection: the card by default, the CPU only on request."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``None`` and the default mean ``"cuda"``. A CUDA device on a machine
    without a usable card raises: nothing moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "minpaxos_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev
