"""paxray: one int32 telemetry row per round of the resident loop.

The port of the JAX package's ``ops/telemetry.py``. ``telemetry_row``
is the plain form of the row the resident loop writes into its ring at
``(round - tel_base) mod rows``; on the card the row is assembled by
kernel K9 (``ops/resident.py round_close``) from per-group terms, and
this function is what its plain twin uses. The field order is the
``obs/recorder.py`` layout, asserted below.
"""

from __future__ import annotations

import torch

from minpaxos_tpu_torch.obs.recorder import (
    N_TEL_FIELDS,
    TEL_ASSIGNED,
    TEL_CLAIM_ROWS,
    TEL_COMMITTED,
    TEL_FIELD_NAMES,
    TEL_IN_FLIGHT,
    TEL_INBOX_HWM,
    TEL_INBOX_ROWS,
    TEL_INJECTED,
    TEL_PREPARED,
    TEL_ROUND,
)

__all__ = ["telemetry_row", "N_TEL_FIELDS", "TEL_FIELD_NAMES"]


def telemetry_row(round_idx, committed_delta, in_flight, assigned,
                  injected_rows, inbox_rows, claim_rows, prepared_shards,
                  inbox_hwm, device=None) -> torch.Tensor:
    """One ``[N_TEL_FIELDS]`` int32 row from 0-d tensors or ints."""
    fields = {
        TEL_ROUND: round_idx,
        TEL_COMMITTED: committed_delta,
        TEL_IN_FLIGHT: in_flight,
        TEL_ASSIGNED: assigned,
        TEL_INJECTED: injected_rows,
        TEL_INBOX_ROWS: inbox_rows,
        TEL_CLAIM_ROWS: claim_rows,
        TEL_PREPARED: prepared_shards,
        TEL_INBOX_HWM: inbox_hwm,
    }
    assert sorted(fields) == list(range(N_TEL_FIELDS))
    # a Python int becomes a fill, not a host copy (CUDA-graph safe)
    return torch.stack([v.to(torch.int32) if isinstance(v, torch.Tensor)
                        else torch.full((), v, dtype=torch.int32, device=device)
                        for v in (fields[i] for i in range(N_TEL_FIELDS))])
