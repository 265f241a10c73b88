"""The paxray telemetry-row layout of the resident loop.

The port's partial copy of the JAX package's ``obs/recorder.py``: only
the layout of the one int32 row per protocol round that the resident
loop writes into its telemetry ring (``parallel/sharded.py``), and the
post-window filter of a ring readback. The Perfetto rendering of the
rows (``device_round_events``) and the host flight recorder are not
ported yet.

Fields: round — absolute protocol round (-1 = row never written);
committed_delta — instances committed this round, summed over groups
at the cursor replica; in_flight — assigned but uncommitted after the
round; assigned — log slots assigned this round; injected_rows — live
workload rows in the round's ext batch; inbox_rows — routed peer rows
delivered from the pending inboxes (drain sub-steps included);
claim_rows — executed-slot delta (rows through the KV apply);
prepared_shards — groups whose cursor replica is a prepared leader
(every group for Mencius); inbox_hwm — the round's largest delivered
inbox of one replica, routed + injected.
"""

from __future__ import annotations

import numpy as np

(TEL_ROUND, TEL_COMMITTED, TEL_IN_FLIGHT, TEL_ASSIGNED, TEL_INJECTED,
 TEL_INBOX_ROWS, TEL_CLAIM_ROWS, TEL_PREPARED, TEL_INBOX_HWM) = range(9)
N_TEL_FIELDS = 9
TEL_FIELD_NAMES = ("round", "committed_delta", "in_flight", "assigned",
                   "injected_rows", "inbox_rows", "claim_rows",
                   "prepared_shards", "inbox_hwm")


def telemetry_valid_rows(buf) -> np.ndarray:
    """The written rows of a telemetry ring readback, sorted by round
    ([n, N_TEL_FIELDS]); rows never written (round -1) are dropped."""
    rows = np.asarray(buf)
    if rows.ndim != 2 or rows.shape[1] != N_TEL_FIELDS:
        raise ValueError(f"telemetry buffer must be [n, {N_TEL_FIELDS}], "
                         f"got {rows.shape}")
    rows = rows[rows[:, TEL_ROUND] >= 0]
    return rows[np.argsort(rows[:, TEL_ROUND], kind="stable")]
