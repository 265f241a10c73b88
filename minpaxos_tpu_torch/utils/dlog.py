"""Debug logging, gated at import time.

Counterpart of reference src/dlog/dlog.go:5-19, where a compile-time
``const DLOG = false`` makes every call a no-op the compiler can erase.
Python has no compile-time consts, so we read the ``MINPAXOS_DLOG`` env
var once at import and bind ``dlog`` to a no-op when disabled — the
per-call overhead is one dead function call, and hot paths are expected
to guard with ``if DLOG:`` exactly like the reference's callers rely on
the constant.

Enabled-path line format (interleaved multi-replica stderr must be
attributable, which raw timestamps alone are not)::

    [dlog r2 1234.567890 +1.250ms] replica 2: dispatch [5]

* ``r2`` — the process-wide id set by ``set_dlog_id`` (the server CLI
  sets ``r<replica id>`` after registration; absent until set, e.g.
  for clients and the master).
* ``1234.567890`` — ``time.monotonic()`` at the call. CLOCK_MONOTONIC
  is machine-wide on Linux, so lines from different replica processes
  on one host sort onto a single timeline.
* ``+1.250ms`` — delta since this process's previous dlog line: burst
  spacing readable without subtracting timestamps by hand.
"""

from __future__ import annotations

import os
import sys
import time

DLOG: bool = os.environ.get("MINPAXOS_DLOG", "0") not in ("", "0", "false", "False")

_ID: str = ""
_LAST: float | None = None


def set_dlog_id(tag) -> None:
    """Set the process-wide log prefix (e.g. ``r0``). One replica per
    process is the deployment shape (cli/server.py); the in-process
    test harness leaves it unset and relies on message text."""
    global _ID
    _ID = str(tag)


def _dlog_enabled(fmt: str, *args) -> None:
    global _LAST
    ts = time.monotonic()
    delta_ms = 0.0 if _LAST is None else (ts - _LAST) * 1e3
    _LAST = ts
    msg = (fmt % args) if args else fmt
    tag = f" {_ID}" if _ID else ""
    print(f"[dlog{tag} {ts:.6f} +{delta_ms:.3f}ms] {msg}",
          file=sys.stderr, flush=True)


def _dlog_disabled(fmt: str, *args) -> None:  # pragma: no cover - trivial
    pass


# bound once at import: the disabled path stays a no-op function call,
# never a conditional inside the logger
dlog = _dlog_enabled if DLOG else _dlog_disabled
