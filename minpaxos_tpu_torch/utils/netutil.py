"""Localhost port allocation for harnesses and benchmarks.

Replica servers follow the reference's port scheme: the control plane
listens on data port + 1000 (runtime/replica.py _start_control,
matching the reference's master-ping convention). A data port is
therefore only usable if its +1000 sibling is ALSO free — picking
ephemeral ports without checking the sibling makes the control bind
fail at startup with nothing but a silent dead replica to show for it.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import random
import socket
import tempfile
import time

CONTROL_OFFSET = 1000

#: a port handed out stays out of every other draw on this host (same
#: temporary directory) this long: the caller's server binds it within
#: seconds, and until then a concurrent harness in another process could
#: draw it too (free_ports releases what it tested)
RESERVE_S = 120.0
_RESERVED = os.path.join(tempfile.gettempdir(), "minpaxos_tpu_torch.ports")


@contextlib.contextmanager
def _reservations():
    """The host's recent hand-outs ({port: time}), under an exclusive
    lock across processes; what the block adds is written back."""
    with open(_RESERVED, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            f.seek(0)
            now = time.time()
            held = {}
            for line in f.read().split("\n"):
                try:
                    port, t = line.split()
                    if now - float(t) < RESERVE_S:
                        held[int(port)] = float(t)
                except ValueError:
                    continue  # a torn or foreign line reserves nothing
            yield held
            f.seek(0)
            f.truncate()
            f.write("".join(f"{p} {t}\n" for p, t in held.items()))
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _ephemeral_floor() -> int:
    """The lowest port the kernel hands to outbound connections."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_ports(n: int, sibling_offset: int = 0) -> list[int]:
    """n distinct free localhost ports. With ``sibling_offset`` > 0,
    each returned port p additionally has p + sibling_offset free
    (both are bound during selection, so concurrent callers in other
    processes cannot grab either; a process that does not share the
    reservations below can still take one between selection and the
    server's bind). Ports are drawn from below the kernel's ephemeral
    range while it leaves room: a port inside it can be taken between
    selection and the server's bind by any outbound connection of the
    host (a long-lived one held a control port past its 10 s bind
    retry); the kernel's own choice is the fallback. A port handed out
    by any process sharing the temporary directory is not handed out
    again for RESERVE_S (``_reservations``)."""
    with _reservations() as reserved:
        ports = _draw(n, sibling_offset, reserved)
        now = time.time()
        for p in ports:
            reserved[p] = now
            if sibling_offset:
                reserved[p + sibling_offset] = now
    return ports


def _draw(n: int, sibling_offset: int, reserved: dict) -> list[int]:
    held: list[socket.socket] = []
    ports: list[int] = []
    tries = 0
    hi = _ephemeral_floor() - 1 - sibling_offset
    rng = random.Random()
    try:
        while len(ports) < n:
            tries += 1
            if tries > 50 * n + 100:
                raise OSError(f"could not find {n} free port"
                              f"(+{sibling_offset}) pairs")
            s = socket.socket()
            want = rng.randint(10000, hi) if hi > 10000 and tries <= 40 * n else 0
            try:
                s.bind(("127.0.0.1", want))
            except OSError:
                s.close()
                continue
            p = s.getsockname()[1]
            if p in reserved or p + sibling_offset in reserved:
                s.close()
                continue
            if sibling_offset:
                if not (1024 < p and p + sibling_offset < 65536):
                    s.close()
                    continue
                s2 = socket.socket()
                try:
                    s2.bind(("127.0.0.1", p + sibling_offset))
                except OSError:
                    s.close()
                    s2.close()
                    continue
                held.append(s2)
            held.append(s)
            ports.append(p)
    finally:
        for s in held:
            s.close()
    return ports
