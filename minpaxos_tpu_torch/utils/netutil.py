"""Localhost port allocation for harnesses and benchmarks.

Replica servers follow the reference's port scheme: the control plane
listens on data port + 1000 (runtime/replica.py _start_control,
matching the reference's master-ping convention). A data port is
therefore only usable if its +1000 sibling is ALSO free — picking
ephemeral ports without checking the sibling makes the control bind
fail at startup with nothing but a silent dead replica to show for it.
"""

from __future__ import annotations

import random
import socket

CONTROL_OFFSET = 1000


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
    processes cannot grab either; the usual bind-then-release TOCTOU
    window remains). Ports are drawn from below the kernel's ephemeral
    range while it leaves room: a port inside it can be taken between
    selection and the server's bind by any outbound connection of the
    host (a long-lived one held a control port past its 10 s bind
    retry); the kernel's own choice is the fallback."""
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
