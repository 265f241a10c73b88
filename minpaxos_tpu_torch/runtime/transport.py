"""TCP transport: peer mesh + client listener for a replica process.

The port's copy of the JAX package's ``runtime/transport.py``, with its
fault-injection hook (the ``chaos`` shim, ``chaos/shim.py``), its
event-journal records of peer links going up and down and its
per-command tracing hook (the ``trace`` sink: reader threads stamp the
decode span of sampled client proposes).

Counterpart of the reference's genericsmr connection plumbing
(genericsmr.go:125-400): full TCP mesh where the lower-id replica dials
and the higher-id listens, a 1-byte connection-type handshake
(CLIENT/PEER, genericsmrproto.go:16-17), per-connection buffered
writers flushed once per batch, reconnect-on-failure both outbound
(ReconnectToPeer :254-287) and inbound (peerReconnector :377-400).

Threading: readers decode frames and enqueue
``(src_kind, conn_id, kind, rows)`` onto one queue owned by the
protocol thread; writes happen only from the protocol thread through
``send``/``flush_all``. Single-owner by construction — the reference's
benign data races cannot exist here. Each peer link has a reader
thread of its own; every client connection is read by one ``selectors``
loop (``_client_loop``), where the JAX package starts a thread per
client connection: a leader serving a swarm of thousands of sessions
would otherwise run a thread per session, and a host that limits a
process's threads ends such a process outright.
"""

from __future__ import annotations

import queue
import selectors
import socket
import threading
import time
import traceback

import numpy as np

from minpaxos_tpu_torch.obs.trace import ST_DECODE
from minpaxos_tpu_torch.obs.watch import EV_PEER_DOWN, EV_PEER_UP
from minpaxos_tpu_torch.utils.clock import monotonic_ns
from minpaxos_tpu_torch.utils.dlog import dlog
from minpaxos_tpu_torch.wire.codec import FrameWriter, StreamDecoder
from minpaxos_tpu_torch.wire.messages import MsgKind

FROM_PEER = 0
FROM_CLIENT = 1
CONN_LOST = 2


class _Conn:
    # frames_in/rows_in/bytes_in are owned by this connection's reader
    # thread and frames_out by the protocol thread (the only writer) —
    # single-writer tallies, aggregated lock-free-at-the-hot-path into
    # the metrics registry via fn-gauges at snapshot time
    __slots__ = ("sock", "writer", "alive", "frames_in", "rows_in",
                 "bytes_in", "frames_out")

    def __init__(self, sock):
        self.sock = sock
        self.writer = FrameWriter(sock)
        self.alive = True
        self.frames_in = 0
        self.rows_in = 0
        self.bytes_in = 0
        self.frames_out = 0


class Transport:
    """Owns every socket of one replica process."""

    def __init__(self, me: int, addrs: list[tuple[str, int]],
                 inbox_queue: "queue.Queue | None" = None, metrics=None):
        self.me = me
        self.addrs = addrs  # data-port address of every replica, by id
        self.n = len(addrs)
        self.queue: queue.Queue = inbox_queue or queue.Queue()
        self.peers: dict[int, _Conn] = {}
        self.clients: dict[int, _Conn] = {}
        # tallies of connections that were REPLACED (peer redial): the
        # fn-gauges below must stay monotonic — summing live conns
        # only would regress the totals on every reconnect, turning
        # delta-based rates negative. Guarded by _lock.
        self._closed_tallies = {"frames_in": 0, "rows_in": 0,
                                "bytes_in": 0, "frames_out": 0}
        # fault-injection shim (chaos/shim.py): consulted per peer frame
        # in send_peer/_read_loop when installed. Without one a frame
        # pays one attribute load and an is-None test. _chaos_retired
        # carries the fault totals of replaced shims, so the fn-gauge
        # stays monotonic across install/heal cycles.
        self.chaos = None
        self._chaos_retired = 0
        # paxtrace sink (obs/trace.py): when installed and enabled,
        # reader threads stamp a frame-decode span for client PROPOSE
        # frames carrying a sampled command, each into its own ring;
        # otherwise one attribute load and a test per chunk
        self.trace = None
        # event journal (obs/watch.py): peer links going up and down,
        # recorded when installed (one attribute load when absent)
        self.journal = None
        # per-peer dial suppression state: a refused dial doubles the
        # peer's suppression window instead of re-timing out every
        # 0.5 s — a flapping or partitioned peer must not price a
        # connect timeout into every dispatch. Written by the protocol
        # thread (refusal) AND the accept thread (inbound-install
        # reset), both under self._lock; dial_peer's lone window read
        # stays lock-free (a stale read costs one extra suppression)
        self._dial_fails: dict[int, int] = {}
        self._dial_window: dict[int, float] = {}
        self._dial_tallies = {"ok": 0, "refused": 0, "suppressed": 0}
        if metrics is not None:
            # wire visibility in the owner's registry: evaluated at
            # snapshot time (obs/metrics.py fn_gauge), so the per-frame
            # hot path stays a plain attribute add on the _Conn
            metrics.fn_gauge("peer_conns_alive", self._peers_alive)
            metrics.fn_gauge("client_conns", lambda: len(self.clients))
            # ingress depth: works for a plain Queue and for the
            # IngressCoalescer (both expose qsize); sampled at snapshot
            metrics.fn_gauge("ingress_queue_depth", self.queue.qsize)
            for attr in ("frames_in", "rows_in", "bytes_in", "frames_out"):
                metrics.fn_gauge(f"net_{attr}",
                                 lambda a=attr: self._net_total(a))
            # dial outcomes: 'suppressed' (backoff window) vs 'refused'
            # (real connect failure) are distinct signals — peer_alive
            # false + dials_suppressed rising means backoff, not churn
            for k in ("ok", "refused", "suppressed"):
                metrics.fn_gauge(f"dials_{k}",
                                 lambda k=k: self._dial_tallies[k])
            metrics.fn_gauge("chaos_injected", self.chaos_faults_total)
        # Client connection ids are globally unique across replicas
        # (replica id in the high bits): command provenance travels
        # through the log as (client_id, cmd_id), and a follower
        # executing a leader-proposed command must never mistake the
        # leader's conn id for one of its own.
        self._next_client = me << 20
        self._lock = threading.Lock()  # guards peers/clients maps only
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        self._last_dial: dict[int, float] = {}
        # every client connection's reads: one selector, one thread
        # (started with the listener)
        self._csel = selectors.DefaultSelector()

    def _conns(self) -> list:
        with self._lock:
            return list(self.peers.values()) + list(self.clients.values())

    def _peers_alive(self) -> int:
        with self._lock:
            return sum(c.alive for c in self.peers.values())

    def _net_total(self, attr: str) -> int:
        with self._lock:
            total = self._closed_tallies[attr]
            conns = list(self.peers.values()) + list(self.clients.values())
        return total + sum(getattr(c, attr) for c in conns)

    # -- fault injection (chaos/shim.py) --

    def set_chaos(self, shim) -> None:
        """Install (or, with None, heal) the fault-injection shim.
        Called from the control thread; readers load the attribute once
        per frame, so the swap is the whole synchronization of the data
        path. The old shim stops first (it delivers the frames it held
        and no tally advances past its stopped flag); its total is then
        folded into the retired carry and the new shim swapped in under
        the lock ``chaos_faults_total`` shares, so the gauge never steps
        down."""
        if shim is not None:
            from minpaxos_tpu_torch.chaos import shim as _chaos_shim

            assert _chaos_shim.FROM_PEER == FROM_PEER
        old = self.chaos
        if old is not None:
            old.stop()  # outside the lock: stop delivers held frames
        with self._lock:
            if old is not None:
                self._chaos_retired += old.faults_total()
            self.chaos = shim

    def chaos_faults_total(self) -> int:
        ch = self.chaos
        if ch is None:
            # no lock without a shim: _chaos_retired changes only in
            # set_chaos, before the swap to None is visible
            return self._chaos_retired
        with self._lock:
            ch = self.chaos
            total = self._chaos_retired
        return total if ch is None else total + ch.faults_total()

    # -- lifecycle --

    def listen(self) -> None:
        host, port = self.addrs[self.me]
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # retry: a quickly-revived replica (kill/revive harnesses, the
        # reference's singleserverreconnect.sh shape) can race its
        # predecessor's listener close — same retry the control port
        # has always had (replica.py _start_control)
        deadline = time.monotonic() + 10.0
        while True:
            try:
                s.bind((host, port))
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        s.listen(64)
        self._listener = s
        threading.Thread(target=self._accept_loop, daemon=True).start()
        threading.Thread(target=self._client_loop, daemon=True).start()

    def connect_peers(self) -> None:
        """Dial every lower-id peer (higher ids dial us); the handshake
        byte + our id identifies us on the other side."""
        for q in range(self.me):
            self.dial_peer(q)

    #: dial backoff ceiling: a peer refusing for a while is re-tried at
    #: most this often; any successful connect (either direction)
    #: resets its window to the base rate
    DIAL_BACKOFF_CAP_S = 5.0

    def dial_peer(self, q: int, rate_limit_s: float = 0.5) -> bool:
        """(Re)connect to peer q. The suppression window is PER PEER
        and doubles on every refused dial (up to DIAL_BACKOFF_CAP_S):
        the old per-call wall-clock limit let a flapping link re-pay a
        full connect timeout every 0.5 s on the protocol thread. The
        dials_{ok,refused,suppressed} tallies make 'peer dead' vs
        'dial suppressed by backoff' distinguishable in stats."""
        now = time.monotonic()
        window = self._dial_window.get(q, rate_limit_s)
        if now - self._last_dial.get(q, -1e9) < window:
            self._dial_tallies["suppressed"] += 1
            return False
        self._last_dial[q] = now
        prev = self.peers.get(q)
        try:
            sock = socket.create_connection(self.addrs[q], timeout=1.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(bytes([int(MsgKind.HANDSHAKE_PEER), self.me]))
        except OSError:
            with self._lock:
                # an inbound handshake can land (accept thread) while
                # this connect was timing out; growing the window then
                # would suppress the first redial after that live conn
                # later drops — only record the refusal if no install
                # raced us
                if self.peers.get(q) is prev:
                    fails = self._dial_fails.get(q, 0) + 1
                    self._dial_fails[q] = fails
                    self._dial_window[q] = min(
                        rate_limit_s * (2 ** fails),
                        self.DIAL_BACKOFF_CAP_S)
            self._dial_tallies["refused"] += 1
            return False
        self._dial_tallies["ok"] += 1
        self._install_peer(q, sock)
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self.peers.values()) + list(self.clients.values())
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
        try:
            self._csel.close()
        except (OSError, RuntimeError):
            pass

    # -- accept / read --

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._handshake, args=(sock,),
                             daemon=True).start()

    def _handshake(self, sock) -> None:
        """First byte: connection type; peers send their id next."""
        try:
            t = sock.recv(1)
            if not t:
                sock.close()
                return
            t = t[0]
            if t == int(MsgKind.HANDSHAKE_PEER):
                pid = sock.recv(1)
                if not pid:
                    sock.close()
                    return
                self._install_peer(pid[0], sock)
            elif t == int(MsgKind.HANDSHAKE_CLIENT):
                with self._lock:
                    cid = self._next_client
                    self._next_client += 1
                    self.clients[cid] = conn = _Conn(sock)
                try:
                    self._csel.register(sock, selectors.EVENT_READ,
                                        (cid, conn, StreamDecoder()))
                except (ValueError, RuntimeError):  # stopped meanwhile
                    sock.close()
            else:
                sock.close()
        except OSError:
            try:
                sock.close()
            except OSError:
                pass

    def _install_peer(self, q: int, sock) -> None:
        with self._lock:
            old = self.peers.get(q)
            if old is not None:
                # fold the replaced conn's tallies into the carry so
                # the net_* gauges never go backward on redial (the
                # old reader thread may race a final frame in — a
                # bounded monitoring undercount, not a regression)
                for attr in self._closed_tallies:
                    self._closed_tallies[attr] += getattr(old, attr)
            self.peers[q] = conn = _Conn(sock)
            # live connection (either direction) resets q's dial
            # backoff — under the lock, paired with dial_peer's
            # refused-path write, so a racing refusal can't re-grow
            # the window after this conn landed
            self._dial_fails.pop(q, None)
            self._dial_window.pop(q, None)
        if old is not None:
            try:
                old.sock.close()
            except OSError:
                pass
        j = self.journal
        if j is not None:
            j.record(EV_PEER_UP, subject=q)
        dlog(f"replica {self.me}: peer {q} connected")
        threading.Thread(target=self._read_loop, args=(q, conn),
                         daemon=True).start()

    def _feed(self, src_kind: int, conn_id: int, conn: _Conn,
              dec: StreamDecoder, chunk: bytes) -> bool:
        """Decode one received chunk and enqueue its frames; False once
        the stream is corrupt (the caller ends the connection)."""
        # the decode span's t0 covers the frame parse, so the clock
        # is read before feed, and only when a sink traces
        tr = self.trace
        t_dec0 = (monotonic_ns() if tr is not None and tr.enabled
                  and src_kind == FROM_CLIENT else 0)
        try:
            frames = dec.feed(chunk)
        except ValueError:
            return False
        conn.bytes_in += len(chunk)
        conn.frames_in += len(frames)
        for kind, rows in frames:
            conn.rows_in += len(rows)
            if t_dec0 and kind == MsgKind.PROPOSE:
                # one vectorized hash per propose frame; spans only
                # for sampled commands
                tr.stamp_batch(ST_DECODE, rows["cmd_id"], t_dec0,
                               monotonic_ns())
            # the fault-injection gate, peer links only: without a
            # shim one attribute load and an is-None test per frame
            ch = self.chaos
            if ch is not None and src_kind == FROM_PEER:
                ch.ingest(conn_id, kind, rows)
            else:
                self.queue.put((src_kind, conn_id, kind, rows))
        return dec.error is None

    def _read_loop(self, q: int, conn: _Conn) -> None:
        """Peer q's reader thread."""
        dec = StreamDecoder()
        sock = conn.sock
        while not self._stop.is_set():
            try:
                chunk = sock.recv(1 << 16)
            except OSError:
                break
            if not chunk or not self._feed(FROM_PEER, q, conn, dec, chunk):
                break
        conn.alive = False
        j = self.journal
        if j is not None and not self._stop.is_set():
            j.record(EV_PEER_DOWN, subject=q)  # shutdown is no news
        self.queue.put((CONN_LOST, -1 - q, None, None))
        try:
            sock.close()
        except OSError:
            pass

    def _client_loop(self) -> None:
        """Every client connection's reads, in one thread: a readable
        socket is read once per wakeup (a ready socket never blocks),
        its frames enqueued as a reader thread would; end of stream, a
        read error or a corrupt frame ends that connection alone."""
        sel = self._csel
        while not self._stop.is_set():
            try:
                events = sel.select(timeout=0.05)
            except (OSError, ValueError):
                return  # the selector was closed by stop()
            for key, _ in events:
                cid, conn, dec = key.data
                try:
                    chunk = conn.sock.recv(1 << 16)
                    if chunk and self._feed(FROM_CLIENT, cid, conn, dec, chunk):
                        continue
                except OSError:
                    pass
                # paxlint: disable=broad-except -- one connection's fault
                # ends that connection, as its own reader thread's death
                # would; every other client's reads go on
                except Exception:
                    traceback.print_exc()
                conn.alive = False
                try:
                    sel.unregister(conn.sock)
                except (KeyError, ValueError):
                    pass
                self.queue.put((CONN_LOST, cid, None, None))
                try:
                    conn.sock.close()
                except OSError:
                    pass

    # -- write (protocol thread only) --

    def send_peer(self, q: int, kind: MsgKind, rows: np.ndarray) -> bool:
        conn = self.peers.get(q)
        if conn is None or not conn.alive:
            return False
        # the outbound gate: a blocked link swallows the frame and
        # reports success, as TCP under an asymmetric partition does,
        # so the caller does not redial a peer that is alive
        ch = self.chaos
        if ch is not None and not ch.allow_send(q):
            return True
        try:
            conn.writer.write(kind, rows)
            conn.frames_out += 1
            return True
        except OSError:
            conn.alive = False
            return False

    def send_client(self, cid: int, kind: MsgKind, rows: np.ndarray) -> bool:
        conn = self.clients.get(cid)
        if conn is None or not conn.alive:
            return False
        try:
            conn.writer.write(kind, rows)
            conn.frames_out += 1
            return True
        except OSError:
            conn.alive = False
            return False

    def flush_all(self) -> None:
        with self._lock:
            conns = list(self.peers.items()) + list(self.clients.items())
        for _, conn in conns:
            if conn.alive:
                try:
                    conn.writer.flush()
                except OSError:
                    conn.alive = False

    def peer_alive(self, q: int) -> bool:
        conn = self.peers.get(q)
        return conn is not None and conn.alive
