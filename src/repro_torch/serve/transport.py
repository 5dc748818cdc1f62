"""Peer transport for the sharded query service: shm queues or framed TCP.

The parent <-> shard-worker link was born as a pair of ``mp.Queue``s plus
a shared-memory slab arena — perfect for same-host workers, useless the
moment a shard group lives in another process tree or on another host
(ROADMAP item 2: the distributed-memory half of the paper's design).
This module puts both links behind one tiny interface so the supervisor,
the chaos harness, and the worker loop never care which one they hold:

* :class:`QueuePeer` — the original path: pickled messages over
  ``mp.Queue``, plane payloads over the shm slab arena
  (``supports_slabs``).
* :class:`TcpPeer` — length-prefixed frames over a TCP socket.  A frame
  is ``8-byte little-endian length + pickled message``; the first frame
  each way is a JSON **hello** (never pickle before the peer is
  authenticated) carrying a per-spawn token and the transports the
  worker can offer, so the transport is *negotiated per peer*: the
  listener answers with the one it picked.  Connect and read honor
  per-peer timeouts; a worker whose connection drops reconnects with
  bounded exponential backoff and re-handshakes, and gives up (exits,
  so the supervisor respawns it) after ``reconnect_attempts``.

Failure signalling is uniform: ``recv`` raises :class:`PeerTimeout`
when nothing arrived in time and :class:`PeerClosed` when the link is
gone — the supervisor turns the former into health *misses* and the
latter into the death/respawn path.

:class:`PeerHealth` is the per-owner health state machine the router
consults (``alive -> suspect -> dead -> rejoining``): misses accumulate
from read timeouts / missed replies, any successful reply resets to
alive, death is terminal until the replacement worker reports ready.

:class:`ChaosState` is the fault-injection seam used by tests and
``benchmarks/serve_load.py --chaos``: a peer consults it on every
send/recv, so message **drops**, added **delays**, and **stalls** (a
hung peer that stops delivering without dying) are injected exactly at
the transport boundary they would occur at in production.
"""
from __future__ import annotations

import hmac
import json
import pickle
import queue as queue_mod
import socket
import struct
import threading
import time

from repro_torch.obs import monotime

#: wire magic for the hello frame; bump the digit on incompatible change
HELLO_MAGIC = "RPTP1"

#: refuse absurd frames before allocating for them (a corrupt or hostile
#: length prefix must not become a multi-GB allocation)
MAX_FRAME_BYTES = 1 << 30

_LEN = struct.Struct("<Q")


class PeerError(Exception):
    """Base class for transport failures."""


class PeerTimeout(PeerError):
    """Nothing arrived within the caller's timeout (a health *miss*)."""


class PeerClosed(PeerError):
    """The link is gone (EOF, reset, or closed queue) — the death path."""


# ---------------------------------------------------------------------------
# chaos injection
# ---------------------------------------------------------------------------

class ChaosState:
    """Thread-safe fault toggles one peer consults on every send/recv.

    ``drop``  — sends are silently discarded until the window expires
    (request loss: the worker never sees them, recovery must come from
    health timeouts + replay/failover, never from the client).
    ``delay`` — every send sleeps first (a slow link, not a dead one).
    ``stall`` — recvs deliver nothing until the window expires even if
    messages are queued (a hung peer / partition that later heals).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._drop_until = 0.0
        self._delay_s = 0.0
        self._delay_until = 0.0
        self._stall_until = 0.0
        self.dropped = 0  # messages eaten by drop windows (observability)

    def drop_for(self, seconds: float) -> None:
        with self._lock:
            self._drop_until = monotime() + float(seconds)

    def delay(self, seconds: float, *, for_s: float = 1e18) -> None:
        with self._lock:
            self._delay_s = max(0.0, float(seconds))
            self._delay_until = monotime() + float(for_s)

    def stall_for(self, seconds: float) -> None:
        with self._lock:
            self._stall_until = monotime() + float(seconds)

    def clear(self) -> None:
        with self._lock:
            self._drop_until = self._delay_until = self._stall_until = 0.0
            self._delay_s = 0.0

    # -- hooks peers call ---------------------------------------------------
    def on_send(self) -> bool:
        """Apply send-side faults; returns False if the message drops."""
        with self._lock:
            now = monotime()
            drop = now < self._drop_until
            delay = self._delay_s if now < self._delay_until else 0.0
            if drop:
                self.dropped += 1
        if delay:
            time.sleep(delay)
        return not drop

    def stalled_until(self) -> float:
        with self._lock:
            return self._stall_until

    def active(self) -> dict:
        with self._lock:
            now = monotime()
            return {"drop": max(0.0, self._drop_until - now),
                    "delay_s": self._delay_s
                    if now < self._delay_until else 0.0,
                    "stall": max(0.0, self._stall_until - now),
                    "dropped": self.dropped}


def _recv_with_stall(raw_recv, chaos: ChaosState | None, held: list,
                     timeout: float | None, bypass_chaos: bool):
    """Shared recv wrapper enforcing stall semantics: a message that
    arrives *during* a stall window (including one that was already in
    flight when the window was armed — the receiver may be blocked in
    the underlying read at arm time) is held, in order, and delivered
    only after the window expires.  ``bypass_chaos`` (the death-drain
    path) skips the wait but still drains held messages first so
    nothing is lost or reordered."""
    if not bypass_chaos:
        timeout = _wait_out_stall(chaos, timeout)
    if held:
        return held.pop(0)
    msg = raw_recv(timeout)
    if (not bypass_chaos and chaos is not None
            and chaos.stalled_until() > monotime()):
        held.append(msg)  # arrived inside the window: withhold it
        raise PeerTimeout("peer stalled")
    return msg


def _wait_out_stall(chaos: ChaosState | None, timeout: float | None
                    ) -> float | None:
    """Sleep through an active stall window (bounded by ``timeout``);
    returns the remaining timeout, or raises :class:`PeerTimeout` if the
    stall consumed it all."""
    if chaos is None:
        return timeout
    until = chaos.stalled_until()
    if until <= 0.0:
        return timeout
    now = monotime()
    if until <= now:
        return timeout
    stall = until - now
    if timeout is not None and stall >= timeout:
        time.sleep(timeout)
        raise PeerTimeout("peer stalled")
    time.sleep(stall)
    return None if timeout is None else max(0.0, timeout - stall)


# ---------------------------------------------------------------------------
# queue peer (same-host: mp.Queue control plane + shm slab payloads)
# ---------------------------------------------------------------------------

class QueuePeer:
    """One side of an ``mp.Queue`` pair; the original same-host link."""

    transport = "shm"
    supports_slabs = True

    def __init__(self, send_q, recv_q, *, chaos: ChaosState | None = None):
        self._send_q = send_q
        self._recv_q = recv_q
        self._held: list = []  # messages withheld by a stall window
        self.chaos = chaos

    def send(self, msg) -> None:
        if self.chaos is not None and not self.chaos.on_send():
            return  # dropped by an injected fault window
        try:
            self._send_q.put(msg)
        except (ValueError, OSError, AssertionError) as e:
            raise PeerClosed(str(e)) from e

    def _raw_recv(self, timeout: float | None):
        try:
            if timeout is None:
                return self._recv_q.get()
            if timeout <= 0.0:
                return self._recv_q.get_nowait()
            return self._recv_q.get(timeout=timeout)
        except queue_mod.Empty as e:
            raise PeerTimeout("no message") from e
        except (EOFError, OSError, ValueError) as e:
            raise PeerClosed(str(e)) from e

    def recv(self, timeout: float | None = None, *,
             bypass_chaos: bool = False):
        return _recv_with_stall(self._raw_recv, self.chaos, self._held,
                                timeout, bypass_chaos)

    def close(self) -> None:
        for q in (self._send_q, self._recv_q):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# framed TCP peer
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, payload: bytes) -> None:
    try:
        sock.sendall(_LEN.pack(len(payload)) + payload)
    except OSError as e:
        raise PeerClosed(str(e)) from e


def recv_frame(sock: socket.socket, timeout: float | None = None) -> bytes:
    """One length-prefixed frame; honors ``timeout`` across partial reads."""
    deadline = None if timeout is None else monotime() + timeout
    head = _recv_exact(sock, _LEN.size, deadline)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME_BYTES:
        raise PeerClosed(f"frame of {n} bytes exceeds cap {MAX_FRAME_BYTES}")
    return _recv_exact(sock, int(n), deadline)


def _recv_exact(sock: socket.socket, n: int, deadline: float | None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        if deadline is not None:
            left = deadline - monotime()
            if left <= 0.0:
                # mid-frame timeouts leave the stream unframed; the only
                # safe continuation is reconnect, so surface it as closed
                # when bytes were already consumed
                if buf:
                    raise PeerClosed("timeout mid-frame")
                raise PeerTimeout("no frame")
            sock.settimeout(left)
        else:
            sock.settimeout(None)
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout as e:
            if buf:
                raise PeerClosed("timeout mid-frame") from e
            raise PeerTimeout("no frame") from e
        except OSError as e:
            raise PeerClosed(str(e)) from e
        if not chunk:
            raise PeerClosed("EOF")
        buf.extend(chunk)
    return bytes(buf)


class TcpPeer:
    """Pickled messages over length-prefixed TCP frames.

    No slab arena across TCP — plane payloads ride inline in the frame
    (``supports_slabs`` is False, so the parent never hands this peer's
    worker a slab name).
    """

    transport = "tcp"
    supports_slabs = False

    def __init__(self, sock: socket.socket, *,
                 chaos: ChaosState | None = None):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._held: list = []  # messages withheld by a stall window
        self.chaos = chaos
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass

    def send(self, msg) -> None:
        if self.chaos is not None and not self.chaos.on_send():
            return
        payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        with self._send_lock:
            send_frame(self._sock, payload)

    def _raw_recv(self, timeout: float | None):
        return pickle.loads(recv_frame(self._sock, timeout))

    def recv(self, timeout: float | None = None, *,
             bypass_chaos: bool = False):
        return _recv_with_stall(self._raw_recv, self.chaos, self._held,
                                timeout, bypass_chaos)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# hello handshake + listener (parent side) + worker connect
# ---------------------------------------------------------------------------

def _hello_send(sock: socket.socket, obj: dict) -> None:
    send_frame(sock, json.dumps(obj).encode("utf-8"))


def _hello_recv(sock: socket.socket, timeout: float) -> dict:
    try:
        obj = json.loads(recv_frame(sock, timeout).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise PeerClosed(f"bad hello: {e}") from e
    if not isinstance(obj, dict) or obj.get("magic") != HELLO_MAGIC:
        raise PeerClosed("bad hello magic")
    return obj


class TcpListener:
    """Parent-side acceptor: one listening socket serves every shard.

    Each worker spawn registers an expected ``(shard, token)``; the
    accept loop handshakes incoming connections, matches the token, and
    hands the authenticated peer to ``on_peer(shard, TcpPeer)``.  A
    reconnecting worker presents the same token and simply replaces its
    previous peer.
    """

    def __init__(self, on_peer, *, host: str = "127.0.0.1",
                 handshake_timeout_s: float = 5.0):
        self._on_peer = on_peer
        self.handshake_timeout_s = float(handshake_timeout_s)
        self._sock = socket.create_server((host, 0))
        self.address = self._sock.getsockname()[:2]
        self._lock = threading.Lock()
        self._expected: dict[int, bytes] = {}
        self._chaos: dict[int, ChaosState] = {}
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="peer-accept")
        self._thread.start()

    def expect(self, shard: int, token: bytes,
               chaos: ChaosState | None = None) -> None:
        with self._lock:
            self._expected[int(shard)] = bytes(token)
            if chaos is not None:
                self._chaos[int(shard)] = chaos

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn: socket.socket) -> None:
        try:
            hello = _hello_recv(conn, self.handshake_timeout_s)
            shard = int(hello.get("shard", -1))
            token = bytes.fromhex(str(hello.get("token", "")))
            offered = hello.get("transports") or ["tcp"]
            with self._lock:
                want = self._expected.get(shard)
                chaos = self._chaos.get(shard)
            if want is None or not hmac.compare_digest(want, token):
                _hello_send(conn, {"magic": HELLO_MAGIC, "ok": False,
                                   "error": "unknown peer"})
                conn.close()
                return
            # negotiation: tcp is the only transport a socket can carry,
            # but the reply names the choice so a future same-host
            # upgrade (worker offers "shm") has its seam
            choice = "tcp" if "tcp" in offered else None
            _hello_send(conn, {"magic": HELLO_MAGIC, "ok": choice is not None,
                               "transport": choice})
            if choice is None:
                conn.close()
                return
        except PeerError:
            try:
                conn.close()
            except OSError:
                pass
            return
        self._on_peer(shard, TcpPeer(conn, chaos=chaos))

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def connect_peer(address: tuple[str, int], shard: int, token: bytes, *,
                 connect_timeout_s: float = 5.0,
                 reconnect_attempts: int = 5,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 1.0) -> TcpPeer:
    """Worker-side connect + hello with bounded exponential backoff.

    Raises :class:`PeerClosed` once every attempt is spent — the worker
    exits and the supervisor's respawn takes over from there.
    """
    last: Exception | None = None
    for attempt in range(max(1, int(reconnect_attempts))):
        if attempt:
            time.sleep(min(backoff_base_s * (2 ** (attempt - 1)),
                           backoff_max_s))
        try:
            sock = socket.create_connection(address,
                                            timeout=connect_timeout_s)
        except OSError as e:
            last = e
            continue
        try:
            _hello_send(sock, {"magic": HELLO_MAGIC, "shard": int(shard),
                               "token": bytes(token).hex(),
                               "transports": ["tcp"]})
            reply = _hello_recv(sock, connect_timeout_s)
            if not reply.get("ok"):
                raise PeerClosed(f"peer refused: {reply.get('error')}")
            sock.settimeout(None)
            return TcpPeer(sock)
        except PeerError as e:
            last = e
            try:
                sock.close()
            except OSError:
                pass
    raise PeerClosed(f"connect to {address} failed after "
                     f"{reconnect_attempts} attempts: {last}")


# ---------------------------------------------------------------------------
# per-owner health state machine
# ---------------------------------------------------------------------------

#: health states, in routing-preference order
ALIVE, REJOINING, SUSPECT, DEAD = "alive", "rejoining", "suspect", "dead"
_RANK = {ALIVE: 0, REJOINING: 1, SUSPECT: 2, DEAD: 3}


class PeerHealth:
    """``alive -> suspect -> dead -> rejoining -> alive``.

    *Misses* (read timeouts, unanswered dispatches) push alive toward
    suspect and suspect toward dead; any delivered reply snaps back to
    alive.  Process death jumps straight to dead; the supervisor marks
    rejoining when the replacement spawns and alive when it reports
    ready.  The router prefers lower :func:`rank` (alive first, dead
    never) when choosing among an owner set.
    """

    def __init__(self, *, suspect_after: int = 1, dead_after: int = 4):
        self.suspect_after = max(1, int(suspect_after))
        self.dead_after = max(self.suspect_after + 1, int(dead_after))
        self._lock = threading.Lock()
        self.state = ALIVE
        self.misses = 0
        self.transitions = 0
        self.since = monotime()

    def _to(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self.transitions += 1
            self.since = monotime()

    def miss(self) -> str:
        with self._lock:
            if self.state == DEAD:
                return self.state
            self.misses += 1
            if self.misses >= self.dead_after:
                self._to(DEAD)
            elif self.misses >= self.suspect_after \
                    and self.state in (ALIVE, SUSPECT):
                self._to(SUSPECT)
            return self.state

    def ok(self) -> None:
        with self._lock:
            self.misses = 0
            self._to(ALIVE)

    def dead(self) -> None:
        with self._lock:
            self._to(DEAD)

    def rejoining(self) -> None:
        with self._lock:
            self.misses = 0
            self._to(REJOINING)

    def rank(self) -> int:
        with self._lock:
            return _RANK[self.state]

    def routable(self) -> bool:
        """Dead owners are never routed to; everything else may be a
        last resort."""
        return self.rank() < _RANK[DEAD]

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "misses": self.misses,
                    "transitions": self.transitions,
                    "since_s": round(monotime() - self.since, 3)}
