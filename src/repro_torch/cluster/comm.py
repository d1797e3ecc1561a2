"""Pluggable message layer for the scheduler/worker cluster.

The shape of dask distributed's ``distributed/comm``: one abstract
:class:`Comm` (point-to-point, message-oriented) and one abstract
:class:`Listener`, with two concrete backends behind one address scheme:

* ``inproc://<name>`` — process-local queue pairs for deterministic
  tests: no sockets, no OS scheduling in the delivery path, FIFO per
  direction.  Messages still round-trip through the wire encoding so
  anything that works inproc works over TCP byte-for-byte.
* ``tcp://<host>:<port>`` — stdlib ``socket`` streams for real
  deployment, length-prefixed frames, one accept thread per listener.

**Framing.**  Every message is one frame: a 4-byte big-endian length
followed by a JSON document.  Values that JSON cannot carry ride in
tagged envelopes — ``numpy`` arrays as raw-bytes base64 (bit-exact, no
float repr round-trip) and other Python objects (a submitted
:class:`~repro_torch.api.problem.Problem`, a returned factorization) as
pickled base64.  A ``torch`` object is refused (:class:`TypeError`):
only host numpy data goes on the wire, and a worker converts to and from
its device at its own edge.  The encoding is applied on *both* backends, so the
inproc path cannot hide a serialization bug the TCP path would hit.

**Retry/backoff.**  :func:`connect` retries refused connections with
exponential backoff; exhaustion raises :class:`CommError` carrying the
attempt count.  Per-connection send/receive never retries — a broken
stream surfaces as :class:`CommClosedError` and the cluster layer above
decides (the scheduler treats it like a heartbeat loss).

**Fault injection.**  Every comm owns a :class:`FaultInjector`; tests
arm it to drop or fail the next N sends (optionally filtered by the
message's ``op``) to exercise dropped heartbeats, lost results and
retry exhaustion deterministically.

Comm traffic is observable: ``repro_comm_messages_total`` /
``repro_comm_bytes_total`` counters (labelled by direction and backend)
land in the metrics registry (:mod:`repro_torch.obs.metrics`).
"""
from __future__ import annotations

import base64
import json
import pickle
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30  # 1 GiB sanity bound on a single message


class CommError(RuntimeError):
    """Connection-level failure (refused, retries exhausted, bad address)."""


class CommClosedError(CommError):
    """The peer (or this side) closed the stream."""


# ----------------------------------------------------------------------
# Wire encoding: JSON + tagged envelopes for arrays / arbitrary objects
# ----------------------------------------------------------------------
def _enc(obj):
    if isinstance(obj, dict):
        return {str(k): _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {
            "__nd__": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype),
            "shape": list(a.shape),
        }
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if type(obj).__module__.split(".")[0] == "torch":
        # device data never rides the wire: workers convert at their edge
        raise TypeError(
            f"{type(obj).__name__} in a cluster message; send numpy arrays"
        )
    return {"__py__": base64.b64encode(pickle.dumps(obj)).decode("ascii")}


def _dec(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            data = base64.b64decode(obj["__nd__"])
            return np.frombuffer(data, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]
            ).copy()
        if "__py__" in obj:
            return pickle.loads(base64.b64decode(obj["__py__"]))
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def encode(msg: dict) -> bytes:
    """One message → one frame payload (length prefix not included)."""
    return json.dumps(_enc(msg), separators=(",", ":")).encode("utf-8")


def decode(payload: bytes) -> dict:
    return _dec(json.loads(payload.decode("utf-8")))


# ----------------------------------------------------------------------
# Fault injection
# ----------------------------------------------------------------------
class FaultInjector:
    """Deterministic send-side fault hooks for tests.

    ``drop(n, op=...)`` silently discards the next ``n`` matching sends
    (a lossy link: dropped heartbeats, lost results); ``fail(n,
    op=...)`` makes them raise :class:`CommClosedError` (a broken
    stream).  ``op=None`` matches every message.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rules: List[Dict] = []
        self.dropped = 0
        self.failed = 0

    def drop(self, n: int = 1, op: Optional[str] = None) -> None:
        with self._lock:
            self._rules.append({"kind": "drop", "n": int(n), "op": op})

    def fail(self, n: int = 1, op: Optional[str] = None) -> None:
        with self._lock:
            self._rules.append({"kind": "fail", "n": int(n), "op": op})

    def check(self, msg: dict) -> str:
        """'ok' | 'drop' | 'fail' for this message (consumes one charge)."""
        op = msg.get("op")
        with self._lock:
            for rule in self._rules:
                if rule["n"] > 0 and (rule["op"] is None or rule["op"] == op):
                    rule["n"] -= 1
                    if rule["kind"] == "drop":
                        self.dropped += 1
                        return "drop"
                    self.failed += 1
                    return "fail"
        return "ok"


def _count(direction: str, backend: str, nbytes: int) -> None:
    from repro_torch.obs import events as obs_events
    from repro_torch.obs import metrics as obs_metrics

    if not obs_events.enabled():
        return
    obs_metrics.REGISTRY.counter(
        "repro_comm_messages_total", "cluster comm messages"
    ).inc(direction=direction, backend=backend)
    obs_metrics.REGISTRY.counter(
        "repro_comm_bytes_total", "cluster comm payload bytes", unit="B"
    ).inc(nbytes, direction=direction, backend=backend)


# ----------------------------------------------------------------------
# Abstract surface
# ----------------------------------------------------------------------
class Comm:
    """One point-to-point message stream."""

    backend = "abstract"

    def __init__(self, local: str, peer: str) -> None:
        self.local = local
        self.peer = peer
        self.faults = FaultInjector()
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def send(self, msg: dict) -> None:
        if self._closed:
            raise CommClosedError(f"send on closed comm to {self.peer}")
        verdict = self.faults.check(msg)
        if verdict == "drop":
            return
        if verdict == "fail":
            raise CommClosedError(
                f"injected send failure to {self.peer} (op={msg.get('op')!r})"
            )
        payload = encode(msg)
        if len(payload) > MAX_FRAME:
            raise CommError(f"frame of {len(payload)} B exceeds MAX_FRAME")
        self._send_payload(payload)
        _count("sent", self.backend, len(payload))

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Next message, or ``None`` on timeout.  Raises
        :class:`CommClosedError` once the stream is finished."""
        payload = self._recv_payload(timeout)
        if payload is None:
            return None
        _count("recv", self.backend, len(payload))
        return decode(payload)

    def close(self) -> None:
        self._closed = True

    # backend hooks ----------------------------------------------------
    def _send_payload(self, payload: bytes) -> None:
        raise NotImplementedError

    def _recv_payload(self, timeout: Optional[float]) -> Optional[bytes]:
        raise NotImplementedError

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return f"<{type(self).__name__} {self.local} -> {self.peer} [{state}]>"


class Listener:
    """Accepts connections on one address, invoking ``handler(comm)``."""

    def __init__(self, address: str, handler: Callable[[Comm], None]) -> None:
        self.address = address
        self.handler = handler

    def close(self) -> None:
        raise NotImplementedError


# ----------------------------------------------------------------------
# InProc backend (deterministic tests)
# ----------------------------------------------------------------------
_SENTINEL = object()  # queue poison pill marking peer close


class InProcComm(Comm):
    backend = "inproc"

    def __init__(
        self,
        local: str,
        peer: str,
        send_q: "queue.Queue",
        recv_q: "queue.Queue",
    ) -> None:
        super().__init__(local, peer)
        self._send_q = send_q
        self._recv_q = recv_q

    def _send_payload(self, payload: bytes) -> None:
        self._send_q.put(payload)

    def _recv_payload(self, timeout: Optional[float]) -> Optional[bytes]:
        if self._closed:
            raise CommClosedError(f"recv on closed comm from {self.peer}")
        try:
            item = self._recv_q.get(timeout=timeout) if timeout != 0 else (
                self._recv_q.get_nowait()
            )
        except queue.Empty:
            return None
        if item is _SENTINEL:
            self._closed = True
            raise CommClosedError(f"peer {self.peer} closed the stream")
        return item

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._send_q.put(_SENTINEL)


_INPROC_LOCK = threading.Lock()
_INPROC: Dict[str, "InProcListener"] = {}


class InProcListener(Listener):
    def __init__(self, address: str, handler: Callable[[Comm], None]) -> None:
        super().__init__(address, handler)
        with _INPROC_LOCK:
            if address in _INPROC:
                raise CommError(f"inproc address {address!r} already bound")
            _INPROC[address] = self
        self._n = 0

    def _connect(self, client_label: str) -> Comm:
        a2b: "queue.Queue" = queue.Queue()
        b2a: "queue.Queue" = queue.Queue()
        self._n += 1
        server_side = InProcComm(
            self.address, f"{client_label}#{self._n}", b2a, a2b
        )
        client_side = InProcComm(client_label, self.address, a2b, b2a)
        self.handler(server_side)
        return client_side

    def close(self) -> None:
        with _INPROC_LOCK:
            if _INPROC.get(self.address) is self:
                del _INPROC[self.address]


# ----------------------------------------------------------------------
# TCP backend (stdlib sockets, length-prefixed frames)
# ----------------------------------------------------------------------
class TCPComm(Comm):
    backend = "tcp"

    def __init__(self, sock: socket.socket, local: str, peer: str) -> None:
        super().__init__(local, peer)
        self._sock = sock
        self._send_lock = threading.Lock()
        self._buf = b""

    def _send_payload(self, payload: bytes) -> None:
        try:
            with self._send_lock:
                self._sock.sendall(_LEN.pack(len(payload)) + payload)
        except OSError as e:
            self._closed = True
            raise CommClosedError(f"send to {self.peer} failed: {e}") from e

    def _read_exact(self, n: int, deadline: Optional[float]) -> Optional[bytes]:
        while len(self._buf) < n:
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._sock.settimeout(left)
            else:
                self._sock.settimeout(None)
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                return None
            except OSError as e:
                self._closed = True
                raise CommClosedError(f"recv from {self.peer}: {e}") from e
            if not chunk:
                self._closed = True
                raise CommClosedError(f"peer {self.peer} closed the stream")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_payload(self, timeout: Optional[float]) -> Optional[bytes]:
        if self._closed:
            raise CommClosedError(f"recv on closed comm from {self.peer}")
        deadline = None if timeout is None else time.monotonic() + timeout
        # NB: a timeout mid-frame keeps the partial bytes buffered, so the
        # next recv() resumes the same frame — no tearing.
        head = self._read_exact(_LEN.size, deadline)
        if head is None:
            return None
        (n,) = _LEN.unpack(head)
        if n > MAX_FRAME:
            raise CommError(f"peer announced oversized frame ({n} B)")
        self._buf = head + self._buf  # un-consume until the body arrives
        body = self._read_exact(_LEN.size + n, deadline)
        if body is None:
            return None
        return body[_LEN.size :]

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class TCPListener(Listener):
    def __init__(self, address: str, handler: Callable[[Comm], None]) -> None:
        host, port = _parse_tcp(address)
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)
        real_port = self._sock.getsockname()[1]
        super().__init__(f"tcp://{host}:{real_port}", handler)
        self._stop = threading.Event()
        self._comms: List[TCPComm] = []
        self._thread = threading.Thread(
            target=self._accept_loop,
            name="repro_torch-cluster-accept",
            daemon=True,
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            comm = TCPComm(sock, self.address, f"tcp://{addr[0]}:{addr[1]}")
            self._comms.append(comm)
            self.handler(comm)

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)
        for c in self._comms:
            c.close()


def _parse_tcp(address: str) -> Tuple[str, int]:
    rest = address[len("tcp://") :]
    host, _, port = rest.rpartition(":")
    if not host or not port:
        raise CommError(f"bad tcp address {address!r} (want tcp://host:port)")
    return host, int(port)


# ----------------------------------------------------------------------
# The pluggable entry points
# ----------------------------------------------------------------------
def listen(address: str, handler: Callable[[Comm], None]) -> Listener:
    """Bind a listener; ``handler(comm)`` fires per inbound connection.

    The handler runs in the accept path (the connector's thread for
    inproc, the accept loop for TCP) and must return promptly — hand
    long-lived streams to their own thread.  ``tcp://host:0`` binds an
    ephemeral port — read the real address back from
    ``listener.address``.
    """
    if address.startswith("inproc://"):
        return InProcListener(address, handler)
    if address.startswith("tcp://"):
        return TCPListener(address, handler)
    raise CommError(f"unknown address scheme in {address!r}")


@dataclass
class RetryPolicy:
    """Exponential backoff for :func:`connect`."""

    retries: int = 5  # attempts beyond the first
    backoff: float = 0.05  # first sleep (seconds)
    factor: float = 2.0
    max_backoff: float = 2.0

    def sleeps(self) -> List[float]:
        out, b = [], self.backoff
        for _ in range(self.retries):
            out.append(min(b, self.max_backoff))
            b *= self.factor
        return out


def connect(
    address: str,
    *,
    label: str = "client",
    retry: Optional[RetryPolicy] = None,
    timeout: float = 5.0,
) -> Comm:
    """Connect with retry/backoff; raises :class:`CommError` after
    exhausting ``retry.retries + 1`` attempts."""
    retry = retry if retry is not None else RetryPolicy()
    sleeps = retry.sleeps() + [None]  # final attempt has no sleep after it
    attempts = 0
    last: Optional[Exception] = None
    for pause in sleeps:
        attempts += 1
        try:
            return _connect_once(address, label, timeout)
        except (CommError, OSError) as e:
            last = e
        if pause is not None:
            time.sleep(pause)
    raise CommError(
        f"connect to {address!r} failed after {attempts} attempts: {last}"
    )


def _connect_once(address: str, label: str, timeout: float) -> Comm:
    if address.startswith("inproc://"):
        with _INPROC_LOCK:
            listener = _INPROC.get(address)
        if listener is None:
            raise CommError(f"no inproc listener at {address!r}")
        return listener._connect(f"inproc://{label}")
    if address.startswith("tcp://"):
        host, port = _parse_tcp(address)
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        local = "tcp://%s:%d" % sock.getsockname()[:2]
        return TCPComm(sock, local, address)
    raise CommError(f"unknown address scheme in {address!r}")


__all__ = [
    "Comm",
    "CommClosedError",
    "CommError",
    "FaultInjector",
    "InProcComm",
    "InProcListener",
    "Listener",
    "RetryPolicy",
    "TCPComm",
    "TCPListener",
    "connect",
    "decode",
    "encode",
    "listen",
]
