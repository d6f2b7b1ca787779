"""Length-prefixed TCP RPC — the data plane (``persia_tpu/rpc.py``).

The wire is byte for byte the JAX package's, so a peer of either package
talks to a peer of the other. Envelopes and array heads are MessagePack,
written and read by the port's own codec (:mod:`persia_tpu_torch._msgpack`).
Wire format per message:

    u32 frame_len | u8 flags | u16 env_len | [u32 tag] | envelope | payload

Envelope: ``[method, payload_len]`` for requests, ``[status, payload_len]``
for responses; the payload is raw bytes (numpy buffers travel uncopied
into the socket). flags bit 0 = payload is zstd-compressed (mirrors the
reference's ``_compressed`` method variants); flags bit 1 = the frame
carries a u32 sequence **tag** between the fixed header and the envelope.

Tags make responses self-describing — a response carries the tag of the
request it answers — which lets the server complete requests
**out of order** (slow shard no longer head-of-line blocks fast ones)
and lets the client multiplex many requests on one connection
(:meth:`RpcClient.call_future`). Tagged framing is negotiated per
connection: a client that wants it sends a ``__tags__`` request first;
servers that support tags answer ``ok``, legacy peers (e.g. the JAX
package's C++ ``ps_server``) answer "no such method" and the connection stays
untagged — fully backward compatible in both directions.

Trace context (:mod:`persia_tpu_torch.tracing`) rides the envelope the same
negotiated way: a client whose process has tracing ENABLED probes
``__trace__`` at dial time; when the server acks, requests carry an
extra ``[trace_id, parent_span_id]`` envelope slot and the server runs
each handler under a child span — one ``trace_id`` then links a trainer
step to its worker stages to the per-shard PS handlers, across both the
serial and the out-of-order dispatch paths. Legacy peers answer the
probe "no such method" and never see the extra slot; with tracing
disabled (the default) the probe itself is never sent, so the wire is
byte-identical to the untraced protocol.

Two more optional envelope slots follow the same negotiate-down rule:
a client that wants **deadline propagation** probes ``__deadline__`` at
dial time; when the server acks, each call may carry its remaining time
budget (seconds) as a fourth envelope slot, and the server SHEDS work
whose budget expired before dispatch (typed back to the caller as
:class:`RpcDeadlineExceeded`). Neither probe nor slot exists when the
feature is off — byte-identical legacy wire.

Failures are typed: transport-level loss surfaces as
:class:`RpcTimeout` / :class:`RpcConnectionLost` (subclassing the
builtin ``TimeoutError`` / ``ConnectionError`` so existing catch
clauses keep working), application errors stay plain :class:`RpcError`,
and a :class:`CircuitBreaker` (per-replica, used by ``PsClient``) fails
fast with :class:`RpcCircuitOpen` instead of re-walking the retry
ladder against a dead peer. Deterministic fault injection
(:mod:`persia_tpu_torch.faults`) hooks the client send and server receive
paths behind a zero-overhead ``_active`` guard.

Numpy arrays are framed with :func:`pack_arrays` / :func:`unpack_arrays`.
:func:`pack_arrays_sg` is the zero-copy twin: it returns a buffer LIST
that ``sendmsg``/writev hands to the kernel without the ``tobytes()``
concatenation copies, and the receive side reads each frame with
``recv_into`` into one preallocated buffer so ``unpack_arrays`` returns
views — bytes on the wire are bit-identical either way.

The server runs a thread per connection (clients hold few, long-lived
connections — trainers and workers, not end users).
"""

import os
import queue as _queue
import random
import select
import socket
import struct
import threading
import time as _time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from persia_tpu_torch import _msgpack, faults, knobs, tracing

try:
    import zstandard

    # ZstdCompressor/ZstdDecompressor objects are NOT safe for concurrent
    # use from multiple threads (observed as wire corruption under the
    # pipelined trainer); keep one pair per thread.
    _zstd_local = threading.local()

    def _zstd_c() -> "zstandard.ZstdCompressor":
        c = getattr(_zstd_local, "c", None)
        if c is None:
            c = _zstd_local.c = zstandard.ZstdCompressor(level=3)
        return c

    def _zstd_d() -> "zstandard.ZstdDecompressor":
        d = getattr(_zstd_local, "d", None)
        if d is None:
            d = _zstd_local.d = zstandard.ZstdDecompressor()
        return d
except ImportError:  # pragma: no cover
    zstandard = None

_FLAG_COMPRESSED = 1
_FLAG_TAGGED = 2
# request hint: more requests may already be in flight on this
# connection — the dispatch-pool server must NOT execute inline on the
# reader thread (a slow handler would head-of-line block the others)
_FLAG_PIPELINED = 4
# payload is block-compressed with the codec negotiated by the
# ``__codec__`` probe (lz4 when both sides have it, zlib fallback); the
# first payload byte names the algorithm, so the frame is self-decoding
# — but the flag is only ever SENT on a connection that negotiated it,
# so legacy peers never see a frame they cannot parse
_FLAG_BLOCK = 8
COMPRESS_THRESHOLD = 1 << 16
BLOCK_THRESHOLD = 1 << 16

# --- negotiated block compression (the __codec__ wire) -------------------
# zstd (above) predates the codec negotiation and stays as-is where the
# library exists; this path is the lz4-or-zlib block codec from the
# reference's lz4-compressed RPC, made safe by negotiation instead of by
# assuming both ends were built alike.
_BLOCK_LZ4 = 1
_BLOCK_ZLIB = 2

try:
    import lz4.frame as _lz4_frame
except ImportError:  # pragma: no cover — zlib fallback always exists
    _lz4_frame = None

import zlib as _zlib

# force block compression even on loopback (tests + bench exercise the
# codec path without a real DCN link; normal loopback traffic skips it,
# same rule as the zstd path — pure CPU tax there). Frozen at import on
# purpose (registered import_time_safe): this sits on the per-frame
# hot path.
_FORCE_BLOCK = knobs.get("PERSIA_RPC_FORCE_BLOCK")

# The server-side refusal table for dunder-named wire extensions: every
# ``__x__`` method a client may probe MUST be declared here, and
# :meth:`RpcServer.register` rejects any dunder handler that is not —
# an undeclared extension cannot ship by accident. ``envelope`` kind ==
# an opt-in negotiated envelope slot whose OFF wire must stay
# byte-identical to the legacy protocol (pinned by served-request-count
# tests); ``control`` kind == a plain opt-in control method with no
# envelope slot. The table is the JAX package's: the port answers the
# same probes the same way.
ENVELOPE_EXTENSIONS: Dict[str, Dict[str, str]] = {
    "__tags__": {
        "kind": "envelope",
        "doc": "tagged frames: u32 request ids, out-of-order responses",
    },
    "__trace__": {
        "kind": "envelope",
        "doc": "distributed-tracing context rides an extra envelope slot",
    },
    "__deadline__": {
        "kind": "envelope",
        "doc": "per-call deadline propagation; servers shed expired work",
    },
    "__codec__": {
        "kind": "envelope",
        "doc": "negotiated payload codec: block compression + half-"
               "precision rows",
    },
    "__routing__": {
        "kind": "envelope",
        "doc": "routing-epoch rider: client stamps its slot-table epoch "
               "on request meta so a resharding server fast-rejects "
               "stale-epoch writes; opt-in via PERSIA_ROUTING_WIRE",
    },
    "__faults__": {
        "kind": "control",
        "doc": "remote fault-injection control, opt-in via "
               "PERSIA_FAULTS_RPC=1",
    },
    "__shutdown__": {
        "kind": "control",
        "doc": "cooperative server stop (handled inline by the serve "
               "loops, never dispatched to a handler)",
    },
}


def block_codecs() -> List[str]:
    """Locally supported block codecs, preference order first."""
    return (["lz4", "zlib"] if _lz4_frame is not None else ["zlib"])


def _block_compress(data: bytes, algo: str) -> bytes:
    if algo == "lz4" and _lz4_frame is not None:
        return bytes((_BLOCK_LZ4,)) + _lz4_frame.compress(data)
    return bytes((_BLOCK_ZLIB,)) + _zlib.compress(data, 1)


def _block_decompress(payload) -> bytes:
    buf = payload if isinstance(payload, (bytes, bytearray)) \
        else bytes(payload)
    algo, body = buf[0], buf[1:]
    if algo == _BLOCK_LZ4:
        if _lz4_frame is None:  # pragma: no cover — negotiation prevents
            raise RpcError("lz4 block payload but lz4 unavailable")
        return _lz4_frame.decompress(body)
    if algo == _BLOCK_ZLIB:
        return _zlib.decompress(body)
    raise RpcError(f"unknown block codec id {algo}")

# A payload is bytes, OR a buffer list from pack_arrays_sg (scatter-
# gather: written with one sendmsg instead of concatenated first).
Payload = Union[bytes, bytearray, memoryview, list, tuple]


def _is_loopback(sock: socket.socket) -> bool:
    """Compression exists for DCN links; on loopback it is pure CPU
    overhead (embedding/sign payloads are near-incompressible: zstd-3
    spends ~35 ms per 7 MB for a 7% size win, measured on this host)."""
    try:
        peer = sock.getpeername()[0]
    except OSError:
        return False
    if peer.startswith("::ffff:"):
        # IPv4-mapped IPv6 (dual-stack listeners hand these out for
        # plain 127.0.0.1 connects); strip the mapping prefix so local
        # traffic is not mis-billed the zstd CPU
        peer = peer[7:]
    return peer.startswith("127.") or peer == "::1"


class RpcError(RuntimeError):
    """Base of the typed RPC failure hierarchy. Application-level errors
    (a handler raised) are plain ``RpcError``; transport-level failures
    surface as the subclasses below, which ALSO subclass the builtin
    exception callers historically caught (``ConnectionError`` /
    ``TimeoutError``) — existing ``except (RpcError, ConnectionError,
    OSError)`` clauses keep working, while new callers can distinguish
    retryable transport loss from fatal application errors."""


class RpcTimeout(RpcError, TimeoutError):
    """The socket timed out waiting for the peer (``socket.timeout`` is
    a ``TimeoutError``/``OSError``, so legacy catch clauses still
    match). Retryable: the request MAY have executed."""


class RpcConnectionLost(RpcError, ConnectionError):
    """The connection died mid-call (reset, closed, refused). Retryable
    for idempotent/dedup'd methods; the completed state of an in-flight
    request is ambiguous."""


class RpcDeadlineExceeded(RpcError):
    """The server shed the request because its propagated deadline had
    already passed at dispatch time (or a deadline-aware layer failed
    it fast). NOT retryable with the same deadline — the time budget is
    spent; callers degrade instead (serving zero-vector fallback)."""


class RpcCircuitOpen(RpcConnectionLost):
    """Fail-fast refusal: the replica's :class:`CircuitBreaker` is open
    after consecutive transport failures. No wire traffic happened; a
    background probe re-closes the breaker when the replica returns."""


# server-side shed marker: the client maps this envelope prefix back to
# the typed exception (the err slot carries "ExcName: message" strings)
_DEADLINE_ERR = "RpcDeadlineExceeded"

# err-envelope exception names that re-type on the client. A handler in
# a MIDDLE tier (worker) that loses ITS downstream hop (PS) reports
# "ConnectionResetError: ..." through a perfectly healthy connection —
# without this mapping the caller sees a plain RpcError and every
# transport-aware layer above (serving degradation, pipeline
# lost-update accounting) misclassifies a nested outage as an
# application bug. Plain OSError is deliberately NOT mapped: it carries
# genuine application failures (filesystem errors in dump/load paths)
# that must surface, not be silently retried/dropped as transport loss.
_REMOTE_LOST = frozenset((
    "RpcConnectionLost", "RpcCircuitOpen", "ConnectionError",
    "ConnectionResetError", "ConnectionRefusedError",
    "ConnectionAbortedError", "BrokenPipeError",
))
_REMOTE_TIMEOUT = frozenset(("RpcTimeout", "TimeoutError", "timeout"))


def _typed_call_error(addr: str, method: str, msg: str) -> RpcError:
    msg = str(msg)
    name = msg.split(":", 1)[0]
    full = f"{addr} {method}: {msg}"
    if name == _DEADLINE_ERR:
        return RpcDeadlineExceeded(full)
    if name in _REMOTE_LOST:
        return RpcConnectionLost(full)
    if name in _REMOTE_TIMEOUT:
        return RpcTimeout(full)
    return RpcError(full)


def _typed_transport_error(e: BaseException, addr: str,
                           method: str) -> RpcError:
    """Wrap a raw OSError/socket.timeout in the typed hierarchy (pass
    already-typed errors through untouched)."""
    if isinstance(e, RpcError):
        return e
    if isinstance(e, socket.timeout):
        return RpcTimeout(f"{addr} {method}: {e!r}")
    return RpcConnectionLost(f"{addr} {method}: {e!r}")


class CircuitBreaker:
    """Per-replica fail-fast gate: CLOSED -> (``threshold`` consecutive
    transport failures) -> OPEN, where :meth:`allow` refuses instantly
    (callers raise :class:`RpcCircuitOpen` without touching the wire,
    so a dead PS replica costs microseconds instead of a full
    retry-with-backoff ladder per call). From OPEN, a background probe
    (``probe`` callable, e.g. a bare TCP connect) — or the ``cooldown``
    clock when no probe is given — moves the breaker to HALF_OPEN:
    exactly ONE trial call is let through; its success closes the
    breaker, its failure re-opens it. Application errors (plain
    RpcError) never trip the breaker — only transport-level loss does.
    """

    def __init__(self, threshold: int = 5, cooldown: float = 1.0,
                 probe: Optional[Callable[[], bool]] = None,
                 probe_interval: float = 0.25):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self.probe_interval = float(probe_interval)
        self._probe = probe
        self._lock = threading.Lock()
        self._state = "closed"
        self._fails = 0
        self._opened_at = 0.0
        self._trial_inflight = False
        self._probe_thread: Optional[threading.Thread] = None

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """True when a call may proceed (closed, or the half-open
        trial slot). False == fail fast, no wire traffic."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if _time.monotonic() - self._opened_at < self.cooldown:
                    return False
                self._state = "half_open"
                self._trial_inflight = False
            # half_open: one trial call at a time
            if self._trial_inflight:
                return False
            self._trial_inflight = True
            return True

    def record_success(self):
        with self._lock:
            self._state = "closed"
            self._fails = 0
            self._trial_inflight = False

    def record_failure(self):
        with self._lock:
            self._fails += 1
            if self._state == "half_open" or self._fails >= self.threshold:
                self._open_locked()

    def _open_locked(self):
        self._state = "open"
        self._opened_at = _time.monotonic()
        self._trial_inflight = False
        if self._probe is not None and (
            self._probe_thread is None or not self._probe_thread.is_alive()
        ):
            self._probe_thread = threading.Thread(
                target=self._probe_loop, daemon=True,
                name="circuit-breaker-probe")
            self._probe_thread.start()

    def _probe_loop(self):
        """Background recovery watch: while the breaker is open, poll
        the probe; the first success arms the half-open trial slot
        immediately (no need to wait out the cooldown). The inter-probe
        sleep is decorrelated-jittered: after a supervised PS restart,
        every client in the fleet opens its breaker at the same instant,
        and a fixed cadence would land all N recovery probes (and the
        trial calls they arm) on the reborn replica in synchronized
        waves."""
        delay = self.probe_interval
        while True:
            with self._lock:
                if self._state != "open":
                    return
            try:
                ok = bool(self._probe())
            except Exception:
                ok = False
            if ok:
                with self._lock:
                    if self._state == "open":
                        self._state = "half_open"
                        self._trial_inflight = False
                return
            delay = decorrelated_jitter(self.probe_interval,
                                        8 * self.probe_interval, delay)
            self._sleep(delay)

    # injectable for fake-clock tests
    _sleep = staticmethod(_time.sleep)


def decorrelated_jitter(base: float, cap: float, prev: float,
                        rand: Optional[Callable[[], float]] = None
                        ) -> float:
    """Next backoff delay, AWS-style "decorrelated jitter":
    ``min(cap, uniform(base, max(base, prev * 3)))``. Unlike plain
    exponential backoff (deterministic, so N clients that failed
    together retry together, forever), each client's delay is drawn
    from a widening window — reconnect storms de-synchronize within a
    round or two. ``rand`` is injectable for deterministic tests."""
    r = (rand or random.random)()
    hi = max(float(base), float(prev) * 3.0)
    return min(float(cap), float(base) + r * (hi - float(base)))


class RetryBudget:
    """Per-client token bucket bounding transport retries: ``capacity``
    tokens burst, refilled at ``refill_per_sec``. Each retry SLEEP
    spends one token; an empty bucket stops the ladder immediately
    (the call surfaces its transport error instead of sleeping). The
    point is storm control — during a long PS outage, N workers x M
    threads x unbounded ladders otherwise wake in lockstep and hammer
    the reborn replica; with a budget, each client's retry pressure is
    capped at ``refill_per_sec`` regardless of caller count. The
    defaults are generous (single-call ladders never notice them).
    ``clock`` is injectable for fake-clock tests. Thread-safe."""

    def __init__(self, capacity: float = 64.0,
                 refill_per_sec: float = 8.0,
                 clock: Optional[Callable[[], float]] = None):
        self.capacity = float(capacity)
        self.refill_per_sec = float(refill_per_sec)
        self._clock = clock or _time.monotonic
        self._tokens = self.capacity
        self._stamp = self._clock()
        self._lock = threading.Lock()

    def _refill_locked(self):
        now = self._clock()
        self._tokens = min(self.capacity, self._tokens
                           + (now - self._stamp) * self.refill_per_sec)
        self._stamp = now

    def acquire(self, n: float = 1.0) -> bool:
        """Spend ``n`` tokens; False == budget exhausted, stop retrying."""
        with self._lock:
            self._refill_locked()
            if self._tokens < n:
                return False
            self._tokens -= n
            return True

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens


def tcp_probe(addr: str, timeout: float = 1.0) -> Callable[[], bool]:
    """Cheapest liveness probe for a breaker: does the address accept a
    TCP connection. (Readiness — checkpoint restored, optimizer armed —
    is the trial call's job; the probe only gates when to bother.)"""
    host, port = addr.rsplit(":", 1)

    def probe() -> bool:
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=timeout):
                return True
        except OSError:
            return False

    return probe


def pack_arrays(meta: dict, arrays: List[np.ndarray]) -> bytes:
    """Frame a small msgpack meta dict + a list of numpy arrays."""
    heads = []
    bufs = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        heads.append((str(a.dtype), list(a.shape)))
        bufs.append(a.tobytes())
    head = _msgpack.packb({"m": meta, "a": heads})
    out = [struct.pack("<I", len(head)), head]
    out.extend(bufs)
    return b"".join(out)


def pack_arrays_sg(meta: dict, arrays: List[np.ndarray]) -> list:
    """Zero-copy twin of :func:`pack_arrays`: returns a buffer list
    ``[prefix, *array buffers]`` that :func:`_send_msg` writes with one
    ``sendmsg`` — the array bytes go socketward without the
    ``tobytes()``/join concatenation copies. The byte stream is
    bit-identical to ``pack_arrays`` output (``unpack_arrays`` cannot
    tell them apart). The caller must not mutate the arrays until the
    send completes (all in-repo callers send synchronously)."""
    heads = []
    bufs = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        heads.append((str(a.dtype), list(a.shape)))
        bufs.append(memoryview(a).cast("B"))
    head = _msgpack.packb({"m": meta, "a": heads})
    return [struct.pack("<I", len(head)) + head] + bufs


def unpack_arrays(payload) -> Tuple[dict, List[np.ndarray]]:
    """Parse a pack_arrays/pack_arrays_sg byte stream. Accepts any
    bytes-like object; the returned arrays are VIEWS into it (the
    receive path hands in the per-frame buffer, so no copy happens
    between socket and numpy)."""
    (head_len,) = struct.unpack_from("<I", payload, 0)
    head = _msgpack.unpackb(payload[4 : 4 + head_len])
    arrays = []
    pos = 4 + head_len
    for dtype, shape in head["a"]:
        dt = np.dtype(dtype)
        n = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(payload, dtype=dt, count=n, offset=pos).reshape(shape)
        pos += n * dt.itemsize
        arrays.append(arr)
    return head["m"], arrays


def _payload_nbytes(payload: Payload) -> int:
    if isinstance(payload, (bytes, bytearray)):
        return len(payload)
    if isinstance(payload, memoryview):
        return payload.nbytes
    return sum(_payload_nbytes(b) for b in payload)


def _payload_bytes(payload: Payload) -> bytes:
    """Flatten a payload (possibly a buffer list) to one bytes object —
    only needed on the compression path, which copies anyway."""
    if isinstance(payload, bytes):
        return payload
    if isinstance(payload, (bytearray, memoryview)):
        return bytes(payload)
    return b"".join(b if isinstance(b, bytes) else bytes(b) for b in payload)


def _as_byte_view(b) -> memoryview:
    mv = b if isinstance(b, memoryview) else memoryview(b)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv


def _sendmsg_all(sock: socket.socket, bufs: List[memoryview]):
    """Vectored send of the whole buffer list (handles short writes and
    IOV_MAX); the scatter-gather half of the zero-copy framing."""
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None:  # pragma: no cover — non-POSIX fallback
        sock.sendall(b"".join(bytes(b) for b in bufs))
        return
    while bufs:
        n = sendmsg(bufs[:1024])
        while n and bufs:
            if n >= bufs[0].nbytes:
                n -= bufs[0].nbytes
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][n:]
                n = 0


def _send_msg(sock: socket.socket, envelope: list, payload: Payload,
              compress: bool, tag: Optional[int] = None,
              pipelined: bool = False, block: Optional[str] = None):
    flags = _FLAG_PIPELINED if pipelined else 0
    nbytes = _payload_nbytes(payload)
    if compress and zstandard is not None and nbytes > COMPRESS_THRESHOLD:
        payload = _zstd_c().compress(_payload_bytes(payload))
        nbytes = len(payload)
        flags |= _FLAG_COMPRESSED
    elif block is not None and nbytes > BLOCK_THRESHOLD and (
            compress or _FORCE_BLOCK):
        comp = _block_compress(_payload_bytes(payload), block)
        if len(comp) < nbytes:  # incompressible payloads ship raw
            payload = comp
            nbytes = len(comp)
            flags |= _FLAG_BLOCK
    env = _msgpack.packb(envelope + [nbytes])
    # frame_len counts everything after the u32: flags+env_len fields (3
    # bytes, already consumed by the fixed 7-byte header read) + the
    # optional 4-byte tag + env + payload
    if tag is None:
        header = struct.pack("<IBH", 3 + len(env) + nbytes, flags, len(env))
    else:
        flags |= _FLAG_TAGGED
        header = struct.pack("<IBHI", 7 + len(env) + nbytes, flags,
                             len(env), tag & 0xFFFFFFFF)
    if isinstance(payload, bytes) and nbytes <= (1 << 14):
        # small single-buffer frames: one concatenated sendall beats the
        # sendmsg bookkeeping
        sock.sendall(header + env + payload)
        return
    bufs = [_as_byte_view(header + env)]
    if isinstance(payload, (list, tuple)):
        bufs.extend(_as_byte_view(b) for b in payload)
    else:
        bufs.append(_as_byte_view(payload))
    _sendmsg_all(sock, [b for b in bufs if b.nbytes])


def _recv_exact_into(sock: socket.socket, view: memoryview):
    n = view.nbytes
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("socket closed")
        got += r


def _recv_msg_full(sock: socket.socket) -> Tuple[list, Payload,
                                                 Optional[int], int]:
    """Read one frame: (envelope, payload view, tag-or-None, flags).
    The whole body lands in ONE fresh buffer via recv_into (no
    chunk-join copy); the payload is a view into it, which
    unpack_arrays turns into numpy views — socket to array without an
    intermediate copy."""
    head = bytearray(7)
    _recv_exact_into(sock, memoryview(head))
    frame_len, flags, env_len = struct.unpack("<IBH", head)
    extra = 4 if flags & _FLAG_TAGGED else 0
    if frame_len < 3 + extra + env_len:
        raise ConnectionError("bad frame header")
    body = bytearray(frame_len - 3)
    view = memoryview(body)
    _recv_exact_into(sock, view)
    tag = None
    if extra:
        (tag,) = struct.unpack_from("<I", body, 0)
        view = view[4:]
    env = _msgpack.unpackb(view[:env_len])
    payload: Payload = view[env_len:]
    if flags & _FLAG_COMPRESSED:
        if zstandard is None:
            # a zstd peer on another host compresses frames past 64 KiB
            # without negotiation; without the library they are refused
            raise RpcError("compressed payload but zstandard unavailable")
        payload = _zstd_d().decompress(payload)
    elif flags & _FLAG_BLOCK:
        payload = _block_decompress(payload)
    return env, payload, tag, flags


def _recv_msg_tagged(sock: socket.socket) -> Tuple[list, Payload,
                                                   Optional[int]]:
    env, payload, tag, _ = _recv_msg_full(sock)
    return env, payload, tag


def _recv_msg(sock: socket.socket) -> Tuple[list, Payload]:
    env, payload, _, _ = _recv_msg_full(sock)
    return env, payload


class RpcServer:
    """Thread-per-connection RPC server with named handlers.

    Handlers take ``(payload: bytes) -> bytes`` and run concurrently;
    state they touch must be internally synchronized (the stores are).
    Handlers may also return a buffer LIST (:func:`pack_arrays_sg`) for
    zero-copy responses.

    Requests carrying a request id (``RpcClient.call(dedup=True)``) are
    executed at most once: a bounded LRU of recently-served ids returns
    the cached response for retried deliveries, so non-idempotent methods
    (gradient updates, forward-buffer ingestion) survive client retries
    without double-applying.

    Caveat: the id cache is in-memory per server process. A retry that
    lands after the server restarted re-executes the method — dedup is
    at-most-once per server incarnation, NOT exactly-once across
    restarts. Restart recovery instead relies on the worker tiers'
    restore-on-failure + re-arm paths (worker.py / worker_server.cc).

    ``concurrent_streams > 1`` enables the per-connection dispatch pool:
    up to that many requests from ONE connection execute concurrently in
    a shared pool. On an untagged connection responses still go out in
    request order (the legacy wire has no response tags, so order is the
    correlation). On a TAGGED connection (client negotiated ``__tags__``)
    responses carry the request's tag and are sent in COMPLETION order —
    a slow handler no longer head-of-line blocks fast ones. Existing
    blocking clients never pipeline, so the default of 1 keeps the exact
    serial per-connection behavior. The handler contract is unchanged —
    handlers already must tolerate cross-connection concurrency, and the
    dispatch pool only adds same-connection concurrency under the same
    rule.
    """

    DEDUP_CACHE_SIZE = 8192
    # Byte bound too: lookup responses are multi-MB, and 8192 of those
    # would not be a cache, it would be a leak (matches the C++
    # DedupCache in native/src/net.h).
    DEDUP_CACHE_BYTES = 256 << 20

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 concurrent_streams: int = 1, enable_tags: bool = True,
                 enable_trace: bool = True, enable_deadline: bool = True,
                 enable_codec: bool = True):
        self._concurrent_streams = max(1, int(concurrent_streams))
        # enable_tags=False emulates a legacy (pre-tag) peer: the
        # ``__tags__`` negotiation answers "no such method" and clients
        # negotiate down to untagged framing (compat tests use this);
        # enable_trace=False likewise refuses the ``__trace__`` probe so
        # clients never attach the trace envelope slot,
        # enable_deadline=False refuses ``__deadline__`` so clients
        # never attach the deadline slot, and enable_codec=False refuses
        # the ``__codec__`` probe so clients never send block-compressed
        # frames or half-precision payloads (legacy-peer emulation)
        self._enable_tags = enable_tags
        self._enable_codec = enable_codec
        self._handlers: Dict[str, Callable[[bytes], bytes]] = {}
        if enable_trace:
            self._handlers["__trace__"] = lambda payload: b""
        if enable_deadline:
            self._handlers["__deadline__"] = lambda payload: b""
        # remote fault-injection control (chaos bench re-arms a live PS
        # subprocess): opt-in by env — never exposed by default
        if knobs.get("PERSIA_FAULTS_RPC"):
            self._handlers["__faults__"] = faults._handle_control
        # /healthz surface: in-flight + served handler counts and the
        # age of the last request seen (scrapers distinguish "idle" from
        # "wedged" by pairing this with their own traffic knowledge).
        # Lock-guarded on purpose: inflight must not drift (a lost +=
        # under a bytecode race would mis-report forever), and two
        # uncontended acquisitions cost ~0.2us against the >=100us of
        # real per-request work — noise next to the GIL this path
        # already serializes on.
        self._stats_lock = threading.Lock()
        self._inflight_reqs = 0
        self._served_reqs = 0
        self._shed_reqs = 0  # deadline-expired requests refused unrun
        self._last_activity = _time.monotonic()
        self._stream_pool = None  # built lazily on the first connection
        self._stream_pool_lock = threading.Lock()
        self._dedup: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._dedup_bytes = 0
        self._dedup_lock = threading.Lock()
        # ids whose FIRST execution is still running: a client whose
        # socket timed out re-sends the same id on a fresh connection
        # while the original handler is still working; the duplicate
        # must wait for that execution, not run concurrently (it would
        # observe half-updated state, e.g. a popped buffer entry)
        self._inflight: Dict[bytes, threading.Event] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.addr = f"{host}:{self._sock.getsockname()[1]}"
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._shutdown_cb: Optional[Callable[[], None]] = None

    def register(self, name: str, fn: Callable[[bytes], bytes]):
        if (name.startswith("__") and name.endswith("__")
                and name not in ENVELOPE_EXTENSIONS):
            # dunder method names are reserved for declared wire
            # extensions: an undeclared one would dodge the negotiate-
            # down/byte-identical discipline
            raise ValueError(
                f"dunder RPC method {name!r} is not a declared wire "
                "extension; add it to rpc.ENVELOPE_EXTENSIONS first")
        self._handlers[name] = fn

    def on_shutdown(self, cb: Callable[[], None]):
        self._shutdown_cb = cb

    def serve_background(self):
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name=f"rpc-server-{self.addr}")
        self._thread.start()

    def serve_forever(self):
        self._running = True
        self._accept_loop()

    def _accept_loop(self):
        try:
            self._sock.settimeout(0.5)
        except OSError:
            return  # stop() closed the socket before the loop started
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    @staticmethod
    def _codec_negotiate(payload) -> Tuple[bytes, Optional[str]]:
        """Answer a ``__codec__`` probe: pick the first of the client's
        block codecs this process also has (lz4 both sides, else zlib —
        zlib is stdlib, so the intersection is never empty against a
        probe from this codebase). Returns (reply payload, chosen)."""
        chosen = None
        try:
            req = _msgpack.unpackb(_payload_bytes(payload)) or {}
            mine = block_codecs()
            chosen = next((c for c in req.get("compress", []) if c in mine),
                          None)
        except Exception:
            chosen = None
        return _msgpack.packb({"compress": chosen}), chosen

    def health(self) -> dict:
        """Live-internals snapshot for the HTTP sidecar's /healthz."""
        with self._stats_lock:
            return {
                "rpc_addr": self.addr,
                "inflight_rpcs": self._inflight_reqs,
                "served_rpcs": self._served_reqs,
                "shed_rpcs": self._shed_reqs,
                "last_activity_age_sec": round(
                    _time.monotonic() - self._last_activity, 3),
            }

    def _handle_one(self, method: str, payload, req_id,
                    trace=None, deadline=None) -> Tuple[list, bytes]:
        """Run one request to a (envelope, body) response pair — the
        single execution point for BOTH the serial and dispatch-pool
        paths. ``trace`` is the propagated ``(trace_id, parent_span)``
        context from the envelope (None when the request is untraced):
        the handler runs under a child span, so per-shard PS handler
        work shows up parented to the caller's stage span even when a
        pool thread answers out of order. ``deadline`` is the request's
        LOCAL-monotonic expiry (computed at recv from the envelope's
        remaining-time slot): a request whose deadline already passed —
        e.g. it sat queued behind a slow handler in the dispatch pool —
        is SHED, not run; the caller's time budget is spent either way,
        and running it anyway would burn server work nobody reads."""
        with self._stats_lock:
            self._inflight_reqs += 1
            self._last_activity = _time.monotonic()
        try:
            if deadline is not None and _time.monotonic() >= deadline:
                with self._stats_lock:
                    self._shed_reqs += 1
                return ["err", f"{_DEADLINE_ERR}: deadline expired "
                               f"before {method!r} dispatched"], b""
            handler = self._handlers.get(method)
            if handler is None:
                raise RpcError(f"no such method {method!r}")
            with tracing.span(f"rpc/{method}",
                              ctx=tuple(trace) if trace else None):
                if req_id is None:
                    result = handler(payload)
                else:
                    result = self._execute_once(handler, payload, req_id)
            return ["ok"], result
        except BaseException as e:
            return ["err", f"{type(e).__name__}: {e}"], b""
        finally:
            with self._stats_lock:
                self._inflight_reqs -= 1
                self._served_reqs += 1

    def _serve_conn_concurrent(self, conn: socket.socket):
        """Dispatch-pool variant: this thread reads requests and submits
        them to the shared pool; a writer thread sends the results back.
        Untagged requests answer strictly in request order (enqueued at
        submit time, the writer blocks on each future); tagged requests
        answer in COMPLETION order (enqueued by a done-callback). The
        ``inflight`` semaphore caps read-ahead at ``concurrent_streams``
        so a fast sender cannot pile unbounded work into the pool."""
        with self._stream_pool_lock:
            if not self._running:
                # stop() already ran: creating a pool here would leak an
                # executor nothing ever shuts down
                try:
                    conn.close()
                except OSError:
                    pass
                return
            if self._stream_pool is None:
                self._stream_pool = ThreadPoolExecutor(
                    max_workers=max(32, self._concurrent_streams),
                    thread_name_prefix="rpc-stream")
            pool = self._stream_pool
        compress = not _is_loopback(conn)
        pending: "_queue.Queue" = _queue.Queue()
        inflight = threading.BoundedSemaphore(self._concurrent_streams)
        # block codec negotiated by this connection's __codec__ probe
        # (mutable cell: send_response closes over it before the probe
        # can arrive)
        block_algo: List[Optional[str]] = [None]
        # responses may leave from the reader (inline fast path), the
        # writer (untagged in-order) or a pool thread (tagged,
        # completion order) — the lock keeps frames from interleaving
        send_lock = threading.Lock()
        # count of requests admitted whose response has not been sent
        # yet; when 0 the reader may execute+respond INLINE (a blocking
        # one-at-a-time client then never pays the pool tax — byte- and
        # order-identical to the serial server)
        queued = [0]
        queued_lock = threading.Lock()
        conn_dead = threading.Event()

        def send_response(env, body, tag):
            if conn_dead.is_set():
                return
            try:
                with send_lock:
                    _send_msg(conn, env, body,
                              compress if env[0] == "ok" else False,
                              tag=tag, block=block_algo[0])
            except OSError:
                conn_dead.set()

        def handle_direct(method, payload, req_id, tag, trace, deadline):
            """Tagged request in a pool thread: handle and send straight
            from here, in COMPLETION order — no queue hop, no writer
            wakeup (out-of-order is the tag wire's whole point)."""
            env, body = self._handle_one(method, payload, req_id, trace,
                                         deadline)
            send_response(env, body, tag)
            with queued_lock:
                queued[0] -= 1
            inflight.release()

        def writer():
            """Untagged responses must go out in REQUEST order (the
            legacy wire has no tags, so order is the correlation)."""
            while True:
                item = pending.get()
                if item is None:
                    return
                if item[0] == "__SHUTDOWN__":
                    try:
                        with send_lock:
                            _send_msg(conn, ["ok"], b"", False, tag=item[1])
                    except OSError:
                        pass
                    self.stop()
                    if self._shutdown_cb is not None:
                        self._shutdown_cb()
                    return
                tag, fut = item
                env, body = fut.result()
                send_response(env, body, tag)
                with queued_lock:
                    queued[0] -= 1
                inflight.release()

        wt = threading.Thread(target=writer, daemon=True,
                              name="rpc-stream-writer")
        wt.start()
        try:
            with conn:
                while self._running and not conn_dead.is_set():
                    try:
                        env, payload, tag, flags = _recv_msg_full(conn)
                    except (ConnectionError, OSError):
                        break
                    method = env[0]
                    if faults._active:
                        # injection sites for the chaos tests: reset
                        # kills the connection cold, drop swallows the
                        # frame (client times out), error answers an
                        # err envelope, corrupt mangles the payload
                        # (handler errors, connection survives)
                        try:
                            act = faults.fire("rpc.server.recv",
                                              method=method)
                        except ConnectionError:
                            break
                        except faults.InjectedFault as e:
                            send_response(
                                ["err", f"InjectedFault: {e}"], b"", tag)
                            continue
                        if act == "drop":
                            continue
                        if act == "corrupt":
                            payload = faults.corrupt_bytes(payload)
                    if method == "__shutdown__":
                        pending.put(("__SHUTDOWN__", tag))
                        wt.join()
                        return
                    if method == "__tags__" and self._enable_tags:
                        inflight.acquire()
                        with queued_lock:
                            queued[0] += 1
                        ack: Future = Future()
                        ack.set_result((["ok"], b""))
                        pending.put((tag, ack))
                        continue
                    if method == "__codec__" and self._enable_codec:
                        reply, block_algo[0] = self._codec_negotiate(payload)
                        inflight.acquire()
                        with queued_lock:
                            queued[0] += 1
                        ack = Future()
                        ack.set_result((["ok"], reply))
                        pending.put((tag, ack))
                        continue
                    req_id = env[1] if len(env) >= 3 else None
                    trace = env[2] if len(env) >= 4 else None
                    # deadline slot carries REMAINING seconds (clock-sync
                    # free); pin it to this host's monotonic clock once,
                    # at recv — queue wait then counts against it
                    deadline = env[3] if len(env) >= 5 else None
                    if deadline is not None:
                        deadline = _time.monotonic() + float(deadline)
                    if flags & _FLAG_PIPELINED:
                        # the client declared more requests may be in
                        # flight: executing inline would head-of-line
                        # block them behind this handler
                        idle = False
                    else:
                        with queued_lock:
                            idle = queued[0] == 0
                        if idle:
                            # ...and the client has not already pipelined
                            # the NEXT request (buffered data means
                            # read-ahead has value; handling inline would
                            # serialize an actively-pipelining client)
                            try:
                                idle = not select.select([conn], [], [],
                                                         0)[0]
                            except ValueError:
                                # fd >= FD_SETSIZE: select() can't watch
                                # it — take the pooled path, never kill
                                # the connection thread
                                idle = False
                    if idle:
                        # nothing in flight on this connection and no
                        # request queued behind this one: respond from
                        # the reader thread
                        renv, rbody = self._handle_one(method, payload,
                                                       req_id, trace,
                                                       deadline)
                        send_response(renv, rbody, tag)
                        if conn_dead.is_set():
                            break
                        continue
                    inflight.acquire()
                    with queued_lock:
                        queued[0] += 1
                    try:
                        if tag is None:
                            fut = pool.submit(
                                self._handle_one, method, payload, req_id,
                                trace, deadline)
                            pending.put((None, fut))
                        else:
                            pool.submit(handle_direct, method, payload,
                                        req_id, tag, trace, deadline)
                    except RuntimeError:
                        # stop() shut the pool down between recv and
                        # submit; the server is closing anyway
                        with queued_lock:
                            queued[0] -= 1
                        inflight.release()
                        break
        finally:
            pending.put(None)

    def _serve_conn(self, conn: socket.socket):
        if self._concurrent_streams > 1:
            self._serve_conn_concurrent(conn)
            return
        compress = not _is_loopback(conn)
        block = None  # set by this connection's __codec__ probe
        with conn:
            while self._running:
                try:
                    env, payload, tag = _recv_msg_tagged(conn)
                except (ConnectionError, OSError):
                    return
                method = env[0]
                req_id = env[1] if len(env) >= 3 else None
                trace = env[2] if len(env) >= 4 else None
                deadline = env[3] if len(env) >= 5 else None
                if deadline is not None:
                    deadline = _time.monotonic() + float(deadline)
                if faults._active:
                    try:
                        act = faults.fire("rpc.server.recv", method=method)
                    except ConnectionError:
                        return
                    except faults.InjectedFault as e:
                        try:
                            _send_msg(conn, ["err", f"InjectedFault: {e}"],
                                      b"", False, tag=tag)
                        except OSError:
                            return
                        continue
                    if act == "drop":
                        continue
                    if act == "corrupt":
                        payload = faults.corrupt_bytes(payload)
                try:
                    if method == "__shutdown__":
                        _send_msg(conn, ["ok"], b"", False, tag=tag)
                        self.stop()
                        if self._shutdown_cb is not None:
                            self._shutdown_cb()
                        return
                    if method == "__tags__" and self._enable_tags:
                        # serial server: tags are echoed but responses
                        # stay in order (valid — tags enable reordering,
                        # they do not promise it)
                        _send_msg(conn, ["ok"], b"", False, tag=tag)
                        continue
                    if method == "__codec__" and self._enable_codec:
                        reply, block = self._codec_negotiate(payload)
                        _send_msg(conn, ["ok"], reply, False, tag=tag)
                        continue
                except OSError:
                    return
                renv, rbody = self._handle_one(method, payload, req_id,
                                               trace, deadline)
                try:
                    _send_msg(conn, renv, rbody,
                              compress if renv[0] == "ok" else False,
                              tag=tag, block=block)
                except OSError:
                    return

    def _execute_once(self, handler, payload, req_id: bytes) -> bytes:
        """At-most-once execution for an id, including the concurrent
        window: a duplicate delivery waits for the in-flight original
        and returns its cached result. If the original ERRORED, nothing
        is cached and the duplicate executes itself — safe, because the
        failed execution restored any state it consumed."""
        while True:
            with self._dedup_lock:
                cached = self._dedup.get(req_id)
                if cached is not None:
                    return cached
                ev = self._inflight.get(req_id)
                if ev is None:
                    self._inflight[req_id] = mine = threading.Event()
                    break
            ev.wait(timeout=600.0)
        try:
            result = handler(payload)
        except BaseException:
            with self._dedup_lock:
                self._inflight.pop(req_id, None)
            mine.set()
            raise
        with self._dedup_lock:
            self._dedup[req_id] = result
            self._dedup_bytes += _payload_nbytes(result)
            while len(self._dedup) > self.DEDUP_CACHE_SIZE or (
                self._dedup_bytes > self.DEDUP_CACHE_BYTES
                and len(self._dedup) > 1
            ):
                _, old = self._dedup.popitem(last=False)
                self._dedup_bytes -= _payload_nbytes(old)
            self._inflight.pop(req_id, None)
        mine.set()
        return result

    def stop(self):
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
        with self._stream_pool_lock:
            pool, self._stream_pool = self._stream_pool, None
        if pool is not None:
            pool.shutdown(wait=False)


class _ConnState:
    """One pooled connection + its negotiated framing + tag bookkeeping.
    Owned by exactly one thread (the client pools one per thread), so
    none of this state needs a lock."""

    __slots__ = ("sock", "compress", "tagged", "trace", "deadline",
                 "codec", "block", "routing", "routing_epoch", "next_tag",
                 "outstanding", "done", "evicted", "dead")

    def __init__(self, sock: socket.socket, compress: bool):
        self.sock = sock
        self.compress = compress
        self.tagged = False
        self.trace = False  # peer acked the __trace__ envelope slot
        self.deadline = False  # peer acked the __deadline__ envelope slot
        self.codec = False  # peer acked the __codec__ payload codec
        self.block = None  # negotiated block-compression algo (or None)
        self.routing = False  # peer acked the __routing__ epoch rider
        self.routing_epoch = None  # peer's routing epoch at dial time
        self.next_tag = 1
        self.outstanding = set()  # tags sent, reply not yet claimed
        self.done: Dict[int, tuple] = {}  # tag -> (env, payload) parked
        self.evicted = set()  # parked replies dropped at DONE_PARK_LIMIT
        self.dead = False


class RpcFuture:
    """Tag-matched pending reply on a multiplexed connection.

    ``result()`` must be called from the thread that issued the call
    (connections are pooled per thread; the waiting thread drives the
    socket and parks replies for other tags — no reader thread)."""

    __slots__ = ("_client", "_cs", "_tag", "_method", "_resolved", "_value",
                 "_error")

    def __init__(self, client, cs, tag, method):
        self._client = client
        self._cs = cs
        self._tag = tag
        self._method = method
        self._resolved = False
        self._value = None
        self._error = None

    @classmethod
    def completed(cls, value=None, error=None) -> "RpcFuture":
        f = cls(None, None, None, None)
        f._resolved = True
        f._value = value
        f._error = error
        return f

    def result(self):
        if not self._resolved:
            self._resolved = True
            try:
                env, payload = self._client._wait_tag(self._cs, self._tag)
                self._client._count_wire(recv=_payload_nbytes(payload))
            except (ConnectionError, OSError) as e:
                self._error = _typed_transport_error(
                    e, self._client.addr, self._method)
                self._client._drop_conn(self._cs)
                raise self._error from e
            if env[0] != "ok":
                self._error = _typed_call_error(
                    self._client.addr, self._method, env[1])
            else:
                self._value = payload
        if self._error is not None:
            raise self._error
        return self._value


class RpcClient:
    """Blocking client with one pooled connection per thread.

    Transient connection failures retry with backoff (the reference's
    forward workers block on wait_for_serving until servers recover,
    forward.rs:708-715; here the recovery wait lives in the client so
    every caller gets it). Application-level errors (RpcError) never
    retry. At-least-once semantics: a request may be re-sent if the
    connection died after the server processed it.

    With ``enable_tags`` (default) each fresh connection negotiates
    tagged framing (``__tags__`` probe); against a tag-capable server,
    :meth:`call_future` multiplexes many in-flight requests on the one
    connection with tag-matched completion, and :meth:`call_many`
    windows requests that the server may execute out of order. Legacy
    peers negotiate down to the untagged wire transparently.
    """

    def __init__(self, addr: str, timeout: float = 60.0,
                 max_retries: int = 5, retry_backoff: float = 0.2,
                 enable_tags: bool = True,
                 deadline: Optional[float] = None,
                 enable_deadline: Optional[bool] = None,
                 enable_codec: bool = False,
                 enable_routing: bool = False,
                 retry_budget: Optional[RetryBudget] = None):
        self.addr = addr
        host, port = addr.rsplit(":", 1)
        self._target = (host, int(port))
        self.timeout = timeout
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        # storm control on the transport retry ladder: delays are
        # decorrelated-jittered (see decorrelated_jitter) and retry
        # sleeps spend from a per-client token bucket, so N clients
        # that lost the same replica neither wake in lockstep nor
        # retry unboundedly against the reborn process
        self.retry_budget = (retry_budget if retry_budget is not None
                             else RetryBudget())
        self._retry_rand: Callable[[], float] = random.random
        self._retry_sleep: Callable[[float], None] = _time.sleep
        self.enable_tags = enable_tags
        # opt-in payload codec (PsClient turns it on for its
        # mixed-precision wire): probes __codec__ at dial; legacy
        # servers negotiate down; when off, no probe — byte-identical
        self.enable_codec = enable_codec
        # opt-in routing-epoch rider (PERSIA_ROUTING_WIRE / reshard
        # tooling): probes __routing__ at dial; legacy servers refuse
        # and the connection carries no rider; when off, no probe —
        # byte-identical legacy wire
        self.enable_routing = enable_routing
        # payload bytes in/out, pre-framing (what the wire codec
        # shrinks): the bench's bytes-on-wire accounting
        self._wire_lock = threading.Lock()
        self._bytes_sent = 0
        self._bytes_recv = 0
        # deadline propagation is negotiated like __trace__: the
        # ``__deadline__`` probe is ONLY sent when this client wants
        # deadlines at all (a default deadline, or enable_deadline=True
        # for per-call use), so the no-deadline wire stays byte-identical
        # to the legacy protocol. ``deadline`` is seconds-from-send; the
        # envelope carries the remaining budget and the server sheds
        # work whose budget expired before dispatch.
        self.default_deadline = deadline
        self.enable_deadline = (bool(enable_deadline)
                                if enable_deadline is not None
                                else deadline is not None)
        self._local = threading.local()
        # one pooled conn per calling thread, keyed by the Thread object,
        # so close() (and GC via __del__) can release every socket
        # deterministically and conns of exited threads are swept instead
        # of leaking fds for the client's lifetime
        self._conn_by_thread: Dict[threading.Thread, _ConnState] = {}
        self._conns_lock = threading.Lock()

    def _dial(self) -> _ConnState:
        sock = socket.create_connection(self._target, timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        cs = _ConnState(sock, compress=not _is_loopback(sock))
        try:
            if self.enable_tags:
                # negotiate tagged framing; a legacy peer answers
                # "no such method __tags__" and the connection stays
                # untagged (negotiate-down, both directions compatible)
                _send_msg(sock, ["__tags__"], b"", False)
                env, _, _ = _recv_msg_tagged(sock)
                cs.tagged = env[0] == "ok"
            if tracing.tracing_enabled():
                # negotiate the trace envelope slot the same way; only
                # probed when this process traces at all, so the
                # disabled wire stays byte-identical to the legacy one
                _send_msg(sock, ["__trace__"], b"", False)
                env, _, _ = _recv_msg_tagged(sock)
                cs.trace = env[0] == "ok"
            if self.enable_deadline:
                # deadline slot negotiation: legacy peers answer "no
                # such method" and never see the slot (negotiate-down)
                _send_msg(sock, ["__deadline__"], b"", False)
                env, _, _ = _recv_msg_tagged(sock)
                cs.deadline = env[0] == "ok"
            if self.enable_codec:
                # payload-codec negotiation: the probe carries this
                # side's block codecs; an acking server replies with the
                # chosen one and both sides may then ship half-precision
                # payloads and block-compressed large frames. Legacy
                # peers answer "no such method" and the connection stays
                # on the fp32/raw wire; with the codec off the probe is
                # never sent — byte-identical legacy wire.
                _send_msg(sock, ["__codec__"],
                          _msgpack.packb({"compress": block_codecs()}),
                          False)
                env, pl, _ = _recv_msg_tagged(sock)
                if env[0] == "ok":
                    cs.codec = True
                    try:
                        rep = _msgpack.unpackb(_payload_bytes(pl))
                        cs.block = (rep or {}).get("compress")
                    except Exception:
                        cs.block = None
            if self.enable_routing:
                # routing-epoch rider negotiation: a reshard-aware
                # server acks with its current slot-table epoch; legacy
                # peers answer "no such method" and the connection
                # carries no rider (negotiate-down) — with the rider
                # off the probe is never sent, byte-identical wire
                _send_msg(sock, ["__routing__"], b"", False)
                env, pl, _ = _recv_msg_tagged(sock)
                if env[0] == "ok":
                    cs.routing = True
                    try:
                        rep = _msgpack.unpackb(_payload_bytes(pl))
                        cs.routing_epoch = int((rep or {}).get("epoch", 0))
                    except Exception:
                        cs.routing_epoch = None
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        me = threading.current_thread()
        dead = []
        with self._conns_lock:
            self._conn_by_thread[me] = cs
            for t in list(self._conn_by_thread):
                if not t.is_alive() and t is not me:
                    dead.append(self._conn_by_thread.pop(t))
        for c in dead:
            try:
                c.sock.close()
            except OSError:
                pass
        self._local.cs = cs
        return cs

    def _conn(self) -> _ConnState:
        cs = getattr(self._local, "cs", None)
        if cs is None or cs.dead:
            cs = self._dial()
        return cs

    def renegotiate(self):
        """Drop the calling thread's pooled connection so its next call
        re-dials and re-runs envelope-extension negotiation. Used when
        an extension flag flips after the first dial — e.g. the reshard
        controller arming ``enable_deadline`` on an already-connected
        client; other threads' connections are untouched (their wire
        stays exactly as negotiated)."""
        cs = getattr(self._local, "cs", None)
        if cs is not None:
            self._drop_conn(cs)

    def codec_active(self) -> bool:
        """True when this thread's connection negotiated the payload
        codec (dialing if needed); False against legacy peers, on
        dial failure (the caller's normal call path retries), or when
        the codec was never enabled."""
        if not self.enable_codec:
            return False
        try:
            return self._conn().codec
        except (ConnectionError, OSError):
            return False

    def routing_active(self) -> bool:
        """True when this thread's connection negotiated the
        __routing__ epoch rider (dialing if needed); False against
        legacy peers or when the rider was never enabled."""
        if not self.enable_routing:
            return False
        try:
            return self._conn().routing
        except (ConnectionError, OSError):
            return False

    def _count_wire(self, sent: int = 0, recv: int = 0):
        with self._wire_lock:
            self._bytes_sent += sent
            self._bytes_recv += recv

    def wire_stats(self) -> Dict[str, int]:
        """Cumulative request/response PAYLOAD bytes through this client
        (pre-compression — the codec-sensitive number: fp16 rows and
        int8 grads halve/quarter it; block compression on a DCN link
        shrinks the physical bytes further)."""
        with self._wire_lock:
            return {"sent": self._bytes_sent, "recv": self._bytes_recv}

    def _drop_conn(self, cs: Optional[_ConnState]):
        if cs is None:
            return
        cs.dead = True
        try:
            cs.sock.close()
        except OSError:
            pass
        with self._conns_lock:
            me = threading.current_thread()
            if self._conn_by_thread.get(me) is cs:
                del self._conn_by_thread[me]
        if getattr(self._local, "cs", None) is cs:
            self._local.cs = None

    @staticmethod
    def _traced_envelope(envelope: list, cs: _ConnState) -> list:
        """Attach the caller's active span context as the third envelope
        slot when this connection negotiated ``__trace__`` (the req-id
        slot is explicitly None when absent so servers index the slots
        positionally). Untraced calls and un-negotiated connections send
        the envelope untouched — byte-identical to the legacy wire."""
        if not cs.trace:
            return envelope
        tctx = tracing.current_context()
        if tctx is None:
            return envelope
        return [envelope[0], envelope[1] if len(envelope) > 1 else None,
                list(tctx)]

    def _build_envelope(self, envelope: list, cs: _ConnState,
                        deadline: Optional[float]) -> list:
        """Full envelope assembly: trace slot (slot 2) then the deadline
        slot (slot 3, remaining seconds). Earlier slots are padded with
        None so servers keep indexing positionally; with no deadline in
        play the envelope is exactly the traced/legacy form —
        byte-identical wire when the feature is off."""
        env = self._traced_envelope(envelope, cs)
        if deadline is None:
            deadline = self.default_deadline
        if deadline is not None and cs.deadline:
            env = list(env)
            while len(env) < 3:
                env.append(None)
            env.append(float(deadline))
        return env

    def _take_tag(self, cs: _ConnState) -> int:
        tag = cs.next_tag
        cs.next_tag = ((tag + 1) & 0xFFFFFFFF) or 1
        return tag

    # parked replies nobody has claimed yet; beyond this, the oldest are
    # evicted — replies for ABANDONED futures (e.g. a windowed burst cut
    # short by an earlier error) would otherwise accumulate on the
    # pooled connection for the client's lifetime. An evicted tag that
    # IS later claimed fails loudly (RpcError from _wait_tag), never
    # hangs — the dict cannot distinguish abandoned from merely
    # slow-to-resolve, so keep in-flight call_future bursts under this.
    DONE_PARK_LIMIT = 1024

    def _park_one(self, cs: _ConnState):
        """Read ONE reply and park it for whichever tag it answers."""
        env, payload, rtag = _recv_msg_tagged(cs.sock)
        if rtag is None:
            raise ConnectionError("untagged reply on tagged connection")
        if rtag in cs.outstanding:
            cs.outstanding.discard(rtag)
            cs.done[rtag] = (env, payload)
            while len(cs.done) > self.DONE_PARK_LIMIT:
                old = next(iter(cs.done))
                cs.done.pop(old)
                cs.evicted.add(old)
                while len(cs.evicted) > 8 * self.DONE_PARK_LIMIT:
                    cs.evicted.pop()
        # unknown tags (abandoned futures) are dropped

    def _drain_ready(self, cs: _ConnState):
        """Park any responses already sitting in the kernel buffer.
        Called before each pipelined SEND: if the client only ever reads
        after its whole send burst, its unread responses can fill both
        sockets' kernel buffers and stall the server's writer (and with
        it the server's read-ahead semaphore) — the classic duplex-pipe
        deadlock. Draining keeps the response direction flowing, so
        sends never face a stalled peer."""
        try:
            while cs.outstanding and select.select([cs.sock], [], [], 0)[0]:
                self._park_one(cs)
        except ValueError:
            # fd >= FD_SETSIZE: select() can't watch it; skip the
            # opportunistic drain (the eventual blocking reads still
            # make progress)
            pass

    def _wait_tag(self, cs: _ConnState, tag: int) -> tuple:
        """Read replies until ``tag``'s arrives; replies for other
        outstanding tags are parked for their futures. Single-owner-
        thread demultiplexing: whoever waits drives the socket."""
        while True:
            if tag in cs.done:
                return cs.done.pop(tag)
            if tag in cs.evicted:
                cs.evicted.discard(tag)
                raise RpcError(
                    f"{self.addr}: reply for tag {tag} was evicted "
                    f"(more than {self.DONE_PARK_LIMIT} unresolved "
                    f"futures parked on one connection)")
            self._park_one(cs)

    def call(self, method: str, payload: Payload = b"",
             dedup: bool = False, deadline: Optional[float] = None):
        """``dedup=True`` attaches a per-request id that the server uses
        to execute the request at most once (RpcServer's LRU of served
        ids): required for non-idempotent methods (gradient updates,
        forward-buffer ingestion), where a blind re-send after an
        ambiguous connection death would double-apply the update or leak
        an orphaned forward-buffer entry. With the id attached, retries
        are safe, so every call keeps the full retry-with-backoff
        resilience (the reference's forward workers block on
        wait_for_serving until servers recover, forward.rs:708-715).

        The server's id cache does not survive its restart: a retry
        that lands on a restarted process re-executes the method (see
        RpcServer docstring)."""
        envelope: list = [method]
        if dedup:
            envelope.append(os.urandom(12))
        delay = self.retry_backoff
        attempts_left = self.max_retries
        while True:
            cs = getattr(self._local, "cs", None)
            if cs is not None and cs.dead:
                cs = None
            fresh = cs is None
            if fresh:
                try:
                    cs = self._dial()
                except (ConnectionError, OSError) as e:
                    if attempts_left <= 0 or not self.retry_budget.acquire():
                        raise _typed_transport_error(e, self.addr,
                                                     method) from e
                    attempts_left -= 1
                    delay = decorrelated_jitter(self.retry_backoff, 5.0,
                                                delay, self._retry_rand)
                    self._retry_sleep(delay)
                    continue
            others_inflight = bool(cs.outstanding)
            try:
                if faults._active:
                    faults.fire("rpc.client.send", addr=self.addr,
                                method=method)
                env_send = self._build_envelope(envelope, cs, deadline)
                if cs.tagged:
                    tag = self._take_tag(cs)
                    _send_msg(cs.sock, env_send, payload, cs.compress,
                              tag=tag, block=cs.block)
                    cs.outstanding.add(tag)
                    env, result = self._wait_tag(cs, tag)
                else:
                    _send_msg(cs.sock, env_send, payload, cs.compress,
                              block=cs.block)
                    env, result = _recv_msg(cs.sock)
                self._count_wire(sent=_payload_nbytes(payload),
                                 recv=_payload_nbytes(result))
                break
            except (ConnectionError, OSError) as e:
                self._drop_conn(cs)
                if others_inflight:
                    # tag-matched calls were in flight on this
                    # connection; a transparent re-send cannot know
                    # their completion state — surface the failure
                    raise _typed_transport_error(e, self.addr,
                                                 method) from e
                if not fresh:
                    continue  # stale pooled socket: redial once, no sleep
                if attempts_left <= 0 or not self.retry_budget.acquire():
                    raise _typed_transport_error(e, self.addr,
                                                 method) from e
                attempts_left -= 1
                delay = decorrelated_jitter(self.retry_backoff, 5.0,
                                            delay, self._retry_rand)
                self._retry_sleep(delay)
        if env[0] != "ok":
            raise _typed_call_error(self.addr, method, env[1])
        return result

    def call_future(self, method: str, payload: Payload = b"",
                    dedup: bool = False,
                    deadline: Optional[float] = None) -> RpcFuture:
        """Issue a request and return a tag-matched :class:`RpcFuture`
        without waiting for the reply — many can be in flight on this
        thread's one connection, and a tag-capable server completes them
        out of order (no head-of-line blocking on a slow method).
        ``result()`` must be called from this same thread. No transport
        retry (the completed prefix of a multiplexed burst is ambiguous);
        against a legacy untagged peer this degrades to a synchronous
        call returning an already-completed future."""
        cs = self._conn()
        if not cs.tagged:
            try:
                return RpcFuture.completed(
                    value=self.call(method, payload, dedup=dedup,
                                    deadline=deadline))
            except (RpcError, ConnectionError, OSError) as e:
                return RpcFuture.completed(error=e)
        envelope: list = [method]
        if dedup:
            envelope.append(os.urandom(12))
        envelope = self._build_envelope(envelope, cs, deadline)
        tag = self._take_tag(cs)
        try:
            if faults._active:
                faults.fire("rpc.client.send", addr=self.addr,
                            method=method)
            self._drain_ready(cs)  # keep the reply direction flowing
            _send_msg(cs.sock, envelope, payload, cs.compress, tag=tag,
                      pipelined=True, block=cs.block)
        except (ConnectionError, OSError) as e:
            self._drop_conn(cs)
            raise _typed_transport_error(e, self.addr, method) from e
        self._count_wire(sent=_payload_nbytes(payload))
        cs.outstanding.add(tag)
        return RpcFuture(self, cs, tag, method)

    def call_many(self, method: str, payloads: List[Payload],
                  window: int = 16,
                  deadline: Optional[float] = None) -> list:
        """Pipelined calls on this thread's pooled connection: up to
        ``window`` requests are on the wire before the first response is
        read. On a tagged connection the server may execute and answer
        them OUT OF ORDER (tags restore the pairing); results still
        return in request order. On a legacy untagged connection the
        responses arrive in request order — the framing has no tags —
        and a ``concurrent_streams`` server still executes them
        concurrently.

        The window bounds the responses the server may have to buffer
        while we are still sending (kernel-socket-buffer deadlock
        guard). No retry: a connection failure mid-pipeline is raised
        as-is because the completed prefix is ambiguous — use only for
        idempotent methods (predict, lookups). An APPLICATION error is
        raised only after every in-flight response has been read, so
        the pooled connection stays in sync for subsequent calls."""
        if not payloads:
            return []
        cs = self._conn()
        if cs.tagged:
            return self._call_many_tagged(cs, method, payloads, window,
                                          deadline)
        results: list = []
        first_err: Optional[str] = None
        envelope = self._build_envelope([method], cs, deadline)
        try:
            i_send = 0
            while len(results) < len(payloads):
                while (i_send < len(payloads)
                       and i_send - len(results) < window):
                    if faults._active:
                        faults.fire("rpc.client.send", addr=self.addr,
                                    method=method)
                    _send_msg(cs.sock, envelope, payloads[i_send],
                              cs.compress, pipelined=True, block=cs.block)
                    self._count_wire(sent=_payload_nbytes(payloads[i_send]))
                    i_send += 1
                env, result = _recv_msg(cs.sock)
                self._count_wire(recv=_payload_nbytes(result))
                if env[0] != "ok":
                    # keep draining: an unread tail would desynchronize
                    # the NEXT call's request/response pairing
                    if first_err is None:
                        first_err = (self.addr, method, env[1])
                    result = b""
                results.append(result)
        except (ConnectionError, OSError) as e:
            self._drop_conn(cs)
            raise _typed_transport_error(e, self.addr, method) from e
        if first_err is not None:
            raise _typed_call_error(*first_err)
        return results

    def _call_many_tagged(self, cs: _ConnState, method: str,
                          payloads: List[Payload], window: int,
                          deadline: Optional[float] = None) -> list:
        results: list = []
        tags: List[int] = []
        first_err: Optional[tuple] = None
        envelope = self._build_envelope([method], cs, deadline)
        try:
            i_send = 0
            while len(results) < len(payloads):
                while (i_send < len(payloads)
                       and i_send - len(results) < window):
                    if faults._active:
                        faults.fire("rpc.client.send", addr=self.addr,
                                    method=method)
                    self._drain_ready(cs)  # keep the reply direction flowing
                    tag = self._take_tag(cs)
                    _send_msg(cs.sock, envelope, payloads[i_send],
                              cs.compress, tag=tag, pipelined=True,
                              block=cs.block)
                    self._count_wire(sent=_payload_nbytes(payloads[i_send]))
                    cs.outstanding.add(tag)
                    tags.append(tag)
                    i_send += 1
                # claim in request order; out-of-order arrivals park in
                # cs.done, so a slow request never blocks the server
                env, result = self._wait_tag(cs, tags[len(results)])
                self._count_wire(recv=_payload_nbytes(result))
                if env[0] != "ok":
                    if first_err is None:
                        first_err = (self.addr, method, env[1])
                    result = b""
                results.append(result)
        except (ConnectionError, OSError) as e:
            self._drop_conn(cs)
            raise _typed_transport_error(e, self.addr, method) from e
        if first_err is not None:
            raise _typed_call_error(*first_err)
        return results

    def call_msg(self, method: str, **kwargs) -> dict:
        """msgpack-dict convenience call."""
        result = self.call(method, _msgpack.packb(kwargs))
        return _msgpack.unpackb(result) if result else {}

    def shutdown_server(self):
        try:
            self.call("__shutdown__")
        except (RpcError, ConnectionError, OSError):
            pass

    def close(self):
        """Close every pooled connection (all threads). Safe to call from
        teardown while worker threads are gone; a racing caller simply
        redials."""
        with self._conns_lock:
            conns = list(self._conn_by_thread.values())
            self._conn_by_thread.clear()
        for cs in conns:
            cs.dead = True
            try:
                cs.sock.close()
            except OSError:
                pass
        self._local.cs = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
