"""Asyncio RPC substrate.

Role-equivalent of the reference's gRPC layer (src/ray/rpc/: GrpcServer,
ClientCallManager, RetryableGrpcClient) — but deliberately not gRPC: a
length-prefixed pickle protocol over asyncio TCP keeps the control plane in
one dependency-free file, and every server in this framework (GCS, raylet,
worker) is an ``RpcServer`` with async handler methods.

Frame format (v2): [u32 length][0xF2][u32 meta_len][u16 nbuf][u64 buf_len]*
                   [meta pickle][buffer bytes ...]
Request:   (request_id:int, method:str, args:tuple, kwargs:dict)
Response:  (request_id:int, ok:bool, value_or_exc)
One-way:   request_id == -1 (no response expected)

The meta section is a protocol-5 pickle with out-of-band buffers: large
contiguous payloads (numpy arrays and other PickleBuffer producers) travel
after the meta as raw wire segments, written with ``writelines`` so no
header+body concatenation copy ever happens, and reconstructed on the read
side as memoryviews over the received body (zero-copy). Payloads are pickled
with the standard library through ``serialization.Pickler`` (callables by
reference, tensors as raw bytes).

Includes deterministic chaos injection keyed by method name, the equivalent of
the reference's RAY_testing_rpc_failure / rpc_chaos.h.

The port of ``ray_tpu/_internal/rpc.py`` (host code: the port imports nothing
of ``ray_tpu``). It departs from the reference in three ways:

- a payload the standard pickler refuses raises a ``ValueError`` that names
  its type; the reference falls back to cloudpickle, which the card's
  machine does not have;
- the legacy v1 frame (a raw cloudpickle body) is gone, since its only
  peers are cloudpickle peers: a body without the v2 tag is malformed;
- the RPC latency, retry and circuit-state metric families are not
  recorded (the runtime planes' metrics are not ported yet); the circuit
  events are.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import pickle
import random
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..exceptions import RpcError
from .serialization import pickle_dumps

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<I")
_MAX_FRAME = 1 << 31

# v2 framing: first body byte. Pickle protocol >= 2 streams always start with
# the PROTO opcode 0x80, so 0xF2 unambiguously marks a v2 frame.
_V2_TAG = 0xF2
_V2_HDR = struct.Struct("<BIH")  # tag, meta_len, nbuf
_V2_BUFLEN = struct.Struct("<Q")
# Buffers below this stay inline in the meta pickle; splitting tiny buffers
# out-of-band costs more than it saves (mirrors serialization._OOB_THRESHOLD).
_RPC_OOB_THRESHOLD = 1 * 1024
# Public alias: payload producers (the ingress proxies) size-gate whether to
# wrap bodies in bytearray so they ride the zero-copy out-of-band path.
RPC_OOB_THRESHOLD = _RPC_OOB_THRESHOLD

# Wire/framing counters for tests and the microbenchmark proof layer.
_frame_stats = {
    "frames_sent": 0,
    "frames_received": 0,
    "oob_buffers_sent": 0,
    "oob_buffers_received": 0,
}


def frame_stats() -> Dict[str, int]:
    return dict(_frame_stats)


def _encode_frame(payload: Any) -> List[Any]:
    """Serialize ``payload`` into a list of wire parts (header + meta +
    out-of-band buffers) suitable for ``writer.writelines`` — the multi-MB
    body is never concatenated into one bytes object."""
    buffers: List[memoryview] = []

    def cb(pb: pickle.PickleBuffer):
        try:
            raw = pb.raw()
        except BufferError:
            return True  # non-contiguous: keep inline
        if raw.nbytes >= _RPC_OOB_THRESHOLD:
            buffers.append(raw)
            return False  # out-of-band
        return True  # keep inline

    try:
        meta = pickle_dumps(payload, buffer_callback=cb)
    except ValueError:
        raise
    except Exception as e:
        # the reference cloudpickles what pickle refuses; the port has no
        # cloudpickle, so the sender learns what could not travel
        raise ValueError(
            f"an RPC payload of type {type(payload).__name__} cannot be pickled "
            f"by reference: {e!r}") from None
    total = _V2_HDR.size + len(meta) + len(buffers) * _V2_BUFLEN.size + sum(
        b.nbytes for b in buffers
    )
    if total > _MAX_FRAME:
        raise RpcError(f"frame too large: {total} bytes")
    header = bytearray(4 + _V2_HDR.size + len(buffers) * _V2_BUFLEN.size)
    _LEN.pack_into(header, 0, total)
    _V2_HDR.pack_into(header, 4, _V2_TAG, len(meta), len(buffers))
    off = 4 + _V2_HDR.size
    for b in buffers:
        _V2_BUFLEN.pack_into(header, off, b.nbytes)
        off += _V2_BUFLEN.size
    _frame_stats["frames_sent"] += 1
    _frame_stats["oob_buffers_sent"] += len(buffers)
    return [bytes(header), meta, *buffers]


def _decode_body(body) -> Any:
    """Decode one frame body; out-of-band buffers come back as memoryview
    slices of ``body`` (zero-copy). A body without the v2 tag is refused."""
    _frame_stats["frames_received"] += 1
    mv = memoryview(body)
    if mv[0] == _V2_TAG:
        tag, meta_len, nbuf = _V2_HDR.unpack_from(mv, 0)
        off = _V2_HDR.size
        sizes = []
        for _ in range(nbuf):
            (n,) = _V2_BUFLEN.unpack_from(mv, off)
            sizes.append(n)
            off += _V2_BUFLEN.size
        meta = mv[off : off + meta_len]
        off += meta_len
        bufs = []
        for n in sizes:
            bufs.append(mv[off : off + n])
            off += n
        _frame_stats["oob_buffers_received"] += nbuf
        return pickle.loads(meta, buffers=bufs)
    raise RpcError(f"not a v2 frame (first byte {mv[0]:#x})")


async def _read_frame(
    reader: asyncio.StreamReader, preread_header: Optional[bytes] = None
) -> Any:
    header = preread_header or await reader.readexactly(4)
    (length,) = _LEN.unpack(header)
    if length > _MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    return _decode_body(body)


def _write_frame(writer: asyncio.StreamWriter, payload: Any):
    writer.writelines(_encode_frame(payload))


class _FrameBatcher:
    """Per-connection outgoing write coalescing, self-clocked: a frame
    enqueued while the connection is quiet is written immediately (no added
    latency on the sync ping-pong path — the transport's own buffer absorbs
    same-tick bursts into one send), while frames enqueued while a drain is
    already pending are batched and flushed with a single ``writelines`` and
    one shared ``drain`` when it completes (reference role: gRPC's batched
    completion-queue writes)."""

    __slots__ = ("_writer", "_parts", "_drain_fut", "_done_fut")

    def __init__(self, writer: asyncio.StreamWriter):
        self._writer = writer
        self._parts: List[Any] = []
        self._drain_fut: Optional[asyncio.Future] = None
        self._done_fut: Optional[asyncio.Future] = None

    def enqueue(self, parts: List[Any]) -> asyncio.Future:
        """Send one encoded frame; returns a future resolving once the
        write (and its coalesced drain, when one is needed) completed."""
        if self._writer.is_closing():
            # Reconnect race: the recv loop's teardown closed this writer
            # while a caller already past _ensure_connected was still headed
            # here. Fail fast — enqueueing would strand the caller's future
            # forever (the dead connection delivers no response).
            fut = asyncio.get_event_loop().create_future()
            fut.set_exception(
                ConnectionResetError("connection closing; frame not sent")
            )
            return fut
        if self._drain_fut is None:
            # quiet connection: write now
            loop = asyncio.get_event_loop()
            try:
                self._writer.writelines(parts)
            except Exception as e:
                fut = loop.create_future()
                fut.set_exception(e)
                return fut
            if self._writer.transport.get_write_buffer_size() == 0:
                # the socket took everything: no flow control needed, no
                # drain task — the ping-pong fast path costs zero tasks
                fut = self._done_fut
                if fut is None:
                    fut = self._done_fut = loop.create_future()
                    fut.set_result(None)
                return fut
            fut = loop.create_future()
            self._drain_fut = fut
            asyncio.ensure_future(self._drain(fut))
            return fut
        # a drain is in flight: coalesce — this batch flushes (one
        # writelines, one drain) when it resolves
        self._parts.extend(parts)
        return self._drain_fut

    async def _drain(self, fut: asyncio.Future):
        try:
            await self._writer.drain()
            while self._parts:
                parts, self._parts = self._parts, []
                self._writer.writelines(parts)
                await self._writer.drain()
        except Exception as e:
            self._drain_fut = None
            if not fut.done():
                fut.set_exception(e)
            return
        self._drain_fut = None
        if not fut.done():
            fut.set_result(None)


# ---------------------------------------------------------------------------
# Authentication (reference: rpc/authentication/, enable_cluster_auth in
# ray_config_def.h:36 — cluster-ID/token auth on every RPC channel)
# ---------------------------------------------------------------------------

_auth_token: Optional[str] = None

# Pre-pickle auth preamble: with a token set, the FIRST bytes of every
# connection are [magic][u32 len][token] checked with a constant-time compare
# BEFORE any pickle.loads runs — pickle deserialization is arbitrary code
# execution, so the token must gate it, not follow it. Without a token the
# transport assumes a trusted network (single-host / private VPC), as the
# reference does with auth disabled.
_AUTH_MAGIC = b"RTA1"
_MAX_TOKEN = 4096


def set_auth_token(token: Optional[str]):
    """Process-wide shared secret. When set, every RpcServer in this process
    requires clients to present it before any other method, and every
    RpcClient sends it on connect. Workers receive it via the
    RAY_TPU_CLUSTER_AUTH_TOKEN env var — deliberately NOT via the --config
    argv JSON, which is world-readable through /proc/<pid>/cmdline."""
    global _auth_token
    _auth_token = token or None


async def _consume_auth_preamble(reader: asyncio.StreamReader) -> bool:
    """Read [u32 len][token] (the magic was already consumed) and validate.
    Any malformed or mismatched preamble rejects the peer. With auth disabled
    server-side the token is consumed and ignored, so a token-bearing client
    talking to a no-auth server degrades gracefully instead of the magic
    bytes being misparsed as an 826 MB frame header that hangs every call."""
    import hmac

    try:
        (tlen,) = _LEN.unpack(await reader.readexactly(4))
        if tlen > _MAX_TOKEN:
            return False
        token = (await reader.readexactly(tlen)).decode("utf-8", "strict")
    except Exception:
        return False
    if _auth_token is None:
        return True
    return hmac.compare_digest(token, _auth_token)


# ---------------------------------------------------------------------------
# Chaos injection (reference: rpc/rpc_chaos.h, RAY_testing_rpc_failure)
#
# Two spec formats:
#   legacy flat  {"method": prob}            -> server-side raise in _dispatch
#                                               (exactly the old semantics)
#   structured   {"seed": int, "rules": [...]} -> client-side fault mesh
#                                               applied in call/call_oneway
# A structured rule models one link-fault class and matches on
# (method, src, dst): {"method": "name-or-*", "src": "node-hex-prefix-or-*",
# "dst": "host:port-or-*", "fail": p, "delay_ms": f, "jitter_ms": f,
# "blackhole": bool, "disconnect": p}. src is the caller's node identity
# (RpcClient.chaos_src), dst the literal connect target, so directional
# partitions (A->B drops while B->A flows) are expressible. All rng draws are
# from one seeded Random under a lock: deterministic and thread-safe.
# ---------------------------------------------------------------------------

_chaos_lock = threading.Lock()
_chaos: Dict[str, float] = {}  # legacy flat spec — injected server-side
_chaos_rng = random.Random(0)

# Methods the mesh never touches: the chaos spec itself distributes through
# chaos_fetch, so healing a partition must propagate through the partition.
_CHAOS_EXEMPT = frozenset({"chaos_fetch", "__register__"})
_BLACKHOLE_MAX_S = 3600.0


class _ChaosRule:
    __slots__ = (
        "method", "src", "dst", "fail", "delay_ms", "jitter_ms",
        "blackhole", "disconnect",
    )

    def __init__(self, raw: Dict[str, Any]):
        self.method = str(raw.get("method", "*"))
        self.src = str(raw.get("src", "*"))
        self.dst = str(raw.get("dst", "*"))
        self.fail = float(raw.get("fail", 0.0))
        self.delay_ms = float(raw.get("delay_ms", 0.0))
        self.jitter_ms = float(raw.get("jitter_ms", 0.0))
        self.blackhole = bool(raw.get("blackhole", False))
        self.disconnect = float(raw.get("disconnect", 0.0))

    def matches(self, method: str, src: Optional[str], dst: str) -> bool:
        if self.method != "*" and self.method != method:
            return False
        if self.src != "*" and not (src or "").startswith(self.src):
            return False
        if self.dst != "*" and self.dst != dst:
            return False
        return True


class _ChaosState:
    __slots__ = ("rules", "rng", "seed")

    def __init__(self, rules: List[_ChaosRule], seed: int):
        self.rules = rules
        self.rng = random.Random(seed)
        self.seed = seed


_chaos_state: Optional[_ChaosState] = None


def set_rpc_chaos(spec: Optional[Dict[str, Any]], seed: int = 0):
    """Configure fault injection for testing. Accepts the legacy flat
    ``{"method": prob}`` dict (server-side raises, unchanged semantics) or a
    structured ``{"seed": ..., "rules": [...]}`` mesh spec (client-side
    delay/fail/blackhole/disconnect/partition). An empty/None spec clears
    both."""
    global _chaos_rng, _chaos_state
    spec = spec or {}
    with _chaos_lock:
        _chaos.clear()
        if "rules" in spec or "seed" in spec:
            rules = [_ChaosRule(r) for r in spec.get("rules", ())]
            _chaos_state = (
                _ChaosState(rules, int(spec.get("seed", seed))) if rules else None
            )
        else:
            _chaos.update(spec)
            _chaos_state = None
        _chaos_rng = random.Random(seed)


def get_rpc_chaos_active() -> bool:
    return bool(_chaos) or _chaos_state is not None


def _maybe_inject_failure(method: str):
    if not _chaos or method in _CHAOS_EXEMPT:
        return
    with _chaos_lock:
        p = _chaos.get(method)
        if p and _chaos_rng.random() < p:
            raise RpcError(f"injected failure for {method}")


def _chaos_plan(
    method: str, src: Optional[str], dst: str
) -> Tuple[float, Optional[str]]:
    """Evaluate the mesh for one outgoing call. Returns (delay_s, action)
    where action is None | "fail" | "blackhole" | "disconnect"."""
    state = _chaos_state
    if state is None or method in _CHAOS_EXEMPT:
        return 0.0, None
    delay = 0.0
    action: Optional[str] = None
    with _chaos_lock:
        if _chaos_state is not state:  # swapped under us: skip this draw
            return 0.0, None
        for rule in state.rules:
            if not rule.matches(method, src, dst):
                continue
            if rule.delay_ms or rule.jitter_ms:
                delay += (
                    rule.delay_ms + state.rng.random() * rule.jitter_ms
                ) / 1000.0
            if action is None and rule.blackhole:
                action = "blackhole"
            if action is None and rule.fail and state.rng.random() < rule.fail:
                action = "fail"
            if (
                action is None
                and rule.disconnect
                and state.rng.random() < rule.disconnect
            ):
                action = "disconnect"
    return delay, action


# ---------------------------------------------------------------------------
# Per-link circuit breaker + retryable calls
# (reference: retryable_grpc_client.h — server_unavailable_timeout /
# retry-with-backoff on transient channel errors)
# ---------------------------------------------------------------------------

_BREAKER_THRESHOLD = 5
_BREAKER_COOLDOWN_S = 2.0

# Transport-level failures: what the breaker counts and retry_call retries.
# Application exceptions raised by the remote handler travel as pickled
# payloads of *their own* types and deliberately do not match.
_TRANSIENT_RPC_ERRORS = (RpcError, asyncio.TimeoutError, TimeoutError, OSError)


def _transport_error(msg: str) -> RpcError:
    """RpcError flagged as a *link* failure (vs a remote handler raising
    RpcError itself, which proves the link is alive)."""
    err = RpcError(msg)
    err.transport_error = True
    return err


def _is_transport_failure(e: BaseException) -> bool:
    if isinstance(e, (asyncio.TimeoutError, TimeoutError, OSError)):
        return True
    return isinstance(e, RpcError) and getattr(e, "transport_error", False)


def configure_circuit_breaker(
    threshold: Optional[int] = None, cooldown_s: Optional[float] = None
):
    """Process-wide breaker tuning (None keeps the current value)."""
    global _BREAKER_THRESHOLD, _BREAKER_COOLDOWN_S
    if threshold is not None:
        _BREAKER_THRESHOLD = int(threshold)
    if cooldown_s is not None:
        _BREAKER_COOLDOWN_S = float(cooldown_s)


def _record_circuit_event(name: str, **fields):
    try:
        from ..util import events as _ev
        _ev.record_event(getattr(_ev, name.upper(), name), **fields)
    except Exception:  # pragma: no cover — events must never break RPC
        pass


async def retry_call(
    client: "RpcClient",
    method: str,
    *args,
    attempts: int = 3,
    timeout: Optional[float] = None,
    total_timeout: Optional[float] = None,
    backoff_s: float = 0.05,
    max_backoff_s: float = 2.0,
    **kwargs,
):
    """Call with bounded retries on transport-level failures: jittered
    exponential backoff, a per-attempt ``timeout``, and a ``total_timeout``
    deadline budget inherited across attempts. Only for idempotent
    control-plane RPCs — the callee may have executed a failed attempt."""
    deadline = (
        None if total_timeout is None else time.monotonic() + total_timeout
    )
    delay = backoff_s
    last_exc: Optional[BaseException] = None
    for attempt in range(max(1, attempts)):
        per_attempt = timeout
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            per_attempt = (
                remaining if per_attempt is None else min(per_attempt, remaining)
            )
        try:
            return await client.call(method, *args, timeout=per_attempt, **kwargs)
        except _TRANSIENT_RPC_ERRORS as e:
            last_exc = e
            if attempt + 1 >= max(1, attempts):
                break
            sleep_s = min(delay, max_backoff_s) * (0.5 + 0.5 * random.random())
            if deadline is not None:
                sleep_s = min(sleep_s, max(0.0, deadline - time.monotonic()))
            delay *= 2
            if sleep_s > 0:
                await asyncio.sleep(sleep_s)
    if last_exc is None:
        raise RpcError(f"{client.name}: retry budget exhausted for {method}")
    raise last_exc


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class RpcServer:
    """TCP server dispatching frames to registered async handlers.

    Handlers are ``async def handle(*args, **kwargs)``; their return value is
    pickled back. Exceptions propagate to the caller as the response payload.
    """

    def __init__(self, name: str = "server"):
        self.name = name
        self._handlers: Dict[str, Callable] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_lost_cb: Optional[Callable] = None
        self._conn_registered_cb: Optional[Callable] = None
        self._conns: set[asyncio.StreamWriter] = set()
        self.port: Optional[int] = None

    def register(self, method: str, handler: Callable):
        self._handlers[method] = handler

    def register_service(self, service: Any, prefix: str = ""):
        """Register every ``handle_*`` coroutine of a service object."""
        for attr in dir(service):
            if attr.startswith("handle_"):
                self.register(prefix + attr[len("handle_") :], getattr(service, attr))

    def on_connection_lost(self, cb: Callable):
        """cb(peer_meta) fires when a client connection drops; used for
        worker-death detection (reference: NodeManager::HandleClientConnectionError)."""
        self._conn_lost_cb = cb

    def on_connection_registered(self, cb: Callable):
        """cb(peer_meta) fires on every (authenticated) __register__ — i.e.
        also on transparent reconnects; pairs with on_connection_lost for
        session liveness tracking."""
        self._conn_registered_cb = cb

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._on_client, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self):
        if self._server is not None:
            self._server.close()
            # Unblock connection handlers parked in readexactly(); on
            # Python 3.12 wait_closed() waits for every handler to finish.
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None

    async def _on_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer_meta: Dict[str, Any] = {}
        tasks: set[asyncio.Task] = set()
        self._conns.add(writer)
        batcher = _FrameBatcher(writer)
        try:
            # First 4 bytes are either the auth-preamble magic or the first
            # frame's length header. Auth is decided BEFORE the frame loop:
            # no pickle from an unauthenticated peer is ever parsed
            # (deserialization is code execution). peer_meta stays empty on
            # rejection, so no death callbacks fire either.
            try:
                first = await reader.readexactly(4)
            except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
                return
            preread: Optional[bytes] = None
            if first == _AUTH_MAGIC:
                if not await _consume_auth_preamble(reader):
                    logger.warning(
                        "%s: auth preamble failed, dropping connection",
                        self.name,
                    )
                    return
            elif _auth_token is not None:
                logger.warning(
                    "%s: missing auth preamble, dropping connection", self.name
                )
                return
            else:
                preread = first
            while True:
                try:
                    frame = await _read_frame(reader, preread)
                    preread = None
                except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
                    break
                except Exception:
                    # Malformed frame (bad pickle / oversized): this peer is
                    # not speaking our protocol — drop the connection.
                    logger.warning("%s: malformed frame, dropping connection", self.name)
                    break
                try:
                    req_id, method, args, kwargs = frame
                except (TypeError, ValueError):
                    logger.warning("%s: malformed frame, dropping connection", self.name)
                    break
                if method == "__register__":
                    if (
                        _auth_token is not None
                        and kwargs.get("auth_token") != _auth_token
                    ):
                        # reject BEFORE absorbing the meta: a spoofed
                        # worker_id in an unauthenticated register must not
                        # reach the connection-lost callback (worker-death
                        # spoofing)
                        logger.warning(
                            "%s: unauthenticated register, dropping connection",
                            self.name,
                        )
                        if req_id != -1:
                            try:
                                writer.writelines(
                                    _encode_frame(
                                        (req_id, False,
                                         RpcError("authentication failed"))
                                    )
                                )
                                await writer.drain()
                            except Exception:
                                pass
                        break
                    peer_meta.update(kwargs)
                    if self._conn_registered_cb is not None:
                        try:
                            self._conn_registered_cb(peer_meta)
                        except Exception:
                            logger.exception("connection-registered callback failed")
                    if req_id != -1:
                        writer.writelines(
                            _encode_frame(
                                (req_id, True, None)
                            )
                        )
                    continue
                if _auth_token is not None and peer_meta.get("auth_token") != _auth_token:
                    logger.warning(
                        "%s: unauthenticated request %r, dropping connection",
                        self.name, method,
                    )
                    if req_id != -1:
                        try:
                            writer.writelines(
                                _encode_frame(
                                    (req_id, False,
                                     RpcError("authentication failed"))
                                )
                            )
                            await writer.drain()
                        except Exception:
                            pass
                    break
                t = asyncio.ensure_future(
                    self._dispatch(
                        batcher, req_id, method, args, kwargs
                    )
                )
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        finally:
            self._conns.discard(writer)
            for t in tasks:
                t.cancel()
            if self._conn_lost_cb is not None and peer_meta:
                try:
                    res = self._conn_lost_cb(peer_meta)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    logger.exception("connection-lost callback failed")
            writer.close()

    async def _dispatch(self, batcher, req_id, method, args, kwargs):
        try:
            _maybe_inject_failure(method)
            handler = self._handlers.get(method)
            if handler is None:
                raise RpcError(f"{self.name}: no handler for {method!r}")
            value = await handler(*args, **kwargs)
            ok = True
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # noqa: BLE001 — errors travel to caller
            value, ok = e, False
        if req_id == -1:
            return
        encode = _encode_frame
        try:
            try:
                parts = encode((req_id, ok, value))
            except Exception as e:
                # Response unserializable or oversized: still answer the
                # caller so its future resolves instead of hanging.
                parts = encode((req_id, False, RpcError(f"bad response: {e}")))
            await batcher.enqueue(parts)
        except (ConnectionResetError, BrokenPipeError, RuntimeError, OSError):
            pass


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class RpcClient:
    """Persistent connection to one RpcServer with request multiplexing and
    reconnect-with-retry (reference: retryable_grpc_client.h)."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        name: str = "client",
        register_meta: Optional[Dict[str, Any]] = None,
        connect_timeout: float = 10.0,
        chaos_src: Optional[str] = None,
    ):
        self.host, self.port = host, port
        self.name = name
        # Caller identity (node-id hex) for directional chaos rules, and the
        # literal dst string those rules match against.
        self.chaos_src = chaos_src
        self._chaos_dst = f"{host}:{port}"
        self._register_meta = register_meta
        self._connect_timeout = connect_timeout
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._batcher: Optional[_FrameBatcher] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._req_ids = itertools.count(1)
        self._recv_task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()
        self._closed = False
        # Per-link circuit breaker: closed -> open after _BREAKER_THRESHOLD
        # consecutive transport failures -> half_open probe after cooldown.
        self._breaker_state = "closed"
        self._breaker_failures = 0
        self._breaker_opened_at = 0.0

    # -- circuit breaker ----------------------------------------------------

    def _breaker_check(self):
        """Fail fast while the circuit is open; transition to half_open (one
        probe allowed through) once the cooldown elapsed."""
        if self._breaker_state != "open":
            return
        if time.monotonic() - self._breaker_opened_at >= _BREAKER_COOLDOWN_S:
            self._breaker_state = "half_open"
            return
        raise RpcError(
            f"{self.name}: circuit open to {self._chaos_dst} "
            f"({self._breaker_failures} consecutive failures)"
        )

    def _breaker_record(self, ok: bool):
        if ok:
            if self._breaker_state != "closed":
                self._breaker_state = "closed"
                _record_circuit_event(
                    "circuit_close", peer=self._chaos_dst, client=self.name
                )
            self._breaker_failures = 0
            return
        self._breaker_failures += 1
        opened = (
            self._breaker_state == "half_open"
            or (
                self._breaker_state == "closed"
                and self._breaker_failures >= _BREAKER_THRESHOLD
            )
        )
        if opened:
            was_half_open = self._breaker_state == "half_open"
            self._breaker_state = "open"
            self._breaker_opened_at = time.monotonic()
            if not was_half_open:
                _record_circuit_event(
                    "circuit_open",
                    peer=self._chaos_dst,
                    client=self.name,
                    failures=self._breaker_failures,
                )

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    async def _ensure_connected(self, timeout: Optional[float] = None):
        """``timeout`` caps the connect-retry window below the client's
        ``connect_timeout``: a call that carries a deadline must not spend
        longer than that deadline retrying a refused connect (a SIGKILLed
        peer refuses instantly but used to be retried for the full window)."""
        if self._closed:
            raise _transport_error(f"{self.name}: client is closed")
        if self._writer is not None and not self._writer.is_closing():
            return
        async with self._lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            window = self._connect_timeout
            if timeout is not None:
                window = min(window, timeout)
            deadline = asyncio.get_event_loop().time() + window
            delay = 0.02
            while True:
                try:
                    self._reader, self._writer = await asyncio.open_connection(
                        self.host, self.port
                    )
                    break
                except OSError:
                    if asyncio.get_event_loop().time() > deadline or self._closed:
                        raise _transport_error(
                            f"{self.name}: cannot connect to {self.host}:{self.port}"
                        )
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 0.5)
            if _auth_token is not None:
                # pre-pickle handshake: must be the first bytes on the wire
                tok = _auth_token.encode()
                self._writer.write(_AUTH_MAGIC + _LEN.pack(len(tok)) + tok)
            meta = dict(self._register_meta or {})
            if _auth_token is not None:
                meta["auth_token"] = _auth_token
            if meta:
                _write_frame(self._writer, (-1, "__register__", (), meta))
            self._batcher = _FrameBatcher(self._writer)
            self._recv_task = asyncio.ensure_future(self._recv_loop())

    async def _recv_loop(self):
        reader = self._reader
        try:
            while True:
                req_id, ok, value = await _read_frame(reader)
                fut = self._pending.pop(req_id, None)
                if fut is None or fut.done():
                    continue
                if ok:
                    fut.set_result(value)
                else:
                    if not isinstance(value, BaseException):
                        # a malformed/hostile server can send any payload as
                        # the error; set_exception would raise TypeError and
                        # kill this recv loop — wrap instead
                        value = RpcError(
                            f"remote error (non-exception payload): {value!r}"
                        )
                    fut.set_exception(value)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError, EOFError):
            pass
        except asyncio.CancelledError:
            return
        finally:
            err = _transport_error(
                f"{self.name}: connection to {self.host}:{self.port} lost"
            )
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            if self._writer is not None:
                self._writer.close()
                self._writer = None

    async def call(self, method: str, *args, timeout: Optional[float] = None, **kwargs):
        self._breaker_check()
        action = None
        if _chaos_state is not None:
            delay, action = _chaos_plan(method, self.chaos_src, self._chaos_dst)
            if delay:
                await asyncio.sleep(delay)
            if action == "blackhole":
                # The link eats the request: hang for the caller's deadline
                # (capped), then surface a typed error — never an unbounded
                # silent hang.
                await asyncio.sleep(
                    min(timeout if timeout is not None else _BLACKHOLE_MAX_S,
                        _BLACKHOLE_MAX_S)
                )
                self._breaker_record(False)
                raise _transport_error(
                    f"{self.name}: injected blackhole for {method}"
                )
            if action == "fail":
                self._breaker_record(False)
                raise _transport_error(
                    f"{self.name}: injected failure for {method}"
                )
        try:
            await self._ensure_connected(timeout)
        except BaseException:
            self._breaker_record(False)
            raise
        req_id = next(self._req_ids)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[req_id] = fut
        try:
            await self._batcher.enqueue(
                _encode_frame((req_id, method, args, kwargs))
            )
            if action == "disconnect":
                self._abort_transport()
            if timeout is None:
                value = await fut
            else:
                value = await asyncio.wait_for(fut, timeout)
            self._breaker_record(True)
            return value
        except BaseException as e:
            # timeout / write failure / cancellation: drop the orphaned entry
            # so a long-lived connection doesn't accumulate dead futures
            self._pending.pop(req_id, None)
            self._breaker_record(not _is_transport_failure(e))
            raise

    async def call_oneway(self, method: str, *args, **kwargs):
        self._breaker_check()
        action = None
        if _chaos_state is not None:
            delay, action = _chaos_plan(method, self.chaos_src, self._chaos_dst)
            if delay:
                await asyncio.sleep(delay)
            if action == "blackhole":
                return  # one-way send silently eaten by the link
            if action == "fail":
                self._breaker_record(False)
                raise _transport_error(
                    f"{self.name}: injected failure for {method}"
                )
        await self._ensure_connected()
        await self._batcher.enqueue(_encode_frame((-1, method, args, kwargs)))
        if action == "disconnect":
            self._abort_transport()

    def _abort_transport(self):
        """Injected mid-call disconnect: hard-reset the connection with
        requests in flight (exercises the reconnect/fail-pending path)."""
        w = self._writer
        if w is None:
            return
        try:
            w.transport.abort()
        except Exception:
            pass

    async def close(self):
        self._closed = True
        if self._recv_task is not None:
            self._recv_task.cancel()
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class ClientPool:
    """Cache of RpcClients keyed by address (reference: rpc client pools in
    core_worker — CoreWorkerClientPool / RayletClientPool)."""

    def __init__(
        self,
        name: str = "pool",
        register_meta: Optional[Dict] = None,
        chaos_src: Optional[str] = None,
    ):
        self.name = name
        self._register_meta = register_meta
        self.chaos_src = chaos_src
        self._clients: Dict[Tuple[str, int], RpcClient] = {}

    def set_chaos_src(self, src: Optional[str]):
        """Tag this pool's caller identity (node-id hex) for directional
        chaos rules — applied to existing and future clients (a worker only
        learns its node id after connect_to_raylet)."""
        self.chaos_src = src
        for client in self._clients.values():
            client.chaos_src = src

    def get(self, host: str, port: int) -> RpcClient:
        key = (host, port)
        client = self._clients.get(key)
        if client is None or client._closed:
            client = RpcClient(
                host, port, name=f"{self.name}->{host}:{port}",
                register_meta=self._register_meta,
                chaos_src=self.chaos_src,
            )
            self._clients[key] = client
        return client

    async def close_all(self):
        for c in self._clients.values():
            await c.close()
        self._clients.clear()
