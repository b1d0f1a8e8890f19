"""HTTP proxy actor, the cluster's ingress: the port of
ray_tpu/serve/proxy.py.

It terminates HTTP, resolves the route prefix to an application, forwards
the request body to the app's ingress deployment through a
DeploymentHandle, and writes the response back: JSON in and out by
default, ``application/octet-stream`` bodies as bytes, chunked NDJSON (or
SSE, when the client accepts ``text/event-stream``) for a generator
ingress, and the ASGI relay to an ``@serve.ingress`` deployment's
``__asgi__``. The status codes and bodies are the reference's: 404 for no
app, 503 with ``Retry-After`` for a shed or a draining proxy, 504 for a
deadline, 500 otherwise.

Departure: the reference runs an aiohttp server (``ray_tpu/serve/
proxy.py:76-224``); the card's machine has no aiohttp, so this proxy runs
``asyncio.start_server`` with a plain HTTP/1.1 parser of its own
(request line, headers, a ``Content-Length`` or chunked body; keep-alive
unless the client asks to close) and writes ``Transfer-Encoding:
chunked`` for streamed responses, as aiohttp does for an HTTP/1.1
``StreamResponse``. Where aiohttp defaults a request without a
``Content-Type`` to ``application/octet-stream``, so does this parser.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from contextlib import aclosing
from http import HTTPStatus
from typing import Dict, List, Optional, Tuple
from urllib.parse import unquote

from .._internal.rpc import RPC_OOB_THRESHOLD as _RPC_OOB_THRESHOLD

logger = logging.getLogger(__name__)

_MAX_HEADER_BYTES = 64 * 1024


class _HTTPError(Exception):
    """A request the parser refuses (answered 400 and the connection
    closed)."""


class _Request:
    """One parsed HTTP/1.1 request."""

    def __init__(self, method: str, target: str, version: str,
                 headers: List[Tuple[str, str]], body: bytes):
        self.method = method
        self.version = version
        path, _, query = target.partition("?")
        self.path = unquote(path) or "/"
        self.query_string = query
        self.raw_headers = headers
        self.headers: Dict[str, str] = {}
        for k, v in headers:
            self.headers.setdefault(k.lower(), v)
        self.body = body

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)

    @property
    def content_type(self) -> str:
        raw = self.header("content-type")
        if not raw:
            return "application/octet-stream"
        return raw.split(";", 1)[0].strip().lower()

    @property
    def keep_alive(self) -> bool:
        conn = self.header("connection").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


class _Response:
    """A whole (non-streamed) response."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "application/octet-stream"):
        self.status = status
        self.body = body
        self.headers = dict(headers or {})
        self.headers.setdefault("Content-Type", content_type)


def _json_response(data, status: int = 200,
                   headers: Optional[Dict[str, str]] = None) -> _Response:
    return _Response(json.dumps(data).encode(), status, headers,
                     "application/json; charset=utf-8")


def _status_line(status: int) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    return f"HTTP/1.1 {status} {reason}\r\n".encode()


def _head_bytes(status: int, headers: Dict[str, str]) -> bytes:
    lines = [_status_line(status)]
    for k, v in headers.items():
        lines.append(f"{k}: {v}\r\n".encode("latin-1"))
    lines.append(b"\r\n")
    return b"".join(lines)


class _Stream:
    """A chunked response: :meth:`prepare` writes the head, :meth:`write`
    one chunk, :meth:`write_eof` the last chunk."""

    def __init__(self, writer: asyncio.StreamWriter, status: int = 200):
        self._writer = writer
        self.status = status
        self.headers: Dict[str, str] = {}
        self.prepared = False

    async def prepare(self):
        headers = dict(self.headers)
        headers["Transfer-Encoding"] = "chunked"
        self._writer.write(_head_bytes(self.status, headers))
        await self._writer.drain()
        self.prepared = True

    async def write(self, data: bytes):
        if data:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self._writer.drain()

    async def write_eof(self):
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


async def _read_request(reader: asyncio.StreamReader) -> Optional[_Request]:
    """The next request on the connection; None when the peer closed it
    between requests."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise _HTTPError("truncated request head")
    except asyncio.LimitOverrunError:
        raise _HTTPError("request head too large")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _HTTPError(f"bad request line {lines[0][:80]!r}")
    method, target, version = parts
    headers: List[Tuple[str, str]] = []
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise _HTTPError(f"bad header line {line[:80]!r}")
        headers.append((name.strip(), value.strip()))
    lookup = {k.lower(): v for k, v in headers}
    body = b""
    if "chunked" in lookup.get("transfer-encoding", "").lower():
        chunks = []
        while True:
            size_line = await reader.readuntil(b"\r\n")
            size = int(size_line.split(b";", 1)[0].strip() or b"0", 16)
            if size == 0:
                # trailers, up to the blank line
                while (await reader.readuntil(b"\r\n")) != b"\r\n":
                    pass
                break
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)
        body = b"".join(chunks)
    elif lookup.get("content-length"):
        try:
            n = int(lookup["content-length"])
        except ValueError:
            raise _HTTPError("bad Content-Length")
        body = await reader.readexactly(n) if n > 0 else b""
    return _Request(method.upper(), target, version, headers, body)


class HTTPProxy:
    """Actor: runs the HTTP server in a dedicated thread and event loop.

    Several HTTPProxy actors share one host:port through SO_REUSEPORT
    (``reuse_port=True``): the kernel spreads accepted connections over
    the listeners. Each registers with the controller under its
    ``proxy_id``, so drains address individual proxies."""

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 8000,
                 proxy_id: str = "http#0", reuse_port: bool = False):
        self._controller = controller
        self._host = host
        self._port = port
        self._proxy_id = proxy_id
        self._reuse_port = reuse_port
        self._routes: Dict[str, str] = {}
        self._handles: Dict[str, object] = {}
        self._ingress: Dict[str, tuple] = {}
        self._ready = threading.Event()
        self._error: Optional[str] = None
        self._started_at = time.time()
        self._draining = False
        self._inflight = 0
        # pre-bound metric handles + the hot response headers: the request
        # loop builds no tag dicts or header dicts per request
        from ..util.metrics import ingress_handles

        self._m = ingress_handles(proxy_id)
        self._hot_headers = {"X-Proxy-Id": proxy_id}
        self._thread = threading.Thread(
            target=self._serve_forever, daemon=True, name="http-proxy"
        )
        self._thread.start()
        if not self._ready.wait(timeout=15):
            raise RuntimeError(f"HTTP proxy failed to start: {self._error}")
        if self._error is not None:
            raise RuntimeError(f"HTTP proxy failed to start: {self._error}")

    # -- server --------------------------------------------------------------

    def _serve_forever(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._start_server())
        except Exception as e:  # noqa: BLE001
            self._error = repr(e)
            self._ready.set()
            return
        loop.run_forever()

    async def _start_server(self):
        self._server = await asyncio.start_server(
            self._on_connection, self._host, self._port,
            reuse_port=self._reuse_port or None, limit=_MAX_HEADER_BYTES,
        )
        self._ready.set()

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    request = await _read_request(reader)
                except (_HTTPError, ValueError, asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError) as e:
                    await self._write_whole(
                        writer, _json_response({"error": f"bad request: {e}"}, 400), False)
                    return
                if request is None:
                    return
                keep = request.keep_alive
                resp = await self._route(request, writer)
                if resp is not None:
                    await self._write_whole(writer, resp, keep)
                if not keep:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001 - one connection's fault
            logger.exception("proxy connection failed")
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    async def _write_whole(writer: asyncio.StreamWriter, resp: _Response,
                           keep_alive: bool):
        headers = dict(resp.headers)
        headers["Content-Length"] = str(len(resp.body))
        if not keep_alive:
            headers["Connection"] = "close"
        writer.write(_head_bytes(resp.status, headers) + resp.body)
        await writer.drain()

    async def _route(self, request: _Request, writer):
        """The reference's three routes: ``/-/routes``, ``/-/healthz`` and
        everything else. Returns a whole response, or None once a streamed
        one has been written."""
        if request.path == "/-/healthz":
            return _json_response({"status": "ok"})
        if request.path == "/-/routes":
            await self._refresh_routes_async()
            return _json_response(self._routes)
        return await self._handle_request(request, writer)

    async def _refresh_routes_async(self):
        # the blocking handle API stays off the server's loop
        await asyncio.get_running_loop().run_in_executor(None, self._refresh_routes)

    def _refresh_routes(self):
        from .. import api

        try:
            self._routes = api.get(
                self._controller.get_app_route_prefixes.remote(), timeout=10
            )
            # re-deploys may flip an app's ingress mode (stream/asgi)
            self._ingress.clear()
        except Exception:
            logger.exception("route refresh failed")

    def _resolve(self, path: str):
        """Longest-prefix route match -> (prefix, app_name)."""
        best = None
        for prefix, app_name in self._routes.items():
            if path == prefix or path.startswith(prefix.rstrip("/") + "/") or (
                prefix == "/" and best is None
            ):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, app_name)
        return best

    @staticmethod
    def _request_timeout_s(request: _Request) -> Optional[float]:
        """Per-request deadline from the ``X-Request-Timeout-S`` header;
        None defers to the deployment's
        RequestRouterConfig.default_timeout_s."""
        raw = request.header("X-Request-Timeout-S")
        if not raw:
            return None
        try:
            timeout_s = float(raw)
        except ValueError:
            return None
        return timeout_s if timeout_s > 0 else None

    @staticmethod
    def _trace_context(request: _Request) -> Optional[dict]:
        """The request's trace: an inbound ``X-Trace-Id``, else a fresh one
        when this process traces, else None."""
        from ..util import tracing

        raw = request.header("X-Trace-Id")
        if raw:
            return tracing.new_trace_context(raw.strip()[:64])
        if tracing.is_tracing_enabled():
            return tracing.new_trace_context()
        return None

    @staticmethod
    def _error_response(exc: Exception) -> _Response:
        """Typed serve errors onto HTTP: a shed is 503 + Retry-After, a
        deadline 504, everything else 500."""
        from ..exceptions import (
            BackPressureError,
            DeadlineExceededError,
            GetTimeoutError,
        )

        cause = getattr(exc, "cause", None) or exc
        if isinstance(cause, BackPressureError):
            return _json_response(
                {"error": repr(cause), "retry_after_s": cause.retry_after_s},
                status=503,
                headers={"Retry-After": str(max(1, int(cause.retry_after_s + 0.5)))},
            )
        if isinstance(cause, (DeadlineExceededError, GetTimeoutError)):
            return _json_response({"error": repr(cause)}, status=504)
        return _json_response({"error": repr(exc)}, status=500)

    def _count(self, status: int):
        if status < 400:
            self._m["ok"].inc()
        elif status == 503:
            self._m["shed"].inc()
        elif status == 504:
            self._m["timeout"].inc()
        else:
            self._m["error"].inc()

    async def _handle_request(self, request: _Request, writer):
        if self._draining:
            self._m["drain"].inc()
            return _json_response(
                {"error": "proxy draining", "retry_after_s": 1.0},
                status=503,
                headers={"Retry-After": "1", "X-Proxy-Id": self._proxy_id},
            )
        t0 = time.perf_counter()
        self._inflight += 1
        self._m["inflight"].set(self._inflight)
        stream = None
        try:
            try:
                resp = await self._dispatch(request, writer)
            except Exception as e:  # noqa: BLE001
                resp = self._error_response(e)
            if isinstance(resp, _Stream):
                stream, resp = resp, None
        finally:
            self._inflight -= 1
            self._m["inflight"].set(self._inflight)
            self._m["latency"].observe((time.perf_counter() - t0) * 1000.0)
        if stream is not None:
            self._count(stream.status)
            return None
        self._count(resp.status)
        resp.headers.setdefault("X-Proxy-Id", self._proxy_id)
        return resp

    async def _dispatch(self, request: _Request, writer):
        path = request.path
        match = self._resolve(path)
        if match is None:
            await self._refresh_routes_async()
            match = self._resolve(path)
        if match is None:
            return _json_response({"error": f"no app for path {path}"}, status=404)
        prefix, app_name = match
        info = await self._ingress_info(app_name)
        if info.get("asgi"):
            return await self._handle_asgi(request, writer, app_name, path, prefix)
        body: object = None
        raw = request.body
        if raw:
            if request.content_type == "application/octet-stream":
                # binary fast path: no JSON decode; large bodies go as a
                # bytearray, which the RPC plane ships out of band
                body = bytearray(raw) if len(raw) >= _RPC_OOB_THRESHOLD else raw
            else:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    body = raw.decode("utf-8", "replace")
        timeout_s = self._request_timeout_s(request)
        trace_ctx = self._trace_context(request)
        if info.get("stream"):
            return await self._handle_stream(request, writer, app_name, body,
                                             timeout_s, trace_ctx)
        # the handle API blocks: one executor thread per in-flight request
        result = await asyncio.get_running_loop().run_in_executor(
            None, self._call_ingress, app_name, path, prefix, body, timeout_s,
            trace_ctx,
        )
        if trace_ctx is None:
            headers = self._hot_headers
        else:
            headers = {"X-Proxy-Id": self._proxy_id,
                       "X-Trace-Id": trace_ctx["trace_id"]}
        if isinstance(result, Exception):
            resp = self._error_response(result)
            resp.headers.update(headers)
            return resp
        if isinstance(result, (dict, list, int, float, str, bool)) or result is None:
            return _json_response({"result": result}, headers=headers)
        return _Response(bytes(result), headers=headers,
                         content_type="application/octet-stream")

    _INGRESS_TTL_S = 5.0

    async def _ingress_info(self, app_name: str) -> dict:
        cached = self._ingress.get(app_name)
        if cached is not None and time.time() - cached[0] < self._INGRESS_TTL_S:
            return cached[1]
        from .. import api

        def fetch():
            try:
                return api.get(
                    self._controller.get_ingress_info.remote(app_name), timeout=10
                )
            except Exception:
                logger.exception("ingress info fetch failed")
                return {}

        info = await asyncio.get_running_loop().run_in_executor(None, fetch)
        self._ingress[app_name] = (time.time(), info)
        return info

    def _get_handle(self, app_name: str):
        from .api import get_app_handle

        handle = self._handles.get(app_name)
        if handle is None:
            handle = get_app_handle(app_name, _controller=self._controller)
            self._handles[app_name] = handle
        return handle

    def _call_ingress(self, app_name: str, path: str, prefix: str, body,
                      timeout_s: Optional[float] = None,
                      trace_ctx: Optional[dict] = None):
        """Forward to the app's ingress through its handle, which absorbs
        replica deaths and drains (and sheds, per the deployment's
        RequestRouterConfig); what escapes is returned, for
        :meth:`_error_response`."""
        from ..util import tracing

        try:
            handle = self._get_handle(app_name)
            if timeout_s is not None:
                handle = handle.options(timeout_s=timeout_s)
            if trace_ctx is None and not tracing.is_tracing_enabled():
                return handle.remote(body).result()
            with tracing.request_span("serve.proxy", trace_ctx, app=app_name, path=path):
                return handle.remote(body).result()
        except Exception as e:  # noqa: BLE001
            return e

    # -- streaming -----------------------------------------------------------

    async def _iter_stream(self, make_gen):
        """Drive a blocking DeploymentResponseGenerator on a pool thread and
        relay its items onto this loop as they arrive. Closing this
        generator (client gone, early break) stops the pump."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        _DONE = object()
        stop = threading.Event()

        def pump():
            gen = None
            try:
                gen = make_gen()
                for item in gen:
                    if stop.is_set():
                        break
                    loop.call_soon_threadsafe(queue.put_nowait, item)
            except Exception as e:  # noqa: BLE001 - relayed to the consumer
                loop.call_soon_threadsafe(queue.put_nowait, e)
            finally:
                close = getattr(gen, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001
                        pass
                loop.call_soon_threadsafe(queue.put_nowait, _DONE)

        loop.run_in_executor(None, pump)
        try:
            while True:
                item = await queue.get()
                if item is _DONE:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    async def _handle_stream(self, request: _Request, writer, app_name: str, body,
                             timeout_s: Optional[float] = None,
                             trace_ctx: Optional[dict] = None):
        """Generator ingress -> chunked NDJSON, or SSE when the client
        accepts text/event-stream. An error after the head has gone out is
        written inside the negotiated framing."""
        sse = "text/event-stream" in request.header("Accept")
        resp = _Stream(writer)
        resp.headers["Content-Type"] = "text/event-stream" if sse else "application/x-ndjson"
        resp.headers["X-Proxy-Id"] = self._proxy_id
        if trace_ctx:
            resp.headers["X-Trace-Id"] = trace_ctx["trace_id"]
        await resp.prepare()

        def make_gen():
            from ..util import tracing

            opts = {"stream": True}
            if timeout_s is not None:
                opts["timeout_s"] = timeout_s
            handle = self._get_handle(app_name).options(**opts)
            if trace_ctx is None:
                return handle.remote(body)
            with tracing.request_span("serve.proxy", trace_ctx, app=app_name, stream=True):
                return handle.remote(body)

        try:
            async with aclosing(self._iter_stream(make_gen)) as stream:
                async for item in stream:
                    if isinstance(item, (bytes, bytearray)):
                        chunk = bytes(item)
                    elif sse:
                        chunk = f"data: {json.dumps(item)}\n\n".encode()
                    else:
                        chunk = (json.dumps(item) + "\n").encode()
                    await resp.write(chunk)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception as e:  # noqa: BLE001 - the head has gone out
            err = json.dumps({"error": repr(e)})
            await resp.write(f"data: {err}\n\n".encode() if sse else (err + "\n").encode())
        await resp.write_eof()
        return resp

    async def _handle_asgi(self, request: _Request, writer, app_name: str, path: str,
                           prefix: str):
        """ASGI ingress: build an ASGI-3 HTTP scope, stream it through the
        replica's ``__asgi__`` method, and relay response-start and body
        events back as they arrive."""
        root = prefix.rstrip("/")
        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.method,
            "scheme": "http",
            "path": path[len(root):] or "/" if path.startswith(root) else path,
            "raw_path": path.encode(),
            "root_path": root,
            "query_string": request.query_string.encode(),
            "headers": [
                (k.lower().encode(), v.encode()) for k, v in request.raw_headers
            ],
            "client": None,
            "server": (self._host, self._port),
        }
        body = request.body

        def make_gen():
            return (
                self._get_handle(app_name)
                .options(stream=True, method_name="__asgi__")
                .remote(scope, body)
            )

        resp = None

        async def relay():
            nonlocal resp
            async with aclosing(self._iter_stream(make_gen)) as stream:
                async for event in stream:
                    etype = event.get("type")
                    if etype == "http.response.start":
                        resp = _Stream(writer, status=event.get("status", 200))
                        for k, v in event.get("headers", []):
                            name = k.decode() if isinstance(k, bytes) else k
                            val = v.decode() if isinstance(v, bytes) else v
                            # the proxy frames the body itself
                            if name.lower() not in ("content-length", "transfer-encoding"):
                                resp.headers[name] = val
                        resp.headers.setdefault("X-Proxy-Id", self._proxy_id)
                        await resp.prepare()
                    elif etype == "http.response.body":
                        if resp is None:
                            raise RuntimeError("ASGI app sent body before response start")
                        await resp.write(event.get("body", b""))
                        if not event.get("more_body"):
                            return
                    elif etype == "asgi.error":
                        raise RuntimeError(event.get("error", "ASGI app failed"))

        try:
            await relay()
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception as e:  # noqa: BLE001
            if resp is None:
                return _json_response({"error": repr(e)}, status=500)
            await resp.write(json.dumps({"error": repr(e)}).encode())
        if resp is None:
            return _json_response({"error": "ASGI app sent no response"}, status=500)
        await resp.write_eof()
        return resp

    # -- control -------------------------------------------------------------

    def address(self):
        return (self._host, self._port)

    def ping(self):
        return True

    def describe(self) -> dict:
        """The identity record the controller keeps under the GCS
        ``proxy:`` prefix."""
        from .. import _worker_api

        worker = _worker_api.maybe_get_core_worker()
        node = worker.node_id.hex() if worker is not None and worker.node_id else ""
        return {
            "kind": "http",
            "proxy_id": self._proxy_id,
            "host": self._host,
            "port": self._port,
            "pid": os.getpid(),
            "node": node,
            "started_at": self._started_at,
        }

    def stats(self) -> dict:
        return {"proxy_id": self._proxy_id, "inflight": self._inflight,
                "draining": self._draining}

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Stop accepting (new requests get 503 + Retry-After), then wait,
        bounded, for in-flight requests to finish. True when the proxy
        drained clean."""
        from ..util import events as _events

        self._draining = True
        deadline = time.time() + timeout_s
        while self._inflight > 0 and time.time() < deadline:
            time.sleep(0.02)
        _events.record_event(
            _events.PROXY_DRAIN, proxy_id=self._proxy_id, kind="http",
            inflight=self._inflight,
        )
        return self._inflight == 0
