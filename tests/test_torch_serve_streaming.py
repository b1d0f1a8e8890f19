"""Streaming and ASGI ingress of the port's serve control plane against
ray_tpu.serve: every program of tests/test_serve_streaming.py
(tests/torch_serve_programs.py) against ``ray_tpu`` and then
``ray_tpu_torch``, one single-node cluster per runtime for the whole file
and never both at once; local mode with no cluster. The handle's item
streaming (the first item before the generator ends, async generators, a
non-generator refused), NDJSON and SSE through the HTTP proxy, and the ASGI
relay; the port's proxy is its standard-library server (ROADMAP kept item
40), the reference's is aiohttp's.
"""

from __future__ import annotations

import asyncio
import importlib
import json

import pytest

import torch_serve_programs as P

#: what tests/test_serve_streaming.py asserts of each program
EXPECTED = {
    "prog_handle_streaming_first_item_before_completion": (
        "DeploymentResponseGenerator", {"chunk": 0}, True, [{"chunk": 1}, {"chunk": 2}]),
    "prog_handle_streaming_async_generator": [0, 10, 20, 30],
    "prog_handle_streaming_non_generator_errors": True,
    "prog_http_streaming_ndjson": (True, {"token": 0}, True, [{"token": 1}, {"token": 2}]),
    "prog_http_streaming_sse": (True, [{"a": 1}, {"a": 2}]),
    "prog_asgi_ingress_end_to_end": (
        (200, "asgi", {"echo": "ping", "method": "POST", "has_replica": True}),
        "part0;part1;part2;done", 404),
}
LOCAL = {"prog_local_mode_streaming": [100, 101, 102]}


@pytest.fixture(scope="module")
def runs():
    out = P.run_programs(list(EXPECTED), num_cpus=6, http=True)
    for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
        rt = importlib.import_module(name)
        out[key].update({prog: P.run_one(P.SERVE_PROGRAMS[prog], rt) for prog in LOCAL})
    return out


@pytest.mark.parametrize("name", list(EXPECTED) + list(LOCAL))
def test_program_matches_reference(runs, name):
    want = EXPECTED.get(name, LOCAL.get(name))
    assert runs["ref"][name] == want
    assert runs["port"][name] == runs["ref"][name]


def _proxy_exchange(raw_request: bytes) -> bytes:
    """One request through the port's HTTP parser, answered in process with
    what it parsed, then a three-byte streamed body, through the port's
    writers into a buffer."""
    from ray_tpu_torch.serve import proxy as px

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw_request)
        reader.feed_eof()
        req = await px._read_request(reader)
        resp = px._json_response({"method": req.method, "path": req.path,
                                  "query": req.query_string, "body": req.body.decode(),
                                  "ctype": req.content_type, "keep": req.keep_alive})

        class W:
            data = b""

            def write(self, b):
                W.data += b

            async def drain(self):
                pass

        await px.HTTPProxy._write_whole(W(), resp, req.keep_alive)
        stream = px._Stream(W(), 200)
        await stream.prepare()
        await stream.write(b"abc")
        await stream.write_eof()
        return W.data

    return asyncio.run(go())


def test_stdlib_parser_reads_length_and_chunked_bodies():
    """Kept item 40: the port's proxy parses HTTP/1.1 itself. A
    Content-Length body and a chunked one read the same; a request without
    Content-Type is application/octet-stream, as aiohttp reads it; a
    percent-encoded path is decoded; HTTP/1.1 keeps the connection unless
    asked to close; a streamed body is framed as chunks."""
    plain = _proxy_exchange(
        b"POST /a%20b/c?x=1 HTTP/1.1\r\nHost: h\r\nContent-Length: 5\r\n\r\nhello")
    head, _, rest = plain.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 OK\r\n")
    assert b"Content-Type: application/json; charset=utf-8" in head
    body = json.loads(rest[:int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])])
    assert body == {"method": "POST", "path": "/a b/c", "query": "x=1", "body": "hello",
                    "ctype": "application/octet-stream", "keep": True}
    assert rest.endswith(b"Transfer-Encoding: chunked\r\n\r\n3\r\nabc\r\n0\r\n\r\n")
    chunked = _proxy_exchange(
        b"POST /p HTTP/1.1\r\nTransfer-Encoding: chunked\r\nConnection: close\r\n"
        b"Content-Type: text/plain; charset=utf-8\r\n\r\n2\r\nhe\r\n3\r\nllo\r\n0\r\n\r\n")
    head, _, rest = chunked.partition(b"\r\n\r\n")
    assert b"Connection: close" in head
    assert b'"body": "hello"' in rest and b'"ctype": "text/plain"' in rest
    assert b'"keep": false' in rest
