"""Tracing: the port of ray_tpu/util/tracing.py.

Spans carry (trace_id, span_id, parent_id) and are kept by an in-process
recorder as chrome-trace complete ("X") events. The active context is the
innermost open span of this thread, else the request context installed by
:func:`request_span` (a ContextVar, so concurrent coroutines keep their
own). Spans are recorded only while tracing is on (``RAY_TPU_TRACE`` set
and not ``0``, or :func:`enable_tracing`), or under a propagated request
context.

The device side: :func:`device_profile` records CPU and CUDA activity
with ``torch.profiler`` and writes a chrome trace under its log
directory, the counterpart of the reference's ``jax.profiler`` XPlane
trace; :func:`start_device_trace` / :func:`stop_device_trace` (and
:func:`device_trace` over them) do the same around an open span of work,
one trace at a time; :func:`annotate_device_trace` names a region inside
it.

The reference streams spans to its GCS span store from a background
thread, and ``timeline()`` / ``task_execution_span`` read and write the
runtime's task events. The port has no runtime yet: nothing is pushed and
no thread is started; those two wait for it.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Dict, List, Optional

_lock = threading.Lock()
_spans: List[dict] = []
_spans_cap = 50000  # the reference's local backstop
_enabled = os.environ.get("RAY_TPU_TRACE", "") not in ("", "0")

# per-thread stack of open spans, and the request context: a ContextVar,
# coroutine-local under asyncio
_tls = threading.local()
_task_context: contextvars.ContextVar[Optional[Dict[str, str]]] = (
    contextvars.ContextVar("ray_tpu_task_context", default=None)
)
# one trace per process for spans with no enclosing context
_root_trace_id: Optional[str] = None


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def enable_tracing():
    """Turn on span recording in this process."""
    global _enabled
    _enabled = True


def is_tracing_enabled() -> bool:
    """True when this process records spans: statically (``RAY_TPU_TRACE``
    or :func:`enable_tracing`), or because a propagated request context is
    active."""
    return _enabled or _task_context.get() is not None


def current_context() -> Optional[Dict[str, str]]:
    """The active span context: the innermost open span of this thread,
    else the request context."""
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return _task_context.get()


def _root_trace() -> str:
    """The per-process trace_id for spans with no enclosing context."""
    global _root_trace_id
    if _root_trace_id is None:
        with _lock:
            if _root_trace_id is None:
                _root_trace_id = _new_id()
    return _root_trace_id


@contextmanager
def trace_span(name: str, category: str = "app", **attrs):
    """Record one span around the block, linked to the enclosing span or
    request context."""
    if not is_tracing_enabled():
        yield
        return
    parent = current_context()
    ctx = {
        "trace_id": parent["trace_id"] if parent else _root_trace(),
        "span_id": _new_id(),
    }
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)
    start = time.perf_counter()
    wall = time.time()
    try:
        yield
    finally:
        dur = time.perf_counter() - start
        stack.pop()
        _record_span(
            name, category, wall, dur,
            ctx["trace_id"], ctx["span_id"],
            (parent or {}).get("span_id", ""), attrs,
        )


def new_trace_context(trace_id: Optional[str] = None) -> Dict[str, str]:
    """Mint a root request context (an inbound trace id, or a fresh trace).
    The empty span_id marks a trace root: the first span opened under it is
    the top of the tree."""
    return {"trace_id": trace_id or _new_id(), "span_id": ""}


@contextmanager
def request_span(name: str, ctx: Optional[Dict[str, str]],
                 category: str = "serve", **attrs):
    """Adopt a propagated request context (or mint one when this process
    traces statically) around one serve-request stage, recording the stage
    span. Yields the active span context. It is installed as the request
    context, so spans opened downstream parent to this stage.

    ``ctx is None`` with static tracing off is the untraced path: no
    allocation, no span, yields None."""
    if ctx is None and not _enabled:
        yield None
        return
    span_ctx = {
        "trace_id": (ctx or {}).get("trace_id") or _root_trace(),
        "span_id": _new_id(),
    }
    token = _task_context.set(span_ctx)
    start = time.perf_counter()
    wall = time.time()
    try:
        yield span_ctx
    finally:
        _task_context.reset(token)
        _record_span(
            name, category, wall, time.perf_counter() - start,
            span_ctx["trace_id"], span_ctx["span_id"],
            (ctx or {}).get("span_id", ""), attrs,
        )


def child_context(ctx: Optional[Dict[str, str]]) -> Optional[Dict[str, str]]:
    """Mint a child span context under ``ctx`` (or the root trace) without
    touching the request context, for a stage that spans yields of a
    generator; :func:`emit_closed_span` records it once it ends. None on
    the untraced path."""
    if ctx is None and not _enabled:
        return None
    return {
        "trace_id": (ctx or {}).get("trace_id") or _root_trace(),
        "span_id": _new_id(),
    }


def emit_closed_span(name: str, span_ctx: Dict[str, str],
                     parent_ctx: Optional[Dict[str, str]], start_wall: float,
                     dur_s: float, category: str = "serve", **attrs) -> None:
    """Record a span whose identity (:func:`child_context`) was minted
    before it closed, so that spans emitted while it was open could already
    parent to it."""
    _record_span(
        name, category, start_wall, dur_s,
        span_ctx["trace_id"], span_ctx["span_id"],
        (parent_ctx or {}).get("span_id", ""), attrs,
    )


def emit_span(name: str, ctx: Optional[Dict[str, str]], start_wall: float,
              dur_s: float, category: str = "serve",
              **attrs) -> Optional[str]:
    """Record one completed span against an explicit parent context: for
    stages that start and end on different threads (the continuous-batching
    engine admits and retires requests on whichever caller thread steps
    it). Returns the new span_id, or None when tracing is off and no
    context was given."""
    if ctx is None:
        if not _enabled:
            return None
        ctx = {"trace_id": _root_trace(), "span_id": ""}
    span_id = _new_id()
    _record_span(
        name, category, start_wall, dur_s,
        ctx.get("trace_id") or _root_trace(), span_id,
        ctx.get("span_id", ""), attrs,
    )
    return span_id


def _record_span(name, category, wall, dur_s, trace_id, span_id, parent_id,
                 attrs):
    span = {
        "name": name,
        "cat": category,
        "ph": "X",
        "ts": wall * 1e6,
        "dur": dur_s * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident() % 100000,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "args": {**attrs, "trace_id": trace_id, "span_id": span_id,
                 "parent_id": parent_id},
    }
    with _lock:
        _spans.append(span)
        if len(_spans) > _spans_cap:
            del _spans[:len(_spans) - _spans_cap]


def get_spans() -> List[dict]:
    with _lock:
        return list(_spans)


def clear_spans():
    with _lock:
        _spans.clear()


def export_spans(filename: str):
    """Write this process's spans as a chrome trace."""
    with open(filename, "w") as f:
        json.dump({"traceEvents": get_spans()}, f)


def build_chrome_trace(events: List[dict]) -> List[dict]:
    """Task-event records (per-state timestamps) -> chrome-trace complete
    ("X") events."""
    trace: List[dict] = []
    for ev in events:
        start = ev.get("ts_running")
        if start is None:
            continue
        end = ev.get("ts_finished") or ev.get("ts_failed") or time.time()
        trace.append(
            {
                "name": ev.get("name", ev.get("task_id", "?")),
                "cat": ev.get("type", "TASK"),
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(end - start, 0.0) * 1e6,
                "pid": ev.get("node_id", "node"),
                "tid": ev.get("worker_pid", 0),
                "args": {
                    "task_id": ev.get("task_id"),
                    "state": ev.get("state"),
                    "attempt": ev.get("attempt", 0),
                },
            }
        )
    return trace


def merge_span_events(trace: List[dict], *span_lists: List[dict]) -> List[dict]:
    """Append span lists onto a chrome trace, deduplicating by span_id."""
    seen = set()
    for spans in span_lists:
        for span in spans:
            sid = span.get("span_id")
            if sid and sid in seen:
                continue
            if sid:
                seen.add(sid)
            trace.append(span)
    return trace


# -- device profiling: torch.profiler ------------------------------------------


@contextmanager
def device_profile(logdir: str):
    """Record a profile of the block, host and device: CPU activity, and
    CUDA activity (kernels, copies, syncs) when this process can reach a
    card. On exit it writes a chrome trace,
    ``<logdir>/<host>_<pid>.<time>.pt.trace.json``, that TensorBoard's
    profiler plugin and chrome://tracing open:

        with ray_tpu_torch.util.tracing.device_profile("prof"):
            train_step(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


# the one open device trace of this process (start_device_trace /
# stop_device_trace), and the log directory it writes to
_device_trace: Optional[tuple] = None
_device_trace_lock = threading.Lock()


def start_device_trace(log_dir: str) -> str:
    """Start recording a :func:`device_profile`-style trace (CPU activity,
    and CUDA activity when this process can reach a card) that
    :func:`stop_device_trace` writes as a chrome trace under ``log_dir``.
    One trace at a time: starting a second while one is open raises. The
    log directory has no default (the reference's is a fixed /tmp path)."""
    global _device_trace
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    with _device_trace_lock:
        if _device_trace is not None:
            raise RuntimeError(
                f"a device trace into {_device_trace[1]!r} is already open"
            )
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(log_dir))
        prof.start()
        _device_trace = (prof, log_dir)
    return log_dir


def stop_device_trace() -> None:
    """Stop the open device trace and write it; raises if none is open."""
    global _device_trace
    with _device_trace_lock:
        if _device_trace is None:
            raise RuntimeError("no device trace is open")
        prof, _ = _device_trace
        _device_trace = None
    prof.stop()


@contextmanager
def device_trace(log_dir: str):
    """:func:`start_device_trace` and :func:`stop_device_trace` around the
    block; yields the log directory."""
    start_device_trace(log_dir)
    try:
        yield log_dir
    finally:
        stop_device_trace()


def annotate_device_trace(name: str):
    """A named region inside a device profile: a ``record_function`` range
    around the host-side launches, shown on the trace's timeline."""
    import torch

    return torch.profiler.record_function(name)
