"""Replica actor: the port of ray_tpu/serve/replica.py.

It hosts one copy of a deployment's user callable: runs the user
``__init__`` once (then ``reconfigure(user_config)`` and a sync ``warmup``
hook, so that RUNNING implies warmed up), serves requests while tracking
the ongoing-request count (the autoscaling signal), and answers health
checks, metrics polls, drains and shutdowns.

Every request passes admission control before user code runs:
dead-on-arrival requests (deadline already passed) are rejected without
computing, DRAINING replicas refuse new work with a retryable typed error,
and once ``max_ongoing_requests`` are executing, further requests wait in a
bounded queue (``max_queued_requests``) past which the replica sheds fast
with ``BackPressureError``. The request's multiplexed model id is bound to
the context that runs user code (its task, or the pool thread that runs
sync code), and sync generators stream item by item from the pool.

Copied from the reference, with these departures:

- the callable arrives pickled by reference (its module and name), not by
  value: the port has no cloudpickle (ROADMAP kept item 35);
- the reference's per-replica telemetry series (``util/timeseries``: queue
  depth and TTFT history) and its hang watchdog (``util/watchdog``) are
  left out: they wait for the runtime's observability (ROADMAP A item 21).
  The ``serve_ttft_seconds`` and warmup histograms are recorded, as in the
  reference.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import time
from typing import Any, Dict, Optional


def _lease_card() -> Optional[int]:
    """The CUDA index of the card this worker's lease binds it to, or None
    (no lease names a card, or no runtime in this process)."""
    from .. import _worker_api

    worker = _worker_api.maybe_get_core_worker()
    return getattr(worker, "_cuda_index", None) if worker is not None else None


def _bind_thread(card: int) -> None:
    import torch

    torch.cuda.set_device(card)


class Replica:
    """The actor class; the controller creates it through ``remote``."""

    def __init__(
        self,
        deployment_name: str,
        replica_id: str,
        cls_or_fn_bytes: bytes,
        init_args: tuple,
        init_kwargs: dict,
        user_config: Any,
        max_ongoing_requests: int = 100,
        max_queued_requests: int = 64,
    ):
        from collections import OrderedDict

        from concurrent.futures import ThreadPoolExecutor

        from .._internal import serialization

        warmup_start = time.perf_counter()
        self._deployment_name = deployment_name
        self._replica_id = replica_id
        self._ongoing = 0
        self._queued = 0
        self._total_served = 0
        self._shed_total = 0
        self._doa_total = 0
        self._draining = False
        self._max_ongoing = max(1, int(max_ongoing_requests))
        self._max_queued = max(0, int(max_queued_requests))
        # set on every request completion so queued waiters re-check for a
        # free slot (created lazily: __init__ may run before a loop exists)
        self._slot_free: Optional[asyncio.Event] = None
        # the pool that runs sync user code binds each of its threads to
        # the lease's card, as the core worker's executor threads are
        # (ROADMAP kept item 34): CUDA's current device is a thread's own
        card = _lease_card()
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix=f"replica-{replica_id}",
            initializer=_bind_thread if card is not None else None,
            initargs=(card,) if card is not None else (),
        )
        # recently-routed distinct prefix-affinity keys (bounded recency
        # map key -> last-seen ts); the controller reads the live count as
        # its scale-down victim signal
        self._affinity_keys: "OrderedDict[int, float]" = OrderedDict()
        target = serialization.loads(cls_or_fn_bytes)
        if inspect.isclass(target):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target
        self._is_function = not inspect.isclass(target)
        if user_config is not None:
            self._reconfigure_sync(user_config)
        # cold-start accounting: everything between actor start and
        # ready-to-serve counts — deserialize, user __init__ (weight-plane
        # resolution for LLM replicas happens there), reconfigure, and an
        # optional synchronous warmup() hook. check_health (and therefore
        # the STARTING -> RUNNING transition) cannot run before this
        # completes, so RUNNING always implies warmed-up.
        warmup_hook = getattr(self._callable, "warmup", None)
        if warmup_hook is not None and not inspect.iscoroutinefunction(
            warmup_hook
        ):
            warmup_hook()
        self._warmup_s = time.perf_counter() - warmup_start
        from ..util.metrics import record_serve_replica_warmup

        record_serve_replica_warmup(deployment_name, self._warmup_s)

    _AFFINITY_KEY_WINDOW_S = 60.0
    _AFFINITY_KEY_CAP = 4096

    def _note_affinity(self, metadata: Optional[dict]):
        key = (metadata or {}).get("affinity_key")
        if key is None:
            return
        self._affinity_keys.pop(key, None)
        self._affinity_keys[key] = time.time()
        while len(self._affinity_keys) > self._AFFINITY_KEY_CAP:
            self._affinity_keys.popitem(last=False)

    def _live_affinity_keys(self) -> int:
        cutoff = time.time() - self._AFFINITY_KEY_WINDOW_S
        while self._affinity_keys:
            key, ts = next(iter(self._affinity_keys.items()))
            if ts >= cutoff:
                break
            self._affinity_keys.popitem(last=False)
        return len(self._affinity_keys)

    # -- admission control ----------------------------------------------------

    def _deadline_of(self, metadata: Optional[dict]) -> Optional[float]:
        if not metadata:
            return None
        d = metadata.get("deadline_ts")
        return float(d) if d is not None else None

    def _check_doa(self, metadata: Optional[dict]):
        """Reject dead-on-arrival work: if the caller's deadline already
        passed, nobody is waiting for the result — don't compute it."""
        deadline = self._deadline_of(metadata)
        if deadline is not None and time.time() >= deadline:
            from ..exceptions import DeadlineExceededError
            from ..util.metrics import record_serve_doa

            self._doa_total += 1
            record_serve_doa(self._deployment_name)
            timeout_s = float((metadata or {}).get("timeout_s") or 0.0)
            raise DeadlineExceededError(
                deployment=self._deployment_name,
                elapsed_s=time.time() - (deadline - timeout_s)
                if timeout_s
                else 0.0,
                timeout_s=timeout_s,
                where=f"replica {self._replica_id} admission",
            )

    async def _admit(self, metadata: Optional[dict]):
        """Admission control, runs BEFORE user code and before the request
        counts as accepted. Order matters: drain check first (stale routers
        get a retryable error), then DOA, then capacity. Raises fast —
        shedding must cost milliseconds, not a timeout."""
        self._check_fenced()
        if self._draining:
            from ..exceptions import ReplicaDrainingError
            from ..util import events as _events

            _events.record_event(
                _events.DRAIN_REJECTED, deployment=self._deployment_name,
                replica=self._replica_id,
            )
            raise ReplicaDrainingError(self._replica_id)
        self._check_doa(metadata)
        if self._ongoing < self._max_ongoing:
            self._ongoing += 1
            return
        if self._queued >= self._max_queued:
            from ..exceptions import BackPressureError
            from ..util import events as _events
            from ..util.metrics import record_serve_shed

            self._shed_total += 1
            record_serve_shed(self._deployment_name)
            _events.record_event(
                _events.REQUEST_SHED, deployment=self._deployment_name,
                replica=self._replica_id, ongoing=self._ongoing,
                queued=self._queued,
            )
            raise BackPressureError(
                replica_id=self._replica_id,
                ongoing=self._ongoing,
                queued=self._queued,
                retry_after_s=0.1,
            )
        # wait for a slot; bounded by the request deadline (if any) so a
        # queued request never outlives its caller
        if self._slot_free is None:
            self._slot_free = asyncio.Event()
        deadline = self._deadline_of(metadata)
        self._queued += 1
        try:
            while True:
                self._check_fenced()
                if self._draining:
                    from ..exceptions import ReplicaDrainingError
                    from ..util import events as _events

                    _events.record_event(
                        _events.DRAIN_REJECTED,
                        deployment=self._deployment_name,
                        replica=self._replica_id, queued=True,
                    )
                    raise ReplicaDrainingError(self._replica_id)
                self._check_doa(metadata)
                if self._ongoing < self._max_ongoing:
                    self._ongoing += 1
                    return
                self._slot_free.clear()
                wait_s = 0.25
                if deadline is not None:
                    wait_s = min(wait_s, max(0.0, deadline - time.time()))
                try:
                    await asyncio.wait_for(
                        self._slot_free.wait(), timeout=wait_s + 0.001
                    )
                except asyncio.TimeoutError:
                    pass
        finally:
            self._queued -= 1

    def _check_fenced(self):
        """Split-brain guard: this replica's node lost GCS contact, so the
        controller may already be starting a replacement elsewhere. Reject
        with a retryable typed error so routers fail over instead of
        double-serving (or hanging on a partitioned node)."""
        from ..util import fencing

        if fencing.is_fenced():
            from ..exceptions import NodeFencedError

            _fenced, node_id, reason = fencing.fence_info()
            raise NodeFencedError(node_id, reason or "gcs unreachable")

    def _release(self):
        self._ongoing -= 1
        self._total_served += 1
        if self._slot_free is not None:
            self._slot_free.set()

    def _dequeue(self):
        self._queued -= 1

    # -- request path --------------------------------------------------------

    async def _prepare_call(self, method: str, args: tuple, kwargs: dict,
                            metadata: Optional[dict]):
        """Shared request setup: multiplex context, chained-response
        resolution, target-callable lookup."""
        if metadata and metadata.get("multiplexed_model_id"):
            from .multiplex import _set_multiplexed_model_id

            _set_multiplexed_model_id(metadata["multiplexed_model_id"])
        # response chaining (reference: DeploymentResponse args resolve to
        # their values before the method runs): the handle converted chained
        # responses to ObjectRefs; they arrive nested inside the args tuple
        # (only top-level task args auto-resolve), so resolve here
        from ..object_ref import ObjectRef

        if any(isinstance(a, ObjectRef) for a in args) or any(
            isinstance(v, ObjectRef) for v in kwargs.values()
        ):
            from .. import api as ray_api

            async def resolve(x):
                if isinstance(x, ObjectRef):
                    loop = asyncio.get_running_loop()
                    return await loop.run_in_executor(
                        None, lambda: ray_api.get(x, timeout=60)
                    )
                return x

            args = tuple([await resolve(a) for a in args])
            kwargs = {k: await resolve(v) for k, v in kwargs.items()}
        if self._is_function:
            fn = self._callable
        else:
            fn = getattr(self._callable, method or "__call__")
        return fn, args, kwargs

    async def handle_request(self, method: str, args: tuple, kwargs: dict,
                             metadata: Optional[dict] = None):
        from ..util import tracing as _tracing

        tctx = (metadata or {}).get("trace_ctx")
        t0 = time.perf_counter()
        if tctx is None and not _tracing.is_tracing_enabled():
            # untraced fast path: skip the span contextmanager entirely
            return await self._run_request(
                method, args, kwargs, metadata, t0, None
            )
        # adopt the caller's trace: every span below (and anything user
        # code opens — the engine, kvcache) joins the request's trace
        with _tracing.request_span(
            "serve.replica", tctx, deployment=self._deployment_name,
            replica=self._replica_id, method=method or "__call__",
        ) as span_ctx:
            return await self._run_request(
                method, args, kwargs, metadata, t0, span_ctx
            )

    async def _run_request(self, method: str, args: tuple, kwargs: dict,
                           metadata: Optional[dict], t0: float,
                           span_ctx: Optional[dict]):
        from ..util import tracing as _tracing
        from ..util.metrics import record_serve_ttft

        admit_wall = time.time()
        try:
            await self._admit(metadata)
        except BaseException as exc:
            if span_ctx is not None:
                _tracing.emit_span(
                    "serve.admission", span_ctx, admit_wall,
                    time.perf_counter() - t0,
                    rejected=type(exc).__name__,
                )
            raise
        # admission span covers the bounded queue wait on purpose:
        # that wait IS the stage a slow request spent here
        if span_ctx is not None:
            _tracing.emit_span(
                "serve.admission", span_ctx, admit_wall,
                time.perf_counter() - t0,
                ongoing=self._ongoing, queued=self._queued,
            )
        self._note_affinity(metadata)
        try:
            fn, args, kwargs = await self._prepare_call(
                method, args, kwargs, metadata
            )
            if inspect.iscoroutinefunction(fn):
                result = await fn(*args, **kwargs)
            else:
                # sync user code must not block the worker's event
                # loop (it services RPC + heartbeats); run it on the
                # request pool. The context carries the multiplexed
                # model id AND the active trace context across the
                # thread hop.
                import contextvars

                loop = asyncio.get_running_loop()
                ctx = contextvars.copy_context()
                result = await loop.run_in_executor(
                    self._pool, lambda: ctx.run(fn, *args, **kwargs)
                )
            # unary TTFT = first (and only) output; queue wait is
            # included on purpose — that is the latency the caller
            # experiences and the signal the autoscaler scales on
            ttft = time.perf_counter() - t0
            record_serve_ttft(
                self._deployment_name, ttft,
                trace_id=span_ctx["trace_id"] if span_ctx else None,
            )
            return result
        finally:
            self._release()

    async def handle_request_stream(self, method: str, args: tuple,
                                    kwargs: dict,
                                    metadata: Optional[dict] = None):
        """Streaming request path (reference: replica.py generator handling
        behind DeploymentResponseGenerator, serve/handle.py:557): the user
        method must be a (sync or async) generator; every yielded item ships
        to the caller through the runtime's streaming-generator machinery as
        soon as it exists."""
        from ..util import tracing as _tracing
        from ..util.metrics import record_serve_ttft

        _SENTINEL = object()
        tctx = (metadata or {}).get("trace_ctx")
        # async generator: a request_span set/reset token cannot bracket
        # the yields (each step may run under a different caller context),
        # so the stream span's identity is minted up front and recorded
        # explicitly when the stream ends
        span_ctx = _tracing.child_context(tctx)
        t0 = time.perf_counter()
        wall0 = time.time()
        first_emitted = False

        def _note_first():
            nonlocal first_emitted
            if not first_emitted:
                first_emitted = True
                ttft = time.perf_counter() - t0
                record_serve_ttft(
                    self._deployment_name, ttft,
                    trace_id=span_ctx["trace_id"] if span_ctx else None,
                )
                if span_ctx is not None:
                    # streaming first-token stage: admission to first item
                    _tracing.emit_span(
                        "serve.first_token", span_ctx, wall0, ttft,
                        deployment=self._deployment_name,
                        replica=self._replica_id,
                    )

        try:
            admit_wall = time.time()
            try:
                await self._admit(metadata)
            except BaseException as exc:
                if span_ctx is not None:
                    _tracing.emit_span(
                        "serve.admission", span_ctx, admit_wall,
                        time.perf_counter() - t0, rejected=type(exc).__name__,
                    )
                raise
            if span_ctx is not None:
                _tracing.emit_span(
                    "serve.admission", span_ctx, admit_wall,
                    time.perf_counter() - t0,
                    ongoing=self._ongoing, queued=self._queued,
                )
            self._note_affinity(metadata)
            try:
                fn, args, kwargs = await self._prepare_call(
                    method, args, kwargs, metadata
                )
                if inspect.isasyncgenfunction(fn):
                    async for item in fn(*args, **kwargs):
                        _note_first()
                        yield item
                    return
                if inspect.iscoroutinefunction(fn):
                    raise TypeError(
                        f"stream=True requires a generator method; "
                        f"{method!r} is a coroutine function"
                    )
                import contextvars

                loop = asyncio.get_running_loop()
                ctx = contextvars.copy_context()
                if span_ctx is not None:
                    # install the stream's span as the copied context's
                    # task context: generator steps below run under ctx, so
                    # engine/kvcache spans parent to this stream
                    ctx.run(_tracing._task_context.set, span_ctx)
                gen = await loop.run_in_executor(
                    self._pool, lambda: ctx.run(fn, *args, **kwargs)
                )
                if not inspect.isgenerator(gen):
                    raise TypeError(
                        f"stream=True requires a generator method; {method!r} "
                        f"returned {type(gen).__name__}"
                    )
                # drive the sync generator on the pool: each next() may block
                # on user compute and must stay off the worker's event loop.
                # Every step runs under the copied context — generator bodies
                # see the context active at each next(), not at creation, so
                # a bare next() would drop the multiplexed-model-id var.
                while True:
                    item = await loop.run_in_executor(
                        self._pool, lambda: ctx.run(next, gen, _SENTINEL)
                    )
                    if item is _SENTINEL:
                        return
                    _note_first()
                    yield item
            finally:
                self._release()
        finally:
            if span_ctx is not None:
                _tracing.emit_closed_span(
                    "serve.replica_stream", span_ctx, tctx, wall0,
                    time.perf_counter() - t0,
                    deployment=self._deployment_name,
                    replica=self._replica_id, method=method or "__call__",
                )

    # -- control plane -------------------------------------------------------

    def get_metrics(self) -> Dict[str, Any]:
        from .. import _worker_api

        try:
            worker = _worker_api.get_core_worker()
            node_id = worker.node_id.hex() if worker.node_id else ""
        except Exception:
            node_id = ""
        return {
            "replica_id": self._replica_id,
            "node_id": node_id,
            "queue_len": self._ongoing + self._queued,
            "ongoing": self._ongoing,
            "queued": self._queued,
            "shed_total": self._shed_total,
            "doa_total": self._doa_total,
            "total_served": self._total_served,
            "draining": self._draining,
            "pid": os.getpid(),
            "affinity_keys": self._live_affinity_keys(),
            "warmup_s": round(self._warmup_s, 6),
            "mesh": self._mesh_info(),
        }

    def _mesh_info(self):
        """Mesh ownership card from the user callable (LLM replicas expose
        mesh_info(): mesh shape, per-device HBM, KV pool footprint). None
        for callables without a mesh — the controller then reports the
        replica as single-device."""
        fn = getattr(self._callable, "mesh_info", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            return None

    def check_health(self) -> bool:
        user_check = getattr(self._callable, "check_health", None)
        if user_check is not None:
            user_check()
        return True

    def _reconfigure_sync(self, user_config):
        rec = getattr(self._callable, "reconfigure", None)
        if rec is not None:
            rec(user_config)

    def reconfigure(self, user_config) -> bool:
        self._reconfigure_sync(user_config)
        return True

    async def _run_shutdown_hook(self):
        """Run user cleanup before the controller hard-kills this actor;
        an explicit shutdown() wins over __del__ (which GC may also run)."""
        for hook in ("shutdown", "__del__"):
            fn = getattr(type(self._callable), hook, None)
            if fn is not None:
                try:
                    result = fn(self._callable)
                    if inspect.iscoroutine(result):
                        await result
                except Exception:
                    pass
                break

    async def _wait_idle(self, timeout_s: float) -> bool:
        deadline = time.time() + timeout_s
        while (self._ongoing > 0 or self._queued > 0) and time.time() < deadline:
            await asyncio.sleep(0.05)
        return self._ongoing == 0 and self._queued == 0

    async def drain(self, timeout_s: float = 5.0) -> bool:
        """Graceful drain: stop admitting new requests, finish everything
        in-flight AND queued (bounded by timeout_s), then ack. The
        controller only kills this actor after the ack or the deadline
        (reference: replica.py perform_graceful_shutdown). Returns True if
        the replica drained clean (zero dropped accepted requests)."""
        from ..util.metrics import record_serve_drain

        start = time.time()
        self._draining = True
        clean = await self._wait_idle(timeout_s)
        await self._run_shutdown_hook()
        record_serve_drain(self._deployment_name, time.time() - start)
        return clean

    async def prepare_for_shutdown(self, timeout_s: float = 5.0) -> bool:
        """Drain: wait for ongoing requests to finish (reference:
        graceful_shutdown_timeout_s semantics). Kept as the synchronous
        stop path; sets _draining so no new work is admitted while the
        controller blocks on us."""
        self._draining = True
        clean = await self._wait_idle(timeout_s)
        await self._run_shutdown_hook()
        return clean
