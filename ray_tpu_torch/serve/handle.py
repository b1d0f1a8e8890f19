"""DeploymentHandle and Router, the request data plane: the port of
ray_tpu/serve/handle.py, copied without departure.

Each call samples two running replicas and routes to the one with the
shorter queue (power of two choices), using queue lengths from the
controller's routing table, refreshed on a version poll. With an affinity
key (the hash of a request's leading prompt tokens, or of its multiplexed
model id) one candidate is the key's rendezvous-ring replica, which wins
unless its queue is more than ``Router._AFFINITY_SLACK`` longer than the
other's. Handles work from any process: they pickle as the controller's
handle and names.

``remote()`` wraps every submission in a retryable envelope. A
per-request deadline (``options(timeout_s=...)``, or the deployment's
``RequestRouterConfig.default_timeout_s``) rides in the request metadata
so replicas can reject dead-on-arrival work; on replica death, transport
failure, a stale-table ``ReplicaDrainingError``, or (by policy) a
``BackPressureError`` shed, the response force-refreshes the routing
table, excludes the failed replica and resubmits, bounded by
``max_attempts`` and the remaining deadline. Streaming responses retry
only while no item has been consumed. A ``DeploymentResponse`` passed
into another call travels as its object ref (response chaining).
"""

from __future__ import annotations

import logging
import random
import threading
import time
import zlib
from typing import Any, Dict, FrozenSet, Optional, Set

from .. import api
from ..exceptions import (
    ActorDiedError,
    BackPressureError,
    DeadlineExceededError,
    NodeFencedError,
    ReplicaDrainingError,
    RpcError,
    WorkerCrashedError,
)
from ..util import events as _events
from ..util import tracing as _tracing
from .hash_ring import ReplicaRing

logger = logging.getLogger(__name__)


def _prefix_affinity_key(args, kwargs, num_tokens: int) -> Optional[int]:
    """Stable hash of a request's leading prompt tokens, for cache-affine
    routing. Looks for the serving request dict convention ({"token_ids":
    ...} or {"prompt": ...}) in the call args; hashes the first
    ``num_tokens`` token ids (or 4x that many prompt characters — a rough
    token-length proxy). zlib.crc32, NOT hash(): the key must agree across
    processes and PYTHONHASHSEED randomizes str/bytes hashing per-process."""
    for value in list(args) + list(kwargs.values()):
        if not isinstance(value, dict):
            continue
        token_ids = value.get("token_ids")
        if token_ids is not None:
            try:
                head = ",".join(str(int(t)) for t in list(token_ids)[:num_tokens])
            except (TypeError, ValueError):
                continue
            return zlib.crc32(head.encode())
        prompt = value.get("prompt")
        if isinstance(prompt, str):
            return zlib.crc32(prompt[: 4 * num_tokens].encode())
    return None


def _unwrap(exc: BaseException) -> BaseException:
    """User/replica exceptions travel wrapped as TaskError with ``.cause``
    set to the original; classification wants the original."""
    cause = getattr(exc, "cause", None)
    return cause if isinstance(cause, BaseException) else exc


_TYPED_SERVE_ERRORS = (
    BackPressureError, DeadlineExceededError, NodeFencedError,
    ReplicaDrainingError,
)


class _RequestContext:
    """Everything needed to resubmit one request to a different replica:
    the routing inputs, the failover policy from the deployment's
    RequestRouterConfig, and the mutable attempt state (current replica,
    replicas already tried). Shared by unary and streaming responses."""

    def __init__(self, router: "Router", deployment: str, method: str,
                 args: tuple, kwargs: dict, metadata: Optional[dict],
                 affinity: Optional[int], stream: bool,
                 deadline_ts: Optional[float], router_cfg: Dict[str, Any],
                 replica_id: str):
        self.router = router
        self.deployment = deployment
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.metadata = metadata
        self.affinity = affinity
        self.stream = stream
        self.deadline_ts = deadline_ts
        self.max_attempts = max(1, int(router_cfg.get("max_attempts", 3)))
        self.backoff_s = float(router_cfg.get("backoff_s", 0.05))
        self.retry_backpressure = bool(
            router_cfg.get("retry_backpressure", True)
        )
        self.attempt = 1
        self.replica_id = replica_id
        self.tried: Set[str] = {replica_id}

    def remaining_s(self) -> Optional[float]:
        if self.deadline_ts is None:
            return None
        return self.deadline_ts - time.time()

    def _retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, (ActorDiedError, WorkerCrashedError, RpcError,
                            ReplicaDrainingError, NodeFencedError)):
            return True
        if isinstance(exc, BackPressureError):
            return self.retry_backpressure
        return False

    def classify(self, raw_exc: BaseException):
        """(exception to raise to the caller, retryable?). Typed serve
        errors surface unwrapped (callers/proxies except BackPressureError,
        not TaskError); everything else keeps its existing shape."""
        exc = _unwrap(raw_exc)
        to_raise = exc if isinstance(exc, _TYPED_SERVE_ERRORS) else raw_exc
        return to_raise, self._retryable(exc)

    def failover(self, raw_exc: BaseException):
        """Try to resubmit after ``raw_exc``. Returns the new submission
        (ref or ref-gen) or None when the error must surface (not
        retryable, attempts exhausted, or no deadline budget left)."""
        to_raise, retryable = self.classify(raw_exc)
        if not retryable or self.attempt >= self.max_attempts:
            return None
        remaining = self.remaining_s()
        backoff = self.backoff_s * self.attempt
        if remaining is not None and remaining <= backoff:
            return None
        cause = _unwrap(raw_exc)
        logger.info(
            "serve failover (%s attempt %d/%d): %s on replica %s; "
            "resubmitting", self.deployment, self.attempt, self.max_attempts,
            type(cause).__name__, self.replica_id,
        )
        attempt_wall = time.time()
        attempt_t0 = time.perf_counter()
        if backoff > 0:
            time.sleep(backoff)
        self.attempt += 1
        # the failed replica may be a fresh death the controller hasn't
        # noticed yet — exclude it explicitly so the refreshed table can't
        # hand it straight back
        try:
            rid, replica = self.router.pick(
                self.deployment, self.affinity,
                exclude=frozenset(self.tried), force_refresh=True,
                deadline_ts=self.deadline_ts,
            )
        except Exception:
            return None
        excluded = sorted(self.tried)
        self.replica_id = rid
        self.tried.add(rid)
        from ..util.metrics import record_serve_retry

        # the retry counter tags the OUTCOME replica (where the request
        # went), so it counts only after the pick succeeds
        record_serve_retry(self.deployment, type(cause).__name__, replica=rid)
        _events.record_event(
            _events.REQUEST_RETRY, deployment=self.deployment,
            reason=type(cause).__name__, attempt=self.attempt,
            replica=rid, excluded=excluded,
        )
        # sibling attempt span under the request's trace: one per failover,
        # tagged with the replicas already excluded and the backoff burned
        _tracing.emit_span(
            "serve.attempt", (self.metadata or {}).get("trace_ctx"),
            attempt_wall, time.perf_counter() - attempt_t0,
            deployment=self.deployment, attempt=self.attempt,
            reason=type(cause).__name__, replica=rid,
            excluded=excluded, backoff_s=backoff,
        )
        return _submit(replica, self)


def _submit(replica, ctx: "_RequestContext"):
    """One raw submission of the request to a replica actor."""
    if ctx.stream:
        return replica.handle_request_stream.options(
            num_returns="streaming"
        ).remote(ctx.method, ctx.args, ctx.kwargs, ctx.metadata)
    return replica.handle_request.remote(
        ctx.method, ctx.args, ctx.kwargs, ctx.metadata
    )


class DeploymentResponse:
    """Future for one request (reference: serve/handle.py
    DeploymentResponse): .result() blocks; ._to_object_ref() exposes the ref
    for composition with ray_tpu.get/wait.

    With a retry context, ``result()`` is where failover happens: the
    submission was eager (fire-and-forget callers never block), so a
    replica death is only observed — and absorbed — when the result is
    awaited."""

    def __init__(self, ref, ctx: Optional[_RequestContext] = None):
        self._ref = ref
        self._ctx = ctx

    def replica_id(self) -> Optional[str]:
        """The replica that served (or is serving) this request — AFTER
        failover, the replica the final resubmission landed on, not the
        one originally routed to. None for bare refs with no context."""
        return self._ctx.replica_id if self._ctx is not None else None

    def trace_id(self) -> Optional[str]:
        """The request's trace id (joins caller-side latency with the
        server-side spans); None when the request was not traced."""
        if self._ctx is None:
            return None
        tctx = (self._ctx.metadata or {}).get("trace_ctx")
        return tctx.get("trace_id") if tctx else None

    def result(self, timeout_s: Optional[float] = None):
        while True:
            wait_s = timeout_s
            if self._ctx is not None:
                remaining = self._ctx.remaining_s()
                if remaining is not None:
                    remaining = max(remaining, 0.001)
                    wait_s = remaining if wait_s is None \
                        else min(wait_s, remaining)
            try:
                return api.get(self._ref, timeout=wait_s)
            except BaseException as exc:  # noqa: BLE001
                if self._ctx is None:
                    raise
                new_ref = self._ctx.failover(exc)
                if new_ref is None:
                    to_raise, _ = self._ctx.classify(exc)
                    if to_raise is exc:
                        raise
                    raise to_raise from exc
                self._ref = new_ref

    def _to_object_ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Streaming response (reference: serve/handle.py:557
    DeploymentResponseGenerator): iterating yields each item the replica's
    generator produces, as soon as it is reported — the first item is
    consumable while the replica is still generating.

    Failover is guarded by consumption: once any item has been delivered
    to the caller, a mid-stream failure surfaces instead of retrying (a
    restarted stream would silently replay or skip output)."""

    def __init__(self, ref_gen, timeout_s: Optional[float] = 60.0,
                 ctx: Optional[_RequestContext] = None):
        self._ref_gen = ref_gen
        self._timeout_s = timeout_s
        self._ctx = ctx
        self._consumed = 0

    def replica_id(self) -> Optional[str]:
        """See DeploymentResponse.replica_id."""
        return self._ctx.replica_id if self._ctx is not None else None

    def trace_id(self) -> Optional[str]:
        """See DeploymentResponse.trace_id."""
        if self._ctx is None:
            return None
        tctx = (self._ctx.metadata or {}).get("trace_ctx")
        return tctx.get("trace_id") if tctx else None

    def __iter__(self):
        return self

    def _item_timeout(self) -> Optional[float]:
        if self._ctx is not None and self._ctx.deadline_ts is not None:
            return max(self._ctx.deadline_ts - time.time(), 0.001)
        return self._timeout_s

    def _maybe_failover(self, exc: BaseException) -> bool:
        """Replace the underlying stream with a fresh submission if the
        idempotency guard (zero items consumed) and retry policy allow."""
        if self._ctx is None or self._consumed > 0:
            return False
        new_gen = self._ctx.failover(exc)
        if new_gen is None:
            return False
        self.close()
        self._ref_gen = new_gen
        return True

    def __next__(self):
        while True:
            try:
                ref = next(self._ref_gen)  # StopIteration at end of stream
                return_value = api.get(ref, timeout=self._item_timeout())
            except StopIteration:
                raise
            except BaseException as exc:  # noqa: BLE001
                if self._maybe_failover(exc):
                    continue
                # release the owner's stream bookkeeping NOW — a leaked
                # half-consumed stream pins its reported items until GC
                self.close()
                if self._ctx is not None:
                    to_raise, _ = self._ctx.classify(exc)
                    if to_raise is not exc:
                        raise to_raise from exc
                raise
            self._consumed += 1
            return return_value

    def close(self):
        """Stop consuming; closing the underlying ObjectRefGenerator
        eagerly releases the owner's stream bookkeeping AND signals the
        producing replica to stop generating (object_ref.py close())."""
        close = getattr(self._ref_gen, "close", None)
        if close is not None:
            close()
        self._ref_gen = iter(())

    def _to_object_ref_gen(self):
        return self._ref_gen


class _DeploymentView:
    """One deployment's routing snapshot, generation-stamped.

    Built only when the controller-reported table ``version`` (replica
    membership) changes; between generations a refresh just rewrites the
    queue-length list in place. Replica rows are pre-split into parallel
    tuples and the rendezvous ring is precomputed, so the per-request pick
    is index arithmetic over immutable structure — no lock, no dict built,
    no sort."""

    __slots__ = ("generation", "ids", "handles", "queues", "ring",
                 "router_config", "index_of")

    def __init__(self, generation: int, replicas, router_config: dict):
        rows = sorted(replicas, key=lambda r: str(r[0]))
        self.generation = generation
        self.ids = tuple(str(r[0]) for r in rows)
        self.handles = tuple(r[1] for r in rows)
        # the one mutable field: refreshed in place between generations
        self.queues = [int(r[2]) for r in rows]
        # ring ids == self.ids (both sorted), so a ring index indexes the
        # parallel tuples directly
        self.ring = ReplicaRing(self.ids)
        self.router_config = router_config or {}
        self.index_of = {rid: i for i, rid in enumerate(self.ids)}


class Router:
    """Per-process replica picker for one application."""

    _REFRESH_S = 1.0
    _STALE_WARN_S = 10.0

    def __init__(self, controller, app_name: str):
        self._controller = controller
        self._app_name = app_name
        # deployment -> _DeploymentView; whole-dict reference swapped
        # atomically on refresh so pick() reads without the lock
        self._views: Dict[str, _DeploymentView] = {}
        self._last_refresh = 0.0
        self._ever_refreshed = False
        self._last_stale_warn = 0.0
        self._lock = threading.Lock()
        self._rr = 0
        # stats for the cross-proxy agreement tests and `ray_tpu proxies`:
        # picks must proceed with NO controller round-trip between the
        # periodic table polls
        self.table_fetches = 0
        self.picks = 0

    def _refresh(self, force: bool = False):
        """Pull the routing table from the controller. A slow or briefly
        unreachable controller must NOT fail the request path: on error we
        keep serving from the cached (stale) views with a rate-limited
        warning, and only raise if there has never been a successful
        refresh (nothing cached to fall back on)."""
        now = time.time()
        if not force and now - self._last_refresh < self._REFRESH_S:
            return
        try:
            table = api.get(
                self._controller.get_routing_table.remote(self._app_name),
                timeout=5,
            )
        except Exception as exc:
            with self._lock:
                if not self._ever_refreshed:
                    raise
                stale_s = now - self._last_refresh
                # back off further refresh attempts for one TTL so every
                # request doesn't eat the controller timeout serially
                self._last_refresh = now
                if now - self._last_stale_warn >= self._STALE_WARN_S:
                    self._last_stale_warn = now
                    logger.warning(
                        "serve controller unreachable (%s); routing %r "
                        "from routing table %.1fs stale",
                        type(exc).__name__, self._app_name, stale_s,
                    )
            return
        with self._lock:
            old_views = self._views
            views: Dict[str, _DeploymentView] = {}
            for dep_name, entry in table.items():
                replicas = entry.get("replicas") or []
                generation = int(entry.get("version", 0))
                old = old_views.get(dep_name)
                if (
                    old is not None
                    and old.generation == generation
                    and len(old.ids) == len(replicas)
                ):
                    # same membership generation: update queue lengths in
                    # place, keep the ring and tuples (the common case —
                    # membership changes are rare, queue drift is constant)
                    for rid, _handle, queue_len in replicas:
                        i = old.index_of.get(str(rid))
                        if i is not None:
                            old.queues[i] = int(queue_len)
                    old.router_config = entry.get("router_config") \
                        or old.router_config
                    views[dep_name] = old
                else:
                    views[dep_name] = _DeploymentView(
                        generation, replicas,
                        entry.get("router_config") or {},
                    )
            self._views = views
            self._last_refresh = now
            self._ever_refreshed = True
            self.table_fetches += 1

    def router_config(self, deployment: str) -> Dict[str, Any]:
        """The deployment's failover policy as distributed through the
        routing table; defaults when the table predates the field."""
        self._refresh()
        view = self._views.get(deployment)
        cfg = view.router_config if view is not None else None
        if not cfg:
            from .config import RequestRouterConfig

            cfg = RequestRouterConfig().as_dict()
        return cfg

    def stats(self) -> Dict[str, int]:
        """{picks, table_fetches}: the agreement tests assert picks advance
        while table_fetches stays flat (no per-request controller RPC)."""
        return {"picks": self.picks, "table_fetches": self.table_fetches}

    # an affine replica keeps winning until its queue runs this many
    # requests longer than the random alternative's — cache reuse is worth
    # a little imbalance, but not a hot spot
    _AFFINITY_SLACK = 2

    def pick(self, deployment: str, affinity: Optional[int] = None,
             exclude: FrozenSet[str] = frozenset(),
             force_refresh: bool = False,
             deadline_ts: Optional[float] = None):
        """Power-of-two-choices on reported queue length; returns
        ``(replica_id, handle)``. With an ``affinity`` key (hash of the
        request's prompt prefix), the pick is biased: one candidate is
        always the key's rendezvous-ring replica (serve/hash_ring.py — the
        SAME winner in every proxy/handle process, no controller round
        trip), which wins unless its queue is more than _AFFINITY_SLACK
        behind — so repeated prefixes land where their KV blocks already
        live, and overload still spills to the rest of the fleet.
        ``exclude`` drops replicas a failover already tried — unless that
        would leave no candidate (a 1-replica deployment's restart is
        still worth a retry)."""
        self._refresh(force=force_refresh)
        self.picks += 1
        view = self._views.get(deployment)
        if view is not None and view.ids and not exclude:
            return self._pick_fast(view, affinity)
        return self._pick_slow(deployment, affinity, exclude, deadline_ts)

    def _pick_fast(self, view: _DeploymentView, affinity: Optional[int]):
        """The per-request hot path: index arithmetic over the view's
        precomputed tuples. Deliberately allocates no dict (guarded by a
        dis()-based perf-smoke test) — at proxy saturation this runs tens
        of thousands of times a second per process."""
        ids = view.ids
        n = len(ids)
        if n == 1:
            return ids[0], view.handles[0]
        queues = view.queues
        if affinity is not None:
            i = view.ring.lookup_index(affinity)
            j = random.randrange(n - 1)
            if j >= i:
                j += 1
            if queues[i] <= queues[j] + self._AFFINITY_SLACK:
                return ids[i], view.handles[i]
            return ids[j], view.handles[j]
        # two random candidates, shorter controller-reported queue wins;
        # round-robin counter breaks ties so equal queues still spread
        a = random.randrange(n)
        b = random.randrange(n - 1)
        if b >= a:
            b += 1
        qa = queues[a]
        qb = queues[b]
        if qa == qb:
            self._rr += 1
            winner = a if self._rr % 2 else b
        else:
            winner = a if qa < qb else b
        return ids[winner], view.handles[winner]

    def _pick_slow(self, deployment: str, affinity: Optional[int],
                   exclude: FrozenSet[str],
                   deadline_ts: Optional[float]):
        """Failover / cold paths: exclusion sets and empty views (waiting
        for the first replica to come RUNNING, bounded by the request
        deadline)."""
        deadline = time.time() + 30
        if deadline_ts is not None:
            deadline = min(deadline, deadline_ts)
        while True:
            view = self._views.get(deployment)
            if view is not None and view.ids:
                kept = [
                    i for i in range(len(view.ids))
                    if view.ids[i] not in exclude
                ]
                if not kept:
                    # exclusion would leave no candidate: a 1-replica
                    # deployment's restart is still worth a retry
                    kept = list(range(len(view.ids)))
                if len(kept) == 1:
                    i = kept[0]
                    return view.ids[i], view.handles[i]
                if affinity is not None:
                    i = view.ring.lookup_excluding(affinity, exclude)
                    if i not in kept:
                        i = random.choice(kept)
                    j = random.choice([k for k in kept if k != i])
                    if view.queues[i] <= view.queues[j] + self._AFFINITY_SLACK:
                        return view.ids[i], view.handles[i]
                    return view.ids[j], view.handles[j]
                a, b = random.sample(kept, 2)
                qa, qb = view.queues[a], view.queues[b]
                if qa == qb:
                    self._rr += 1
                    winner = a if self._rr % 2 else b
                else:
                    winner = a if qa < qb else b
                return view.ids[winner], view.handles[winner]
            if time.time() > deadline:
                raise RuntimeError(
                    f"no running replicas for deployment {deployment!r}"
                )
            time.sleep(0.1)
            self._refresh(force=True)


class DeploymentHandle:
    def __init__(self, controller, app_name: str, deployment: str,
                 method: str = "__call__", multiplexed_model_id: str = "",
                 stream: bool = False, prefix_affinity_tokens: int = 0,
                 timeout_s: Optional[float] = None,
                 _router: Optional[list] = None):
        self._controller = controller
        self._app_name = app_name
        self._deployment = deployment
        self._method = method
        self._multiplexed_model_id = multiplexed_model_id
        self._stream = stream
        # > 0: hash this many leading prompt tokens of each request and
        # bias replica picking toward the hash's replica (prefix-cache
        # affinity); 0 disables
        self._prefix_affinity_tokens = prefix_affinity_tokens
        # per-request deadline; None defers to the deployment's
        # RequestRouterConfig.default_timeout_s
        self._timeout_s = timeout_s
        # the router depends only on (controller, app_name), both immutable
        # across options()/method handles — a shared mutable holder means
        # whichever handle first routes a request creates the Router and all
        # derived handles reuse its cached routing table
        self._router_holder: list = _router if _router is not None else [None]

    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                prefix_affinity_tokens: Optional[int] = None,
                timeout_s: Optional[float] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self._controller,
            self._app_name,
            self._deployment,
            method_name if method_name is not None else self._method,
            multiplexed_model_id
            if multiplexed_model_id is not None
            else self._multiplexed_model_id,
            stream if stream is not None else self._stream,
            prefix_affinity_tokens
            if prefix_affinity_tokens is not None
            else self._prefix_affinity_tokens,
            timeout_s if timeout_s is not None else self._timeout_s,
            _router=self._router_holder,
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        # handle.other_method.remote(...) sugar
        return DeploymentHandle(
            self._controller, self._app_name, self._deployment, name,
            self._multiplexed_model_id, self._stream,
            self._prefix_affinity_tokens, self._timeout_s,
            _router=self._router_holder,
        )

    def remote(self, *args, **kwargs):
        if self._router_holder[0] is None:
            self._router_holder[0] = Router(self._controller, self._app_name)
        router: Router = self._router_holder[0]
        router_cfg = router.router_config(self._deployment)
        # handle-level options() wins; otherwise the deployment's
        # RequestRouterConfig.prefix_affinity_tokens (distributed through
        # the routing table) turns affinity on for every router — proxies
        # included — with no per-call-site configuration
        tokens = self._prefix_affinity_tokens or int(
            router_cfg.get("prefix_affinity_tokens", 0) or 0
        )
        affinity = None
        if self._multiplexed_model_id:
            # adapter-id affinity WINS over prefix affinity: a multiplexed
            # deployment (multi-tenant LoRA serving) keeps each tenant hot
            # on few replicas — the adapter stays resident in their slot
            # banks and that tenant's prefixes concentrate in their radix,
            # so both the adapter hit rate AND the prefix hit rate ride
            # the same rendezvous bias
            affinity = zlib.crc32(
                ("adapter:" + self._multiplexed_model_id).encode()
            )
        elif tokens > 0:
            affinity = _prefix_affinity_key(args, kwargs, tokens)
        timeout_s = self._timeout_s
        if timeout_s is None:
            timeout_s = router_cfg.get("default_timeout_s", 60.0)
        deadline_ts = time.time() + timeout_s if timeout_s else None
        trace_ctx = _tracing.inject_context()  # None on the untraced path
        route_wall = time.time()
        route_t0 = time.perf_counter()
        rid, replica = router.pick(
            self._deployment, affinity, deadline_ts=deadline_ts
        )
        if trace_ctx is not None:
            _tracing.emit_span(
                "serve.route", trace_ctx, route_wall,
                time.perf_counter() - route_t0,
                deployment=self._deployment, replica=rid,
                affinity=affinity is not None,
            )
        metadata: Dict[str, Any] = {}
        if trace_ctx is not None:
            # the trace rides the request: the replica adopts it so its
            # admission/engine/kvcache spans join this caller's trace
            metadata["trace_ctx"] = trace_ctx
        if self._multiplexed_model_id:
            metadata["multiplexed_model_id"] = self._multiplexed_model_id
        if affinity is not None:
            # the key rides with the request so the replica can count the
            # distinct prefixes recently routed to it — the controller's
            # scale-down victim signal (drain the fewest-prefixes replica)
            metadata["affinity_key"] = affinity
        if deadline_ts is not None:
            # the deadline rides WITH the request so the replica can reject
            # dead-on-arrival work; retries inherit the same absolute
            # deadline (remaining budget, not a fresh timeout)
            metadata["deadline_ts"] = deadline_ts
            metadata["timeout_s"] = timeout_s
        # response chaining (reference: passing DeploymentResponse into a
        # downstream .remote — serve/handle.py): a response argument becomes
        # its ObjectRef, which the task-arg machinery resolves to the VALUE
        # before the replica method runs — no blocking .result() in between
        def chain(x):
            return x._to_object_ref() if isinstance(x, DeploymentResponse) else x

        args = tuple(chain(a) for a in args)
        kwargs = {k: chain(v) for k, v in kwargs.items()}
        ctx = _RequestContext(
            router, self._deployment, self._method, args, kwargs,
            metadata or None, affinity, self._stream, deadline_ts,
            router_cfg, rid,
        )
        if self._stream:
            # replica-side async generator shipped item-by-item through the
            # runtime's streaming-generator path (ObjectRefGenerator)
            ref_gen = _submit(replica, ctx)
            return DeploymentResponseGenerator(
                ref_gen, timeout_s=timeout_s or 60.0, ctx=ctx
            )
        ref = _submit(replica, ctx)
        return DeploymentResponse(ref, ctx=ctx)

    def __reduce__(self):
        return (
            DeploymentHandle,
            (self._controller, self._app_name, self._deployment, self._method,
             self._multiplexed_model_id, self._stream,
             self._prefix_affinity_tokens, self._timeout_s),
        )
