"""LLM serving: the port of ray_tpu/llm/serving.py's replica and
disaggregated ingress.

:class:`LLMServer` is the counterpart of the reference's replica callable
``_LLMReplica``: it builds the model and an engine and answers token-level
requests. With ``kv_cache_blocks=None`` the engine is
the dense :class:`~ray_tpu_torch.llm.engine.LLMEngine`; with it set, a
:class:`~ray_tpu_torch.llm.engine.ContinuousBatchingEngine` over a
:class:`~ray_tpu_torch.kvcache.KVCacheManager` (prefix reuse, memory-gated
admission), with the config's chunked prefill, speculative draft and
multi-tenant adapters (an :class:`~ray_tpu_torch.lora.AdapterStore`).

With ``LLMConfig.kv_tier`` or a ``role``, the server holds a
:class:`~ray_tpu_torch.kvtier.KVTierClient` over ``tier_backend``. A fused
server on the tier (no role) exports the prefixes it computes and pulls
warm ones from its peers. ``role="prefill"`` serves :meth:`LLMServer.prefill`
(run the admission prefill, ship the K/V) and ``role="decode"``
:meth:`LLMServer.decode_shipped` (adopt the shipment, decode with zero
prefill tokens); :class:`_DisaggIngress` routes a request through one of
each. The cluster's tier backend (``kvtier.GcsTierBackend``), the
deployment graph that builds role pools (``build_llm_deployment``) and
prefix-affinity routing wait for the runtime and the serve control plane;
in process, servers share a ``kvtier.LocalTierBackend``.

With ``LLMConfig.tensor_parallel_size`` (or ``mesh={"tp": n}``) above 1 the
server is rank 0 of a tensor-parallel replica (llm/tp_ranks.py): its weights,
decode caches and KV block pools are split over n ranks, one process each,
on ``devices`` (default: this host's cards; ``"cpu"`` entries for CPU ranks),
with the collectives of ``tp_backend``: ``"nccl"`` (a card per rank) or
``"gloo"`` (ranks on the CPU, or several on one card). ``server.engine`` is
rank 0's engine; the others run in lockstep with it. :meth:`LLMServer.close`
stops them (a finalizer does too). Adapters, the KV tier, roles and
``LLMPredictor`` under tp > 1 are not ported yet (ROADMAP A.5). The weight plane
and tokenizers come with later slices of the port; so a request names its
adapter by an explicit ``adapter_id`` only (the reference also reads
serve's multiplexed model id).

Request/response shape:
  {"token_ids": [...], "max_new_tokens": 32, "temperature": 0.0,
   "eos_token_id": None, "adapter_id": None, "stream": False}
-> {"token_ids": [...], "num_prompt_tokens": N, "finished_reason": ...}
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Dict, Optional, Sequence

import torch

from .._internal.device import DeviceLike, resolve_device
from ..exceptions import BackPressureError
from ..kvcache import KVCacheManager
from ..kvtier import GcsTierBackend, KVShipment, KVTierClient
from ..lora import AdapterLease, AdapterStore
from ..models.llama import init_params, param_shapes
from .config import LLMConfig, require_servable
from .engine import ContinuousBatchingEngine, GenerationRequest, LLMEngine

#: the seeds of a server's random weights and of its speculative draft's, at
#: every tensor-parallel size (llm/tp_ranks.py draws its slices under them)
PARAMS_SEED, DRAFT_SEED = 0, 1


class LLMServer:
    """Holds one engine with its weights on ``device`` (default: the card).
    Without ``params`` the weights are random, from the port's
    ``init_params`` under seed 0, as the reference's replica draws them
    under ``PRNGKey(0)``; given ``params`` are shared, not copied. A
    speculative draft is drawn likewise under seed 1. With
    ``LLMConfig.adapters`` the server holds an adapter store on ``device``
    (:attr:`adapter_store`): fill it with ``prewarm`` or a callable
    ``AdapterConfig.source``. ``role`` is None (fused), ``"prefill"`` or
    ``"decode"``; a role, or ``LLMConfig.kv_tier``, puts the server on the
    KV tier of ``tier_backend`` (the cluster's backend is not ported yet).

    Tensor parallelism (tp > 1 in the config): ``devices`` and
    ``tp_backend`` place and join the ranks (see the module docstring);
    ``device`` must then be None. Given ``params`` are the whole model on
    rank 0's device: rank 0 keeps views of its slices and sends the other
    ranks theirs."""

    def __init__(self, llm_config: LLMConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device: DeviceLike = None,
                 role: Optional[str] = None,
                 tier_backend=None,
                 devices: Optional[Sequence[Any]] = None,
                 tp_backend: str = "nccl"):
        if role not in (None, "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        if role is not None and not llm_config.kv_cache_blocks:
            raise ValueError(
                f"role={role!r} needs the paged engine: set kv_cache_blocks"
            )
        self._config = llm_config
        self._role = role
        self._kv_tier: Optional[KVTierClient] = None
        self._ranks = None
        model_config = require_servable(llm_config.build_model_config())
        tp, sp = llm_config.effective_parallelism()
        if tp > 1:
            self._start_tensor_parallel(model_config, params, device, role, devices,
                                        tp_backend)
            return
        if devices is not None:
            raise ValueError("devices= places tensor-parallel ranks; one rank takes device=")
        self._device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self._device).manual_seed(PARAMS_SEED)
            params = init_params(model_config, gen, device=self._device)
        self._kv_cache: Optional[KVCacheManager] = None
        self._adapter_store: Optional[AdapterStore] = None
        if llm_config.kv_cache_blocks:
            # paged prefix-reusing engine: requests stream through a slot
            # pool over a shared KV block pool; admission is memory-gated
            # and prompts sharing cached prefixes prefill only the suffix
            self._kv_cache = KVCacheManager(
                num_blocks=llm_config.kv_cache_blocks,
                block_size=llm_config.kv_block_size,
            )
            if llm_config.kv_tier or role is not None:
                # role servers need the tier for the prefill->decode
                # handoff; fused servers opt in to share warm prefixes
                self._kv_tier = KVTierClient(
                    model=llm_config.model_id,
                    backend=tier_backend if tier_backend is not None else GcsTierBackend(),
                    block_size=llm_config.kv_block_size,
                    codec=llm_config.kv_ship_codec,
                    device=self._device,
                )
            draft = None
            if llm_config.draft_model is not None:
                draft_cfg = llm_config.build_draft_model_config()
                gen = torch.Generator(device=self._device).manual_seed(DRAFT_SEED)
                draft = (draft_cfg, init_params(draft_cfg, gen, device=self._device))
            if llm_config.adapters is not None:
                # callers' threads resolve slot leases before admission, so
                # a cold attach never runs on the thread that steps the pool
                self._adapter_store = AdapterStore.from_config(
                    model_config, llm_config.adapters, self._device)
            self._engine = ContinuousBatchingEngine(
                model_config, params,
                num_slots=llm_config.max_batch_size,
                kv_cache=self._kv_cache,
                seed=llm_config.seed,
                draft=draft,
                spec_tokens=llm_config.spec_tokens,
                prefill_chunk_tokens=llm_config.prefill_chunk_tokens,
                kv_tier=self._kv_tier,
                adapter_store=self._adapter_store,
                device=self._device,
            )
        else:
            self._engine = LLMEngine(
                model_config, params,
                max_batch_size=llm_config.max_batch_size,
                seed=llm_config.seed,
                device=self._device,
            )

    def _start_tensor_parallel(self, model_config, params, device, role, devices,
                               tp_backend) -> None:
        """Rank 0 of a tensor-parallel replica: validate the mesh (typed
        MeshValidationError), spawn the other ranks and build every rank's
        engine over its slices."""
        from ..parallel.plan import PartitionPlan, validate_mesh_for_model
        from .engine import _resolve_seed
        from .tp_ranks import EngineSpec, start_ranks

        cfg = self._config
        if role is not None:
            raise NotImplementedError(
                "disaggregated roles under tensor parallelism are not ported yet "
                "(ROADMAP A.5)"
            )
        if device is not None:
            raise ValueError("a tensor-parallel server places its ranks by devices=, "
                             "not device=")
        tp, sp = cfg.effective_parallelism()
        plan = PartitionPlan.for_model(model_config, tp, sp, devices=devices,
                                       backend=tp_backend)
        # every parameter splits evenly (a ValueError as the reference's
        # shard_params raises), checked before any rank is spawned
        param_shapes(model_config, plan)
        draft_cfg = cfg.build_draft_model_config() if cfg.kv_cache_blocks else None
        if draft_cfg is not None:
            validate_mesh_for_model(tp, plan.num_devices, draft_cfg.n_heads,
                                    draft_cfg.n_kv_heads, "draft")
        spec = EngineSpec(
            model_config=model_config, paged=bool(cfg.kv_cache_blocks),
            batch=cfg.max_batch_size, seed=_resolve_seed(cfg.seed),
            kv_cache_blocks=cfg.kv_cache_blocks or 0, kv_block_size=cfg.kv_block_size,
            draft_config=draft_cfg, spec_tokens=cfg.spec_tokens,
            prefill_chunk_tokens=cfg.prefill_chunk_tokens,
        )
        self._ranks = start_ranks(plan, spec, params)
        self._engine = self._ranks.engine
        self._device = plan.device(0)
        self._kv_cache = self._engine._kv if spec.paged else None
        self._adapter_store = None
        self._finalizer = weakref.finalize(self, self._ranks.close)

    @property
    def engine(self):
        """The :class:`LLMEngine` or :class:`ContinuousBatchingEngine` (rank
        0's under tensor parallelism)."""
        return self._engine

    @property
    def ranks(self):
        """The tensor-parallel ranks (:class:`~.tp_ranks.TPRanks`), or None
        at tp = 1."""
        return self._ranks

    def close(self) -> None:
        """Stop the other tensor-parallel ranks and leave no process or
        process group behind; nothing to do at tp = 1. Idempotent."""
        if self._ranks is not None:
            self._ranks.close()

    @property
    def adapter_store(self) -> Optional[AdapterStore]:
        """The adapter store (None without ``LLMConfig.adapters``)."""
        return self._adapter_store

    def kvcache_stats(self) -> Optional[Dict[str, Any]]:
        """The KV cache's stats (None on the dense engine)."""
        if self._kv_cache is None:
            return None
        return self._kv_cache.stats()

    def kvtier_stats(self) -> Optional[Dict[str, Any]]:
        """The KV tier client's stats (exports held, the registry's totals)
        and this server's role; None when the server is not on the tier."""
        if self._kv_tier is None:
            return None
        out = self._kv_tier.stats()
        out["role"] = self._role or "fused"
        return out

    def adapters_stats(self) -> Optional[Dict[str, Any]]:
        """The adapter store's stats (None without an adapter store)."""
        if self._adapter_store is None:
            return None
        return self._adapter_store.stats()

    def _resolve_adapter(self, request: Dict[str, Any]) -> Optional[AdapterLease]:
        """Resolve the request's ``adapter_id`` to a slot lease BEFORE engine
        admission, on the caller's thread: a cold attach runs here, never on
        the thread that steps the pool, so in-flight decodes keep stepping.
        When every slot is pinned the request backpressures: ``acquire`` is
        polled until ``acquire_timeout_s``, then BackPressureError (which is
        retryable) is raised."""
        aid = request.get("adapter_id")
        if aid is None:
            return None
        if self._adapter_store is None:
            raise ValueError(
                f"request names adapter {aid!r} but the deployment has no "
                "adapter plane; set LLMConfig(adapters=AdapterConfig(...))"
            )
        deadline = time.monotonic() + self._config.adapters.acquire_timeout_s
        while True:
            lease = self._adapter_store.acquire(aid)
            if lease is not None:
                return lease
            if time.monotonic() >= deadline:
                raise BackPressureError(
                    f"adapter store exhausted: all "
                    f"{self._adapter_store.num_slots} slots pinned by "
                    "in-flight requests"
                )
            time.sleep(0.02)

    def _release(self, lease: Optional[AdapterLease]) -> None:
        if self._adapter_store is not None:
            self._adapter_store.release(lease)

    def _parse_request(self, request: Dict[str, Any],
                       lease: Optional[AdapterLease] = None) -> GenerationRequest:
        token_ids = request.get("token_ids")
        if token_ids is None:
            raise ValueError(
                "request needs 'token_ids' (tokenizers come with a later "
                "slice of the port)"
            )
        return GenerationRequest(
            token_ids=list(token_ids),
            max_new_tokens=int(
                request.get("max_new_tokens", self._config.max_new_tokens)
            ),
            temperature=float(
                request.get("temperature", self._config.temperature)
            ),
            eos_token_id=request.get("eos_token_id"),
            adapter_id=lease.adapter_id if lease is not None else None,
            adapter_slot=lease.slot if lease is not None else -1,
        )

    @staticmethod
    def _result(result) -> Dict[str, Any]:
        return {
            "token_ids": result.token_ids,
            "num_prompt_tokens": result.num_prompt_tokens,
            "finished_reason": result.finished_reason,
        }

    # -- disaggregated roles -------------------------------------------------

    def prefill(self, request: Dict[str, Any]) -> Optional[bytes]:
        """The prefill role: run ONLY the admission prefill and ship the
        committed K/V and the first sampled token. Returns the shipment
        blob for :meth:`decode_shipped`, or None when this server can't
        serve it now (no tier, an adapter request, pool backpressure): the
        ingress then has the decode server compute it, so the request
        still completes."""
        if self._kv_tier is None or request.get("adapter_id") is not None:
            return None
        shipment = self._engine.prefill_only(self._parse_request(request))
        return shipment.to_blob() if shipment is not None else None

    def decode_shipped(self, request: Dict[str, Any],
                       shipment_blob: Optional[bytes]) -> Dict[str, Any]:
        """The decode role: fetch a shipped prefix, adopt it and decode. A
        missing blob or a dead prefill holder degrades to a computed
        admission: a transfer problem costs latency, never a request."""
        lease = self._resolve_adapter(request)
        try:
            gen_req = self._parse_request(request, lease)
            ship = None
            if shipment_blob is not None and self._kv_tier is not None:
                shipment = KVShipment.from_blob(shipment_blob)
                payload = self._kv_tier.fetch_shipment(shipment)
                if payload is not None:
                    ship = (shipment, payload)
            result = self._engine.generate_one(gen_req, shipment=ship)
        finally:
            self._release(lease)
        return self._result(result)

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        if request.get("stream"):
            return list(self.stream(request))[-1]
        lease = self._resolve_adapter(request)
        try:
            result = self._engine.generate([self._parse_request(request, lease)])[0]
        finally:
            self._release(lease)
        return self._result(result)

    def stream(self, request: Dict[str, Any]):
        """Yields one dict per generated token as it is sampled, then a
        final summary dict. The adapter lease is held until the generator
        ends or is closed; closing it early first cancels the engine's
        request, so no step decodes it with the slot after the release."""
        lease = self._resolve_adapter(request)
        try:
            yield from self._stream_leased(request, lease)
        finally:
            self._release(lease)

    def _stream_leased(self, request: Dict[str, Any], lease: Optional[AdapterLease]):
        gen_req = self._parse_request(request, lease)
        index = 0
        for item in self._engine.generate_stream(gen_req):
            if isinstance(item, int):
                yield {"token_id": item, "index": index}
                index += 1
            else:  # final GenerationResult
                yield {
                    "token_ids": item.token_ids,
                    "num_prompt_tokens": item.num_prompt_tokens,
                    "finished_reason": item.finished_reason,
                    "finished": True,
                }


class _DisaggIngress:
    """Disaggregated serving ingress over a prefill server and a decode
    server (objects with :meth:`LLMServer.prefill` and
    :meth:`LLMServer.decode_shipped`): the prefill side runs the prompt and
    ships its K/V, then the decode side adopts the shipment and decodes. A
    prefill side that returns no blob (it could not serve the request now)
    degrades to ``decode_shipped(request, None)``, a computed admission on
    the decode side. Unlike the reference's ingress, which holds serve
    handles and turns any exception of the prefill call into that
    fallback, an exception here propagates: in process there is no
    transport to fail, so it is a fault of the code. Prefix-affinity
    routing over pools of servers waits for the serve control plane."""

    def __init__(self, prefill_server, decode_server):
        self._prefill = prefill_server
        self._decode = decode_server

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self._decode.decode_shipped(request, self._prefill.prefill(request))

    def stream(self, request: Dict[str, Any]):
        """Streaming through the disaggregated path: the handoff happens up
        front, then the decode side's result is yielded (as the
        reference's ingress does)."""
        yield self(request)
