"""LLM serving: the port of ray_tpu/llm/serving.py.

:class:`LLMServer` is the counterpart of the reference's replica callable
``_LLMReplica``: it builds the model and an engine and answers token-level
requests. With ``kv_cache_blocks=None`` the engine is
the dense :class:`~ray_tpu_torch.llm.engine.LLMEngine`; with it set, a
:class:`~ray_tpu_torch.llm.engine.ContinuousBatchingEngine` over a
:class:`~ray_tpu_torch.kvcache.KVCacheManager` (prefix reuse, memory-gated
admission), with the config's chunked prefill, speculative draft and
multi-tenant adapters (an :class:`~ray_tpu_torch.lora.AdapterStore`).

:func:`build_llm_deployment` wraps it in a serve application
(``ray_tpu_torch.serve``): ``num_replicas`` replicas of :class:`_LLMReplica`,
or the queue autoscaler's ``autoscaling_config``, or the SLO autoscaler's
``autoscale_policy``, each replica reserving ``resources_per_replica`` and
serving on the card its lease names (a ``GPU`` share below 1 packs several
replicas on one card). A request names its adapter by an explicit
``adapter_id`` field or by serve's multiplexed model id
(``handle.options(multiplexed_model_id=...)``), and the server has the
serve replica's hooks (``warmup``, ``mesh_info``, ``reconfigure``).

With ``LLMConfig.kv_tier`` or a ``role``, the server holds a
:class:`~ray_tpu_torch.kvtier.KVTierClient` over ``tier_backend``. A fused
server on the tier (no role) exports the prefixes it computes and pulls
warm ones from its peers. ``role="prefill"`` serves :meth:`LLMServer.prefill`
(run the admission prefill, ship the K/V) and ``role="decode"``
:meth:`LLMServer.decode_shipped` (adopt the shipment, decode with zero
prefill tokens); :class:`_DisaggIngress` routes a request through one of
each: over serve handles in a deployment's role graph
(``<name>-prefill`` and ``<name>-decode`` pools, the prefills routed with
prefix affinity), or over two servers in process. The cluster's tier
backend (``kvtier.GcsTierBackend``) is ROADMAP A item 15, so a role graph
needs an injected ``tier_backend``: in local mode servers share a
``kvtier.LocalTierBackend``.

With ``LLMConfig.tensor_parallel_size`` (or ``mesh={"tp": n}``) above 1 the
server is rank 0 of a tensor-parallel replica (llm/tp_ranks.py): its weights,
decode caches and KV block pools are split over n ranks, one process each,
on ``devices`` (default: this host's cards; ``"cpu"`` entries for CPU ranks),
with the collectives of ``tp_backend``: ``"nccl"`` (a card per rank) or
``"gloo"`` (ranks on the CPU, or several on one card). ``server.engine`` is
rank 0's engine; the others run in lockstep with it. :meth:`LLMServer.close`
stops them (a finalizer does too). Such a server serves what a tp=1 one
does: rank 0 holds the adapter store (each rank's bank holds its slices of
every slot), the tier client and the role; a shipment carries every KV
head, so a tp=2 side and a tp=1 side of a disaggregated pair interoperate.
A process holds one tensor-parallel server at a time, so an in-process
disaggregated pair puts a tp > 1 side beside a tp=1 side. The weight plane
(``weights_name``, hot reloads) is ROADMAP A item 16, and tokenizers need a
download: both raise.

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
from ..serve.multiplex import get_multiplexed_model_id
from .config import LLMConfig, require_servable
from .engine import ContinuousBatchingEngine, GenerationRequest, LLMEngine

_WEIGHT_PLANE = (
    "{} needs the weight plane, which is ROADMAP A item 16 of the PyTorch "
    "port (the weight plane slice); pass params= or params_blob= instead"
)

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
                                        tp_backend, tier_backend)
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
                               tp_backend, tier_backend) -> None:
        """Rank 0 of a tensor-parallel replica: validate the mesh (typed
        MeshValidationError), build rank 0's tier client and adapter store
        under the plan, spawn the other ranks and build every rank's engine
        over its slices."""
        from ..parallel.plan import PartitionPlan, validate_mesh_for_model
        from .engine import _resolve_seed
        from .tp_ranks import EngineSpec, start_ranks

        cfg = self._config
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
        self._device = plan.device(0)
        if cfg.kv_cache_blocks and (cfg.kv_tier or role is not None):
            self._kv_tier = KVTierClient(
                model=cfg.model_id,
                backend=tier_backend if tier_backend is not None else GcsTierBackend(),
                block_size=cfg.kv_block_size, codec=cfg.kv_ship_codec, device=self._device,
            )
        self._adapter_store = None
        if cfg.adapters is not None:
            self._adapter_store = AdapterStore.from_config(
                model_config, cfg.adapters, self._device, plan=plan)
        store = self._adapter_store
        spec = EngineSpec(
            model_config=model_config, paged=bool(cfg.kv_cache_blocks),
            batch=cfg.max_batch_size, seed=_resolve_seed(cfg.seed),
            kv_cache_blocks=cfg.kv_cache_blocks or 0, kv_block_size=cfg.kv_block_size,
            draft_config=draft_cfg, spec_tokens=cfg.spec_tokens,
            prefill_chunk_tokens=cfg.prefill_chunk_tokens, tier=self._kv_tier is not None,
            adapter_slots=store.num_slots if store else 0, adapter_rank=store.rank if store else 0,
            adapter_alpha=store.alpha if store else 0.0,
            adapter_dtype=store.dtype if store else None,
        )
        self._ranks = start_ranks(plan, spec, params, kv_tier=self._kv_tier,
                                  adapter_store=store)
        self._engine = self._ranks.engine
        self._kv_cache = self._engine._kv if spec.paged else None
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

    # -- the serve replica's hooks -------------------------------------------

    def warmup(self) -> Dict[str, Any]:
        """The serve replica's warmup hook (run before the replica reports
        healthy). The reference's asserts that the weight plane resolved;
        the port's servers never take weights from it (ROADMAP A item 16)."""
        return {"weights_name": None, "weights_version": None,
                "weights_resolve_s": 0.0}

    def reload_weights(self, version: Optional[int] = None) -> Dict[str, Any]:
        raise NotImplementedError(_WEIGHT_PLANE.format("reload_weights"))

    def reconfigure(self, user_config) -> None:
        """The serve reconfigure hook. The reference's hot-reloads a
        ``{"weights_version": v}`` from the weight plane and ignores the
        rest; a server without the weight plane (every server of the port,
        ROADMAP A item 16) ignores it all, as the reference's without a
        ``weights_name`` does."""

    def mesh_info(self) -> Dict[str, Any]:
        """The replica's mesh card, polled into the serve controller's
        replica inventory: mesh shape, device count, the card's allocated
        bytes per device (``torch.cuda.memory_allocated``, where the
        reference reads HBM in use; None on the CPU) and the per-device KV
        block-pool footprint."""
        if self._ranks is None:
            devices = [self._device]
            info: Dict[str, Any] = {"mesh": {}, "tag": "tp=1", "num_devices": 1}
        else:
            plan = self._ranks.plan
            devices = [plan.device(r) for r in range(plan.num_devices)]
            info = {"mesh": plan.mesh_shape(), "tag": plan.describe(),
                    "num_devices": plan.num_devices}
        info["devices"] = [str(d) for d in devices]
        info["per_device_hbm_bytes"] = [
            int(torch.cuda.memory_allocated(d)) if d.type == "cuda" else None
            for d in devices
        ]
        from .. import _worker_api, get_gpu_ids

        if _worker_api.is_initialized():
            info["gpu_ids"] = get_gpu_ids()  # the lease's cards, in a replica
        if self._kv_cache is not None:
            info["kv_pool_bytes_per_device"] = self._kv_cache.pool_accounting()[
                "kv_pool_bytes_per_device"]
        return info

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """The launches of each of the port's hand-written kernels in this
        process (their wrappers count each launch; a replica's process
        holds one server) and this server's model calls (rank 0's under
        tensor parallelism). ``reset`` sets them all to 0 first."""
        from ..ops.flash_attention import flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq
        from ..ops.rmsnorm import rmsnorm_fwd

        wrappers = {"rmsnorm_fwd": rmsnorm_fwd, "flash_attention_fwd": flash_attention_fwd,
                    "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}
        if reset:
            for fn in wrappers.values():
                fn.launches = 0
            self._engine.forward_calls = 0
        out = {name: fn.launches for name, fn in wrappers.items()}
        out["forward_calls"] = self._engine.forward_calls
        return out

    def _requested_adapter_id(self, request: Dict[str, Any]) -> Optional[str]:
        """The tenant of a request: an explicit ``adapter_id`` field wins,
        else serve's multiplexed model id, which the serve replica binds to
        the request's thread before user code runs."""
        aid = request.get("adapter_id")
        if aid is None:
            aid = get_multiplexed_model_id() or None
        return aid

    def _resolve_adapter(self, request: Dict[str, Any]) -> Optional[AdapterLease]:
        """Resolve the request's adapter id to a slot lease BEFORE engine
        admission, on the caller's thread: a cold attach runs here, never on
        the thread that steps the pool, so in-flight decodes keep stepping.
        When every slot is pinned the request backpressures: ``acquire`` is
        polled until ``acquire_timeout_s``, then BackPressureError (which is
        retryable) is raised."""
        aid = self._requested_adapter_id(request)
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
        if self._kv_tier is None or self._requested_adapter_id(request) is not None:
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


def load_params_blob(params_blob: bytes, device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The port's parameter dict from its ``serialization.dumps`` bytes (the
    tensors cross as raw bytes, ROADMAP kept item 36), moved to ``device``.
    The reference only ``loads`` its blob too: no weight plane is involved."""
    from .._internal import serialization

    params = serialization.loads(params_blob)
    if not isinstance(params, dict) or not all(
            isinstance(v, torch.Tensor) for v in params.values()):
        raise ValueError("params_blob must hold the port's parameter dict "
                         "(name -> tensor), through serialization.dumps")
    dev = torch.device(device) if device is not None else None
    return {k: v.to(dev) for k, v in params.items()} if dev is not None else params


class _LLMReplica(LLMServer):
    """The replica callable of :func:`build_llm_deployment`, with the
    reference replica's arguments (``llm_config, params_blob,
    tokenizer_name, weights_name, role, tier_backend``) and ``device``.

    ``device=None`` serves on the card of this replica's lease (the card
    the worker is bound to, ROADMAP kept item 34): a lease that names no
    card raises, and nothing falls back to card 0 or to the CPU.
    ``device="cpu"`` serves on the CPU. At ``tensor_parallel_size = n``
    the ranks go on the lease's first n cards over NCCL, or, with
    ``device="cpu"``, on n CPU ranks over gloo. ``tokenizer_name`` and
    ``weights_name`` raise: tokenizers need a download and the weight plane
    is ROADMAP A item 16."""

    def __init__(self, llm_config: LLMConfig, params_blob: Optional[bytes] = None,
                 tokenizer_name: Optional[str] = None,
                 weights_name: Optional[str] = None,
                 role: Optional[str] = None, tier_backend=None,
                 device: DeviceLike = None):
        if tokenizer_name is not None:
            raise NotImplementedError(
                "tokenizer_name needs AutoTokenizer.from_pretrained, which is a "
                "download; send token_ids"
            )
        if weights_name is not None:
            raise NotImplementedError(_WEIGHT_PLANE.format("weights_name"))
        tp, _ = llm_config.effective_parallelism()
        dev, devices, backend = _replica_placement(device, tp)
        params = None
        if params_blob is not None:
            params = load_params_blob(params_blob, dev if dev is not None else devices[0])
        super().__init__(llm_config, params=params, device=dev, role=role,
                         tier_backend=tier_backend, devices=devices, tp_backend=backend)

    def shutdown(self) -> None:
        """The serve replica's shutdown hook: stop the tensor-parallel
        ranks before the replica's process is killed."""
        self.close()


def _replica_placement(device: DeviceLike, tp: int):
    """(device, devices, tp_backend) for a replica at tensor-parallel size
    ``tp``: from ``device`` when given, else from the lease's cards."""
    if device is not None:
        dev = torch.device(device)
        if tp == 1:
            return dev, None, "nccl"
        if dev.type != "cpu":
            raise ValueError("a tensor-parallel replica places its ranks on its "
                             "lease's cards: pass device=None (or 'cpu')")
        return None, ["cpu"] * tp, "gloo"
    from .. import get_gpu_ids
    from .._internal.accelerators import cuda_index

    ids = get_gpu_ids()
    if len(ids) < 1 or (tp > 1 and len(ids) < tp):
        raise RuntimeError(
            f"this replica's lease names {len(ids)} card(s) for tensor-parallel "
            f"size {tp}: set LLMConfig.resources_per_replica's 'GPU' (a share "
            "below 1 packs replicas on one card; tp > 1 takes tp whole cards), or "
            "pass device='cpu'"
        )
    cards = [torch.device("cuda", cuda_index(i)) for i in ids]
    if tp == 1:
        return cards[0], None, "nccl"
    return None, [str(c) for c in cards[:tp]], "nccl"


class _DisaggIngress:
    """Disaggregated serving ingress: the prefill side runs the prompt and
    ships its K/V, then the decode side adopts the shipment and decodes. A
    prefill side that returns no blob (it could not serve the request now)
    degrades to ``decode_shipped(request, None)``, a computed admission on
    the decode side.

    In a deployment (:func:`build_llm_deployment`'s role graph) the two
    sides are serve handles of the ``<name>-prefill`` and ``<name>-decode``
    pools, and the prefills are routed with ``prefix_affinity_tokens``, so
    shared prefixes keep landing on the prefill replica whose radix holds
    them, as the reference's ingress routes them. In process the sides may
    also be two servers (objects with :meth:`LLMServer.prefill` and
    :meth:`LLMServer.decode_shipped`). Unlike the reference's ingress,
    which turns any exception of the prefill call into the fallback, an
    exception propagates (ROADMAP kept item 13): the handles' own failover
    absorbs a dead replica, and what still escapes is a fault."""

    def __init__(self, prefill, decode, prefix_affinity_tokens: int = 0):
        if hasattr(prefill, "options"):  # serve handles
            pre = prefill.options(method_name="prefill")
            if prefix_affinity_tokens:
                pre = pre.options(prefix_affinity_tokens=prefix_affinity_tokens)
            dec = decode.options(method_name="decode_shipped")
            self._prefill = lambda request: pre.remote(request).result()
            self._decode = lambda request, blob: dec.remote(request, blob).result()
        else:
            self._prefill = prefill.prefill
            self._decode = decode.decode_shipped

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self._decode(request, self._prefill(request))

    def stream(self, request: Dict[str, Any]):
        """Streaming through the disaggregated path: the handoff happens up
        front, then the decode side's result is yielded (as the
        reference's ingress does)."""
        yield self(request)


def _actor_options(resources: Dict[str, float]) -> Dict[str, Any]:
    """``resources_per_replica`` as actor options: ``CPU`` -> ``num_cpus``,
    ``GPU`` -> ``num_gpus``, every other key a custom resource. The
    reference passes the dict itself as ``ray_actor_options``, whose keys
    its ``build_resources`` never reads, so its replicas lease one CPU and
    nothing else (ROADMAP kept item 38)."""
    res = dict(resources)
    opts: Dict[str, Any] = {}
    if "CPU" in res:
        opts["num_cpus"] = float(res.pop("CPU"))
    if "GPU" in res:
        opts["num_gpus"] = float(res.pop("GPU"))
    if res:
        opts["resources"] = res
    return opts


def build_llm_deployment(llm_config: LLMConfig, *,
                         params_blob: Optional[bytes] = None,
                         name: Optional[str] = None,
                         tier_backend=None,
                         device: DeviceLike = None):
    """A bound serve application for this LLM (the reference's
    ``build_llm_deployment``).

    Fused: one deployment of :class:`_LLMReplica` named ``name`` (default
    the model id), with ``autoscale_policy`` (the SLO autoscaler), else
    ``autoscaling_config`` (the queue autoscaler), else ``num_replicas``.
    With ``llm_config.roles`` it is three deployments: ``<name>-prefill``
    and ``<name>-decode`` pools and a :class:`_DisaggIngress` root that
    routes the handoff. Every replica reserves ``resources_per_replica``
    and builds its weights from ``params_blob`` (the port's parameter dict
    through ``serialization.dumps``) or from seed 0. ``device`` is each
    replica's (None: the card of its lease). A role graph, or
    ``kv_tier``, needs ``tier_backend``: the cluster's, ``GcsTierBackend``,
    is ROADMAP A item 15."""
    from .. import serve

    if (llm_config.roles is not None or llm_config.kv_tier) and tier_backend is None:
        raise NotImplementedError(
            "roles / kv_tier over a cluster need kvtier.GcsTierBackend, which is "
            "ROADMAP A item 15 of the PyTorch port; pass tier_backend= (a shared "
            "kvtier.LocalTierBackend in local mode)"
        )
    base_name = name or llm_config.model_id
    actor_options = _actor_options(llm_config.resources_per_replica)

    def replica(role, **options):
        return serve.deployment(_LLMReplica, ray_actor_options=dict(actor_options),
                                **options).bind(
            llm_config, params_blob, None, None, role, tier_backend, device)

    if llm_config.roles is not None:
        prefill = replica("prefill", name=f"{base_name}-prefill",
                          num_replicas=llm_config.roles["prefill"])
        decode = replica("decode", name=f"{base_name}-decode",
                         num_replicas=llm_config.roles["decode"])
        ingress = serve.deployment(_DisaggIngress, name=base_name, num_replicas=1)
        return ingress.bind(prefill, decode, llm_config.prefix_affinity_tokens)
    options: Dict[str, Any] = {"name": base_name}
    if llm_config.autoscale_policy:
        options["autoscale_policy"] = dict(llm_config.autoscale_policy) if isinstance(
            llm_config.autoscale_policy, dict) else llm_config.autoscale_policy
    elif llm_config.autoscaling_config:
        options["autoscaling_config"] = dict(llm_config.autoscaling_config)
    else:
        options["num_replicas"] = llm_config.num_replicas
    return replica(None, **options)


def publish_llm_weights(llm_config: LLMConfig, params, *,
                        weights_name: Optional[str] = None,
                        meta: Optional[dict] = None):
    """The reference publishes one weight-plane version for a deployment's
    replicas; the weight plane is ROADMAP A item 16."""
    raise NotImplementedError(_WEIGHT_PLANE.format("publish_llm_weights"))
