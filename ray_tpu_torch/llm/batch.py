"""Offline batch inference: the port of ray_tpu/llm/batch.py.

:class:`LLMPredictor` is a plain callable over a batch dict (the reference
runs it as a ``Dataset.map_batches`` UDF class; the port has no data plane
yet): ``{"token_ids": list of prompts}`` -> the same dict plus
``"generated"``, through one dense :class:`~ray_tpu_torch.llm.engine.
LLMEngine` on ``device`` (default: the card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._internal.device import DeviceLike, resolve_device
from ..lora import AdapterLease, AdapterStore
from ..models.llama import init_params
from .config import LLMConfig, require_servable
from .engine import GenerationRequest, LLMEngine

class LLMPredictor:
    """Batch callable: ``{"token_ids": [[...], ...]}`` -> adds
    ``"generated"``.

    Weights: ``params`` (the port's state dict, on ``device``, shared, not
    copied), else ``params_blob`` (that dict through
    ``serialization.dumps``, read back with ``loads`` as the reference reads
    its blob, and moved to ``device``), else the weight plane's head
    version of ``weights_name`` (fetched through ``weights.fetch`` onto
    ``device``), else random from ``init_params`` under seed 0, as the
    reference draws them under ``PRNGKey(0)``.

    An optional per-row ``"adapter_id"`` column multiplexes LoRA tenants
    through the one engine: rows of a batch may name different adapters
    (or None for the base model) and still run as one mixed batch through
    the batched-gather path. It needs ``llm_config.adapters``; the store
    (:attr:`adapter_store`) is filled by ``prewarm`` or by the config's
    callable source. A batch leases each distinct adapter once and releases
    every lease when it ends; a batch that names more adapters than there
    are free slots raises.

    Like the reference's, the predictor reads no ``tensor_parallel_size``
    (nor ``mesh``): it builds its one engine on its one device whatever the
    config's parallelism.
    """

    def __init__(self, llm_config: Optional[LLMConfig] = None,
                 params_blob: Optional[bytes] = None,
                 weights_name: Optional[str] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device: DeviceLike = None):
        if sum(x is not None for x in (params, params_blob, weights_name)) > 1:
            raise ValueError("pass one of params=, params_blob= and weights_name= (not both)")
        self._config = llm_config or LLMConfig()
        model_config = require_servable(self._config.build_model_config())
        self._device = resolve_device(device)
        if params_blob is not None:
            from .serving import load_params_blob

            params = load_params_blob(params_blob, self._device)
        elif weights_name is not None:
            from .. import weights

            _, params = weights.fetch(weights_name, device=self._device, timeout=60.0)
        if params is None:
            params = init_params(model_config, device=self._device)
        self._adapter_store: Optional[AdapterStore] = None
        if self._config.adapters is not None:
            self._adapter_store = AdapterStore.from_config(
                model_config, self._config.adapters, self._device)
        self._engine = LLMEngine(
            model_config, params,
            max_batch_size=self._config.max_batch_size,
            seed=self._config.seed,
            device=self._device,
            adapter_store=self._adapter_store,
        )

    @property
    def adapter_store(self) -> Optional[AdapterStore]:
        """The adapter store (None without ``llm_config.adapters``)."""
        return self._adapter_store

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        prompts = batch["token_ids"]
        adapter_ids = batch.get("adapter_id")
        if adapter_ids is not None and self._adapter_store is None:
            raise ValueError(
                "batch has an 'adapter_id' column but LLMConfig.adapters "
                "is not configured"
            )
        leases: Dict[str, AdapterLease] = {}
        try:
            requests = []
            for i, p in enumerate(prompts):
                aid = adapter_ids[i] if adapter_ids is not None else None
                aid = str(aid) if aid is not None else None
                slot = -1
                if aid:
                    lease = leases.get(aid)
                    if lease is None:
                        lease = self._adapter_store.acquire(aid)
                        if lease is None:
                            raise RuntimeError(
                                f"no free adapter slot for {aid!r}: batch "
                                "names more live adapters than "
                                "adapters.max_live"
                            )
                        leases[aid] = lease
                    slot = lease.slot
                requests.append(GenerationRequest(
                    token_ids=list(p),
                    max_new_tokens=self._config.max_new_tokens,
                    temperature=self._config.temperature,
                    adapter_id=aid or None,
                    adapter_slot=slot,
                ))
            results = self._engine.generate(requests)
        finally:
            for lease in leases.values():
                self._adapter_store.release(lease)
        out = dict(batch)
        out["generated"] = [r.token_ids for r in results]
        return out
