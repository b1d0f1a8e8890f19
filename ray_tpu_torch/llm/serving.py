"""LLM serving: the port of ray_tpu/llm/serving.py, dense branch.

:class:`LLMServer` is the counterpart of the reference's replica callable
``_LLMReplica`` for ``kv_cache_blocks=None``: it builds the model and the
dense :class:`~ray_tpu_torch.llm.engine.LLMEngine` and answers token-level
requests. The serve control plane, the weight plane and tokenizers come
with later slices of the port.

Request/response shape:
  {"token_ids": [...], "max_new_tokens": 32, "temperature": 0.0,
   "eos_token_id": None, "stream": False}
-> {"token_ids": [...], "num_prompt_tokens": N, "finished_reason": ...}
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._internal.device import DeviceLike, resolve_device
from ..models.llama import init_params
from .config import LLMConfig
from .engine import GenerationRequest, LLMEngine


class LLMServer:
    """Holds one engine with its weights on ``device`` (default: the card).
    Without ``params`` the weights are random, from the port's
    ``init_params`` under seed 0, as the reference's replica draws them
    under ``PRNGKey(0)``."""

    def __init__(self, llm_config: LLMConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device: DeviceLike = None):
        self._config = llm_config
        self._device = resolve_device(device)
        model_config = llm_config.build_model_config()
        if params is None:
            params = init_params(model_config, device=self._device)
        self._engine = LLMEngine(
            model_config, params,
            max_batch_size=llm_config.max_batch_size,
            seed=llm_config.seed,
            device=self._device,
        )

    @property
    def engine(self) -> LLMEngine:
        return self._engine

    def _parse_request(self, request: Dict[str, Any]) -> GenerationRequest:
        if request.get("adapter_id") is not None:
            raise NotImplementedError(
                "per-request adapters come with the port's LoRA serving slice"
            )
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
        )

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        if request.get("stream"):
            return list(self.stream(request))[-1]
        result = self._engine.generate([self._parse_request(request)])[0]
        return {
            "token_ids": result.token_ids,
            "num_prompt_tokens": result.num_prompt_tokens,
            "finished_reason": result.finished_reason,
        }

    def stream(self, request: Dict[str, Any]):
        """Yields one dict per generated token as it is sampled, then a
        final summary dict."""
        gen_req = self._parse_request(request)
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
