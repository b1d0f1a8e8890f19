"""The dense LLM engine: the port of ray_tpu/llm/engine.py (``LLMEngine``).

- **prefill** runs the model in decode mode over the whole prompt batch,
  writing every layer's K/V into a fresh dense cache (models/llama.py
  ``LayerCache``), as the reference does; it does not take the flash path;
- **decode** feeds one token per row per step through the same cache, which
  each call updates in place;
- requests are grouped by prompt length (no padding), each group is one
  prefill and one decode loop of at most ``max_batch_size`` rows, and rows
  that hit EOS keep decoding with their outputs dropped.

Greedy where the temperature is 0, otherwise a categorical draw from a
``torch.Generator`` reseeded per step from the engine seed, the counterpart
of the reference's ``fold_in(key, step)``: the same request gives the same
tokens from one engine seed. PyTorch draws other bits than JAX, so sampled
tokens agree with the reference only at temperature 0.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .._internal.device import DeviceLike, resolve_device
from ..models.llama import build_llama, new_cache


def _resolve_seed(seed: Optional[int]) -> int:
    """Per-process default: replicas sampling at temperature > 0 must not
    emit identical streams."""
    if seed is not None:
        return int(seed)
    return int.from_bytes(os.urandom(4), "little")


def host_sync(x: torch.Tensor) -> np.ndarray:
    """The one device-to-host point of the serving path: sampled token ids
    and nothing else come back to the host, here."""
    return x.cpu().numpy()


def _sample_impl(
    logits: torch.Tensor, temps: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """Greedy where temps == 0, temperature-categorical elsewhere."""
    greedy = logits.argmax(dim=-1)
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    sampled = torch.multinomial(
        torch.softmax(scaled, dim=-1), 1, generator=generator
    )[:, 0]
    return torch.where(temps == 0.0, greedy, sampled)


@dataclasses.dataclass
class GenerationRequest:
    token_ids: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_token_id: Optional[int] = None


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[int]  # generated tokens only
    num_prompt_tokens: int
    finished_reason: str  # "eos" | "length"


class _DecodeModelBase:
    """Prefill and decode over the cached Llama, sharing ``params`` (the
    port's state dict, on ``device``) without copying them."""

    def __init__(self, model_config, params: Dict[str, torch.Tensor],
                 device: DeviceLike = None):
        self._cfg = model_config
        self._device = resolve_device(device)
        wrong = {str(t.device) for t in params.values() if t.device != self._device}
        if wrong:
            raise ValueError(f"params on {sorted(wrong)}, engine on {self._device}")
        self._params = params
        self._model = build_llama(model_config, params)

    @torch.inference_mode()
    def _prefill(self, tokens: torch.Tensor):
        """tokens (b, plen) -> (last-position logits (b, vocab), new cache)."""
        cache = new_cache(self._cfg, tokens.shape[0], self._device)
        logits = self._model(tokens, cache)
        return logits[:, -1, :], cache

    @torch.inference_mode()
    def _decode(self, cache, last_tokens: torch.Tensor):
        """last_tokens (b, 1) -> (logits (b, vocab), cache updated in place)."""
        logits = self._model(last_tokens, cache)
        return logits[:, -1, :], cache

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self._device)

    def _sample_tokens(self, logits, temps: np.ndarray, generator) -> np.ndarray:
        """Greedy where temps == 0, temperature-categorical elsewhere; an
        all-greedy batch skips the categorical draw."""
        if temps.any():
            t = torch.as_tensor(temps, device=logits.device)
            return host_sync(_sample_impl(logits, t, generator))
        return host_sync(logits.argmax(dim=-1))


class LLMEngine(_DecodeModelBase):
    def __init__(
        self,
        model_config,
        params: Dict[str, torch.Tensor],
        max_batch_size: int = 8,
        seed: Optional[int] = None,
        device: DeviceLike = None,
    ):
        super().__init__(model_config, params, device)
        self._max_batch = max_batch_size
        self._seed = _resolve_seed(seed)
        self._generator = torch.Generator(device=self._device)

    # -- generation ----------------------------------------------------------

    def generate(self, requests: List[GenerationRequest]) -> List[GenerationResult]:
        """Generate for a list of requests, grouping same-length prompts
        into batched prefill/decode loops."""
        groups: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(len(r.token_ids), []).append(i)
        results: List[Optional[GenerationResult]] = [None] * len(requests)
        for _plen, indices in sorted(groups.items()):
            for start in range(0, len(indices), self._max_batch):
                chunk = indices[start:start + self._max_batch]
                out = self._generate_group([requests[i] for i in chunk])
                for i, res in zip(chunk, out):
                    results[i] = res
        return results  # type: ignore[return-value]

    def _generate_group(
        self, requests: List[GenerationRequest]
    ) -> List[GenerationResult]:
        cfg = self._cfg
        b = len(requests)
        plen = len(requests[0].token_ids)
        max_new = max(r.max_new_tokens for r in requests)
        if plen + max_new > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) exceeds "
                f"max_seq_len ({cfg.max_seq_len})"
            )
        logits, cache = self._prefill(self._tokens([r.token_ids for r in requests]))
        generated: List[List[int]] = [[] for _ in range(b)]
        finished = [False] * b
        reasons = ["length"] * b

        def record(last):
            for i, r in enumerate(requests):
                if finished[i] or len(generated[i]) >= r.max_new_tokens:
                    continue
                tok = int(last[i])
                generated[i].append(tok)
                if r.eos_token_id is not None and tok == r.eos_token_id:
                    finished[i] = True
                    reasons[i] = "eos"

        last = self._sample(logits, requests, 0)
        record(last)
        for step in range(1, max_new):
            if all(
                finished[i] or len(generated[i]) >= requests[i].max_new_tokens
                for i in range(b)
            ):
                break
            logits, cache = self._decode(cache, self._tokens(last).reshape(b, 1))
            last = self._sample(logits, requests, step)
            record(last)

        return [
            GenerationResult(
                token_ids=generated[i][: r.max_new_tokens],
                num_prompt_tokens=plen,
                finished_reason=reasons[i],
            )
            for i, r in enumerate(requests)
        ]

    def _sample(self, logits, requests, step) -> np.ndarray:
        temps = np.array(
            [max(r.temperature, 0.0) for r in requests], np.float32
        )
        # the counterpart of fold_in(key, step): one stream per step index
        self._generator.manual_seed((self._seed * 1_000_003 + step) % (1 << 63))
        return self._sample_tokens(logits, temps, self._generator)

    def generate_stream(self, request: GenerationRequest):
        """Token-by-token generation for ONE request: yields each generated
        token id as soon as it is sampled, then a final GenerationResult.
        Same programs and sampling rule as generate(), so at temperature 0
        the streamed tokens equal the batch path's."""
        cfg = self._cfg
        plen = len(request.token_ids)
        if plen + request.max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_seq_len "
                f"({cfg.max_seq_len})"
            )
        if request.max_new_tokens <= 0:  # matches generate()'s empty result
            yield GenerationResult(
                token_ids=[], num_prompt_tokens=plen, finished_reason="length"
            )
            return
        logits, cache = self._prefill(self._tokens([request.token_ids]))
        generated: List[int] = []
        reason = "length"
        last = self._sample_step(logits, request, 0)
        generated.append(last)
        yield last
        if request.eos_token_id is not None and last == request.eos_token_id:
            reason = "eos"
        else:
            for step in range(1, request.max_new_tokens):
                logits, cache = self._decode(cache, self._tokens([[last]]))
                last = self._sample_step(logits, request, step)
                generated.append(last)
                yield last
                if (
                    request.eos_token_id is not None
                    and last == request.eos_token_id
                ):
                    reason = "eos"
                    break
        yield GenerationResult(
            token_ids=generated,
            num_prompt_tokens=plen,
            finished_reason=reason,
        )

    def _sample_step(self, logits, request, step) -> int:
        return int(self._sample(logits, [request], step)[0])
