"""LLM deployment configuration: the port of ray_tpu/llm/config.py.

Carries the fields the serving paths read: the dense engine, and the
continuous-batching engine over the paged KV cache (``kv_cache_blocks``)
with speculative decoding (``draft_model``) and chunked prefill
(``prefill_chunk_tokens``). The fields of features that later slices of the
port bring (tensor/sequence parallel meshes, multi-tenant adapters,
disaggregated roles, the cluster KV tier, MoE) are accepted so that a config
written for ray_tpu reads the same, and asking for any of them raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..models.llama import LlamaConfig


@dataclass
class LLMConfig:
    model_id: str = "llama-tiny"
    model_family: str = "llama"
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    max_seq_len: int = 512
    max_batch_size: int = 8
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 = greedy
    # sampling seed: None = fresh per process, an int = reproducible
    seed: Optional[int] = None
    # paged KV cache (ray_tpu_torch.kvcache): when kv_cache_blocks is set,
    # the server runs a ContinuousBatchingEngine over a pool of that many
    # kv_block_size-token blocks with prefix reuse and memory-gated
    # admission; None keeps the dense grouped-batch engine
    kv_cache_blocks: Optional[int] = None
    kv_block_size: int = 32
    # speculative decoding: a small draft model (same config grammar as
    # model_id/model_kwargs) proposes spec_tokens tokens per engine step and
    # the target verifies them in one call. Requires kv_cache_blocks;
    # spec_tokens defaults to 4 when a draft_model is named without a k.
    draft_model: Optional[str] = None
    draft_model_kwargs: Dict[str, Any] = field(default_factory=dict)
    spec_tokens: int = 0
    # chunked prefill: per-engine-step prefill token budget, so a long
    # prompt interleaves with in-flight decodes; 0 = prefill runs to
    # completion at admission. Requires kv_cache_blocks.
    prefill_chunk_tokens: int = 0
    # later slices of the port
    tensor_parallel_size: int = 1
    sequence_parallel_size: int = 1
    mesh: Optional[Dict[str, int]] = None
    adapters: Any = None
    roles: Optional[Dict[str, int]] = None
    kv_tier: bool = False

    def __post_init__(self):
        later = {
            "mesh / tensor_parallel_size / sequence_parallel_size": (
                max(self.effective_parallelism()) > 1,
                "the tensor-parallel slice",
            ),
            "adapters": (self.adapters is not None, "the LoRA serving slice"),
            "roles": (
                self.roles is not None,
                "the disaggregated prefill/decode slice",
            ),
            "kv_tier": (self.kv_tier, "the cluster KV tier slice"),
            "model_family='moe'": (
                self.model_family == "moe",
                "the MoE slice",
            ),
        }
        for name, (asked, slice_name) in later.items():
            if asked:
                raise NotImplementedError(
                    f"LLMConfig {name} is not ported yet: it comes with "
                    f"{slice_name} of the PyTorch port"
                )
        if self.model_family != "llama":
            raise ValueError(f"unknown model family {self.model_family!r}")
        if self.draft_model is not None and self.spec_tokens <= 0:
            self.spec_tokens = 4
        if self.spec_tokens > 0 and self.draft_model is None:
            raise ValueError("spec_tokens needs a draft_model to propose tokens")
        if self.prefill_chunk_tokens < 0:
            raise ValueError("prefill_chunk_tokens must be >= 0")
        if (
            self.draft_model is not None or self.prefill_chunk_tokens
        ) and not self.kv_cache_blocks:
            raise ValueError(
                "speculative decoding / chunked prefill run on the "
                "continuous-batching engine: set kv_cache_blocks"
            )

    def effective_parallelism(self) -> tuple:
        """(tp, sp) with ``mesh`` winning over the scalar fields."""
        if self.mesh is not None:
            return (self.mesh.get("tp", 1), self.mesh.get("sp", 1))
        return (self.tensor_parallel_size, self.sequence_parallel_size)

    def build_model_config(self) -> LlamaConfig:
        kwargs = dict(self.model_kwargs)
        kwargs.setdefault("max_seq_len", self.max_seq_len)
        if self.model_id.endswith("tiny"):
            return LlamaConfig.tiny(**kwargs)
        return LlamaConfig(**kwargs)

    def build_draft_model_config(self) -> Optional[LlamaConfig]:
        """Model config for the speculative draft, same name grammar as
        build_model_config (the draft shares the target's vocab, and its
        max_seq_len must cover the target's so both caches hold the same
        positions)."""
        if self.draft_model is None:
            return None
        kwargs = dict(self.draft_model_kwargs)
        kwargs.setdefault("max_seq_len", self.max_seq_len)
        if self.draft_model.endswith("tiny"):
            return LlamaConfig.tiny(**kwargs)
        return LlamaConfig(**kwargs)
