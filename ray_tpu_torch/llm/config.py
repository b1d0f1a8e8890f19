"""LLM deployment configuration: the port of ray_tpu/llm/config.py.

Carries the fields the dense serving path reads. The fields of features
that later slices of the port bring (paged KV cache, tensor/sequence
parallel meshes, speculative decoding, multi-tenant adapters, disaggregated
roles, the cluster KV tier, MoE) are accepted so that a config written for
ray_tpu reads the same, and asking for any of them raises.
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
    # later slices of the port
    tensor_parallel_size: int = 1
    sequence_parallel_size: int = 1
    mesh: Optional[Dict[str, int]] = None
    kv_cache_blocks: Optional[int] = None
    draft_model: Optional[str] = None
    adapters: Any = None
    roles: Optional[Dict[str, int]] = None
    kv_tier: bool = False

    def __post_init__(self):
        later = {
            "kv_cache_blocks": (
                self.kv_cache_blocks is not None,
                "the continuous-batching (paged KV cache) slice",
            ),
            "mesh / tensor_parallel_size / sequence_parallel_size": (
                max(self.effective_parallelism()) > 1,
                "the tensor-parallel slice",
            ),
            "draft_model": (
                self.draft_model is not None,
                "the speculative-decoding slice",
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
