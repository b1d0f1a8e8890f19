"""LLM deployment configuration: the port of ray_tpu/llm/config.py.

Carries the fields the serving paths read: the dense engine, the
continuous-batching engine over the paged KV cache (``kv_cache_blocks``)
with speculative decoding (``draft_model``) and chunked prefill
(``prefill_chunk_tokens``), multi-tenant LoRA adapters (``adapters``), and
the cluster KV tier (``kv_tier``, ``kv_ship_codec``) with disaggregated
prefill/decode roles (``roles``; ``LLMServer(role=)`` plays one). Every
field of the reference's config is a field here, with its default and its
checks, so that a config written for ray_tpu reads the same. A tensor-
parallel mesh (``tensor_parallel_size`` or ``mesh={"tp": n}``) is served by
``LLMServer`` (llm/tp_ranks.py), with adapters, the KV tier and roles as at
tp = 1. ``num_replicas``, ``autoscaling_config``, ``autoscale_policy``,
``prefix_affinity_tokens`` and ``resources_per_replica`` shape the serve
deployment that ``llm.build_llm_deployment`` builds. A sequence-parallel
mesh is refused on purpose (ROADMAP kept item 32), and the weight plane's
quantized publishes wait for their slice (ROADMAP A item 16): asking for
either raises.

``resources_per_replica`` defaults to ``{"CPU": 1.0, "GPU": 1.0}``: a
replica that serves on the card asks for the card, and its ``GPU`` share
(a fraction packs several replicas on one card) reaches the lease, which
binds the replica to its card. The reference's default is ``{"TPU": 0.0,
"CPU": 1.0}``, and its controller drops the dict's keys on the way to the
lease (ROADMAP kept item 38).

``model_family="moe"`` builds a :class:`~ray_tpu_torch.models.moe.MoEConfig`
by the reference's grammar. Nothing serves it: the reference has no MoE
decode path (its replica fails on the config), so the port's servers refuse
it with a ValueError (:func:`require_servable`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from ..exceptions import MeshValidationError
from ..models.llama import LlamaConfig
from ..models.moe import MoEConfig


@dataclass
class AdapterConfig:
    """Multi-tenant LoRA serving (ray_tpu_torch.lora): each server keeps an
    :class:`~ray_tpu_torch.lora.AdapterStore` of ``max_live`` slots on the
    card at rank ``slot_rank``; requests name an adapter by an explicit
    ``adapter_id`` field. A cold adapter refills from ``source``: a
    callable ``source(adapter_id) -> adapter tree``, or None to serve only
    prewarmed adapters. ``"weights:<prefix>"`` passes this check, as in the
    reference, but refilling from it raises until the weight plane is
    ported."""

    max_live: int = 8  # resident adapter slots per server
    slot_rank: int = 8  # the bank-wide LoRA rank (fixed: slots are paged)
    alpha: float = 16.0  # lora_b is pre-scaled by alpha/rank at attach
    source: Optional[Any] = None  # "weights:<prefix>" | callable | None
    # acquire() retry budget when every slot is pinned before the server
    # raises BackPressureError
    acquire_timeout_s: float = 5.0

    def __post_init__(self):
        if self.max_live < 1:
            raise ValueError("AdapterConfig.max_live must be >= 1")
        if self.slot_rank < 1:
            raise ValueError("AdapterConfig.slot_rank must be >= 1")
        if self.source is not None and not (
            callable(self.source) or str(self.source).startswith("weights:")
        ):
            raise ValueError(
                'AdapterConfig.source must be "weights:<prefix>" or a '
                f"callable, got {self.source!r}"
            )


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
    # multi-tenant LoRA (ray_tpu_torch.lora): an AdapterConfig, or its
    # dict form, gives the server an adapter slot bank and serves batches
    # whose rows name different adapters. Requires kv_cache_blocks.
    adapters: Optional[AdapterConfig] = None
    # prefix-affinity routing over the leading tokens (0 disables): the
    # role graph's ingress routes prefills with it; callers of a fused
    # deployment pass it as handle.options(prefix_affinity_tokens=...)
    prefix_affinity_tokens: int = 16
    # disaggregated prefill/decode: {"prefill": n, "decode": m} replica
    # counts (build_llm_deployment builds the pools; an LLMServer(role=)
    # plays one role). Requires kv_cache_blocks.
    roles: Optional[Dict[str, int]] = None
    # the cluster KV tier: share computed prefixes across servers, and the
    # codec of KV shipments ("raw" | "int8"). Requires kv_cache_blocks.
    kv_tier: bool = False
    kv_ship_codec: str = "raw"
    # parallelism (reference: engine_kwargs tensor_parallel_size / pp): the
    # replica's mesh; ``mesh`` wins over the scalar fields
    tensor_parallel_size: int = 1
    sequence_parallel_size: int = 1
    mesh: Optional[Dict[str, int]] = None
    # the serve deployment: a static replica count, the queue autoscaler's
    # AutoscalingConfig dict, or the SLO autoscaler's AutoscalePolicy dict
    # (which wins); each replica's resources ("CPU" -> num_cpus, "GPU" ->
    # num_gpus, any other key a custom resource)
    num_replicas: int = 1
    autoscaling_config: Optional[Dict[str, Any]] = None
    autoscale_policy: Optional[Dict[str, Any]] = None
    resources_per_replica: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 1.0, "GPU": 1.0}
    )
    # the weight plane's int8 publishes (a later slice)
    quantized: bool = False

    def __post_init__(self):
        # the reference's checks of values come before any not-ported raise
        if self.mesh is not None:
            unknown = set(self.mesh) - {"tp", "sp"}
            if unknown:
                raise MeshValidationError(
                    f"LLMConfig.mesh axes {sorted(unknown)} not supported "
                    "for serving replicas; use 'tp' (tensor parallel) "
                    "and/or 'sp' (sequence parallel)"
                )
            for axis, size in self.mesh.items():
                if not isinstance(size, int) or size < 1:
                    raise MeshValidationError(
                        f"LLMConfig.mesh[{axis!r}] must be a positive "
                        f"int, got {size!r}"
                    )
        if self.kv_ship_codec not in ("raw", "int8"):
            raise ValueError(
                f"LLMConfig.kv_ship_codec must be 'raw' or 'int8', got "
                f"{self.kv_ship_codec!r}"
            )
        if self.roles is not None:
            unknown = set(self.roles) - {"prefill", "decode"}
            if unknown:
                raise ValueError(
                    f"LLMConfig.roles keys {sorted(unknown)} not "
                    "supported; use 'prefill' and 'decode'"
                )
            for role_name in ("prefill", "decode"):
                count = self.roles.get(role_name)
                if not isinstance(count, int) or count < 1:
                    raise ValueError(
                        f"LLMConfig.roles[{role_name!r}] must be a "
                        f"positive int, got {count!r}"
                    )
        if (self.roles is not None or self.kv_tier) and not self.kv_cache_blocks:
            raise ValueError(
                "disaggregated roles / kv_tier need the paged engine: "
                "set kv_cache_blocks"
            )
        _, sp = self.effective_parallelism()
        if sp > 1:
            raise NotImplementedError(
                f"LLMConfig mesh / sequence_parallel_size = {sp} is refused on purpose (ROADMAP "
                "kept item 32), not left for a later slice: the reference never runs ring "
                "attention when it serves (its engine builds the decode-mode model, "
                "ray_tpu/llm/engine.py:150), so an sp replica there only repeats tp's work "
                "on sp times the devices; use tensor_parallel_size"
            )
        if self.quantized:
            raise NotImplementedError(
                "LLMConfig quantized is not ported yet: it comes with the weight "
                "plane slice of the PyTorch port (ROADMAP A item 16)"
            )
        if self.model_family not in ("llama", "moe"):
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
        if isinstance(self.adapters, dict):
            self.adapters = AdapterConfig(**self.adapters)
        if self.adapters is not None and not self.kv_cache_blocks:
            raise ValueError(
                "multi-tenant adapters run on the continuous-batching "
                "engine: set kv_cache_blocks"
            )

    def effective_parallelism(self) -> tuple:
        """(tp, sp) with ``mesh`` winning over the scalar fields."""
        if self.mesh is not None:
            return (self.mesh.get("tp", 1), self.mesh.get("sp", 1))
        return (self.tensor_parallel_size, self.sequence_parallel_size)

    def build_model_config(self) -> Union[LlamaConfig, MoEConfig]:
        kwargs = dict(self.model_kwargs)
        kwargs.setdefault("max_seq_len", self.max_seq_len)
        cls = MoEConfig if self.model_family == "moe" else LlamaConfig
        if self.model_id.endswith("tiny"):
            return cls.tiny(**kwargs)
        return cls(**kwargs)

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


def require_servable(model_config) -> LlamaConfig:
    """``model_config`` if the port's engines can serve it; a MoEConfig
    raises ValueError: the reference has no MoE decode path (its replica
    fails with an AttributeError when it builds Llama weights from one)."""
    if isinstance(model_config, MoEConfig):
        raise ValueError(
            "model_family='moe' cannot be served: the reference has no MoE "
            "decode path (ray_tpu's replica fails on a MoEConfig), so the "
            "port has none either; train or score it with "
            "ray_tpu_torch.models.moe"
        )
    return model_config
