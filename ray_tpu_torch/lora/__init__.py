"""ray_tpu_torch.lora: the multi-tenant adapter plane, the port of ray_tpu.lora.

Many tenants' LoRA fine-tunes are served over ONE copy of the base model:

- :class:`AdapterStore`: paged adapter *slots* on the card, mirroring the
  KV block pool (kvcache/manager.py): a fixed-capacity bank per
  ``lora_a``/``lora_b`` projection, stacked over layers, refcount leases
  pinning in-use slots, LRU eviction of idle adapters.
- the batched-gather LoRA product (models/llama.py ``gather_adapters`` and
  ``LoRADense``): the engines pass one adapter slot per row (-1 = the base
  model) and every projection adds ``x @ A[slot] @ B[slot]``, so ONE model
  call serves a batch whose rows name different adapters.
- :func:`publish_adapter`: adapters ride the weight plane, published
  under ``<prefix>/<adapter_id>`` and refilled into a slot by a store with
  ``source="weights:<prefix>"``.

Serving wires this up through ``LLMConfig(adapters=AdapterConfig(...))``.
"""

from .store import (
    AdapterLease,
    AdapterStore,
    adapter_target_paths,
    publish_adapter,
)

__all__ = [
    "AdapterLease",
    "AdapterStore",
    "adapter_target_paths",
    "publish_adapter",
]
