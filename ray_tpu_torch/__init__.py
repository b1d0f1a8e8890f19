"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's device stack.

Each module mirrors one module of ``ray_tpu`` (same relative path), written
in PyTorch idiom. Every Pallas kernel that ``ray_tpu`` runs on the path a
module covers is a hand-written CUDA C++ kernel for Hopper (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``; beside each
kernel sits its plain PyTorch version, which the wrapper runs only for a
tensor that lies on the CPU.

Covered so far:

- dense serving of the Llama family: ``llm.LLMServer`` -> ``llm.LLMEngine``
  -> ``models.llama.Llama`` -> ``ops.{rmsnorm,rope,flash_attention}``;
- LoRA fine-tuning of Llama: ``train.TorchTrainer(...).fit()`` ->
  ``train.examples.llama_lora`` -> ``models.llama.next_token_loss`` ->
  ``loss.backward()`` through the flash-attention backward kernels -> AdamW
  on the adapters;
- continuous batching over the paged prefix KV cache (``kvcache``), with
  chunked prefill and speculative decoding;
- multi-tenant LoRA serving: ``llm.LLMConfig(adapters=...)`` ->
  ``lora.AdapterStore`` slot bank -> batched-gather ``LoRADense`` in every
  model call; ``llm.LLMPredictor`` for batches with per-row adapters.
- vision training: ResNet through ``train.DataParallelTrainer(...).fit()``
  -> ``train.examples.resnet`` -> ``models.resnet`` (cuDNN convolutions,
  flax's BatchNorm) -> SGD with momentum; ViT through
  ``models.vit.classification_loss`` -> ``loss.backward()``, its encoder
  attention through the flash-attention kernels, non-causal;
- data-parallel training: ``collective`` (``NcclGroup``, ``GlooGroup``,
  the bucketized ``GradientReduceScheduler``) under
  ``train.TorchTrainer(scaling_config=ScalingConfig(num_workers=n),
  backend_config=TorchConfig())``, whose spawned workers sum their
  gradients with ``train.collective.reduce_gradients``.

- the runtime core: ``init`` / ``remote`` / ``get`` / ``put`` / ``wait`` /
  ``kill`` / ``get_actor``, tasks, actors, the object plane and placement
  groups (``runtime/``, copies of ``ray_tpu``'s host code, pickled with the
  standard library: callables travel by reference, tensors as raw bytes),
  with the card as the node's ``GPU`` resource and each leased worker bound
  to its lease's card; device objects (``experimental``).

Every Pallas kernel of ``ray_tpu`` now has its CUDA counterpart. The package
imports neither JAX nor ``ray_tpu``, and ``import ray_tpu_torch`` imports no
torch: the public API below loads on first use (PEP 562).
"""

from __future__ import annotations

import importlib

__version__ = "0.5.0"

# name -> module of the public API, loaded on first attribute access
_LAZY = {
    **dict.fromkeys(
        ("available_resources", "cancel", "cluster_resources", "get", "get_actor", "init",
         "is_initialized", "kill", "nodes", "put", "remote", "shutdown", "wait"), ".api"),
    "method": ".actor",
    "ObjectRef": ".object_ref",
    "ObjectRefGenerator": ".object_ref",
    "get_runtime_context": ".runtime_context",
    **dict.fromkeys(
        ("ActorID", "JobID", "NodeID", "ObjectID", "PlacementGroupID", "TaskID", "UniqueID",
         "WorkerID"), "._internal.ids"),
}


def get_gpu_ids():
    """The GPU ids of this worker's lease (reference role: ray.get_gpu_ids);
    [] in a driver and in a worker whose lease names no card."""
    from . import _worker_api

    worker = _worker_api.maybe_get_core_worker()
    return list(getattr(worker, "gpu_ids", []))


#: submodules loaded on first attribute access, as ``ray_tpu``'s
_LAZY_SUBMODULES = ("exceptions",)


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY) + list(_LAZY_SUBMODULES))
