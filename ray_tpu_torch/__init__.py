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

Every Pallas kernel of ``ray_tpu`` now has its CUDA counterpart. The package
imports neither JAX nor ``ray_tpu``.
"""
