"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's device stack.

Each module mirrors one module of ``ray_tpu`` (same relative path), written
in PyTorch idiom. Every Pallas kernel that ``ray_tpu`` runs on the path a
module covers is a hand-written CUDA C++ kernel for Hopper (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``; beside each
kernel sits its plain PyTorch version, which the wrapper runs only for a
tensor that lies on the CPU.

Covered so far: dense serving of the Llama family —
``llm.LLMServer`` -> ``llm.LLMEngine`` -> ``models.llama.Llama`` ->
``ops.{rmsnorm,rope,flash_attention}``. The package imports neither JAX nor
``ray_tpu``.
"""
