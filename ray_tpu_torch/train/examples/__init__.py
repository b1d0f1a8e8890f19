"""Example training loops of the port: ``llama_lora`` (BASELINE.json
config 3, the Llama LoRA fine-tune) and ``resnet`` (config 2, ResNet-50
through DataParallelTrainer). Import them as submodules; the package does
not, so that ``python -m ray_tpu_torch.train.examples.<name>`` runs each
module once."""

__all__ = ["llama_lora", "resnet"]
