"""ray_tpu_torch.models: the port's model families, each mirroring the
``ray_tpu.models`` module of the same name.

Llama (causal LM, LoRA, KV-cache decode; ``llama``), ResNet (v1.5
bottleneck, flax's BatchNorm; ``resnet``) and ViT (bidirectional flash
attention; ``vit``); ``convert`` carries the reference's flax weights in.
"""

from .llama import Llama, LlamaConfig
from .resnet import ResNet, ResNetConfig
from .vit import ViT, ViTConfig

__all__ = ["Llama", "LlamaConfig", "ResNet", "ResNetConfig", "ViT", "ViTConfig"]
