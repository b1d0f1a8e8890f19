"""ray_tpu_torch.models: the port's model families, each mirroring the
``ray_tpu.models`` module of the same name.

Llama (causal LM, LoRA, KV-cache decode; ``llama``), the Mixtral-style MoE
transformer (top-k routed experts; ``moe``), ResNet (v1.5 bottleneck,
flax's BatchNorm; ``resnet``) and ViT (bidirectional flash attention;
``vit``); ``convert`` carries the reference's flax weights in.
"""

from .llama import Llama, LlamaConfig
from .moe import MoEConfig, MoETransformer
from .resnet import ResNet, ResNetConfig
from .vit import ViT, ViTConfig

__all__ = ["Llama", "LlamaConfig", "MoEConfig", "MoETransformer", "ResNet", "ResNetConfig",
           "ViT", "ViTConfig"]
