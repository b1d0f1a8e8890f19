"""Dense LLM serving on the card: config, engine and server."""

from .config import LLMConfig
from .engine import GenerationRequest, GenerationResult, LLMEngine
from .serving import LLMServer

__all__ = [
    "GenerationRequest",
    "GenerationResult",
    "LLMConfig",
    "LLMEngine",
    "LLMServer",
]
