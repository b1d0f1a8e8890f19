"""LLM serving on the card: config, engines and server."""

from .config import LLMConfig
from .engine import (
    ContinuousBatchingEngine,
    GenerationRequest,
    GenerationResult,
    LLMEngine,
)
from .serving import LLMServer

__all__ = [
    "ContinuousBatchingEngine",
    "GenerationRequest",
    "GenerationResult",
    "LLMConfig",
    "LLMEngine",
    "LLMServer",
]
