"""LLM serving on the card: config, engines, server and batch predictor."""

from .batch import LLMPredictor
from .config import AdapterConfig, LLMConfig
from .engine import (
    ContinuousBatchingEngine,
    GenerationRequest,
    GenerationResult,
    LLMEngine,
)
from .serving import LLMServer

__all__ = [
    "AdapterConfig",
    "ContinuousBatchingEngine",
    "GenerationRequest",
    "GenerationResult",
    "LLMConfig",
    "LLMEngine",
    "LLMPredictor",
    "LLMServer",
]
