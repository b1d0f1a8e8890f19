"""LLM serving on the card: config, engines, server, the serve deployment
and the batch predictor."""

from .batch import LLMPredictor
from .config import AdapterConfig, LLMConfig
from .engine import (
    ContinuousBatchingEngine,
    GenerationRequest,
    GenerationResult,
    LLMEngine,
)
from .serving import LLMServer, build_llm_deployment, publish_llm_weights

__all__ = [
    "AdapterConfig",
    "ContinuousBatchingEngine",
    "GenerationRequest",
    "GenerationResult",
    "LLMConfig",
    "LLMEngine",
    "LLMPredictor",
    "LLMServer",
    "build_llm_deployment",
    "publish_llm_weights",
]
