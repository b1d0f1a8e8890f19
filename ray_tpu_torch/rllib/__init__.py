"""ray_tpu_torch.rllib: PPO, the port of ray_tpu.rllib's PPO path.

``PPOConfig().environment(...).env_runners(...).training(...).build()``:
the PPO learner runs on the card as an eager PyTorch update loop (the
reference compiles it into one ``lax.scan``), and the env runners step
their envs and a CPU copy of the policy in the caller's process. The port
needs no gymnasium: ``env.CartPoleEnv`` is gymnasium's ``CartPole-v1``
written out in numpy, and any env factory with the gymnasium step API works.
DQN, SAC, IMPALA, BC, the offline algorithms, DreamerV3 and multi-agent are
not ported yet.
"""

from .algorithm import PPO, PPOConfig
from .connectors import (
    ClipActions,
    Connector,
    ConnectorContext,
    ConnectorPipeline,
    FlattenObservations,
    Lambda,
    NormalizeObservations,
)
from .env import Box, CartPoleEnv, Discrete, VectorEnv, make_env
from .env_runner import EnvRunner
from .learner import PPOLearner

__all__ = [
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "EnvRunner",
    "VectorEnv",
    "make_env",
    "CartPoleEnv",
    "Box",
    "Discrete",
    "Connector",
    "ConnectorContext",
    "ConnectorPipeline",
    "FlattenObservations",
    "NormalizeObservations",
    "ClipActions",
    "Lambda",
]
