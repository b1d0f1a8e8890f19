"""ray_tpu_torch.rllib: the port of ray_tpu.rllib.

``<Algo>Config().environment(...).env_runners(...).training(...).build()``
for PPO, DQN, SAC, IMPALA / APPO, DreamerV3, multi-agent PPO and, with
``.offline_data(...)``, BC, MARWIL, CQL and IQL. Every
learner (parameters, target networks, Adam's moments; DreamerV3's world
model, actor and critics) runs on the card as an eager PyTorch update loop
(the reference compiles its updates into jitted ``lax.scan`` programs)
unless ``build(device=...)`` names another device; the env runners and
replay buffers stay on the host, stepping their envs and a CPU copy of the
policy in the caller's process. The port needs no gymnasium:
``env.CartPoleEnv`` and ``env.PendulumEnv`` are gymnasium's ``CartPole-v1``
and ``Pendulum-v1`` written out in numpy, and any env factory with the
gymnasium step API works. ``as_trainable`` waits for the port of
``tune/``.
"""

from .algorithm import PPO, PPOConfig
from .bc import BC, BCConfig
from .connectors import (
    ClipActions,
    Connector,
    ConnectorContext,
    ConnectorPipeline,
    FlattenObservations,
    Lambda,
    NormalizeObservations,
)
from .dqn import DQN, DQNConfig, ReplayBuffer
from .dreamer import DreamerV3, DreamerV3Config
from .env import Box, CartPoleEnv, Discrete, PendulumEnv, VectorEnv, make_env
from .env_runner import EnvRunner
from .impala import IMPALA, APPOConfig, IMPALAConfig
from .learner import PPOLearner
from .multi_agent import MultiAgentEnvRunner, MultiAgentPPO, MultiAgentPPOConfig
from .multi_agent_env import MultiAgentEnv
from .offline import CQL, IQL, MARWIL, CQLConfig, IQLConfig, MARWILConfig
from .sac import SAC, SACConfig

__all__ = [
    "PPO",
    "PPOConfig",
    "DQN",
    "DQNConfig",
    "IMPALA",
    "IMPALAConfig",
    "APPOConfig",
    "SAC",
    "SACConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "CQL",
    "CQLConfig",
    "IQL",
    "IQLConfig",
    "DreamerV3",
    "DreamerV3Config",
    "ReplayBuffer",
    "PPOLearner",
    "EnvRunner",
    "VectorEnv",
    "make_env",
    "CartPoleEnv",
    "PendulumEnv",
    "Box",
    "Discrete",
    "MultiAgentEnv",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "MultiAgentEnvRunner",
    "Connector",
    "ConnectorContext",
    "ConnectorPipeline",
    "FlattenObservations",
    "NormalizeObservations",
    "ClipActions",
    "Lambda",
]
