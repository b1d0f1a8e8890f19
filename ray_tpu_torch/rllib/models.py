"""RLModule: the PPO policy/value network, the port of ray_tpu/rllib/models.py.

:class:`ActorCritic` computes logits (or a Gaussian's mean and state-free
``log_std``) and the value in one forward. Module and parameter names follow
the flax tree (``Dense_0`` .. ``Dense_{h-1}`` hidden, ``Dense_h`` logits,
``Dense_{h+1}`` value, ``log_std``) and dense kernels are stored as flax
stores them, (in, out), so converted weights load one to one
(models/convert.py ``actor_critic_params_from_jax``). Fresh weights follow
flax's defaults: ``lecun_normal`` kernels, zero biases, zero ``log_std``.

Sampling takes an explicit ``torch.Generator`` on the device of the model,
where the reference takes a PRNG key. Only ``ActorCritic`` is ported:
QNetwork, TwinQ and the squashed Gaussian actor come with DQN and SAC.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .._internal.device import DeviceLike, resolve_device

MLP_HIDDEN: Tuple[int, ...] = (64, 64)
_LOG_2PI = math.log(2 * math.pi)
_LOG_2PIE = math.log(2 * math.pi * math.e)
# flax's variance_scaling: the std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, ``kernel`` (in, out)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self.bias, x, self.kernel)


class ActorCritic(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, discrete: bool,
                 hidden: Tuple[int, ...] = MLP_HIDDEN):
        super().__init__()
        self.discrete = discrete
        self.n_hidden = len(hidden)
        widths = (obs_dim, *hidden)
        for i in range(self.n_hidden):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self.add_module(f"Dense_{self.n_hidden}", Dense(widths[-1], action_dim))
        self.add_module(f"Dense_{self.n_hidden + 1}", Dense(widths[-1], 1))
        if not discrete:
            self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs: torch.Tensor):
        """obs [B, obs_dim] -> (logits, values) or ((mean, log_std), values)."""
        x = obs
        for i in range(self.n_hidden):
            x = torch.tanh(getattr(self, f"Dense_{i}")(x))
        logits = getattr(self, f"Dense_{self.n_hidden}")(x)
        v = getattr(self, f"Dense_{self.n_hidden + 1}")(x).squeeze(-1)
        if not self.discrete:
            return (logits, self.log_std), v
        return logits, v


def init_actor_critic(obs_dim: int, action_dim: int, discrete: bool, seed: int = 0,
                      device: DeviceLike = None) -> ActorCritic:
    """A fresh :class:`ActorCritic` on ``device`` (``None``: the card), its
    weights drawn on the host from ``seed`` so that every device gets the same
    ones: kernels truncated-normal with variance 1/fan-in (flax's
    ``lecun_normal``), biases and ``log_std`` zero."""
    device = resolve_device(device)
    model = ActorCritic(obs_dim, action_dim, discrete)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Dense):
                std = math.sqrt(1.0 / module.kernel.shape[0]) / _TRUNC_STD
                nn.init.trunc_normal_(module.kernel, 0.0, 1.0, -2.0, 2.0, generator=g)
                module.kernel.mul_(std)
                module.bias.zero_()
    return model.to(device)


def sample_actions(model: ActorCritic, obs: torch.Tensor, generator: torch.Generator):
    """obs [B, D] -> (actions, log_probs, values), drawing from ``generator``
    (on obs's device): categorical over the logits, or ``mean + std * eps``."""
    out, values = model(obs)
    if model.discrete:
        all_logp = torch.log_softmax(out, dim=-1)
        actions = torch.multinomial(all_logp.exp(), 1, generator=generator)
        logp = all_logp.gather(1, actions)[:, 0]
        return actions[:, 0], logp, values
    mean, log_std = out
    eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                      dtype=mean.dtype)
    actions = mean + torch.exp(log_std) * eps
    return actions, _gaussian_logp(actions, mean, log_std), values


def log_prob_entropy(model_discrete: bool, out, actions: torch.Tensor):
    """Differentiable log-prob + entropy for the PPO loss."""
    if model_discrete:
        all_logp = torch.log_softmax(out, dim=-1)
        logp = all_logp.gather(1, actions.long()[:, None])[:, 0]
        entropy = -torch.sum(torch.exp(all_logp) * all_logp, dim=-1)
        return logp, entropy
    mean, log_std = out
    logp = _gaussian_logp(actions, mean, log_std)
    entropy = torch.sum(log_std + 0.5 * _LOG_2PIE, dim=-1)
    return logp, entropy.expand(logp.shape)


def _gaussian_logp(x, mean, log_std):
    std = torch.exp(log_std)
    return torch.sum(-0.5 * ((x - mean) / std) ** 2 - log_std - 0.5 * _LOG_2PI, dim=-1)


def compute_gae(
    rewards: np.ndarray,
    values: np.ndarray,
    dones: np.ndarray,
    last_values: np.ndarray,
    gamma: float,
    lam: float,
):
    """Generalized advantage estimation over [T, N] rollouts, in numpy (the
    reference's function, copied)."""
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    next_values = last_values
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_values * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_values = values[t]
    returns = adv + values
    return adv, returns
