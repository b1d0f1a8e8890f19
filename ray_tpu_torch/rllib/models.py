"""RLModules: the policy, value and Q networks, the port of
ray_tpu/rllib/models.py.

:class:`ActorCritic` (PPO, IMPALA, BC, MARWIL) computes logits (or a
Gaussian's mean and state-free ``log_std``) and the value in one forward;
:class:`QNetwork` (DQN, CQL, IQL) a ReLU MLP's Q values; :class:`TwinQ`
(SAC, continuous IQL) two independent Q(s, a) heads; and
:class:`SquashedGaussianActor` the mean and clipped ``log_std`` of SAC's
pre-tanh Gaussian. Module and parameter names follow the flax trees
(``Dense_0`` .. ``Dense_{h-1}`` hidden, then the heads in flax's order;
TwinQ's ``q1_d{i}`` / ``q1_out`` and ``q2_d{i}`` / ``q2_out``) and dense
kernels are stored as flax stores them, (in, out), so converted weights
load one to one (models/convert.py). Fresh weights follow flax's defaults:
``lecun_normal`` kernels drawn on the host from a seed, zero biases, zero
``log_std``.

Sampling takes an explicit ``torch.Generator`` on the device of the model,
where the reference takes a PRNG key; :func:`squashed_sample_logp` also
takes the normal draws themselves (``noise=``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .._internal.device import DeviceLike, resolve_device

MLP_HIDDEN: Tuple[int, ...] = (64, 64)
_LOG_2 = math.log(2.0)
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


class QNetwork(nn.Module):
    """State-action values for DQN (the reference's ``QNetwork``): a ReLU
    MLP, ``Dense_0`` .. ``Dense_{h-1}`` hidden and ``Dense_h`` out."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Tuple[int, ...] = MLP_HIDDEN):
        super().__init__()
        self.n_hidden = len(hidden)
        widths = (obs_dim, *hidden, action_dim)
        for i in range(self.n_hidden + 1):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_hidden}")(x)


class TwinQ(nn.Module):
    """Two independent Q(s, a) heads over ``concat(obs, actions)`` for
    clipped double Q (the reference's ``TwinQ``)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Tuple[int, ...] = (256, 256)):
        super().__init__()
        self.n_hidden = len(hidden)
        widths = (obs_dim + action_dim, *hidden)
        for head in ("q1", "q2"):
            for i in range(self.n_hidden):
                self.add_module(f"{head}_d{i}", Dense(widths[i], widths[i + 1]))
            self.add_module(f"{head}_out", Dense(widths[-1], 1))

    def _head(self, x: torch.Tensor, head: str) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"{head}_d{i}")(x))
        return getattr(self, f"{head}_out")(x).squeeze(-1)

    def forward(self, obs: torch.Tensor, actions: torch.Tensor):
        x0 = torch.cat([obs, actions], dim=-1)
        return self._head(x0, "q1"), self._head(x0, "q2")


class SquashedGaussianActor(nn.Module):
    """SAC's policy (the reference's ``SquashedGaussianActor``): the mean
    and ``log_std`` (clipped to [-20, 2]) of the Gaussian that tanh
    squashes; ``Dense_h`` the mean, ``Dense_{h+1}`` the log std."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Tuple[int, ...] = (256, 256),
                 log_std_min: float = -20.0, log_std_max: float = 2.0):
        super().__init__()
        self.n_hidden = len(hidden)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        widths = (obs_dim, *hidden)
        for i in range(self.n_hidden):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self.add_module(f"Dense_{self.n_hidden}", Dense(widths[-1], action_dim))
        self.add_module(f"Dense_{self.n_hidden + 1}", Dense(widths[-1], action_dim))

    def forward(self, obs: torch.Tensor):
        x = obs
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        mean = getattr(self, f"Dense_{self.n_hidden}")(x)
        log_std = getattr(self, f"Dense_{self.n_hidden + 1}")(x)
        return mean, torch.clamp(log_std, self.log_std_min, self.log_std_max)


def _init_lecun_(model: nn.Module, seed: int, device: DeviceLike) -> nn.Module:
    """``model`` on ``device`` (``None``: the card), its weights drawn on
    the host from ``seed`` so that every device gets the same ones: kernels
    truncated-normal with variance 1/fan-in (flax's ``lecun_normal``),
    biases zero (other parameters keep their zero start)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Dense):
                std = math.sqrt(1.0 / module.kernel.shape[0]) / _TRUNC_STD
                nn.init.trunc_normal_(module.kernel, 0.0, 1.0, -2.0, 2.0, generator=g)
                module.kernel.mul_(std)
                module.bias.zero_()
    return model.to(device)


def init_actor_critic(obs_dim: int, action_dim: int, discrete: bool, seed: int = 0,
                      device: DeviceLike = None) -> ActorCritic:
    """A fresh :class:`ActorCritic` on ``device`` (``None``: the card),
    weights from ``seed`` (:func:`_init_lecun_`), ``log_std`` zero."""
    return _init_lecun_(ActorCritic(obs_dim, action_dim, discrete), seed, device)


def init_q_network(obs_dim: int, action_dim: int, seed: int = 0,
                   device: DeviceLike = None) -> QNetwork:
    """A fresh :class:`QNetwork` (``MLP_HIDDEN``) on ``device``."""
    return _init_lecun_(QNetwork(obs_dim, action_dim), seed, device)


def init_twin_q(obs_dim: int, action_dim: int, seed: int = 0,
                device: DeviceLike = None) -> TwinQ:
    """A fresh :class:`TwinQ` ((256, 256)) on ``device``."""
    return _init_lecun_(TwinQ(obs_dim, action_dim), seed, device)


def init_squashed_actor(obs_dim: int, action_dim: int, seed: int = 0,
                        device: DeviceLike = None) -> SquashedGaussianActor:
    """A fresh :class:`SquashedGaussianActor` ((256, 256)) on ``device``."""
    return _init_lecun_(SquashedGaussianActor(obs_dim, action_dim), seed, device)


def squashed_sample_logp(mean: torch.Tensor, log_std: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None):
    """a = tanh(u), u ~ N(mean, std), with the tanh-corrected log-prob (SAC
    eq. 21), as the reference computes it. The standard normal draws are
    ``noise`` if given, else drawn from ``generator`` (on mean's device).
    ``softplus(-2u)`` is ``logaddexp(-2u, 0)``, which is what
    ``jax.nn.softplus`` computes (``F.softplus`` switches to the identity
    past its threshold)."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    std = torch.exp(log_std)
    u = mean + std * noise
    a = torch.tanh(u)
    logp = torch.sum(-0.5 * ((u - mean) / std) ** 2 - log_std - 0.5 * _LOG_2PI, dim=-1)
    softplus = torch.logaddexp(-2.0 * u, torch.zeros_like(u))
    logp = logp - torch.sum(2.0 * (_LOG_2 - u - softplus), dim=-1)
    return a, logp


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
