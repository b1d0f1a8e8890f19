"""Offline RL: MARWIL, CQL and IQL, the port of ray_tpu/rllib/offline.py.

Each trains from a fixed dataset with no env interaction (``evaluate()``
rolls out greedily for reporting only). The dataset goes to the learner's
device once, and each epoch is an eager loop over shuffled minibatches
(bc.py's ``OfflineAlgorithm``; the reference scans an epoch in one jitted
``lax.scan``). The learners live on the card unless ``build(device=...)``
names another device.

Dataset schema: {"obs": [N, D], "actions": [N] or [N, A], "rewards": [N],
"dones": [N]} as arrays or rows (``take_all()``); "next_obs" as well for
CQL and IQL; MARWIL derives returns from the episode boundaries.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .._internal.device import DeviceLike
from .bc import OfflineAlgorithm, OfflineConfig, materialize_offline
from .learner import (adam_init, adam_state_dict, host_copy, load_adam_state, load_module,
                      minimize_, module_names, polyak_)
from .models import (
    init_actor_critic,
    init_q_network,
    init_squashed_actor,
    init_twin_q,
    log_prob_entropy,
)

_LOG_2PI = math.log(2 * math.pi)
_EDGE = float(np.float32(1 - 1e-6))  # IQL's clip of normalized actions, as f32 rounds it


def discounted_returns(rewards: np.ndarray, dones: np.ndarray, gamma: float) -> np.ndarray:
    """Reward-to-go within episodes (boundaries at ``dones``): the
    reference's loop, copied."""
    returns = np.zeros_like(rewards)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        acc = rewards[i] + gamma * acc * (1.0 - dones[i])
        returns[i] = acc
    return returns


# ---------------------------------------------------------------------------
# MARWIL
# ---------------------------------------------------------------------------


class MARWILConfig(OfflineConfig):
    """The reference's MARWILConfig, field for field; beta = 0 is BC."""

    def __init__(self):
        super().__init__()
        self.beta = 1.0  # advantage exponent temperature
        self.vf_coeff = 1.0
        self.gamma = 0.99
        self.max_advantage_weight = 20.0


class MARWIL(OfflineAlgorithm):
    """Advantage re-weighted imitation: each (s, a) weighted by
    min(exp(beta * A), max_advantage_weight), the baseline V learned
    jointly (one ActorCritic, one Adam)."""

    loss_key = "marwil_loss"

    def __init__(self, config: MARWILConfig, device: DeviceLike = None):
        super().__init__(config, device, perm_seed=config.seed)
        self.model = init_actor_critic(self.obs_dim, self.act_dim, self.discrete,
                                       config.seed, self.device)
        self.opt_state = adam_init(dict(self.model.named_parameters()))
        data = materialize_offline(config.input_data, self._obs_space, self.obs_dim,
                                   self.discrete)
        data["returns"] = discounted_returns(data["rewards"], data["dones"], config.gamma)
        self._load_data(data)

    def _dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        out, values = self.model(batch["obs"])
        logp, _ = log_prob_entropy(self.discrete, out, batch["actions"])
        advantage = batch["returns"] - values
        weight = torch.clamp(torch.exp(cfg.beta * advantage.detach()),
                             max=cfg.max_advantage_weight)
        policy_loss = -torch.mean(weight * logp)
        vf_loss = torch.mean(advantage ** 2)
        return policy_loss + cfg.vf_coeff * vf_loss

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss = self._loss(batch)
        minimize_(loss, list(self.model.parameters()), self.opt_state, self.config.lr)
        return loss.detach()

    def compute_single_action(self, obs):
        with torch.no_grad():
            out, _ = self.model(self._encode(obs))
        if self.discrete:
            return int(out.argmax(-1)[0])
        return out[0][0].float().cpu().numpy()

    def _state_dict(self):
        return {"params": host_copy(dict(self.model.named_parameters())),
                "opt_state": adam_state_dict(self.opt_state), "iteration": self.iteration}

    def _load_state_dict(self, state):
        load_module(self.model, state["params"], self.device)
        self.opt_state = load_adam_state(state["opt_state"], module_names(self.model),
                                         self.device)
        self.iteration = state["iteration"]


# ---------------------------------------------------------------------------
# CQL (discrete)
# ---------------------------------------------------------------------------


class CQLConfig(OfflineConfig):
    """The reference's CQLConfig, field for field (discrete action spaces:
    the logsumexp is exact)."""

    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005  # polyak for the target network
        self.cql_alpha = 1.0  # weight of the conservative penalty


class CQL(OfflineAlgorithm):
    """Conservative Q-learning: a double-DQN backup (the online network
    picks, the target scores) plus alpha * (logsumexp_a Q(s, a) - Q(s,
    a_data)); the target follows by polyak after every step."""

    loss_key = "cql_loss"

    def __init__(self, config: CQLConfig, device: DeviceLike = None):
        super().__init__(config, device, perm_seed=config.seed)
        if not self.discrete:
            raise ValueError(
                "this CQL implements discrete action spaces (exact "
                "logsumexp); use IQL for continuous offline control"
            )
        self.model = init_q_network(self.obs_dim, self.act_dim, config.seed, self.device)
        self.target_model = init_q_network(self.obs_dim, self.act_dim, config.seed,
                                           self.device)
        self.target_model.requires_grad_(False)
        self.opt_state = adam_init(dict(self.model.named_parameters()))
        self._load_data(materialize_offline(config.input_data, self._obs_space, self.obs_dim,
                                            self.discrete, need_next=True))

    def _dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        q = self.model(batch["obs"])
        q_taken = q.gather(1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            best = self.model(batch["next_obs"]).argmax(dim=1)
            q_next = self.target_model(batch["next_obs"]).gather(1, best[:, None])[:, 0]
            target = batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * q_next
        bellman = torch.mean((q_taken - target) ** 2)
        conservative = torch.mean(torch.logsumexp(q, dim=1) - q_taken)
        return bellman + cfg.cql_alpha * conservative

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss = self._loss(batch)
        minimize_(loss, list(self.model.parameters()), self.opt_state, self.config.lr)
        with torch.no_grad():
            polyak_(list(self.target_model.parameters()), list(self.model.parameters()),
                    self.config.tau)
        return loss.detach()

    def compute_single_action(self, obs) -> int:
        with torch.no_grad():
            return int(self.model(self._encode(obs)).argmax(-1)[0])

    def _state_dict(self):
        return {"params": host_copy(dict(self.model.named_parameters())),
                "target_params": host_copy(dict(self.target_model.named_parameters())),
                "opt_state": adam_state_dict(self.opt_state), "iteration": self.iteration}

    def _load_state_dict(self, state):
        load_module(self.model, state["params"], self.device)
        load_module(self.target_model, state["target_params"], self.device)
        self.target_model.requires_grad_(False)
        self.opt_state = load_adam_state(state["opt_state"], module_names(self.model),
                                         self.device)
        self.iteration = state["iteration"]


# ---------------------------------------------------------------------------
# IQL
# ---------------------------------------------------------------------------


class IQLConfig(OfflineConfig):
    """The reference's IQLConfig, field for field."""

    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005
        self.expectile = 0.7  # tau in the expectile loss
        self.awr_beta = 3.0  # advantage-weighted regression temperature
        self.max_advantage_weight = 100.0


class IQL(OfflineAlgorithm):
    """Implicit Q-learning: V by expectile regression against the target
    Q, Q by a Bellman backup against V(s'), the policy by advantage-weighted
    regression; discrete (QNetwork, ActorCritic) and continuous (TwinQ, the
    squashed Gaussian actor; dataset actions map from the Box into [-1, 1]
    by its mid and half width). Each minibatch steps V, then Q (against the
    updated V), then the policy (the updated V, the old target), then the
    target by polyak, as the reference's loop does."""

    loss_key = "iql_loss"

    def __init__(self, config: IQLConfig, device: DeviceLike = None):
        super().__init__(config, device, perm_seed=config.seed)
        obs_dim, act_dim, seed = self.obs_dim, self.act_dim, config.seed
        self.vf = init_q_network(obs_dim, 1, seed + 1, self.device)  # a scalar V head
        if self.discrete:
            self.qf = init_q_network(obs_dim, act_dim, seed, self.device)
            self.target_qf = init_q_network(obs_dim, act_dim, seed, self.device)
            self.actor = init_actor_critic(obs_dim, act_dim, True, seed + 2, self.device)
        else:
            self.qf = init_twin_q(obs_dim, act_dim, seed, self.device)
            self.target_qf = init_twin_q(obs_dim, act_dim, seed, self.device)
            self.actor = init_squashed_actor(obs_dim, act_dim, seed + 2, self.device)
            low = np.asarray(self._act_space.low, np.float32).reshape(-1)
            high = np.asarray(self._act_space.high, np.float32).reshape(-1)
            self._act_mid = torch.from_numpy((low + high) / 2.0).to(self.device)
            self._act_half = torch.from_numpy((high - low) / 2.0).to(self.device)
        self.target_qf.requires_grad_(False)
        self.opt_state = {name: adam_init(dict(m.named_parameters()))
                          for name, m in self._trained().items()}
        self._load_data(materialize_offline(config.input_data, self._obs_space, self.obs_dim,
                                            self.discrete, need_next=True))

    def _trained(self) -> Dict[str, torch.nn.Module]:
        return {"v": self.vf, "q": self.qf, "pi": self.actor}

    def _dtype(self) -> torch.dtype:
        return next(self.vf.parameters()).dtype

    def _q_of(self, qf, obs, actions) -> torch.Tensor:
        if self.discrete:
            return qf(obs).gather(1, actions[:, None])[:, 0]
        q1, q2 = qf(obs, actions)
        return torch.minimum(q1, q2)

    def _v_loss(self, batch) -> torch.Tensor:
        with torch.no_grad():
            q = self._q_of(self.target_qf, batch["obs"], batch["actions"])
        v = self.vf(batch["obs"])[:, 0]
        diff = q - v
        e = self.config.expectile
        weight = torch.where(diff > 0, diff.new_tensor(e), diff.new_tensor(1 - e))
        return torch.mean(weight * diff ** 2)

    def _q_loss(self, batch) -> torch.Tensor:
        with torch.no_grad():
            next_v = self.vf(batch["next_obs"])[:, 0]
            target = batch["rewards"] + self.config.gamma * (1.0 - batch["dones"]) * next_v
        if self.discrete:
            q_taken = self.qf(batch["obs"]).gather(1, batch["actions"][:, None])[:, 0]
            return torch.mean((q_taken - target) ** 2)
        q1, q2 = self.qf(batch["obs"], batch["actions"])
        return torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)

    def _pi_loss(self, batch) -> torch.Tensor:
        cfg = self.config
        with torch.no_grad():
            q = self._q_of(self.target_qf, batch["obs"], batch["actions"])
            v = self.vf(batch["obs"])[:, 0]
            weight = torch.clamp(torch.exp(cfg.awr_beta * (q - v)), max=cfg.max_advantage_weight)
        if self.discrete:
            out, _ = self.actor(batch["obs"])
            logp, _ = log_prob_entropy(True, out, batch["actions"])
        else:
            # the log-prob of the dataset's action under the squashed
            # Gaussian, normalized from the Box into the policy's [-1, 1]
            mean, log_std = self.actor(batch["obs"])
            eps = 1e-6
            normed = (batch["actions"] - self._act_mid) / self._act_half
            # the reference clips to 1 - eps rounded to f32 (0.99999899),
            # and so does a run in another dtype: at the edge arctanh's
            # slope is 5e5, so 0.999999 would move pre by 0.0066
            y = torch.clamp(normed, -_EDGE, _EDGE)
            pre = torch.atanh(y)
            var = torch.exp(2 * log_std)
            base = -0.5 * ((pre - mean) ** 2 / var + 2 * log_std + _LOG_2PI)
            # the reference's log(1 - tanh(pre)^2 + eps) with tanh(pre) = y:
            # at the Box's edges y is within 1e-6 of 1, where one ulp of an
            # f32 tanh (the card's and the host's may differ) moves the log
            # by 0.04
            correction = torch.log(1 - y ** 2 + eps)
            logp = torch.sum(base - correction, dim=-1)
        return -torch.mean(weight * logp)

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        losses = []
        for name, loss_fn in (("v", self._v_loss), ("q", self._q_loss), ("pi", self._pi_loss)):
            loss = loss_fn(batch)
            params = list(self._trained()[name].parameters())
            minimize_(loss, params, self.opt_state[name], self.config.lr)
            losses.append(loss.detach())
        with torch.no_grad():
            polyak_(list(self.target_qf.parameters()), list(self.qf.parameters()),
                    self.config.tau)
        return losses[0] + losses[1] + losses[2]

    def compute_single_action(self, obs):
        with torch.no_grad():
            if self.discrete:
                out, _ = self.actor(self._encode(obs))
                return int(out.argmax(-1)[0])
            mean, _ = self.actor(self._encode(obs))
            action = self._act_mid + self._act_half * torch.tanh(mean)
        return action[0].float().cpu().numpy()

    def _state_dict(self):
        modules = dict(self._trained(), target_q=self.target_qf)
        return {
            "state": {name: host_copy(dict(m.named_parameters())) for name, m in modules.items()},
            "opt_state": {name: adam_state_dict(s) for name, s in self.opt_state.items()},
            "iteration": self.iteration,
        }

    def _load_state_dict(self, state):
        modules = dict(self._trained(), target_q=self.target_qf)
        for name, module in modules.items():
            load_module(module, state["state"][name], self.device)
        self.target_qf.requires_grad_(False)
        self.opt_state = {name: load_adam_state(state["opt_state"][name], module_names(m),
                                                self.device)
                          for name, m in self._trained().items()}
        self.iteration = state["iteration"]


MARWILConfig.algo_class = MARWIL
CQLConfig.algo_class = CQL
IQLConfig.algo_class = IQL
