"""BC: offline behaviour cloning, the port of ray_tpu/rllib/bc.py, and the
pieces the offline family (offline.py: MARWIL, CQL, IQL) shares with it.

The offline dataset is a dict of arrays, or any object whose ``take_all()``
returns rows (the reference's ``ray_tpu.data.Dataset``; the port duck-types
it and imports no data plane). It goes to the learner's device once, at
``build``; the learner is on the card unless ``build(device=...)`` names
another device. The reference compiles an epoch (shuffle and minibatch
updates) into one jitted ``lax.scan``; here an epoch is an eager loop over
the minibatches of a permutation drawn from the algorithm's own host
generator (``torch.randperm``), each minibatch gathered on the device. Each
``_epoch`` also takes ``perms=``, which is how the tests hand in the
reference's ``jax.random.permutation`` rows. Losses stay on the device;
``train()`` copies them to the host once.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from .._internal.device import DeviceLike, resolve_device
from .config_base import AlgorithmConfig
from .env import encode_obs, make_env, probe_spaces, space_dims
from .learner import (adam_init, adam_state_dict, host_copy, load_adam_state, load_module,
                      minimize_, module_names, to_device)
from .models import init_actor_critic, log_prob_entropy


class OfflineConfig(AlgorithmConfig):
    """The fields every offline config shares, and ``offline_data``."""

    def __init__(self):
        super().__init__()
        # offline input: {"obs": [N, D], "actions": [N] or [N, A], ...}
        # arrays, or an object whose take_all() returns such rows
        self.input_data: Any = None
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_epochs_per_iter = 1

    def offline_data(self, input_data):
        self.input_data = input_data
        return self


class BCConfig(OfflineConfig):
    """The reference's BCConfig, field for field."""


def offline_columns(data) -> Dict[str, np.ndarray]:
    """An offline dataset as numpy columns: a dict of arrays as it is, or
    the rows of ``data.take_all()`` stacked per key."""
    if hasattr(data, "take_all"):
        rows = data.take_all()
        return {key: np.stack([np.asarray(r[key]) for r in rows]) for key in rows[0]}
    return data


def materialize_offline(data, obs_space, obs_dim: int, discrete: bool,
                        need_next: bool = False) -> Dict[str, np.ndarray]:
    """The reference's ``_materialize_offline``: encoded f32 observations,
    rewards and dones (zeros where missing), actions as int64 scalars or
    f32 vectors, and with ``need_next`` the encoded next observations."""
    data = offline_columns(data)
    n = len(data["obs"])
    out = {
        "obs": encode_obs(obs_space, np.asarray(data["obs"], np.float32)),
        "rewards": np.asarray(data.get("rewards", np.zeros(n)), np.float32).reshape(-1),
        "dones": np.asarray(data.get("dones", np.zeros(n)), np.float32).reshape(-1),
    }
    actions = np.asarray(data["actions"])
    if discrete:
        out["actions"] = actions.astype(np.int64).reshape(len(actions))
    else:
        out["actions"] = actions.astype(np.float32).reshape(len(actions), -1)
    if need_next:
        if "next_obs" not in data:
            raise ValueError("CQL/IQL offline data requires 'next_obs'")
        out["next_obs"] = encode_obs(obs_space, np.asarray(data["next_obs"], np.float32))
    if out["obs"].shape[1] != obs_dim:
        raise ValueError(f"offline obs of width {out['obs'].shape[1]}: the env's is {obs_dim}")
    return out


def minibatch_perms(generator: torch.Generator, n_rows: int, batch_size: int,
                    perms=None) -> torch.Tensor:
    """An epoch's minibatch rows, [n_mb, mb] on the host: the first
    n_mb * mb of a permutation from ``generator``, or ``perms`` (the
    caller's rows, n_mb * mb of them in any shape)."""
    mb = min(batch_size, n_rows)
    n_mb = max(n_rows // mb, 1)
    if perms is None:
        return torch.randperm(n_rows, generator=generator)[: n_mb * mb].reshape(n_mb, mb)
    perms = torch.as_tensor(np.array(perms), dtype=torch.int64)
    if perms.numel() != n_mb * mb:
        raise ValueError(f"perms of shape {tuple(perms.shape)}: want {n_mb} x {mb} rows")
    return perms.reshape(n_mb, mb)


def run_epoch(data: Dict[str, torch.Tensor], perm: torch.Tensor,
              step: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
              dtype: torch.dtype) -> torch.Tensor:
    """``step`` over each minibatch of ``perm`` (rows of ``data``, gathered
    on its device, floating columns cast to ``dtype``); the mean of the
    losses, on the device."""
    perm = perm.to(next(iter(data.values())).device)
    losses = []
    for idx in perm:
        batch = {k: v[idx].to(dtype) if v.is_floating_point() else v[idx]
                 for k, v in data.items()}
        losses.append(step(batch))
    return torch.stack(losses).mean()


def evaluate_policy(config, act: Callable[[Any], Any], num_episodes: int) -> Dict[str, Any]:
    """Greedy rollouts of ``act`` in the real env, for reporting (the
    reference's ``evaluate``)."""
    env = make_env(config.env_spec, config.env_config)()
    returns = []
    for ep in range(num_episodes):
        obs, _ = env.reset(seed=config.seed + ep)
        done, total, steps = False, 0.0, 0
        while not done and steps < 1000:
            obs, r, term, trunc, _ = env.step(act(obs))
            total += float(r)
            done = term or trunc
            steps += 1
        returns.append(total)
    close = getattr(env, "close", None)
    if close is not None:
        close()
    return {"episode_return_mean": float(np.mean(returns)), "num_episodes": num_episodes}


class OfflineAlgorithm:
    """What BC and the offline family share: the required config, the
    spaces, the device, the epoch loop, evaluation and checkpointing.
    A subclass sets ``_data`` and defines ``_step``, ``_dtype``,
    ``_state_dict`` and ``_load_state_dict``."""

    #: the key of the loss in ``train()``'s result
    loss_key = "loss"

    def __init__(self, config: OfflineConfig, device: DeviceLike, perm_seed: int):
        if config.env_spec is None:
            raise ValueError("config.environment(...) is required")
        if config.input_data is None:
            raise ValueError("config.offline_data(...) is required")
        self.config = config
        self.iteration = 0
        self._obs_space, self._act_space = probe_spaces(config)
        self.obs_dim, self.act_dim, self.discrete = space_dims(self._obs_space,
                                                               self._act_space)
        self.device = resolve_device(device)
        self._generator = torch.Generator().manual_seed(perm_seed)
        self._data: Dict[str, torch.Tensor] = {}
        #: host seconds of the last iteration's learner epochs (ending with
        #: the losses' copy to the host)
        self.timers: Dict[str, float] = {}

    def _load_data(self, arrays: Dict[str, np.ndarray]):
        self._data = to_device(arrays, self.device, torch.float32)

    def _epoch(self, perms=None) -> torch.Tensor:
        """One epoch of minibatch updates; the mean loss, on the device."""
        n = self._data["obs"].shape[0]
        perm = minibatch_perms(self._generator, n, self.config.train_batch_size, perms)
        return run_epoch(self._data, perm, self._step, self._dtype())

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        losses = torch.stack([self._epoch() for _ in range(self.config.num_epochs_per_iter)])
        losses = losses.cpu().numpy()
        t1 = time.perf_counter()
        self.timers = {"learn_s": t1 - t0}
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            self.loss_key: float(np.mean(losses)),
            "num_samples": int(self._data["obs"].shape[0]),
            "time_this_iter_s": t1 - t0,
        }

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        return evaluate_policy(self.config, self.compute_single_action, num_episodes)

    def _encode(self, obs) -> torch.Tensor:
        enc = encode_obs(self._obs_space, np.asarray(obs)[None])
        return torch.from_numpy(enc).to(self.device, self._dtype())

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        name = type(self).__name__.lower()
        torch.save(self._state_dict(), os.path.join(checkpoint_dir, f"{name}_state.pt"))
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        name = type(self).__name__.lower()
        self._load_state_dict(torch.load(os.path.join(checkpoint_dir, f"{name}_state.pt"),
                                         map_location="cpu", weights_only=True))

    def stop(self):
        pass


class BC(OfflineAlgorithm):
    """Behaviour cloning: the ActorCritic's policy head trained to the
    dataset's actions (-mean log-prob), Adam."""

    loss_key = "bc_loss"

    def __init__(self, config: BCConfig, device: DeviceLike = None):
        super().__init__(config, device, perm_seed=config.seed + 1)
        self.model = init_actor_critic(self.obs_dim, self.act_dim, self.discrete,
                                       config.seed, self.device)
        self.opt_state = adam_init(dict(self.model.named_parameters()))
        self._load_data({k: v for k, v in materialize_offline(
            config.input_data, self._obs_space, self.obs_dim, self.discrete).items()
            if k in ("obs", "actions")})

    def _dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        out, _ = self.model(batch["obs"])
        logp, _ = log_prob_entropy(self.discrete, out, batch["actions"])
        return -torch.mean(logp)

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss = self._loss(batch)
        minimize_(loss, list(self.model.parameters()), self.opt_state, self.config.lr)
        return loss.detach()

    def compute_single_action(self, obs):
        """The greedy action (argmax, or the Gaussian's mean)."""
        with torch.no_grad():
            out, _ = self.model(self._encode(obs))
        if self.discrete:
            return int(out.argmax(-1)[0])
        return out[0][0].float().cpu().numpy()

    def _state_dict(self) -> Dict[str, Any]:
        return {"params": host_copy(dict(self.model.named_parameters())),
                "opt_state": adam_state_dict(self.opt_state), "iteration": self.iteration}

    def _load_state_dict(self, state: Dict[str, Any]):
        load_module(self.model, state["params"], self.device)
        self.opt_state = load_adam_state(state["opt_state"], module_names(self.model),
                                         self.device)
        self.iteration = state["iteration"]


BCConfig.algo_class = BC
