"""Environment interface + vectorization: the port of ray_tpu/rllib/env.py.

Envs follow the gymnasium 5-tuple step API; ``make_env`` accepts a gymnasium
id string or an env-factory callable. The port does not depend on
gymnasium: a string id imports it lazily inside the factory it returns (the
only gymnasium import of the package), and spaces are recognised by their
attributes, so gymnasium's spaces and the port's own :class:`Box` and
:class:`Discrete` both pass. :class:`CartPoleEnv` and :class:`PendulumEnv`
are gymnasium's ``CartPole-v1`` and ``Pendulum-v1`` written out in numpy,
for machines without gymnasium.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np


class VectorEnv:
    """N independent env copies stepped together (autoreset on episode end,
    matching gymnasium's vector semantics)."""

    def __init__(self, env_fns: List[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        first = self.envs[0]
        self.observation_space = first.observation_space
        self.action_space = first.action_space

    def reset(self, seed: Optional[int] = None):
        obs = []
        for i, env in enumerate(self.envs):
            o, _ = env.reset(seed=None if seed is None else seed + i)
            obs.append(o)
        return np.stack(obs)

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (obs, rewards, terminateds, truncateds); terminated/
        truncated envs are reset and their next obs replaces the terminal
        one (PPO's bootstrap does not need it: value targets cut at dones)."""
        obs, rewards, terms, truncs, raw = [], [], [], [], []
        for env, a in zip(self.envs, actions):
            o, r, term, trunc, _ = env.step(a)
            raw.append(o)  # pre-reset: the true arrival obs, terminal or not
            if term or trunc:
                o, _ = env.reset()
            obs.append(o)
            rewards.append(r)
            terms.append(term)
            truncs.append(trunc)
        self.last_raw_obs = np.stack(raw)
        return (
            np.stack(obs),
            np.asarray(rewards, np.float32),
            np.asarray(terms),
            np.asarray(truncs),
        )

    def close(self):
        for env in self.envs:
            try:
                env.close()
            except Exception:
                pass


def make_env(env: Union[str, Callable[[], Any]], env_config: Optional[dict] = None):
    """Factory-of-factories: returns a zero-arg callable building one env."""
    if callable(env):
        cfg = dict(env_config or {})
        return lambda: env(cfg) if _wants_config(env) else env()
    if isinstance(env, str):
        def _make():
            import gymnasium as gym

            return gym.make(env, **(env_config or {}))

        return _make
    raise TypeError(f"env must be a gymnasium id or callable, got {type(env)}")


def probe_spaces(config):
    """(observation space, action space) of one env built from ``config``."""
    probe = make_env(config.env_spec, config.env_config)()
    spaces = probe.observation_space, probe.action_space
    close = getattr(probe, "close", None)
    if close is not None:
        close()
    return spaces


def _wants_config(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 1


def is_discrete(space) -> bool:
    """A Discrete space, gymnasium's or the port's: a scalar space with
    ``n`` (gymnasium's MultiBinary has ``n`` too, and a shape)."""
    return hasattr(space, "n") and tuple(getattr(space, "shape", ())) == ()


def is_box(space) -> bool:
    """A Box space, gymnasium's or the port's: ``shape``, ``low``, ``high``."""
    return not is_discrete(space) and all(
        hasattr(space, a) for a in ("shape", "low", "high")
    )


def encode_obs(observation_space, obs: np.ndarray) -> np.ndarray:
    """Batch of raw observations -> float32 feature matrix [N, obs_dim]
    (Discrete obs are one-hot encoded to match space_dims' obs_dim=n)."""
    if is_discrete(observation_space):
        n = int(observation_space.n)
        idx = np.asarray(obs).astype(np.int64).reshape(-1)
        out = np.zeros((len(idx), n), np.float32)
        out[np.arange(len(idx)), idx] = 1.0
        return out
    return np.asarray(obs, np.float32).reshape(len(obs), -1)


def space_dims(observation_space, action_space) -> Tuple[int, int, bool]:
    """(obs_dim, action_dim, discrete) from the spaces."""
    if is_box(observation_space):
        obs_dim = int(np.prod(observation_space.shape))
    elif is_discrete(observation_space):
        obs_dim = int(observation_space.n)
    else:
        raise ValueError(f"unsupported obs space {observation_space}")
    if is_discrete(action_space):
        return obs_dim, int(action_space.n), True
    if is_box(action_space):
        return obs_dim, int(np.prod(action_space.shape)), False
    raise ValueError(f"unsupported action space {action_space}")


class Discrete:
    """The integers ``0 .. n-1`` (gymnasium's ``spaces.Discrete``, start 0)."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"Discrete needs n > 0, got {n}")
        self.n = int(n)
        self.shape = ()

    def contains(self, x) -> bool:
        if isinstance(x, (np.generic, np.ndarray)):
            if not (np.issubdtype(x.dtype, np.integer) and x.shape == ()):
                return False
        elif not isinstance(x, int):
            return False
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Box:
    """A box in R^shape, bounds per element (gymnasium's ``spaces.Box``)."""

    def __init__(self, low, high, shape: Optional[Tuple[int, ...]] = None,
                 dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast_shapes(np.shape(low), np.shape(high))
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()
        if np.any(self.low > self.high):
            raise ValueError("Box needs low <= high")

    def __repr__(self):
        return f"Box({self.low}, {self.high}, {self.shape}, {self.dtype})"


class CartPoleEnv:
    """gymnasium 1.2.2's ``CartPole-v1`` as ``gym.make`` builds it: Euler
    steps of Barto, Sutton and Anderson's cart-pole in float64, observations
    in float32, reward 1 a step, terminated past 12 degrees or 2.4 units,
    truncated after ``max_episode_steps`` (500; ``env_config`` may set it).
    ``reset(seed=s)`` draws the start state from ``np.random.default_rng(s)``,
    gymnasium's ``seeding.np_random`` (PCG64 over a SeedSequence); a reset
    without a seed keeps drawing from the same generator. Same seeds and
    actions give gymnasium's observations, rewards and flags bit for bit."""

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masspole + masscart
    length = 0.5  # half the pole's length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02  # seconds between state updates
    theta_threshold_radians = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def __init__(self, env_config: Optional[dict] = None):
        cfg = dict(env_config or {})
        self.max_episode_steps = int(cfg.pop("max_episode_steps", 500))
        if cfg:
            raise TypeError(f"CartPoleEnv does not take {sorted(cfg)}")
        high = np.array(
            [self.x_threshold * 2, np.inf, self.theta_threshold_radians * 2, np.inf],
            dtype=np.float32,
        )
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.state: Optional[np.ndarray] = None
        self._rng: Optional[np.random.Generator] = None
        self._elapsed = 0
        self._steps_beyond_terminated: Optional[int] = None

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        elif self._rng is None:
            self._rng = np.random.default_rng()
        self.state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        self._steps_beyond_terminated = None
        self._elapsed = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        if self.state is None:
            raise RuntimeError("call reset before step")
        if not self.action_space.contains(action):
            raise ValueError(f"{action!r} ({type(action)}) invalid")
        # the arithmetic below is gymnasium's, operation for operation
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (
            force + self.polemass_length * np.square(theta_dot) * sintheta
        ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians
        )
        if not terminated:
            reward = 1.0
        elif self._steps_beyond_terminated is None:
            self._steps_beyond_terminated = 0
            reward = 1.0
        else:  # stepped past the end: gymnasium warns and pays nothing
            self._steps_beyond_terminated += 1
            reward = 0.0
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return np.array(self.state, dtype=np.float32), reward, terminated, truncated, {}

    def close(self):
        pass


class PendulumEnv:
    """gymnasium 1.2.2's ``Pendulum-v1`` as ``gym.make`` builds it: the
    swing-up pendulum with state (theta, thetadot) in float64, torque
    clipped to [-2, 2] before the dynamics (g = 10.0 unless ``env_config``
    sets ``g``), observation ``[cos, sin, thetadot]`` in float32, reward
    ``-(angle_normalize(theta)^2 + 0.1 thetadot^2 + 0.001 u^2)``, never
    terminated, truncated after ``max_episode_steps`` (200; ``env_config``
    may set it). ``reset(seed=s)`` draws (theta, thetadot) over
    [-pi, pi] x [-1, 1] from ``np.random.default_rng(s)``; a reset without
    a seed keeps drawing from the same generator. Same seeds and actions
    give gymnasium's observations, rewards and flags bit for bit."""

    max_speed = 8
    max_torque = 2.0
    dt = 0.05
    m = 1.0
    l = 1.0  # noqa: E741 (gymnasium's name)

    def __init__(self, env_config: Optional[dict] = None):
        cfg = dict(env_config or {})
        self.max_episode_steps = int(cfg.pop("max_episode_steps", 200))
        self.g = cfg.pop("g", 10.0)
        if cfg:
            raise TypeError(f"PendulumEnv does not take {sorted(cfg)}")
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(-self.max_torque, self.max_torque, (1,), dtype=np.float32)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.state: Optional[np.ndarray] = None
        self._rng: Optional[np.random.Generator] = None
        self._elapsed = 0

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        elif self._rng is None:
            self._rng = np.random.default_rng()
        high = np.array([np.pi, 1.0])
        self.state = self._rng.uniform(low=-high, high=high)
        self._elapsed = 0
        return self._obs(), {}

    def _obs(self) -> np.ndarray:
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)

    def step(self, u):
        if self.state is None:
            raise RuntimeError("call reset before step")
        arr = np.asarray(u)
        if arr.shape != (1,) or not np.issubdtype(arr.dtype, np.number) \
                or np.issubdtype(arr.dtype, np.complexfloating):
            raise ValueError(f"{u!r} ({type(u)}) invalid")
        # the arithmetic below is gymnasium's, operation for operation
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt  # noqa: E741
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return self._obs(), -costs, False, truncated, {}

    def close(self):
        pass


def _angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi
