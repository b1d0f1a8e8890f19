"""DreamerV3: model-based RL via latent imagination, the port of
ray_tpu/rllib/dreamer.py.

The learner lives on the card unless ``build(device=...)`` names another
device: the RSSM world model (encoder, GRU, prior and posterior heads over
``stoch_groups`` x ``stoch_classes`` categorical latents, decoder, reward
and continue heads), the actor, the critic, its EMA "slow" copy, and an Adam
state for each of the three optimizers. The env runners (a CPU copy of the
world model and actor, acting from the posterior) and the numpy
:class:`SequenceReplayBuffer` stay on the host, in the caller's process.

The reference compiles one update (world-model observe as a ``lax.scan``,
imagination as a second, the λ-returns as a reverse one, three gradient
steps) into one XLA program. Here it is an eager loop on the learner's
device in the reference's order: the world-model step; imagination from
every posterior state with gradients cut; the actor step; the critic step;
the slow-critic EMA. Two changes of form keep the arithmetic: the prior
head runs once over the filtered sequence (it is not in the recurrence),
and imagination rolls the world model without autograd, then takes the
actor's log-probs and entropies in one batched forward over the imagined
features. The actor's loss reaches its parameters only through those (the
features, advantages and weights carry a ``stop_gradient`` in the
reference), so its gradients are ``jax.value_and_grad``'s.

Draws come from ``torch.Generator`` s: the update's from one on the
learner's device seeded ``seed + iteration`` (the reference keys
``PRNGKey(seed + iteration)``), a runner's from one on the host seeded with
its seed. ``jax.random.categorical`` is ``argmax(gumbel + logits)``: every
categorical draw here takes the Gumbel noise (or the chosen classes) from
its caller, so tests can hand in the reference's draws.

Departures from the reference: ``restore`` brings back every Adam moment
and count (the reference re-initialises its optimizers);
``compute_single_action`` draws its latent from a generator seeded 0 (the
reference's ``PRNGKey(0)`` draws differently); runners and the buffer are
objects in the caller's process, not actors.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._internal.device import DeviceLike, resolve_device
from .config_base import AlgorithmConfig
from .env import VectorEnv, encode_obs, make_env, probe_spaces, space_dims
from .learner import (adam_init, adam_state_dict, host_copy, load_adam_state, load_module,
                      minimize_, module_names, polyak_, to_device)
from .models import _TRUNC_STD, Dense, squashed_sample_logp
from .weight_sync import broadcaster_for, resolve_params

STAT_KEYS = ("wm_loss", "recon_loss", "reward_loss", "cont_loss", "kl_dyn", "kl_rep",
             "actor_loss", "critic_loss", "actor_entropy", "imagined_return_mean",
             "return_scale")
LN_EPS = 1e-6  # flax nn.LayerNorm's
_HALF_LOG_2PIE = 0.5 * math.log(2 * math.pi * math.e)

# -- symlog / two-hot regression helpers ----------------------------------------


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def twohot_bins(n_bins: int, low: float = -20.0, high: float = 20.0) -> torch.Tensor:
    """Bin centers in symlog space (decoded values are symexp(bin)), f32."""
    return torch.linspace(low, high, n_bins, dtype=torch.float32)


def twohot_encode(y: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Scalar targets -> two-hot distribution over ``bins`` (y in symlog
    space). Weight splits linearly between the two straddling bins:
    ``searchsorted``'s left side, as ``jnp.searchsorted``, clipped to the
    end bins."""
    bins = bins.to(y.dtype)
    y = torch.clamp(y, bins[0], bins[-1])
    idx_hi = torch.clamp(torch.searchsorted(bins, y.contiguous(), right=False), 1,
                         len(bins) - 1)
    idx_lo = idx_hi - 1
    lo, hi = bins[idx_lo], bins[idx_hi]
    frac = (y - lo) / torch.clamp(hi - lo, min=1e-8)
    out = torch.zeros(*y.shape, len(bins), dtype=y.dtype, device=y.device)
    out.scatter_(-1, idx_lo[..., None], (1.0 - frac)[..., None])
    return out.scatter_(-1, idx_hi[..., None], frac[..., None])


def twohot_decode(logits: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Expected value of the categorical over bins, back through symexp."""
    return symexp(torch.softmax(logits, -1) @ bins.to(logits.dtype))


def twohot_loss(logits: torch.Tensor, target_scalar: torch.Tensor,
                bins: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the two-hot target (target in raw space)."""
    target = twohot_encode(symlog(target_scalar), bins)
    return -torch.sum(target * torch.log_softmax(logits, -1), -1)


# -- categorical latent helpers (unimix + straight-through) ----------------------

UNIMIX = 0.01


def _unimix_probs(logits: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, -1)
    return (1.0 - UNIMIX) * probs + UNIMIX / logits.shape[-1]


def gumbel(shape, generator: Optional[torch.Generator] = None, device: DeviceLike = "cpu",
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with ``u`` uniform on
    [tiny, 1), as ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: ``argmax(gumbel +
    logits)``. ``draw`` is the Gumbel noise (floating, ``logits``' shape) or
    the chosen classes themselves (integer, its shape without the last
    axis); without it the noise comes from ``generator``."""
    if draw is None:
        draw = gumbel(logits.shape, generator, logits.device, logits.dtype)
    if draw.is_floating_point():
        return torch.argmax(draw + logits, -1)
    return draw


def _onehot(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like).scatter_(-1, idx[..., None], 1.0)


def latent_sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Straight-through sample of (G, C) categorical latents -> flat one-hot
    of shape [..., G*C]; ``draw`` as :func:`categorical`'s."""
    probs = _unimix_probs(logits)
    onehot = _onehot(categorical(torch.log(probs), generator, draw), probs)
    st = onehot + probs - probs.detach()
    return st.reshape(*st.shape[:-2], -1)


def latent_kl(lhs_logits: torch.Tensor, rhs_logits: torch.Tensor) -> torch.Tensor:
    """KL(lhs || rhs) summed over latent groups; logits [..., G, C]."""
    lp = _unimix_probs(lhs_logits)
    return torch.sum(lp * (torch.log(lp) - torch.log(_unimix_probs(rhs_logits))), (-2, -1))


def log_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``: ``-labels * log_sigmoid(x) -
    (1 - labels) * log_sigmoid(-x)``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


# -- network modules --------------------------------------------------------------


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, statistics in the input's dtype
    (f32 for the learner, f64 for an f64 control run)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, LN_EPS)


class MLP(nn.Module):
    """The reference's ``_MLP``: ``layers`` x (Dense, LayerNorm, SiLU), then
    a Dense out; flax's names (``Dense_{i}``, ``LayerNorm_{i}``). Takes any
    leading axes."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int, layers: int = 2,
                 heads: int = 1):
        super().__init__()
        self.layers = layers
        widths = (in_dim,) + (hidden,) * layers
        for i in range(layers):
            self.add_module(f"Dense_{i}", Dense(widths[i], hidden))
            self.add_module(f"LayerNorm_{i}", LayerNorm(hidden))
        for j in range(heads):
            self.add_module(f"Dense_{layers + j}", Dense(widths[-1], out_dim))

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(-1, x.shape[-1])
        for i in range(self.layers):
            x = F.silu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return x

    def _head(self, x: torch.Tensor, j: int, lead) -> torch.Tensor:
        out = getattr(self, f"Dense_{self.layers + j}")(x)
        return out.reshape(*lead, out.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._head(self._trunk(x), 0, x.shape[:-1])


class Actor(MLP):
    """The reference's ``_Actor``: the MLP's trunk, then logits (discrete)
    or a mean and a ``log_std`` clipped to [-5, 2] (``Dense_{L}``,
    ``Dense_{L+1}``)."""

    def __init__(self, in_dim: int, action_dim: int, discrete: bool, hidden: int,
                 layers: int = 2):
        super().__init__(in_dim, action_dim, hidden, layers, heads=1 if discrete else 2)
        self.discrete = discrete

    def forward(self, x: torch.Tensor):
        h = self._trunk(x)
        lead = x.shape[:-1]
        if self.discrete:
            return self._head(h, 0, lead)
        return self._head(h, 0, lead), torch.clamp(self._head(h, 1, lead), -5.0, 2.0)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell`` (0.12): ``r = σ(ir(x) + hr(h))``, ``z = σ(iz(x) +
    hz(h))``, ``n = tanh(in(x) + r * hn(h))``, ``h' = (1 - z) * n + z * h``,
    where ``hr`` and ``hz`` have no bias. That is ``torch.gru_cell`` (a fused
    kernel on the card) with ``b_ih = [b_ir; b_iz; b_in]`` and ``b_hh = [0;
    0; b_hn]``. The kernels are flax's, (in, out), side by side in r, z, n
    order: ``kernel_i`` = [ir | iz | in], ``kernel_h`` = [hr | hz | hn]."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.kernel_i = nn.Parameter(torch.empty(in_features, 3 * features))
        self.kernel_h = nn.Parameter(torch.empty(features, 3 * features))
        self.bias_i = nn.Parameter(torch.empty(3 * features))
        self.bias_hn = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        b_hh = F.pad(self.bias_hn, (2 * self.features, 0))
        return torch.gru_cell(x, h, self.kernel_i.t(), self.kernel_h.t(), self.bias_i, b_hh)


class WorldModel(nn.Module):
    """The RSSM's modules under the reference's ``wm`` keys."""

    def __init__(self, obs_dim: int, act_dim: int, deter: int, stoch: int, hidden: int,
                 n_bins: int):
        super().__init__()
        feat = deter + stoch
        self.encoder = MLP(obs_dim, hidden, hidden)
        self.inp_proj = MLP(stoch + act_dim, hidden, hidden, layers=1)
        self.gru = GRUCell(hidden, deter)
        self.prior = MLP(deter, stoch, hidden, layers=1)
        self.post = MLP(deter + hidden, stoch, hidden, layers=1)
        self.decoder = MLP(feat, obs_dim, hidden)
        self.reward = MLP(feat, n_bins, hidden)
        self.cont = MLP(feat, 1, hidden)


class DreamerNets(nn.Module):
    """Every module of the algorithm in one tree, keyed as the reference's
    parameter tree (``wm``, ``actor``, ``critic``, ``slow_critic``), so the
    three optimizers slice it by top-level key. Parameters are empty until
    :meth:`init_params` or a load fills them."""

    def __init__(self, cfg: "DreamerV3Config", obs_dim: int, act_dim: int, discrete: bool):
        super().__init__()
        self.cfg = cfg
        self.obs_dim, self.act_dim, self.discrete = obs_dim, act_dim, discrete
        g, c, h = cfg.stoch_groups, cfg.stoch_classes, cfg.hidden_units
        self.stoch_dim = g * c
        self.feat_dim = cfg.deter_dim + self.stoch_dim
        self.wm = WorldModel(obs_dim, act_dim, cfg.deter_dim, self.stoch_dim, h, cfg.n_bins)
        self.actor = Actor(self.feat_dim, act_dim, discrete, h)
        self.critic = MLP(self.feat_dim, cfg.n_bins, h)
        self.slow_critic = MLP(self.feat_dim, cfg.n_bins, h).requires_grad_(False)
        self.register_buffer("bins", twohot_bins(cfg.n_bins), persistent=False)

    def init_params(self, seed: int) -> "DreamerNets":
        """The reference's initialisers, drawn on the host from ``seed``:
        Dense kernels and the GRU's input kernels truncated-normal with
        variance 1/fan-in (flax's ``lecun_normal``), the GRU's recurrent
        kernels orthogonal per gate, biases zero, LayerNorm scales one; the
        slow critic a copy of the critic."""
        g = torch.Generator().manual_seed(seed)

        def lecun_(kernel):
            nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=g)
            kernel.mul_(math.sqrt(1.0 / kernel.shape[0]) / _TRUNC_STD)

        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, Dense):
                    lecun_(module.kernel)
                    module.bias.zero_()
                elif isinstance(module, LayerNorm):
                    module.scale.fill_(1.0)
                    module.bias.zero_()
                elif isinstance(module, GRUCell):
                    for gate in module.kernel_i.data.chunk(3, 1):
                        lecun_(gate)
                    for gate in module.kernel_h.data.chunk(3, 1):
                        gate.copy_(nn.init.orthogonal_(torch.empty_like(gate), generator=g))
                    module.bias_i.zero_()
                    module.bias_hn.zero_()
            self.slow_critic.load_state_dict(self.critic.state_dict())
        return self

    # -- building blocks ------------------------------------------------------------

    def _seq_step(self, deter, stoch, action):
        """(h_{t-1}, z_{t-1}, a_{t-1}) -> h_t."""
        return self.wm.gru(self.wm.inp_proj(torch.cat([stoch, action], -1)), deter)

    def _logits(self, head_name: str, x: torch.Tensor) -> torch.Tensor:
        out = getattr(self.wm, head_name)(x)
        return out.reshape(*out.shape[:-1], self.cfg.stoch_groups, self.cfg.stoch_classes)

    def observe(self, obs_seq, action_seq, is_first_seq,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Sequence[torch.Tensor]] = None):
        """Filter a batch of sequences through the RSSM.

        obs_seq [B,T,D], action_seq [B,T,A] (a_{t-1}, the action that LED
        INTO obs_t), is_first_seq [B,T]. Returns (deter, post_logits,
        prior_logits, stoch), each [B,T,...]: a Python loop over T, then the
        prior head once over every step. ``draws[t]`` is step t's latent
        draw (:func:`categorical`), else it comes from ``generator``."""
        B, T = obs_seq.shape[:2]
        embed = self.wm.encoder(symlog(obs_seq))
        mask = (1.0 - is_first_seq.to(obs_seq.dtype))[..., None]
        deter = obs_seq.new_zeros(B, self.cfg.deter_dim)
        stoch = obs_seq.new_zeros(B, self.stoch_dim)
        deters, posts, stochs = [], [], []
        for t in range(T):
            m = mask[:, t]
            deter = self._seq_step(deter * m, stoch * m, action_seq[:, t] * m)
            post = self._logits("post", torch.cat([deter, embed[:, t]], -1))
            stoch = latent_sample(post, generator, None if draws is None else draws[t])
            deters.append(deter)
            posts.append(post)
            stochs.append(stoch)
        deter = torch.stack(deters, 1)
        return (deter, torch.stack(posts, 1), self._logits("prior", deter),
                torch.stack(stochs, 1))

    def _act(self, out, generator=None, draw=None):
        """An action from the actor's output, and the draw that made it:
        discrete a one-hot over the unimix policy (``draw`` as
        :func:`categorical`'s), continuous a tanh-squashed Gaussian sample
        in [-1, 1] (``draw`` its standard normal noise)."""
        if self.discrete:
            probs = _unimix_probs(out)
            return _onehot(categorical(torch.log(probs), generator, draw), probs), draw
        mean, log_std = out
        if draw is None:
            draw = torch.randn(mean.shape, generator=generator, device=mean.device,
                               dtype=mean.dtype)
        return squashed_sample_logp(mean, log_std, noise=draw)[0], draw

    def _logp_entropy(self, out, action, noise):
        """(log-prob, entropy) of ``action`` (discrete) or of the sample
        made from ``noise`` (continuous) under the actor's output."""
        if self.discrete:
            probs = _unimix_probs(out)
            logits = torch.log(probs)
            return torch.sum(action * logits, -1), -torch.sum(probs * logits, -1)
        mean, log_std = out
        logp = squashed_sample_logp(mean, log_std, noise=noise)[1]
        return logp, torch.sum(log_std + _HALF_LOG_2PIE, -1)

    def actor_sample(self, feat, generator: Optional[torch.Generator] = None,
                     draw: Optional[torch.Tensor] = None):
        """feat -> (action_repr, logp, entropy). Discrete: one-hot action;
        continuous: tanh-squashed sample in [-1, 1]."""
        out = self.actor(feat)
        action, draw = self._act(out, generator, draw)
        return (action, *self._logp_entropy(out, action, draw))

    def imagine(self, deter, stoch, horizon: int,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Sequence[Sequence[torch.Tensor]]] = None):
        """Roll the prior forward ``horizon`` steps from [N,...] start
        states, acting with the current actor. Returns feats [H+1,N,F],
        actions, logp and entropy [H,N,...]. The roll runs without autograd
        (feats and actions carry no gradient); logp and entropy come from
        one actor forward over the H imagined features and carry the
        actor's gradient, which is all the actor loss takes. ``draws[t]`` is
        step t's (action draw, latent draw), else both come from
        ``generator`` in that order."""
        feats, actions, noises = [], [], []
        with torch.no_grad():
            for t in range(horizon):
                a_draw, z_draw = (None, None) if draws is None else draws[t]
                feat = torch.cat([deter, stoch], -1)
                action, noise = self._act(self.actor(feat), generator, a_draw)
                deter = self._seq_step(deter, stoch, action)
                stoch = latent_sample(self._logits("prior", deter), generator, z_draw)
                feats.append(feat)
                actions.append(action)
                noises.append(noise)
            feats.append(torch.cat([deter, stoch], -1))
            feats = torch.stack(feats)
            actions = torch.stack(actions)
        noise = None if self.discrete else torch.stack(noises)
        logps, ents = self._logp_entropy(self.actor(feats[:horizon]), actions, noise)
        return feats, actions, logps, ents


# -- sequence replay buffer (the reference's, copied) -------------------------------


class SequenceReplayBuffer:
    """Per-env-slot ring buffers of transitions; samples contiguous [B, L]
    subsequences (reference role: dreamerv3/utils/episode_replay_buffer).

    Stored fields follow the ARRIVAL convention — step t describes arriving
    at obs_t: ``action[t]`` is a_{t-1} (the action that led INTO obs_t,
    matching what ``DreamerNets.observe`` and the runner's online filter
    feed the RSSM), ``reward[t]`` the reward collected on that transition,
    ``is_terminal[t]`` whether obs_t is a true terminal state (the runner
    records the pre-auto-reset observation so the continue head sees real
    terminals), ``is_first[t]`` whether obs_t starts a fresh episode."""

    def __init__(self, capacity: int, num_slots: int, obs_dim: int, act_dim: int):
        per = max(capacity // max(num_slots, 1), 1)
        self._per = per
        self._obs = np.zeros((num_slots, per, obs_dim), np.float32)
        self._act = np.zeros((num_slots, per, act_dim), np.float32)
        self._rew = np.zeros((num_slots, per), np.float32)
        self._first = np.zeros((num_slots, per), bool)
        self._term = np.zeros((num_slots, per), bool)
        self._pos = np.zeros(num_slots, np.int64)  # total appended per slot

    def add(self, slot_ids, sequences) -> int:
        """Append per-lane step sequences (dicts of [T_i, ...] arrays —
        lanes differ in length because terminal arrivals add a record);
        slot_ids maps each sequence to its buffer slot."""
        for slot, seq in zip(slot_ids, sequences):
            T = len(seq["reward"])
            if T == 0:
                continue
            # if a single append exceeds the ring, only the tail survives
            if T > self._per:
                seq = {k: v[-self._per:] for k, v in seq.items()}
                self._pos[slot] += T - self._per
                T = self._per
            idx = (self._pos[slot] + np.arange(T)) % self._per
            self._obs[slot, idx] = seq["obs"]
            self._act[slot, idx] = seq["action"]
            self._rew[slot, idx] = seq["reward"]
            self._first[slot, idx] = seq["is_first"]
            self._term[slot, idx] = seq["is_terminal"]
            self._pos[slot] += T
        return int(self.size())

    def size(self) -> int:
        return int(np.minimum(self._pos, self._per).sum())

    def sample(self, batch_size: int, seq_len: int, seed: int):
        """[B, L] contiguous subsequences; a sampled window may cross an
        episode boundary — is_first flags let the RSSM reset mid-window."""
        rng = np.random.default_rng(seed)
        fill = np.minimum(self._pos, self._per)
        ok = np.nonzero(fill >= seq_len)[0]
        if len(ok) == 0:
            return None
        out = {k: [] for k in ("obs", "action", "reward", "is_first", "is_terminal")}
        for _ in range(batch_size):
            slot = int(rng.choice(ok))
            n = int(fill[slot])
            start = int(rng.integers(0, n - seq_len + 1))
            # oldest valid index in ring order
            base = self._pos[slot] % self._per if self._pos[slot] >= self._per else 0
            idx = (base + start + np.arange(seq_len)) % self._per
            out["obs"].append(self._obs[slot, idx])
            out["action"].append(self._act[slot, idx])
            out["reward"].append(self._rew[slot, idx])
            out["is_first"].append(self._first[slot, idx])
            out["is_terminal"].append(self._term[slot, idx])
        return {k: np.stack(v) for k, v in out.items()}


# -- rollout runner --------------------------------------------------------------------


class DreamerRunner:
    """Env runner on the host that acts from the RSSM posterior of a CPU
    copy of the world model and actor, carrying the latent state (deter,
    stoch, prev action) across steps; its draws come from a torch generator
    seeded ``seed``."""

    def __init__(self, env_spec, env_config, num_envs, rollout_len, seed, net_kwargs):
        factory = make_env(env_spec, env_config)
        self._vec = VectorEnv([factory for _ in range(num_envs)])
        obs_dim, act_dim, discrete = space_dims(self._vec.observation_space,
                                                self._vec.action_space)
        cfg = DreamerV3Config()
        for k, v in net_kwargs.items():
            setattr(cfg, k, v)
        self.nets = DreamerNets(cfg, obs_dim, act_dim, discrete).init_params(seed)
        self.nets.requires_grad_(False)
        self._rollout_len = rollout_len
        self._generator = torch.Generator().manual_seed(seed)
        self._obs = self._encode(self._vec.reset(seed=seed))
        n = num_envs
        self._deter = torch.zeros(n, cfg.deter_dim)
        self._stoch = torch.zeros(n, self.nets.stoch_dim)
        self._prev_act = np.zeros((n, act_dim), np.float32)
        self._is_first = np.ones(n, bool)
        if not discrete:
            space = self._vec.action_space
            self._act_low = np.asarray(space.low, np.float32)
            self._act_high = np.asarray(space.high, np.float32)
        self._prev_rew = np.zeros(n, np.float32)
        self._ep_ret = np.zeros(n, np.float32)
        self._ep_len = np.zeros(n, np.int64)

    def _encode(self, obs) -> np.ndarray:
        return encode_obs(self._vec.observation_space, obs)

    def _step(self, obs: np.ndarray) -> torch.Tensor:
        """One posterior filter step and an action; the latent draw first,
        then the action's, as the reference splits its key."""
        nets = self.nets
        mask = torch.from_numpy(1.0 - self._is_first.astype(np.float32))[:, None]
        prev_act = torch.from_numpy(self._prev_act) * mask
        deter = nets._seq_step(self._deter * mask, self._stoch * mask, prev_act)
        embed = nets.wm.encoder(symlog(torch.from_numpy(obs)))
        post = nets._logits("post", torch.cat([deter, embed], -1))
        self._stoch = latent_sample(post, self._generator)
        self._deter = deter
        action, _, _ = nets.actor_sample(torch.cat([deter, self._stoch], -1), self._generator)
        return action

    def sample(self, params: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
        """Roll ``rollout_len`` steps; emit per-lane ARRIVAL-convention
        sequences (see SequenceReplayBuffer). Each env step appends one
        arrival record per lane; episode ends append a second record for
        the terminal arrival (the pre-auto-reset observation), so lane
        sequence lengths differ. ``params``: host copies of ``wm`` and
        ``actor``."""
        params = resolve_params(params)
        self.nets.wm.load_state_dict(params["wm"])
        self.nets.actor.load_state_dict(params["actor"])
        n = self._vec.num_envs
        lanes: List[Dict[str, List]] = [
            {k: [] for k in ("obs", "action", "reward", "is_first", "is_terminal")}
            for _ in range(n)
        ]

        def record(i, obs, action, reward, first, terminal):
            lanes[i]["obs"].append(np.asarray(obs, np.float32))
            lanes[i]["action"].append(np.asarray(action, np.float32))
            lanes[i]["reward"].append(np.float32(reward))
            lanes[i]["is_first"].append(bool(first))
            lanes[i]["is_terminal"].append(bool(terminal))

        ep_returns, ep_lengths = [], []
        for _ in range(self._rollout_len):
            for i in range(n):  # arriving at obs_t via prev action/reward
                record(i, self._obs[i], self._prev_act[i], self._prev_rew[i],
                       self._is_first[i], False)
            with torch.inference_mode():
                a = self._step(self._obs.astype(np.float32)).numpy()
            if self.nets.discrete:
                env_a = np.argmax(a, -1)
            else:
                env_a = self._act_low + (a + 1.0) * 0.5 * (self._act_high - self._act_low)
            next_obs, rewards, terms, truncs = self._vec.step(env_a)
            raw = self._encode(self._vec.last_raw_obs)  # pre-reset arrivals
            dones = terms | truncs
            self._ep_ret += rewards
            self._ep_len += 1
            for i in np.nonzero(dones)[0]:
                # terminal/truncation arrival: the obs auto-reset discarded
                record(i, raw[i], a[i], rewards[i], False, terms[i])
                ep_returns.append(float(self._ep_ret[i]))
                ep_lengths.append(int(self._ep_len[i]))
                self._ep_ret[i] = 0.0
                self._ep_len[i] = 0
            self._prev_act = np.where(dones[:, None], 0.0, a).astype(np.float32)
            self._prev_rew = np.where(dones, 0.0, rewards).astype(np.float32)
            self._is_first = dones  # VectorEnv auto-resets
            self._obs = self._encode(next_obs)
        return {
            "sequences": [{k: np.asarray(v) for k, v in lane.items()} for lane in lanes],
            "episode_returns": ep_returns,
            "episode_lengths": ep_lengths,
        }

    def stop(self):
        self._vec.close()
        return True


# -- config + algorithm -------------------------------------------------------------------


class DreamerV3Config(AlgorithmConfig):
    """The reference's DreamerV3Config, field for field."""

    def __init__(self):
        super().__init__()
        self.num_env_runners = 1
        self.num_envs_per_runner = 1
        self.rollout_len = 64
        # world model
        self.deter_dim = 256
        self.stoch_groups = 16
        self.stoch_classes = 16
        self.hidden_units = 256
        self.n_bins = 41
        # training
        self.seq_len = 16
        self.batch_size = 8
        self.buffer_capacity = 100_000
        self.learning_starts = 256
        self.horizon = 15
        self.gamma = 0.997
        self.gae_lambda = 0.95
        self.world_lr = 4e-4
        self.actor_lr = 1e-4
        self.critic_lr = 1e-4
        self.entropy_coef = 3e-4
        self.free_nats = 1.0
        self.dyn_scale = 0.5
        self.rep_scale = 0.1
        self.slow_critic_decay = 0.98
        self.slow_reg_coef = 1.0
        self.retnorm_decay = 0.99
        self.grad_clip = 100.0

    def _net_kwargs(self) -> Dict[str, Any]:
        return {k: getattr(self, k)
                for k in ("deter_dim", "stoch_groups", "stoch_classes", "hidden_units",
                          "n_bins")}


class DreamerV3:
    """DreamerV3 with host env runners and sequence buffer, and a learner on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, config: DreamerV3Config, device: DeviceLike = None):
        if config.env_spec is None:
            raise ValueError("config.environment(...) is required")
        self.config = config
        self.iteration = 0
        obs_space, act_space = probe_spaces(config)
        obs_dim, act_dim, discrete = space_dims(obs_space, act_space)
        self._obs_space = obs_space
        if not discrete:
            self._act_low = np.asarray(act_space.low, np.float32)
            self._act_high = np.asarray(act_space.high, np.float32)
        self.device = resolve_device(device)
        self.nets = DreamerNets(config, obs_dim, act_dim, discrete).init_params(
            config.seed).to(self.device)
        self.opt = {name: adam_init(dict(getattr(self.nets, name).named_parameters()))
                    for name in ("wm", "actor", "critic")}
        # EMA of the imagined-return percentile range (actor normalizer)
        self.retnorm = torch.tensor(1.0, device=self.device)
        total_slots = config.num_env_runners * config.num_envs_per_runner
        self.buffer = SequenceReplayBuffer(config.buffer_capacity, total_slots, obs_dim,
                                           act_dim)
        self._broadcaster = broadcaster_for(config)
        self.runners = [
            DreamerRunner(config.env_spec, config.env_config, config.num_envs_per_runner,
                          config.rollout_len, config.seed + 1000 * (i + 1),
                          config._net_kwargs())
            for i in range(config.num_env_runners)
        ]
        self._ep_return_window: List[float] = []
        self._snapshot: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        #: host seconds of the last iteration's parts: sampling, the
        #: buffer's adds and draw, the learner's update (ending with the
        #: stats' copy to the host)
        self.timers: Dict[str, float] = {}

    def _dtype(self) -> torch.dtype:
        return self.nets.wm.gru.kernel_i.dtype

    # -- the update -------------------------------------------------------------------

    def _world_loss(self, batch: Dict[str, torch.Tensor], generator=None, draws=None):
        """(loss, deter, stoch, stats) of the world model on ``batch``."""
        cfg, nets = self.config, self.nets
        deter, post, prior, stoch = nets.observe(batch["obs"], batch["action"],
                                                 batch["is_first"], generator, draws)
        feat = torch.cat([deter, stoch], -1)
        obs_hat = nets.wm.decoder(feat)
        recon = torch.sum((obs_hat - symlog(batch["obs"])) ** 2, -1)
        rew_loss = twohot_loss(nets.wm.reward(feat), batch["reward"], nets.bins)
        cont_logit = nets.wm.cont(feat)[..., 0]
        cont_target = 1.0 - batch["is_terminal"].to(cont_logit.dtype)
        cont_loss = log_sigmoid_bce(cont_logit, cont_target)
        # KL balancing with free bits
        dyn = torch.clamp(latent_kl(post.detach(), prior), min=cfg.free_nats)
        rep = torch.clamp(latent_kl(post, prior.detach()), min=cfg.free_nats)
        loss = torch.mean(recon + rew_loss + cont_loss + cfg.dyn_scale * dyn
                          + cfg.rep_scale * rep)
        stats = [loss, recon.mean(), rew_loss.mean(), cont_loss.mean(), dyn.mean(), rep.mean()]
        return loss, deter, stoch, stats

    def _lambda_returns(self, reward, cont, value):
        """reward/cont/value [H+1, N] (index 0 = imagination start); returns
        lambda-returns [H, N] for steps 0..H-1: ``ret_t = r_{t+1} +
        d_{t+1} ((1 - λ) v_{t+1} + λ ret_{t+1})`` from ``ret_H = v_H``, as a
        loop of one ``addcmul`` a step."""
        cfg = self.config
        disc = cont[1:] * cfg.gamma
        base = reward[1:] + disc * ((1.0 - cfg.gae_lambda) * value[1:])
        coef = disc * cfg.gae_lambda
        ret = value[-1]
        rets = []
        for t in range(len(base) - 1, -1, -1):
            ret = torch.addcmul(base[t], coef[t], ret)
            rets.append(ret)
        return torch.stack(rets[::-1])

    def _actor_loss(self, start_deter, start_stoch, generator=None, draws=None):
        """The actor's loss over imagination from the start states, and
        what the critic step and the stats take from it."""
        cfg, nets = self.config, self.nets
        H = cfg.horizon
        feats, _, logps, ents = nets.imagine(start_deter, start_stoch, H, generator, draws)
        with torch.no_grad():
            reward = twohot_decode(nets.wm.reward(feats), nets.bins)
            cont = torch.sigmoid(nets.wm.cont(feats)[..., 0])
            value = twohot_decode(nets.critic(feats), nets.bins)
            rets = self._lambda_returns(reward, cont, value)  # [H, N]
            # imagined-trajectory weights: product of predicted continues
            weight = torch.cumprod(torch.cat([torch.ones_like(cont[:1]), cont[:-1]], 0), 0)[:H]
            # percentile return normalization (jnp.percentile's linear
            # interpolation): this batch's 5..95 range folded into the EMA
            q = torch.quantile(rets.reshape(-1),
                               torch.tensor([0.05, 0.95], dtype=rets.dtype, device=rets.device),
                               interpolation="linear")
            retnorm = cfg.retnorm_decay * self.retnorm + (1.0 - cfg.retnorm_decay) * (q[1] - q[0])
            adv = (rets - value[:H]) / torch.clamp(retnorm, min=1.0)
        loss = -torch.mean(weight * (adv * logps + cfg.entropy_coef * ents))
        return loss, feats[:H], rets, weight, retnorm, ents.detach().mean(), rets.mean()

    def _critic_loss(self, feats, rets, weight):
        """Two-hot CE of the critic to the λ-returns, plus the slow-critic
        regulariser, weighted."""
        nets = self.nets
        logits = nets.critic(feats)
        ce = twohot_loss(logits, rets, nets.bins)
        with torch.no_grad():
            slow_probs = torch.softmax(nets.slow_critic(feats), -1)
        reg = -torch.sum(slow_probs * torch.log_softmax(logits, -1), -1)
        return torch.mean(weight * (ce + self.config.slow_reg_coef * reg))

    def _update(self, batch: Dict[str, np.ndarray], draws: Optional[Dict[str, Any]] = None):
        """One update on ``batch`` ([B, T, ...] numpy, one copy to the
        device), the reference's ``_update_impl`` step for step; the stats in
        ``STAT_KEYS`` order, on the device. ``draws`` ({"observe": T latent
        draws, "imagine": H (action, latent) draw pairs}, tensors or numpy)
        replaces the generator seeded ``seed + iteration`` on the learner's
        device."""
        cfg, nets = self.config, self.nets
        dtype = self._dtype()
        b = to_device(batch, self.device, dtype)
        generator, obs_draws, im_draws = None, None, None
        if draws is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(cfg.seed + self.iteration)
        else:
            obs_draws = [self._draw(d, dtype) for d in draws["observe"]]
            im_draws = [[self._draw(d, dtype) for d in pair] for pair in draws["imagine"]]

        # 1) world model step
        loss, deter, stoch, stats = self._world_loss(b, generator, obs_draws)
        minimize_(loss, list(nets.wm.parameters()), self.opt["wm"], cfg.world_lr,
                  cfg.grad_clip)

        # 2) imagination from every posterior state (gradients cut), actor step
        start_deter = deter.detach().reshape(-1, deter.shape[-1])
        start_stoch = stoch.detach().reshape(-1, stoch.shape[-1])
        actor_loss, feats, rets, weight, self.retnorm, ent_mean, ret_mean = self._actor_loss(
            start_deter, start_stoch, generator, im_draws)
        minimize_(actor_loss, list(nets.actor.parameters()), self.opt["actor"], cfg.actor_lr,
                  cfg.grad_clip)

        # 3) critic step, then the slow critic's EMA toward the new critic
        critic_loss = self._critic_loss(feats, rets, weight)
        minimize_(critic_loss, list(nets.critic.parameters()), self.opt["critic"],
                  cfg.critic_lr, cfg.grad_clip)
        with torch.no_grad():
            polyak_(list(nets.slow_critic.parameters()), list(nets.critic.parameters()),
                    1.0 - cfg.slow_critic_decay)
        self._snapshot = None
        return torch.stack([*(s.detach() for s in stats), actor_loss.detach(),
                            critic_loss.detach(), ent_mean, ret_mean, self.retnorm])

    def _draw(self, draw, dtype) -> torch.Tensor:
        t = torch.as_tensor(np.array(draw))
        return t.to(self.device, dtype if t.is_floating_point() else None)

    def get_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """A host copy of the world model and actor (what the runners act
        with), made once per change."""
        if self._snapshot is None:
            self._snapshot = {name: host_copy(dict(getattr(self.nets, name).named_parameters()))
                              for name in ("wm", "actor")}
        return self._snapshot

    # -- training loop ------------------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        # runners only act: ship wm + actor, not the critic heads
        params_handle = self._broadcaster.handle(self.get_params())
        rollouts = [r.sample(params_handle) for r in self.runners]
        t1 = time.perf_counter()
        ep_returns: List[float] = []
        buffer_size = self.buffer.size()
        for i, ro in enumerate(rollouts):
            slots = list(range(i * cfg.num_envs_per_runner, (i + 1) * cfg.num_envs_per_runner))
            buffer_size = self.buffer.add(slots, ro["sequences"])
            ep_returns.extend(ro["episode_returns"])
        batch = None
        if buffer_size >= cfg.learning_starts:
            batch = self.buffer.sample(cfg.batch_size, cfg.seq_len,
                                       seed=cfg.seed + self.iteration * 997)
        t2 = time.perf_counter()
        stats: Dict[str, float] = {}
        if batch is not None:
            stats = dict(zip(STAT_KEYS, self._update(batch).tolist()))
        t3 = time.perf_counter()
        self.timers = {"sample_s": t1 - t0, "buffer_s": t2 - t1, "learn_s": t3 - t2}
        self.iteration += 1
        self._ep_return_window.extend(ep_returns)
        self._ep_return_window = self._ep_return_window[-100:]
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(self._ep_return_window))
                                    if self._ep_return_window else float("nan")),
            "num_episodes": len(ep_returns),
            "buffer_size": buffer_size,
            "num_env_steps_sampled": sum(len(seq["reward"]) for ro in rollouts
                                         for seq in ro["sequences"]),
            "time_this_iter_s": t3 - t0,
            **stats,
        }

    # -- checkpointing / inference ----------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": host_copy(dict(self.nets.named_parameters())),
            "opt": {name: adam_state_dict(s) for name, s in self.opt.items()},
            "retnorm": self.retnorm.detach().to("cpu", copy=True),
            "iteration": self.iteration,
        }

    def load_state_dict(self, state: Dict[str, Any]):
        """Every parameter (the slow critic's included), the three Adam
        states, ``retnorm`` and the iteration from :meth:`state_dict`;
        tensors keep their dtype."""
        load_module(self.nets, state["params"], self.device)
        self.nets.slow_critic.requires_grad_(False)
        self.opt = {name: load_adam_state(state["opt"][name],
                                          module_names(getattr(self.nets, name)), self.device)
                    for name in ("wm", "actor", "critic")}
        self.retnorm = state["retnorm"].to(self.device, copy=True)
        self.iteration = state["iteration"]
        self._snapshot = None

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        torch.save(self.state_dict(), os.path.join(checkpoint_dir, "dreamer_state.pt"))
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        self.load_state_dict(torch.load(os.path.join(checkpoint_dir, "dreamer_state.pt"),
                                        map_location="cpu", weights_only=True))

    def compute_single_action(self, obs, draw: Optional[torch.Tensor] = None):
        """One-step filter from an empty latent state (no carried context;
        for sustained rollouts use a DreamerRunner, which carries state).
        The latent draw is ``draw`` (as :func:`categorical`'s) or comes from
        a generator seeded 0; the action is the mode (argmax, or tanh of
        the mean rescaled into the env's Box)."""
        nets = self.nets
        dtype = self._dtype()
        x = torch.as_tensor(encode_obs(self._obs_space, np.asarray(obs)[None]))
        x = x.to(self.device, dtype)
        with torch.no_grad():
            zero = x.new_zeros
            deter = nets._seq_step(zero(1, self.config.deter_dim), zero(1, nets.stoch_dim),
                                   zero(1, nets.act_dim))
            post = nets._logits("post", torch.cat([deter, nets.wm.encoder(symlog(x))], -1))
            generator = None
            if draw is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            else:
                draw = self._draw(draw, dtype)
            stoch = latent_sample(post, generator, draw)
            out = nets.actor(torch.cat([deter, stoch], -1))
        if nets.discrete:
            return int(torch.argmax(out, -1)[0])
        a = torch.tanh(out[0]).float().cpu().numpy()[0]
        # same [-1,1] -> Box rescaling the rollout runners apply
        return self._act_low + (a + 1.0) * 0.5 * (self._act_high - self._act_low)

    def stop(self):
        for r in self.runners:
            r.stop()
        self.runners = []


DreamerV3Config.algo_class = DreamerV3
