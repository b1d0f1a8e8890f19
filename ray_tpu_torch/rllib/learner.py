"""PPOLearner: PPO updates on the card, the port of ray_tpu/rllib/learner.py.

The reference compiles all epochs of minibatch updates into one jitted
``lax.scan``. PyTorch has no scan: here the same update is an eager loop on
the learner's device. Each epoch gathers the shuffled batch once, then each
minibatch takes the clipped-surrogate + value + entropy loss, its gradients
(``torch.autograd.grad``), optax's ``clip_by_global_norm`` and optax's Adam,
both written out as multi-tensor (``torch._foreach_*``) ops in the
module-level :func:`clip_by_global_norm_` and :func:`adam_step_`, which every
learner of the package shares (each keeps its own :func:`adam_init` state
per optimizer). The loop never
waits for the device: the per-minibatch stats stay there until the update
ends, and are then averaged over minibatches, then over epochs, and copied
to the host once.

The optimizer is ``optax.chain(clip_by_global_norm(max_grad_norm),
adam(lr))`` step for step: the gradients are scaled by ``max_norm / norm``
only when ``norm >= max_norm`` (``clip_grad_norm_`` would divide by
``norm + 1e-6``), and Adam's eps is added outside the square root of the
bias-corrected second moment (eps_root 0), with no weight decay.

Shuffles come from ``torch.randperm`` with the learner's own host
generator, so the card and the host draw the same permutations; ``update``
also takes them from its caller (``perms=``), which is how the tests hand in
the reference's ``jax.random.permutation`` rows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._internal.device import DeviceLike, resolve_device
from .models import init_actor_critic, log_prob_entropy

STAT_KEYS = ("policy_loss", "vf_loss", "entropy", "total_loss")
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


# -- optax's clip_by_global_norm and adam, shared by every learner -----------


def adam_init(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """optax.adam's state for ``params``: zero moments beside each tensor, in
    its dtype on its device, and a step count of 0."""
    return {
        "mu": {k: torch.zeros_like(p) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        "count": 0,
    }


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: t if norm < max_norm, else
    (t / norm) * max_norm. The norm stays on the device: no sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


def adam_step_(params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any], lr: float) -> None:
    """One optax.adam step in place over ``params`` (the order of
    ``state``'s moment dicts): biased moments, bias-corrected, eps outside
    the root, no weight decay. Call under ``torch.no_grad()``."""
    mu = list(state["mu"].values())
    nu = list(state["nu"].values())
    state["count"] += 1
    count = state["count"]
    torch._foreach_mul_(mu, _ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1 - _ADAM_B1)
    torch._foreach_mul_(nu, _ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - _ADAM_B2)
    mu_hat = torch._foreach_div(mu, 1 - _ADAM_B1 ** count)
    root = torch._foreach_div(nu, 1 - _ADAM_B2 ** count)
    torch._foreach_sqrt_(root)
    torch._foreach_add_(root, _ADAM_EPS)
    torch._foreach_div_(mu_hat, root)
    torch._foreach_add_(params, mu_hat, alpha=-lr)


def minimize_(loss: torch.Tensor, params: List[torch.Tensor], state: Dict[str, Any],
              lr: float, max_grad_norm: Optional[float] = None) -> None:
    """The gradients of ``loss`` w.r.t. ``params`` alone (a parameter the
    loss does not reach gets a zero gradient, as under ``jax.grad``), clipped
    to ``max_grad_norm`` if given, then one :func:`adam_step_`."""
    grads = list(torch.autograd.grad(loss, params, allow_unused=True,
                                     materialize_grads=True))
    with torch.no_grad():
        if max_grad_norm is not None:
            clip_by_global_norm_(grads, max_grad_norm)
        adam_step_(params, grads, state, lr)


def polyak_(targets: List[torch.Tensor], params: List[torch.Tensor], tau: float) -> None:
    """``t = (1 - tau) * t + tau * p`` in place, the reference's form (each
    product rounded, then the sum). Call under ``torch.no_grad()``."""
    torch._foreach_mul_(targets, 1.0 - tau)
    torch._foreach_add_(targets, torch._foreach_mul(params, tau))


def to_device(arrays: Dict[str, np.ndarray], device: torch.device,
              dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Numpy arrays as tensors on ``device``, floating ones in ``dtype``
    (the learner's), integer ones as they are."""
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, dtype if t.is_floating_point() else None)
    return out


def load_module(module: torch.nn.Module, params: Dict[str, torch.Tensor],
                device: torch.device) -> None:
    """``params`` into ``module`` on ``device``, each with the dtype it comes
    with (as ``jax.device_put`` keeps it)."""
    module.load_state_dict(
        {k: torch.as_tensor(v).to(device, copy=True) for k, v in params.items()}, assign=True)


def module_names(module: torch.nn.Module) -> List[str]:
    """``module``'s parameter names in the order :func:`adam_step_` zips."""
    return [k for k, _ in module.named_parameters()]


def host_copy(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A host copy of a dict of tensors (a checkpoint's leaves)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def adam_state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
    """A host copy of an :func:`adam_init` state."""
    return {"mu": host_copy(state["mu"]), "nu": host_copy(state["nu"]),
            "count": state["count"]}


def load_adam_state(state: Dict[str, Any], names: List[str],
                    device: torch.device) -> Dict[str, Any]:
    """An :func:`adam_init` state from :func:`adam_state_dict`'s output, on
    ``device``, its moments in the order of ``names`` (the order
    :func:`adam_step_` zips with the parameters)."""
    return {
        "mu": {k: state["mu"][k].to(device, copy=True) for k in names},
        "nu": {k: state["nu"][k].to(device, copy=True) for k in names},
        "count": int(state["count"]),
    }


class PPOLearner:
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        discrete: bool,
        *,
        lr: float = 3e-4,
        clip_param: float = 0.2,
        vf_coeff: float = 0.5,
        entropy_coeff: float = 0.01,
        num_epochs: int = 4,
        minibatch_size: int = 128,
        max_grad_norm: float = 0.5,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.model = init_actor_critic(obs_dim, action_dim, discrete, seed, self.device)
        self.opt_state = adam_init(dict(self.model.named_parameters()))
        self.lr = lr
        self.clip_param = clip_param
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.num_epochs = num_epochs
        self.minibatch_size = minibatch_size
        self.max_grad_norm = max_grad_norm
        self.discrete = discrete
        self._generator = torch.Generator().manual_seed(seed + 1)
        self._snapshot: Optional[Dict[str, torch.Tensor]] = None

    # -- loss ---------------------------------------------------------------

    def _loss(self, batch: Dict[str, torch.Tensor]):
        """(total loss, stats stacked in ``STAT_KEYS`` order) of one batch."""
        out, values = self.model(batch["obs"])
        logp, entropy = log_prob_entropy(self.discrete, out, batch["actions"])
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - self.clip_param, 1 + self.clip_param) * adv
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        vf_loss = torch.mean((values - batch["returns"]) ** 2)
        ent = torch.mean(entropy)
        total = pg_loss + self.vf_coeff * vf_loss - self.entropy_coeff * ent
        return total, torch.stack([pg_loss, vf_loss, ent, total])

    # -- one minibatch step: gradients, clip, Adam ----------------------------

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        params = list(self.model.parameters())
        total, stats = self._loss(batch)
        grads = list(torch.autograd.grad(total, params))
        with torch.no_grad():
            clip_by_global_norm_(grads, self.max_grad_norm)
            adam_step_(params, grads, self.opt_state, self.lr)
        return stats.detach()

    # -- public -------------------------------------------------------------

    def update(self, train_batch: Dict[str, np.ndarray], *,
               perms: Optional[Any] = None) -> Dict[str, float]:
        """train_batch: flat [B, ...] numpy arrays (obs, actions, logp_old,
        advantages, returns); advantages standardized here, on the host.
        ``perms`` ([num_epochs, n_mb * mb] row indices) replaces the
        learner's own shuffles."""
        adv = train_batch["advantages"]
        train_batch = dict(train_batch)
        train_batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        batch = to_device(train_batch, self.device, next(self.model.parameters()).dtype)
        B = batch["obs"].shape[0]
        mb = min(self.minibatch_size, B)
        n_mb = B // mb
        shape = (self.num_epochs, n_mb * mb)
        if perms is None:
            perms = torch.stack([
                torch.randperm(B, generator=self._generator)[: n_mb * mb]
                for _ in range(self.num_epochs)
            ])
        else:
            perms = torch.as_tensor(np.asarray(perms), dtype=torch.int64)
            if perms.numel() != shape[0] * shape[1]:
                raise ValueError(f"perms of shape {tuple(perms.shape)}: want {shape}")
            perms = perms.reshape(shape)
        perms = perms.to(self.device)
        stats: List[torch.Tensor] = []
        for e in range(self.num_epochs):
            shuffled = {k: v[perms[e]] for k, v in batch.items()}
            for i in range(n_mb):
                rows = slice(i * mb, (i + 1) * mb)
                stats.append(self._step({k: v[rows] for k, v in shuffled.items()}))
        self._snapshot = None
        means = torch.stack(stats).view(self.num_epochs, n_mb, -1).mean(1).mean(0)
        return dict(zip(STAT_KEYS, means.tolist()))

    def get_params(self) -> Dict[str, torch.Tensor]:
        """A host copy of the parameters, made once per change of them."""
        if self._snapshot is None:
            self._snapshot = {
                k: p.detach().to("cpu", copy=True) for k, p in self.model.named_parameters()
            }
        return self._snapshot

    def set_params(self, params: Dict[str, torch.Tensor]):
        """Parameters from ``params``, on the learner's device, each with the
        dtype it comes with (as ``jax.device_put`` keeps it)."""
        load_module(self.model, params, self.device)
        self._snapshot = None

    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": host_copy(dict(self.model.named_parameters())),
            "opt_state": adam_state_dict(self.opt_state),
        }

    def load_state_dict(self, state: Dict[str, Any]):
        self.set_params(state["params"])
        self.opt_state = load_adam_state(state["opt_state"], module_names(self.model),
                                         self.device)
