"""PPOLearner: PPO updates on the card, the port of ray_tpu/rllib/learner.py.

The reference compiles all epochs of minibatch updates into one jitted
``lax.scan``. PyTorch has no scan: here the same update is an eager loop on
the learner's device. Each epoch gathers the shuffled batch once, then each
minibatch takes the clipped-surrogate + value + entropy loss, its gradients
(``torch.autograd.grad``), optax's ``clip_by_global_norm`` and optax's Adam,
both written out as multi-tensor (``torch._foreach_*``) ops. The loop never
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
        self.opt_state = {
            "mu": {k: torch.zeros_like(p) for k, p in self.model.named_parameters()},
            "nu": {k: torch.zeros_like(p) for k, p in self.model.named_parameters()},
            "count": 0,
        }
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
            # optax.clip_by_global_norm: t if norm < max_norm, else
            # (t / norm) * max_norm
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.max_grad_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_grad_norm))
            # optax.adam: biased moments, bias-corrected, eps outside the root
            mu = list(self.opt_state["mu"].values())
            nu = list(self.opt_state["nu"].values())
            self.opt_state["count"] += 1
            count = self.opt_state["count"]
            torch._foreach_mul_(mu, _ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1 - _ADAM_B1)
            torch._foreach_mul_(nu, _ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - _ADAM_B2)
            mu_hat = torch._foreach_div(mu, 1 - _ADAM_B1 ** count)
            root = torch._foreach_div(nu, 1 - _ADAM_B2 ** count)
            torch._foreach_sqrt_(root)
            torch._foreach_add_(root, _ADAM_EPS)
            torch._foreach_div_(mu_hat, root)
            torch._foreach_add_(params, mu_hat, alpha=-self.lr)
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
        dtype = next(self.model.parameters()).dtype
        batch = {}
        for k, v in train_batch.items():
            t = torch.as_tensor(np.asarray(v))
            batch[k] = t.to(self.device, dtype if t.is_floating_point() else None)
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
        self.model.load_state_dict(
            {k: torch.as_tensor(v).to(self.device, copy=True) for k, v in params.items()},
            assign=True,
        )
        self._snapshot = None

    def state_dict(self) -> Dict[str, Any]:
        def host(tree):
            return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}

        return {
            "params": host(dict(self.model.named_parameters())),
            "opt_state": {
                "mu": host(self.opt_state["mu"]),
                "nu": host(self.opt_state["nu"]),
                "count": self.opt_state["count"],
            },
        }

    def load_state_dict(self, state: Dict[str, Any]):
        self.set_params(state["params"])
        opt = state["opt_state"]
        names = [k for k, _ in self.model.named_parameters()]  # the order _step zips
        self.opt_state = {
            "mu": {k: opt["mu"][k].to(self.device, copy=True) for k in names},
            "nu": {k: opt["nu"][k].to(self.device, copy=True) for k in names},
            "count": int(opt["count"]),
        }
