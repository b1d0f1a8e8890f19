"""ResNet via DataParallelTrainer: the port of
ray_tpu/train/examples/resnet.py (BASELINE.json configs[1], "ResNet-50
ImageNet via DataParallelTrainer").

Each step is :func:`train_step`: the forward in train mode (cuDNN
convolutions over channels_last bf16 activations, flax's BatchNorm, which
updates the running statistics in place), ``cross_entropy``,
``loss.backward()`` and SGD with momentum 0.9 over every parameter
(``optax.sgd(lr, momentum=0.9)``: trace = g + 0.9 trace, p -= lr trace).
Data is synthetic, as in the reference.

``train_loop_config`` keys: model ("tiny" | "50"), image_size, epochs,
steps_per_epoch, batch_per_worker, lr, device (None means cuda). The
loop runs at one worker: the reference's data-parallel step computes
BatchNorm's batch statistics over the global batch in the graph, and a gang
of ranks each normalising its own shard would train another model. So at
world size > 1 the loop raises until a sync-BN is ported (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..._internal.device import resolve_device
from ...models.resnet import ResNet, ResNetConfig, build_resnet, cross_entropy, init_train_state
from .. import session
from ..config import RunConfig, ScalingConfig
from ..trainer import DataParallelTrainer


def model_config(config: dict) -> Tuple[ResNetConfig, int]:
    """The loop's config and image size: ResNet-50 at 224 for "50", else
    the tiny test model at 32."""
    if config.get("model") == "50":
        return ResNetConfig.resnet50(), config.get("image_size", 224)
    return ResNetConfig.tiny(), config.get("image_size", 32)


def sgd_model(
    cfg: ResNetConfig, device: torch.device, lr: float = 0.1
) -> Tuple[ResNet, torch.optim.SGD]:
    """A ResNet with the seed-0 initial state on ``device`` and SGD with
    momentum 0.9 (no dampening, no Nesterov, no weight decay) over every
    parameter."""
    params, stats = init_train_state(cfg, torch.Generator(device=device).manual_seed(0), device)
    model = build_resnet(cfg, params, stats)
    return model, torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)


def train_step(
    model: ResNet, optimizer: torch.optim.Optimizer, images: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """One step: train-mode forward (running statistics updated), loss,
    backward, SGD update. Returns the loss (detached, on the model's
    device)."""
    optimizer.zero_grad(set_to_none=True)
    loss = cross_entropy(model(images, train=True), labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def step_batch(
    cfg: ResNetConfig, batch: int, image_size: int, epoch: int, step: int, rank: int,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normal NHWC images (batch, image_size, image_size, 3) f32 and labels,
    seeded epoch*10_000 + step*100 + rank as the reference seeds its PRNG
    key (other bits than JAX's)."""
    gen = torch.Generator(device=device).manual_seed(epoch * 10_000 + step * 100 + rank)
    images = torch.randn((batch, image_size, image_size, 3), generator=gen, device=device)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen, device=device)
    return images, labels


def train_loop_per_worker(config: dict):
    ctx = session.get_context()
    if ctx.get_world_size() > 1:
        raise NotImplementedError(
            f"the ResNet loop at world size {ctx.get_world_size()} needs a sync-BN "
            "(BatchNorm statistics over the global batch, as the reference's in-graph "
            "BatchNorm computes them), which is not ported; run one worker"
        )
    rank = ctx.get_world_rank()
    device = resolve_device(config.get("device"))
    cfg, image_size = model_config(config)
    model, optimizer = sgd_model(cfg, device, lr=config.get("lr", 0.1))
    batch = config.get("batch_per_worker", 8)
    steps = config.get("steps_per_epoch", 4)
    for epoch in range(config.get("epochs", 2)):
        for step in range(steps):
            images, labels = step_batch(cfg, batch, image_size, epoch, step, rank, device)
            loss = train_step(model, optimizer, images, labels)
        session.report({"epoch": epoch, "loss": float(loss), "rank": rank})


def make_trainer(num_workers: int = 1, train_config: Optional[dict] = None) -> DataParallelTrainer:
    """The DataParallelTrainer of this example (reference: ``make_trainer``,
    whose TPU slice arguments have no counterpart)."""
    return DataParallelTrainer(
        train_loop_per_worker,
        train_loop_config=dict(train_config or {}),
        scaling_config=ScalingConfig(num_workers=num_workers),
        run_config=RunConfig(name="resnet"),
    )


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="tiny", choices=["tiny", "50"])
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args()
    result = make_trainer(
        train_config={"model": args.model, "epochs": args.epochs, "device": args.device}
    ).fit()
    if result.error is not None:
        raise SystemExit(f"training failed: {result.error}")
    print({"final": result.metrics})
