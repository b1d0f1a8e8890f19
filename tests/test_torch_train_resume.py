"""fit() resume and top-K checkpoint retention against ray_tpu.train.

The port's CheckpointManager and the reference's are driven through the
same report sequences (each in its own run directory): the checkpoints
each keeps on disk, its manifest, and its latest and best checkpoints must
be equal, by report index. A second fit() under one RunConfig(name=,
storage_path=) starts with get_checkpoint() set to the first run's last
checkpoint, as the reference's controller pushes it on every attempt.
"""

import json
import os

import pytest

from ray_tpu.train.checkpoint import Checkpoint as JaxCheckpoint
from ray_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from ray_tpu.train.checkpoint import load_latest_checkpoint as jax_load_latest
from ray_tpu.train.config import CheckpointConfig as JaxCheckpointConfig
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    CheckpointManager,
    RunConfig,
    TorchTrainer,
    get_checkpoint,
    load_latest_checkpoint,
    report,
)

# id: (CheckpointConfig kwargs, reports as (index, metrics)); a repeated
# index is another rank's report of the same checkpoint
_SEQUENCES = {
    "keep_all": (dict(), [(i, {"loss": 5 - i}) for i in range(4)]),
    "keep_2_newest": (dict(num_to_keep=2), [(i, {"loss": 5 - i}) for i in range(5)]),
    "keep_2_max_score": (
        dict(num_to_keep=2, checkpoint_score_attribute="acc"),
        [(0, {"acc": 0.5}), (1, {"acc": 0.9}), (2, {"acc": 0.1}), (3, {"acc": 0.7}),
         (4, {"acc": 0.2})],
    ),
    "keep_2_min_score": (
        dict(num_to_keep=2, checkpoint_score_attribute="loss",
             checkpoint_score_order="min"),
        [(0, {"loss": 3.0}), (1, {"loss": 1.0}), (2, {"loss": 2.0}), (3, {"loss": 4.0})],
    ),
    "missing_score_pruned_first": (
        dict(num_to_keep=2, checkpoint_score_attribute="acc"),
        [(0, {"acc": 0.1}), (1, {}), (2, {"acc": 0.3}), (3, {"acc": 0.2})],
    ),
    "same_index_merge": (
        dict(num_to_keep=1, checkpoint_score_attribute="acc"),
        [(0, {"acc": 0.2}), (1, {"loss": 1.0}), (1, {"acc": 0.9}), (0, {"acc": 0.95}),
         (2, {"acc": 0.1})],
    ),
    "keep_1": (dict(num_to_keep=1), [(i, {}) for i in range(3)]),
}


def _drive(manager_cls, checkpoint_cls, config, run_dir, reports):
    manager = manager_cls(str(run_dir), config)
    for index, metrics in reports:
        path = run_dir / f"checkpoint_{index:06d}"
        path.mkdir(parents=True, exist_ok=True)
        (path / "state.txt").write_text(str(index))
        manager.register(checkpoint_cls(str(path)), index, metrics)
    with open(run_dir / "checkpoint_manifest.json") as f:
        manifest = json.load(f)

    def name(ckpt):
        return None if ckpt is None else os.path.basename(ckpt.path)

    return {
        "on_disk": sorted(p.name for p in run_dir.iterdir() if p.name.startswith("checkpoint_0")),
        "manifest": [(os.path.basename(c["path"]), c["index"], c["metrics"])
                     for c in manifest["checkpoints"]],
        "manifest_latest": os.path.basename(manifest["latest"]),
        "latest": name(manager.latest_checkpoint),
        "best": name(manager.best_checkpoint),
    }


@pytest.mark.parametrize("case", list(_SEQUENCES))
def test_checkpoint_manager_keeps_what_the_reference_keeps(case, tmp_path):
    kwargs, reports = _SEQUENCES[case]
    want = _drive(JaxCheckpointManager, JaxCheckpoint, JaxCheckpointConfig(**kwargs),
                  tmp_path / "ref", reports)
    got = _drive(CheckpointManager, Checkpoint, CheckpointConfig(**kwargs),
                 tmp_path / "port", reports)
    assert got == want
    keep = kwargs.get("num_to_keep")
    if keep is not None:
        assert len(got["on_disk"]) == keep
    got_latest = load_latest_checkpoint(str(tmp_path / "port"))
    want_latest = jax_load_latest(str(tmp_path / "ref"))
    assert os.path.basename(got_latest.path) == os.path.basename(want_latest.path)


@pytest.mark.parametrize(
    "kwargs, match",
    [(dict(checkpoint_score_order="median"), "checkpoint_score_order"),
     (dict(num_to_keep=0), "num_to_keep"), (dict(num_to_keep=-2), "num_to_keep")],
    ids=["order", "keep_0", "keep_negative"],
)
def test_checkpoint_config_checks_like_reference(kwargs, match):
    with pytest.raises(ValueError, match=match) as want:
        JaxCheckpointConfig(**kwargs)
    with pytest.raises(ValueError, match=match) as got:
        CheckpointConfig(**kwargs)
    assert str(got.value) == str(want.value)


def _loop(config):
    """Report a checkpoint per step, each holding the step it saved; record
    what get_checkpoint() gave at the start."""
    resumed = get_checkpoint()
    config["seen"].append(None if resumed is None else resumed.path)
    start = 0
    if resumed is not None:
        with resumed.as_directory() as d:
            start = int(open(os.path.join(d, "step.txt")).read()) + 1
    for step in range(start, start + config["steps"]):
        d = os.path.join(config["scratch"], f"step_{step}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "step.txt"), "w") as f:
            f.write(str(step))
        report({"step": step, "score": -abs(step - 2)}, checkpoint=Checkpoint.from_directory(d))


def test_second_fit_resumes_from_the_first_runs_last_checkpoint(tmp_path):
    seen = []
    run = dict(name="resume", storage_path=str(tmp_path / "results"))
    config = {"seen": seen, "steps": 3, "scratch": str(tmp_path / "scratch")}
    first = TorchTrainer(_loop, train_loop_config=config, run_config=RunConfig(**run)).fit()
    assert first.error is None and [m["step"] for m in first.metrics_history] == [0, 1, 2]
    second = TorchTrainer(_loop, train_loop_config=config, run_config=RunConfig(**run)).fit()
    assert second.error is None
    assert seen == [None, first.checkpoint.path]
    assert os.path.basename(first.checkpoint.path) == "checkpoint_000002"
    # the second run resumed at step 3; its reports are indexed from 0 again
    assert [m["step"] for m in second.metrics_history] == [3, 4, 5]
    assert load_latest_checkpoint(first.path) == second.checkpoint


def test_fit_keeps_the_top_k_by_score(tmp_path):
    config = {"seen": [], "steps": 5, "scratch": str(tmp_path / "scratch")}
    result = TorchTrainer(_loop, train_loop_config=config, run_config=RunConfig(
        name="topk", storage_path=str(tmp_path / "results"),
        checkpoint_config=CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="score"),
    )).fit()
    kept = sorted(p for p in os.listdir(result.path) if p.startswith("checkpoint_0"))
    # scores -2, -1, 0, -1, -2: the best (step 2) and the latest (step 4)
    assert kept == ["checkpoint_000002", "checkpoint_000004"]
    assert os.path.basename(result.checkpoint.path) == "checkpoint_000004"
