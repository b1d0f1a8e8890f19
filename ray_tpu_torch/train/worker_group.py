"""The ranked worker group: the port of ray_tpu/train/worker_group.py.

The reference's group is N actors placed by a placement group, each running
the loop on a thread. The port's is N processes from
``torch.multiprocessing.get_context("spawn")`` (``fork`` is unsafe once CUDA
is up), rank r pinned to card ``cards[r]`` (or the CPU for None). Each
worker serves commands from its own queue: run a function, take its
:class:`~ray_tpu_torch.train.session.TrainContext`, run the training loop,
stop. Results, reports, completions and errors come back to the controller
through one shared queue, reports as the loop makes them.

Everything sent to a worker is pickled, the loop by reference: the card's
machine has no cloudpickle, and the port does not need it. A loop that
cannot be imported by name (a closure, a lambda) is refused with a
``ValueError`` by :func:`check_importable` before anything spawns; the
reference cloudpickles loops to its actors.
"""

from __future__ import annotations

import logging
import pickle
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch.multiprocessing as mp

logger = logging.getLogger(__name__)

#: how long a worker gets to stop on its own before it is terminated
_STOP_GRACE_S = 5.0
#: how long a terminated worker gets to exit before it is killed
_KILL_AFTER_S = 5.0


def check_importable(fn: Callable, config: Any = None) -> None:
    """Refuse a loop (or config) that cannot travel to a spawned worker:
    the loop must be importable by its module and name."""
    qualname = getattr(fn, "__qualname__", "")
    if "<locals>" in qualname or "<lambda>" in qualname:
        raise ValueError(
            f"train_loop_per_worker {qualname!r} is a closure or a lambda: the workers "
            "are spawned processes and import the loop by name, so define it at the top "
            "level of a module"
        )
    for what, obj in (("train_loop_per_worker", fn), ("train_loop_config", config)):
        try:
            pickle.dumps(obj)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise ValueError(f"{what} cannot be sent to a spawned worker: {e}") from e


def _portable(exc: BaseException) -> BaseException:
    """The exception itself if it pickles, else a RuntimeError with its
    traceback."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:  # noqa: BLE001 - any failure to travel is replaced
        return RuntimeError("".join(traceback.format_exception(exc)))


def _worker_main(rank: int, card: Optional[int], commands, out) -> None:
    """A worker's life: serve ``commands`` until told to stop."""
    import torch

    from . import session

    if card is not None:
        torch.cuda.set_device(card)
    while True:
        msg = commands.get()
        kind = msg[0]
        if kind == "stop":
            return
        try:
            if kind == "exec":
                _, fn, args = msg
                out.put(("result", rank, fn(*args)))
            elif kind == "context":
                ctx = session.TrainContext(**msg[1])
                ctx._report_sink = lambda report: out.put(("report", rank, report))
                session.set_context(ctx)
                out.put(("result", rank, None))
            elif kind == "train":
                _, fn, config = msg
                fn(config)
                out.put(("done", rank, None))
        except BaseException as e:  # noqa: BLE001 - handed to the controller
            traceback.print_exc()
            out.put(("error", rank, _portable(e)))


class WorkerDiedError(RuntimeError):
    """A worker process exited without finishing."""


class WorkerGroup:
    """N spawned workers, rank r on ``cards[r]``; ``name`` names their
    processes and their errors."""

    def __init__(self, cards: Sequence[Optional[int]], name: str = "train-worker"):
        self.cards = list(cards)
        self.name = name
        self.num_workers = len(self.cards)
        self.on_card = self.cards[0] is not None
        ctx = mp.get_context("spawn")
        self._out = ctx.Queue()
        self._commands = [ctx.Queue() for _ in self.cards]
        self._procs = [
            ctx.Process(target=_worker_main, args=(r, c, self._commands[r], self._out),
                        daemon=True, name=f"{name}-{r}")
            for r, c in enumerate(self.cards)
        ]
        #: messages that arrived while :meth:`execute_each` waited for results
        self._backlog: List[Tuple[str, int, Any]] = []

    def start(self):
        for p in self._procs:
            p.start()

    def exited(self) -> List[Tuple[int, Optional[int]]]:
        """(rank, exit code) of each worker that is no longer running."""
        return [(r, p.exitcode) for r, p in enumerate(self._procs)
                if p.pid is not None and not p.is_alive()]

    def _get(self, timeout: float):
        try:
            return self._out.get(timeout=timeout)
        except queue.Empty:
            return None

    def _raise_if_exited(self):
        gone = self.exited()
        if gone:
            rank, code = gone[0]
            raise WorkerDiedError(f"{self.name} rank {rank} exited with code {code}")

    def _collect(self, deadline: float) -> List[Any]:
        results: List[Any] = [None] * self.num_workers
        pending = set(range(self.num_workers))
        while pending:
            msg = self._get(0.1)
            if msg is None:
                self._raise_if_exited()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{self.name} ranks {sorted(pending)} did not answer")
                continue
            kind, rank, payload = msg
            if kind == "result":
                results[rank] = payload
                pending.discard(rank)
            elif kind == "error":
                raise payload
            else:
                self._backlog.append(msg)
        return results

    def submit_each(self, fn: Callable, args_per_rank: Sequence[tuple]) -> None:
        """Start ``fn(*args_per_rank[r])`` in every worker and return at
        once; its result, or its exception, arrives on the shared queue
        (:meth:`poll`)."""
        for q, args in zip(self._commands, args_per_rank):
            q.put(("exec", fn, tuple(args)))

    def execute_each(self, fn: Callable, args_per_rank: Sequence[tuple],
                     timeout_s: float = 600.0) -> List[Any]:
        """Run ``fn(*args_per_rank[r])`` in every worker at once; their
        results by rank. A worker's exception is raised here."""
        self.submit_each(fn, args_per_rank)
        return self._collect(time.monotonic() + timeout_s)

    def execute(self, fn: Callable, *args, timeout_s: float = 600.0) -> List[Any]:
        return self.execute_each(fn, [args] * self.num_workers, timeout_s)

    def set_contexts(self, fields_per_rank: Sequence[dict], timeout_s: float = 600.0):
        """Give each worker its :class:`TrainContext`, whose reports stream
        back to this group."""
        for q, fields in zip(self._commands, fields_per_rank):
            q.put(("context", dict(fields)))
        self._collect(time.monotonic() + timeout_s)

    def start_training(self, fn: Callable, config: dict):
        for q in self._commands:
            q.put(("train", fn, config))

    def poll(self, timeout: float = 0.1) -> List[Tuple[str, int, Any]]:
        """The messages that arrived: ("report", rank, TrainingReport),
        ("done", rank, None) or ("error", rank, exception); waits up to
        ``timeout`` for the first."""
        msgs, self._backlog = self._backlog, []
        first = self._get(0.0 if msgs else timeout)
        while first is not None:
            msgs.append(first)
            first = self._get(0.0)
        return msgs

    def shutdown(self):
        """Stop every worker: ask, then terminate, then kill, each with its
        deadline, draining the queue meanwhile so no worker blocks on it."""
        for p, q in zip(self._procs, self._commands):
            if p.is_alive():
                q.put(("stop",))
        for grace, action in ((_STOP_GRACE_S, "terminate"), (_KILL_AFTER_S, "kill"),
                              (_KILL_AFTER_S, None)):
            deadline = time.monotonic() + grace
            while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
                self._get(0.05)
            alive = [p for p in self._procs if p.is_alive()]
            if not alive or action is None:
                break
            for p in alive:
                getattr(p, action)()
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=1.0)
                if p.is_alive():
                    logger.error("worker %s (pid %d) did not exit", p.name, p.pid)
        for q in [self._out, *self._commands]:
            q.close()
            q.cancel_join_thread()
