"""The rank executor of tensor-parallel serving.

The reference serves ``tensor_parallel_size=n`` with one process driving n
devices: XLA's GSPMD compiles each engine program once over the mesh and
inserts the collectives. PyTorch runs a process per rank, so the port runs
the same engine code in n processes over their shards, in lockstep:

- **Rank 0 is the caller's process.** It holds the engine that the server
  exposes, its request queue and every counter. Ranks 1..n-1 are spawned
  (``train.WorkerGroup``: one process a rank, on its card or the CPU); all
  join a ``TCPStore`` that rank 0 owns and form a collective group
  (``NcclGroup``, or ``GlooGroup`` for ranks on the CPU or sharing a card).
- **Weights.** Seeded ones are drawn by every rank from the same seed,
  tensor by tensor in ``init_params``'s order, each rank keeping its slice
  (no rank holds the whole model). Given ones are sliced by rank 0, which
  sends each rank its slices through the group.
- **Lockstep.** Before rank 0 runs a public entry point of its engine it
  publishes the command in the store (:meth:`TPRanks.publish`): a dense
  ``generate`` or stream, each continuous-batching step with the requests
  added since the last one, a cancellation. The other ranks replay the
  commands in order (:func:`_serve`). Admission, the radix index, chunking
  and speculation are host decisions made from the same commands, so every
  rank makes the same ones; the model's collectives keep the ranks' model
  calls together, and the logits leave the model replicated, so every rank
  samples the same tokens. That is checked, not trusted: every array a
  rank brings to the host (``_host_sync``: sampled tokens, accepted
  counts) is posted to the store and held to rank 0's; on any difference
  rank 0 raises a RuntimeError naming the step and the executor refuses
  every later command.
- **Teardown.** :meth:`TPRanks.close` publishes a stop, destroys rank 0's
  group and process group, and stops the worker processes; the server's
  ``close()`` and its finalizer call it.

The store carries only the control plane (commands, sampled arrays, test
calls); the model's collectives go through the group's ops, so
``collective_summary`` counts them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

#: the store's address: the ranks are processes of this host
STORE_HOST = "127.0.0.1"
#: how long a rank waits for its peers in a collective or for a sampled
#: array, and for the worker processes to come up
TIMEOUT_S = 300.0
#: a worker's wait for rank 0's next command: as long as the server lives
_IDLE_WAIT = datetime.timedelta(days=7)


@dataclasses.dataclass
class EngineSpec:
    """What every rank builds: the dense :class:`LLMEngine` (``paged``
    False) or a :class:`ContinuousBatchingEngine` over a
    :class:`KVCacheManager`, with the server's settings."""

    model_config: Any
    paged: bool
    batch: int  # max_batch_size of the dense engine, num_slots of the paged
    seed: int  # the engines' sampling seed: one for every rank
    kv_cache_blocks: int = 0
    kv_block_size: int = 32
    draft_config: Any = None
    spec_tokens: int = 0
    prefill_chunk_tokens: int = 0


def build_engine(spec: EngineSpec, plan, params, draft_params=None):
    """The engine of one rank, over its slices and its bound ``plan``."""
    from ..kvcache import KVCacheManager
    from .engine import ContinuousBatchingEngine, LLMEngine

    device = plan.device()
    if not spec.paged:
        return LLMEngine(spec.model_config, params, max_batch_size=spec.batch, seed=spec.seed,
                         device=device, plan=plan)
    kv = KVCacheManager(spec.kv_cache_blocks, spec.kv_block_size, plan=plan)
    draft = (spec.draft_config, draft_params) if spec.draft_config is not None else None
    return ContinuousBatchingEngine(
        spec.model_config, params, num_slots=spec.batch, kv_cache=kv, seed=spec.seed,
        draft=draft, spec_tokens=spec.spec_tokens,
        prefill_chunk_tokens=spec.prefill_chunk_tokens, device=device, plan=plan,
    )


def seeded_shards(config, plan, seed: int) -> Dict[str, torch.Tensor]:
    """The bound rank's slices of ``init_params(config)`` under ``seed`` on
    its device: each full tensor is drawn, sliced and freed in turn."""
    from ..models.llama import init_params

    device = plan.device()
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(config, gen, device,
                       shard=lambda name, t: plan.shard_param(name, t).clone())


def _send_shards(group, config, plan, params: Dict[str, torch.Tensor]) -> None:
    """Rank 0: send every other rank its slices, in ``param_shapes`` order."""
    from ..models.llama import param_shapes

    for rank in range(1, plan.num_devices):
        for name in param_shapes(config):
            group.send(plan.shard_param(name, params[name], rank).contiguous(), rank)


def _recv_shards(group, config, plan) -> Dict[str, torch.Tensor]:
    from ..models.llama import param_shapes

    device = plan.device()
    return {name: group.recv(0).to(device) for name in param_shapes(config)}


class _Lockstep:
    """The store plane of one rank: command ``index`` is the latest
    published (rank 0) or replayed (others), and ``sample`` counts the
    arrays brought to the host since it."""

    def __init__(self, store, prefix: str, rank: int, world: int):
        self.store = store
        self.prefix = prefix
        self.rank = rank
        self.world = world
        self.index = -1
        self.sample = 0

    def _key(self, *parts) -> str:
        return "/".join((self.prefix, *map(str, parts)))


class _Follower(_Lockstep):
    """Ranks 1..n-1: replay rank 0's commands, post every sampled array."""

    def publish(self, cmd) -> None:
        pass  # only rank 0 publishes

    def command(self, cmd):
        return contextlib.nullcontext()

    def agree(self, arr: np.ndarray) -> None:
        self.store.set(self._key("agree", self.index, self.sample, self.rank),
                       pickle.dumps(np.asarray(arr)))
        self.sample += 1

    def next_command(self):
        self.index += 1
        self.sample = 0
        key = self._key("cmd", self.index, self.rank)
        cmd = pickle.loads(self.store.get(key))
        self.store.delete_key(key)
        return cmd

    def reply(self, value) -> None:
        self.store.set(self._key("ret", self.index, self.rank), pickle.dumps(value))


def _serve(engine, lockstep: _Follower) -> None:
    """A worker rank's loop: replay rank 0's commands until "stop"."""
    while True:
        cmd = lockstep.next_command()
        kind = cmd[0]
        if kind == "stop":
            return
        if kind == "step":
            engine._pending.extend((rid, req, None) for rid, req in cmd[1])
            engine.step()
        elif kind == "cancel":
            engine.cancel(cmd[1])
        elif kind == "generate":
            engine.generate(cmd[1])
        elif kind == "stream":
            for _ in engine.generate_stream(cmd[1]):
                pass
        elif kind == "call":
            lockstep.reply(cmd[1](engine, *cmd[2]))
        else:
            raise ValueError(f"unknown tensor-parallel command {kind!r}")


def _join(port: int, world: int, rank: int, backend: str, timeout_s: float, prefix: str,
          group_name: str):
    """Join rank 0's store, the default process group and the ``tp``
    collective group. Returns (store, group)."""
    import torch.distributed as dist

    from .. import collective

    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(STORE_HOST, port, world, is_master=False, timeout=timeout)
    store.set(f"{prefix}/up/{rank}", b"1")
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=timeout)
    group = collective.init_collective_group(world, rank, backend=backend, group_name=group_name)
    return store, group


def _leave(group_name: str) -> None:
    import torch.distributed as dist

    from .. import collective

    collective.destroy_collective_group(group_name)
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, port: int, plan, spec: EngineSpec, shipped: bool,
               timeout_s: float, prefix: str, group_name: str, threads: int) -> None:
    """A spawned rank's life: join, take its slices, build its engine,
    replay rank 0's commands until stopped. A failure is posted to the
    store and ends the process at once, so that rank 0's collectives fail
    fast instead of waiting for a peer that will not come. A rank on the
    CPU computes with ``threads`` intra-op threads: rank 0's count, which
    its caller sets to share the host's cores among the ranks (idle
    threads of one rank spinning beside another's compute slow both)."""
    from .serving import DRAFT_SEED, PARAMS_SEED

    world = plan.num_devices
    store = None
    if plan.mesh.devices[rank] == "cpu":
        torch.set_num_threads(threads)
    try:
        store, group = _join(port, world, rank, plan.backend, timeout_s, prefix, group_name)
        plan = plan.bind(rank, group)
        cfg = spec.model_config
        params = (_recv_shards(group, cfg, plan) if shipped
                  else seeded_shards(cfg, plan, PARAMS_SEED))
        draft = (seeded_shards(spec.draft_config, plan, DRAFT_SEED)
                 if spec.draft_config is not None else None)
        engine = build_engine(spec, plan, params, draft)
        lockstep = _Follower(store, prefix, rank, world)
        engine._lockstep = lockstep
        store.set(f"{prefix}/ready/{rank}", b"1")
        store.set_timeout(_IDLE_WAIT)
        _serve(engine, lockstep)
    except BaseException:  # noqa: BLE001 - reported to rank 0, then exit
        text = traceback.format_exc()
        print(f"tensor-parallel rank {rank} failed:\n{text}", flush=True)
        if store is not None:
            with contextlib.suppress(Exception):
                store.set(f"{prefix}/error/{rank}", text.encode())
        os._exit(1)
    _leave(group_name)


class TPRanks(_Lockstep):
    """Rank 0's side of a tensor-parallel replica: the spawned ranks, the
    store, the group, and the lockstep of the engine it builds
    (:attr:`engine`). Made by :func:`start_ranks`."""

    def __init__(self, plan, store, workers, prefix: str, group_name: str, timeout_s: float):
        super().__init__(store, prefix, 0, plan.num_devices)
        self.plan = plan
        self.engine = None
        self._workers = workers
        self._group_name = group_name
        self._timeout_s = timeout_s
        self._lock = threading.RLock()
        self.steps = 0  # "step" commands published
        self._cmd_kind = None
        #: why the ranks stopped, once they disagreed or a rank failed
        self.failed: Optional[str] = None
        self.closed = False

    # -- the engine's lockstep hooks --------------------------------------

    def publish(self, cmd) -> None:
        """Send the other ranks the command rank 0 is about to run."""
        with self._lock:
            if self.failed is not None:
                raise RuntimeError(f"the tensor-parallel ranks stopped: {self.failed}")
            if self.closed:
                raise RuntimeError("the tensor-parallel server is closed")
            self._publish(cmd)
            if cmd[0] == "step":
                self.steps += 1

    def _publish(self, cmd) -> None:
        self.index += 1
        self.sample = 0
        self._cmd_kind = cmd[0]
        blob = pickle.dumps(cmd)
        for rank in range(1, self.world):  # each rank deletes its copy once read
            self.store.set(self._key("cmd", self.index, rank), blob)

    @contextlib.contextmanager
    def command(self, cmd):
        """Publish ``cmd`` and hold the lockstep while rank 0 runs it (the
        dense engine's ``generate`` and streams, one at a time)."""
        with self._lock:
            self.publish(cmd)
            yield

    def agree(self, arr: np.ndarray) -> None:
        """Hold every rank's array of this sample point to rank 0's."""
        mine = np.asarray(arr)
        for rank in range(1, self.world):
            key = self._key("agree", self.index, self.sample, rank)
            theirs = pickle.loads(self._get(key))
            self.store.delete_key(key)
            if theirs.shape != mine.shape or not np.array_equal(theirs, mine):
                self.failed = (
                    f"tensor-parallel ranks disagree at engine step {self.steps} (command "
                    f"{self.index}, {self._cmd_kind!r}, sampled array {self.sample}): rank 0 "
                    f"has {mine.tolist()}, rank {rank} has {theirs.tolist()}"
                )
                raise RuntimeError(self.failed)
        self.sample += 1

    def _get(self, key: str) -> bytes:
        """A value a worker posts, or the worker's failure as an error."""
        start = time.monotonic()
        nap, checked = 0.0002, start
        while not self.store.check([key]):
            now = time.monotonic()
            if now - checked > 0.1:  # a failed rank posts why, or is gone
                self._raise_if_failed()
                checked = now
            if now - start > self._timeout_s:
                self.failed = f"no answer under {key!r} within {self._timeout_s} s"
                raise RuntimeError(f"the tensor-parallel ranks stopped: {self.failed}")
            time.sleep(nap)
            nap = min(2 * nap, 0.002)
        return self.store.get(key)

    def _raise_if_failed(self) -> None:
        for rank in range(1, self.world):
            key = self._key("error", rank)
            if self.store.check([key]):
                self.failed = f"rank {rank} failed:\n{self.store.get(key).decode()}"
                raise RuntimeError(f"the tensor-parallel ranks stopped: {self.failed}")
        gone = self._workers.exited()
        if gone:
            rank, code = gone[0]
            self.failed = f"rank {rank + 1} exited with code {code}"
            raise RuntimeError(f"the tensor-parallel ranks stopped: {self.failed}")

    # -- calls on every rank -----------------------------------------------

    def run(self, fn: Callable, *args) -> List[Any]:
        """``fn(engine, *args)`` on every rank at once, between engine
        steps; the results by rank. ``fn`` travels by name (a module-level
        function) and may run the model: the ranks' collectives meet."""
        with getattr(self.engine, "_lock", contextlib.nullcontext()), self._lock:
            self.publish(("call", fn, args))
            out = [fn(self.engine, *args)]
            for rank in range(1, self.world):
                key = self._key("ret", self.index, rank)
                out.append(pickle.loads(self._get(key)))
                self.store.delete_key(key)
            return out

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Stop every rank and leave no process or process group behind
        (idempotent)."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            with contextlib.suppress(Exception):
                self._publish(("stop",))
            # the workers leave their groups on their own and then exit; one
            # stuck in a collective rank 0 never joined is terminated
            _leave(self._group_name)
            self._workers.shutdown()
            self.store = None


def start_ranks(plan, spec: EngineSpec, params: Optional[Dict[str, torch.Tensor]] = None,
                timeout_s: float = TIMEOUT_S) -> TPRanks:
    """Spawn ranks 1..n-1 of ``plan``, form the group with them in this
    process as rank 0, hand out the weights (``params``, the whole model on
    rank 0's device, sliced and sent; None: every rank draws its slices
    under the server's ``PARAMS_SEED``) and build every rank's engine. Returns the
    :class:`TPRanks`, whose :attr:`~TPRanks.engine` is rank 0's."""
    import torch.distributed as dist

    from .. import collective
    from ..collective.nccl_group import check_distinct_cards
    from ..train.worker_group import WorkerGroup
    from .serving import DRAFT_SEED, PARAMS_SEED

    if dist.is_initialized():
        raise RuntimeError(
            "a tensor-parallel server forms this process's default process group, and "
            "one exists already: destroy it (or close the other server) first"
        )
    cards = [None if d == "cpu" else int(d) for d in plan.mesh.devices]
    if plan.backend == "nccl":
        check_distinct_cards(cards)
        if cards[0] != torch.cuda.current_device():
            raise ValueError(
                f"rank 0 runs in this process on cuda:{cards[0]}: make it the current "
                f"device (torch.cuda.set_device), or list the current one first"
            )
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(STORE_HOST, 0, plan.num_devices, is_master=True,
                          wait_for_workers=False, timeout=timeout)
    prefix = f"tp-{store.port}"
    group_name = f"llm-tp-{store.port}"
    workers = WorkerGroup(cards[1:], name="tp-rank")
    ranks = TPRanks(plan, store, workers, prefix, group_name, timeout_s)
    workers.start()
    try:
        workers.submit_each(_rank_main, [
            (rank, store.port, plan, spec, params is not None, timeout_s, prefix, group_name,
             torch.get_num_threads())
            for rank in range(1, plan.num_devices)
        ])
        for rank in range(1, plan.num_devices):
            ranks._get(ranks._key("up", rank))
        dist.init_process_group("gloo", store=store, rank=0, world_size=plan.num_devices,
                                timeout=timeout)
        group = collective.init_collective_group(plan.num_devices, 0, backend=plan.backend,
                                                 group_name=group_name)
        bound = plan.bind(0, group)
        ranks.plan = bound
        cfg = spec.model_config
        if params is None:
            local = seeded_shards(cfg, bound, PARAMS_SEED)
        else:
            _send_shards(group, cfg, bound, params)
            local = bound.shard_params(params)
        draft = (seeded_shards(spec.draft_config, bound, DRAFT_SEED)
                 if spec.draft_config is not None else None)
        engine = build_engine(spec, bound, local, draft)
        for rank in range(1, plan.num_devices):
            ranks._get(ranks._key("ready", rank))
        engine._lockstep = ranks
        ranks.engine = engine
        return ranks
    except BaseException:
        ranks.close()
        raise
