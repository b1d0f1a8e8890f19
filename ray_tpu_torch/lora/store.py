"""Paged adapter slots: the port of ray_tpu/lora/store.py.

One :class:`AdapterStore` per server owns a fixed-capacity *slot bank* on
the card: for each LoRA projection of the model (``wq``, ``wk``, ``wv``,
``wo`` of every layer, the ``train/lora.py`` leaf naming) a ``lora_a``
``(n_layers, max_live + 1, in_dim, rank)`` and a ``lora_b``
``(n_layers, max_live + 1, rank, out_dim)`` tensor. The layers are stacked
(the reference keeps one ``(num_slots, ...)`` buffer per layer and path),
so that a model call gathers its rows' slots for every layer in one op per
factor (models/llama.py ``gather_adapters``); the extra last row stays all
zero, and slot -1 (the base model) reads it.

Lifecycle, as in the reference (and ``kvcache/manager.py``):

- ``acquire(adapter_id)`` -> :class:`AdapterLease` pins a slot (refcount);
  a resident adapter is a *hit*, a miss takes a free slot, or evicts the
  least recently used idle adapter, and fills it from ``tree`` or the
  configured source. ``None`` means every slot is pinned: backpressure,
  not an error. A failed fill returns the slot to the free list.
- ``release(lease)`` is idempotent; at refcount 0 the adapter stays
  resident on the idle LRU, so the next request for it hits.

Writing a slot. The reference writes copy-on-write (a new bank per attach),
so that a decode step in flight keeps a valid bank. Here a fill copies the
adapter into the bank's rows IN PLACE, under the store's lock, and the
engine reads the bank without taking that lock. That is safe because the
slot being written has refcount 0: no request in any engine holds it, so no
row of any step gathers it (an engine drops a request before its lease is
released: a stream closed early cancels its request first, under the step
lock, in ``ContinuousBatchingEngine.cancel``), and the copies are ordered on the device's
stream with the steps' gathers (every thread of the process issues to the
current device's default stream). A cold attach therefore never stalls a
step, and costs no second bank.

``lora_b`` is pre-scaled by ``alpha/rank`` at attach (in f32, then cast to
the bank's dtype, as the reference's write casts), so a row's delta is
exactly ``x @ A[slot] @ B[slot]``. The weight plane (``publish_adapter``,
``source="weights:<prefix>"``) is not ported yet and raises.

Tensor parallelism (``plan=``, a :class:`~ray_tpu_torch.parallel.plan.
PartitionPlan`): the bank holds the plan's rank's slices, sharded alongside
the base weights (``PartitionPlan.lora_row_shards``): wq/wk/wv's ``lora_b``
split on the output (head) dim, wo's ``lora_a`` on the input dim, the rest
and the slot axis replicated. Rank 0 of a tensor-parallel replica owns the
leases, the LRU and the source; the other ranks hold only a bank, which
rank 0 writes: every slot write sends each of them its slices through the
rank executor (llm/tp_ranks.py, ``attach``), which replays the write there
before any later engine step that names the slot. The model needs no more
collectives: wo's partial ``(x_r A_r) B`` is added before the layer's
allreduce, which sums it as it sums the base partials.

Besides its plain counters (``stats()``), the store records each hit, cold
attach (with its latency) and eviction, and the live slots, in the process's
metrics (``util/metrics``), and each cold attach and eviction in its flight
recorder (``util/events``), as the reference does. The attach time is the
host's: the slot copies are queued on the device's stream and not waited
for (see above), as the reference's dispatch is asynchronous.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .._internal.device import MESH_TAG, DeviceLike, resolve_device
from ..models.llama import PROJECTIONS
from ..util import events as _events
from ..util import metrics as _metrics

_WEIGHT_PLANE = (
    "the weight plane (publish / fetch of adapters) is not ported yet: it "
    "comes with the port's weight plane slice; prewarm() adapters or give "
    "AdapterConfig a callable source"
)


def adapter_target_paths(model_config) -> List[Tuple[Tuple[str, ...], int, int]]:
    """The model's LoRA target paths as ``(path, in_dim, out_dim)`` rows:
    the q/k/v/o attention projections of every layer, matching
    ``models/llama.py``'s LoRADense placement and ``train/lora.py``'s leaf
    naming (``<path>/lora_a`` ``(in_dim, rank)``, ``<path>/lora_b``
    ``(rank, out_dim)``)."""
    h = model_config.n_heads * model_config.head_dim
    hk = model_config.n_kv_heads * model_config.head_dim
    out: List[Tuple[Tuple[str, ...], int, int]] = []
    for i in range(model_config.n_layers):
        layer = f"layer_{i}"
        out.append(((layer, "attn", "wq"), model_config.dim, h))
        out.append(((layer, "attn", "wk"), model_config.dim, hk))
        out.append(((layer, "attn", "wv"), model_config.dim, hk))
        out.append(((layer, "attn", "wo"), h, model_config.dim))
    return out


def publish_adapter(prefix: str, adapter_id: str, lora_tree: Any, **kwargs):
    """Publishing an adapter to the weight plane: not ported yet."""
    raise NotImplementedError(_WEIGHT_PLANE)


@dataclasses.dataclass
class AdapterLease:
    """A pinned adapter slot: hold it for the request's lifetime, release
    exactly once (idempotent). ``slot`` is the bank row the engine gathers
    for this request."""

    adapter_id: str
    slot: int
    closed: bool = False


def _flat_leaves(tree: Any) -> Dict[str, Any]:
    """A nested dict (the reference's form) or a flat dict with dotted keys
    (the port's state dicts, ``split_lora``'s output, a TorchTrainer LoRA
    checkpoint) as ``{"a/b/c": leaf}``."""
    if not isinstance(tree, Mapping):
        raise ValueError("adapter tree must be a (possibly nested) dict")
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        key = str(key).replace(".", "/")
        if isinstance(value, Mapping):
            for sub, leaf in _flat_leaves(value).items():
                out[f"{key}/{sub}"] = leaf
        else:
            out[key] = value
    return out


def _as_f32(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(leaf, dtype=np.float32))


class AdapterStore:
    """Fixed-capacity paged adapter slots with refcount leases and LRU
    refill. Thread-safe: servers resolve leases on their callers' threads
    while the engine's stepping thread reads the bank."""

    def __init__(
        self,
        model_config,
        *,
        max_live: int = 8,
        rank: int = 8,
        alpha: float = 16.0,
        source: Optional[Any] = None,
        param_dtype=None,
        device: DeviceLike = None,
        plan=None,
    ):
        if max_live < 1 or rank < 1:
            raise ValueError("AdapterStore needs max_live >= 1 and rank >= 1")
        self._cfg = model_config
        self._num_slots = int(max_live)
        self._rank = int(rank)
        self._alpha = float(alpha)
        # refill source: a callable source(adapter_id) -> adapter tree; None
        # serves only prewarm()ed adapters; "weights:<prefix>" raises
        self._source = source
        self._dtype = model_config.param_dtype if param_dtype is None else param_dtype
        self._plan = plan
        self._mesh_tag = plan.describe() if plan is not None else MESH_TAG
        self._device = resolve_device(device)
        # on rank 0 of a tensor-parallel replica, the rank executor
        # (llm/tp_ranks.py): it sends the other ranks their slices of every
        # slot write
        self._lockstep = None
        self._paths = adapter_target_paths(model_config)
        self._lock = threading.RLock()
        self._slot_of: Dict[str, int] = {}
        self._refcnt: List[int] = [0] * self._num_slots
        self._free: List[int] = list(range(self._num_slots))
        self._idle: "OrderedDict[str, int]" = OrderedDict()  # LRU, oldest first
        self.hits = 0
        self.cold_attaches = 0
        self.evictions = 0
        self.last_attach_s = 0.0
        self._bank = self._build_bank()

    @classmethod
    def from_config(cls, model_config, adapter_config, device: DeviceLike = None, plan=None):
        """The store that ``LLMConfig.adapters`` (an ``AdapterConfig``) asks
        for, in the model's parameter dtype."""
        return cls(model_config, max_live=adapter_config.max_live,
                   rank=adapter_config.slot_rank, alpha=adapter_config.alpha,
                   source=adapter_config.source, device=device, plan=plan)

    # -- bank ----------------------------------------------------------------

    def _build_bank(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """All-zero slot tensors, one (lora_a, lora_b) pair per projection,
        every layer stacked, with one more row than there are slots: the
        zero row that slot -1 reads. Under a plan, of the rank's slices."""
        n, rows = self._cfg.n_layers, self._num_slots + 1
        row = self._row_slices({
            name: (torch.empty((n, d_in, self._rank), device="meta"),
                   torch.empty((n, self._rank, d_out), device="meta"))
            for (_, _, name), d_in, d_out in self._paths[:4]})
        return {
            name: {factor: torch.zeros((n, rows, *t.shape[1:]), dtype=self._dtype,
                                       device=self._device)
                   for factor, t in zip(("lora_a", "lora_b"), pair)}
            for name, pair in row.items()
        }

    def _row_slices(self, adapter, rank: Optional[int] = None):
        """Rank ``rank``'s (default: this store's) slices of a bank row of
        ``adapter`` (views), or the row itself without a plan."""
        if self._plan is None:
            return adapter
        return self._plan.lora_row_shards(adapter, rank)

    def bank(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The stacked slot tensors the engine passes into every model call.
        Read-only from the caller's side: slots are written through
        acquire/prewarm only."""
        return self._bank

    @property
    def num_slots(self) -> int:
        return self._num_slots

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def alpha(self) -> float:
        return self._alpha

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    # -- lease lifecycle -----------------------------------------------------

    def acquire(self, adapter_id: str, tree: Optional[Any] = None) -> Optional[AdapterLease]:
        """Pin ``adapter_id`` into a slot. Resident -> hit (refcount++).
        Miss -> allocate (a free slot, else evict the LRU *idle* adapter),
        load the adapter (``tree`` if given, else the configured source) and
        write it into the slot's rows. Returns None when every slot is
        pinned by in-flight requests: the caller backpressures."""
        t0 = time.perf_counter()
        with self._lock:
            slot = self._slot_of.get(adapter_id)
            if slot is not None:
                self._idle.pop(adapter_id, None)
                self._refcnt[slot] += 1
                self.hits += 1
                _metrics.record_adapter_hit(mesh=self._mesh_tag)
                return AdapterLease(adapter_id, slot)
            slot = self._allocate_or_evict()
            if slot is None:
                return None
            try:
                self._write_slot(slot, self._load(adapter_id, tree))
            except BaseException:
                # full rollback: the slot returns to the free list and the
                # eviction (if any) stands; never a half-attached adapter
                self._free.append(slot)
                raise
            self._slot_of[adapter_id] = slot
            self._refcnt[slot] = 1
            self.cold_attaches += 1
            self.last_attach_s = time.perf_counter() - t0
            _metrics.record_adapter_cold_attach(self.last_attach_s, mesh=self._mesh_tag)
            _metrics.set_adapter_slots_live(len(self._slot_of), mesh=self._mesh_tag)
            _events.record_event(
                _events.ADAPTER_COLD_ATTACH, adapter_id=adapter_id, slot=slot,
                attach_ms=round(self.last_attach_s * 1000.0, 3),
            )
            return AdapterLease(adapter_id, slot)

    def release(self, lease: Optional[AdapterLease]) -> None:
        """Unpin (idempotent). At refcount 0 the adapter joins the idle
        LRU: still resident, still a hit for the next request."""
        if lease is None or lease.closed:
            return
        with self._lock:
            if lease.closed:
                return
            lease.closed = True
            slot = self._slot_of.get(lease.adapter_id)
            if slot is None or slot != lease.slot:
                return  # already evicted after an out-of-order release
            self._refcnt[slot] = max(0, self._refcnt[slot] - 1)
            if self._refcnt[slot] == 0:
                self._idle[lease.adapter_id] = slot
                self._idle.move_to_end(lease.adapter_id)

    def prewarm(self, adapter_id: str, tree: Any) -> None:
        """Attach an adapter without keeping it pinned (deploy-time warmup,
        tests, benches): one acquire with an explicit tree, released at
        once, so the adapter sits resident on the idle LRU."""
        lease = self.acquire(adapter_id, tree=tree)
        if lease is None:
            raise RuntimeError("adapter store exhausted: every slot is pinned")
        self.release(lease)

    def _allocate_or_evict(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if not self._idle:
            return None  # every slot pinned: backpressure
        old_id, slot = self._idle.popitem(last=False)  # LRU idle adapter
        del self._slot_of[old_id]
        self._refcnt[slot] = 0
        self.evictions += 1
        _metrics.record_adapter_evict(mesh=self._mesh_tag)
        _metrics.set_adapter_slots_live(len(self._slot_of), mesh=self._mesh_tag)
        _events.record_event(_events.ADAPTER_EVICT, adapter_id=old_id, slot=slot)
        return slot

    def _write_slot(self, slot: int, adapter: Dict[str, Tuple[torch.Tensor, torch.Tensor]]):
        """THE bank write: row ``slot`` of every layer, one copy per factor
        and projection, cast to the bank's dtype. Called under the lock for
        a slot of refcount 0 (see the module docstring). On rank 0 of a
        tensor-parallel replica the other ranks' slices, cast likewise, are
        sent first, so that a failed send leaves this rank's bank as it
        was."""
        if self._lockstep is not None:
            self._lockstep.attach(slot, {
                rank: {name: tuple(t.to(self._dtype).clone(memory_format=torch.contiguous_format)
                                   for t in pair)
                       for name, pair in self._row_slices(adapter, rank).items()}
                for rank in range(1, self._plan.num_devices)})
        self.write_rows(slot, self._row_slices(adapter))

    def write_rows(self, slot: int, rows: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Copy one bank row (this store's slices, ``{projection: (a, b)}``)
        into slot ``slot``: the write :meth:`_write_slot` makes here, and the
        rank executor replays on a tensor-parallel replica's other ranks."""
        for name, (a, b) in rows.items():
            self._bank[name]["lora_a"][:, slot].copy_(a)
            self._bank[name]["lora_b"][:, slot].copy_(b)

    # -- refill --------------------------------------------------------------

    def _load(self, adapter_id: str, tree: Optional[Any]):
        if tree is None:
            tree = self._fetch(adapter_id)
        return self._normalize(tree)

    def _fetch(self, adapter_id: str):
        source = self._source
        if source is None:
            raise KeyError(
                f"adapter {adapter_id!r} is not resident and the store has "
                "no refill source; prewarm() it or configure "
                "AdapterConfig(source=<callable>)"
            )
        if callable(source):
            return source(adapter_id)
        if isinstance(source, str) and source.startswith("weights:"):
            raise NotImplementedError(_WEIGHT_PLANE)
        raise ValueError(f"unsupported adapter source {source!r}")

    def _normalize(self, tree: Any) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Shape an adapter tree into the bank's row structure, stacked over
        layers: ``{projection: (a (n_layers, in, r), b (n_layers, r, out))}``
        in f32 on the host. Every target path is present (a missing
        projection becomes zero, the base model for it), the rank is checked
        against the slot rank (the bank is static: a mismatched rank cannot
        attach), and ``lora_b`` is pre-scaled by alpha/rank in f32."""
        flat = _flat_leaves(tree)
        scale = self._alpha / self._rank
        rows: Dict[str, Tuple[list, list]] = {name: ([], []) for name in PROJECTIONS}
        for path, in_dim, out_dim in self._paths:
            joined = "/".join(path)
            a = self._find(flat, joined + "/lora_a")
            b = self._find(flat, joined + "/lora_b")
            if a is not None:
                a = _as_f32(a)
                if tuple(a.shape) != (in_dim, self._rank):
                    raise ValueError(
                        f"adapter {joined}/lora_a has shape {tuple(a.shape)}; "
                        f"this store's slots hold ({in_dim}, {self._rank}) "
                        "(AdapterConfig.slot_rank is the bank-wide rank)"
                    )
            else:
                a = torch.zeros((in_dim, self._rank))
            if b is not None:
                b = _as_f32(b)
                if tuple(b.shape) != (self._rank, out_dim):
                    raise ValueError(
                        f"adapter {joined}/lora_b has shape {tuple(b.shape)}; "
                        f"expected ({self._rank}, {out_dim})"
                    )
                b = b * scale
            else:
                b = torch.zeros((self._rank, out_dim))
            rows[path[-1]][0].append(a)
            rows[path[-1]][1].append(b)
        return {name: (torch.stack(a), torch.stack(b)) for name, (a, b) in rows.items()}

    @staticmethod
    def _find(flat: Dict[str, Any], suffix: str):
        """Match a target leaf by path suffix, so that a tree may carry an
        extra root ({'params': ...}) without breaking attachment."""
        for key, value in flat.items():
            if key == suffix or key.endswith("/" + suffix):
                return value
        return None

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            pinned = sum(1 for c in self._refcnt if c > 0)
            return {
                "num_slots": self._num_slots,
                "rank": self._rank,
                "slots_live": len(self._slot_of),
                "slots_pinned": pinned,
                "slots_idle": len(self._idle),
                "slots_free": len(self._free),
                "hits": self.hits,
                "cold_attaches": self.cold_attaches,
                "evictions": self.evictions,
                "last_attach_ms": round(self.last_attach_s * 1000.0, 3),
                "resident": sorted(self._slot_of),
                "mesh": self._mesh_tag,
            }
