"""The LLM engines: the port of ray_tpu/llm/engine.py.

:class:`LLMEngine`, the dense engine:

- **prefill** runs the model in decode mode over the whole prompt batch,
  writing every layer's K/V into a fresh dense cache (models/llama.py
  ``DecodeCache``), as the reference does; it does not take the flash path;
- **decode** feeds one token per row per step through the same cache, which
  each call updates in place;
- requests are grouped by prompt length (no padding), each group is one
  prefill and one decode loop of at most ``max_batch_size`` rows, and rows
  that hit EOS keep decoding with their outputs dropped.

:class:`ContinuousBatchingEngine`, continuous (in-flight) batching over a
fixed pool of decode slots, optionally over the paged prefix KV cache
(``ray_tpu_torch.kvcache``), with chunked prefill and speculative decoding,
and over the cluster KV tier (``ray_tpu_torch.kvtier``): admission resolves
a prompt local-hit -> peer-pull -> recompute, a directed shipment from a
prefill replica is adopted without prefill, and :meth:`prefill_only` is the
prefill role of disaggregated serving.

Multi-tenant LoRA: with an ``adapter_store`` (ray_tpu_torch.lora
``AdapterStore``) every model call carries its rows' adapter slots
(``GenerationRequest.adapter_slot``, -1 = base), so one call serves rows of
different adapters; a call whose rows are all -1 skips the adapter path and
is the call of an engine without a store. The paged engine salts each
adapter request's prefix-cache keys with its adapter id
(:meth:`ContinuousBatchingEngine._kv_key_tokens`), so that tenants never
share K/V.

Greedy where the temperature is 0, otherwise a categorical draw from a
``torch.Generator`` reseeded per random stream from the engine seed
(:func:`_stream_seed`), the counterpart of the reference's ``fold_in``: the
same requests give the same tokens from one engine seed. PyTorch draws other
bits than JAX, so sampled tokens agree with the reference only at
temperature 0.

Observability, as the reference's: the continuous-batching engine records
TTFT (with a KV manager, tagged by cache outcome and by tier: local, peer
or miss), inter-token latency and
the speculative proposed / accepted counts in ``util/metrics``, a blocked
admission in ``util/events``, and for a request added while tracing is on
the spans ``engine.queue_wait``, ``kvcache.acquire``, ``kvcache.assemble``,
``engine.prefill``, ``kvcache.commit`` and ``engine.decode`` under the
caller's trace context (``util/tracing``). Every clock is read on the host
after the sampled tokens came back (:func:`host_sync`), so that it stamps
completion, not launch, and no record reads a device tensor.

Tensor parallelism (``plan=``, a :class:`~ray_tpu_torch.parallel.plan.
PartitionPlan` bound to this process's rank and its group): the model runs
the rank's slices and the caches hold the rank's KV heads, as the
reference's engines compile with the plan. Every rank runs the same engine
in lockstep (llm/tp_ranks.py): rank 0 publishes each public entry point's
command (a dense ``generate`` or stream, each continuous-batching step with
the requests added and cancelled since the last one) before it runs it, the
other ranks replay it, and every sampled array is held to rank 0's
(``_host_sync``). Rank 0 alone holds the KV tier client, the directed
shipments and the adapter store's leases: what only it can decide (a tier
pull's outcome, an export, whether a disaggregated prefill runs now) it
decides and posts for the others (``_decide``), and a shipment's K/V heads
move between it and the ranks through the plan's group (the manager's
``scatter_payload`` / ``gather_payload``), so that a shipment carries every
KV head whatever the layout. Adapter rows carry their slot in the published
request; every rank's bank holds its slices of the slot. Spans and metrics
carry ``plan.describe()`` as their ``mesh`` tag.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._internal.device import MESH_TAG, DeviceLike, resolve_device
from ..kvtier import PulledPrefix
from ..models.llama import DecodeCache, build_llama, new_cache
from ..util import events as _events
from ..util import metrics as _metrics
from ..util import tracing as _tracing


def _resolve_seed(seed: Optional[int]) -> int:
    """Per-process default: replicas sampling at temperature > 0 must not
    emit identical streams."""
    if seed is not None:
        return int(seed)
    return int.from_bytes(os.urandom(4), "little")


def _stream_seed(seed: int, *stream: int) -> int:
    """The seed of one random stream, the counterpart of the reference's
    ``fold_in(... fold_in(key(seed), stream[0]) ..., stream[-1])``."""
    for n in stream:
        seed = (seed * 1_000_003 + n) % (1 << 63)
    return seed


def host_sync(x: torch.Tensor) -> np.ndarray:
    """The one device-to-host point of the serving path: sampled token ids
    and nothing else come back to the host, here."""
    return x.cpu().numpy()


def _sample_impl(
    logits: torch.Tensor, temps: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """Greedy where temps == 0, temperature-categorical elsewhere."""
    greedy = logits.argmax(dim=-1)
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    sampled = torch.multinomial(
        torch.softmax(scaled, dim=-1), 1, generator=generator
    )[:, 0]
    return torch.where(temps == 0.0, greedy, sampled)


def speculative_accept(
    target_logits: torch.Tensor,
    draft_logits: torch.Tensor,
    draft_tokens: torch.Tensor,
    temps: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
):
    """Acceptance of k draft proposals per row against the target, and the
    token after the accepted prefix. A pure function of its inputs and the
    generator's draws.

    ``target_logits`` (S, k+1, V): position j predicts the token after input
    j of [last, d_1..d_k]; ``draft_logits`` (S, k, V): the draft's logits
    that proposed d_1..d_k; ``draft_tokens`` (S, k); ``temps`` (S,), or None
    when every row is greedy (then ``generator`` is unused).

    At temperature 0 a proposal is accepted iff it equals the target argmax,
    and the next token is the target argmax after the accepted prefix: the
    greedy trajectory. At temperature T > 0 this is rejection sampling:
    accept d_j with probability min(1, p_t(d_j) / p_d(d_j)) (p = softmax of
    logits / T); the first rejected position draws from the normalized
    residual max(p_t - p_d, 0), and a row that accepted all k draws its
    bonus from p_t. Each emitted token is then distributed as ancestral
    sampling from the target.

    Returns (emitted (S, k+1): the accepted prefix, then the bonus /
    correction token, then zeros; counts (S,): accepted + 1)."""
    k = draft_tokens.shape[1]
    vocab = target_logits.shape[-1]
    device = target_logits.device
    ok = target_logits[:, :k].argmax(dim=-1) == draft_tokens
    if temps is not None:
        tscale = temps.clamp_min(1e-6)
        pt = torch.softmax(target_logits[:, :k].float() / tscale[:, None, None], dim=-1)
        pd = torch.softmax(draft_logits.float() / tscale[:, None, None], dim=-1)
        pt_d = pt.gather(-1, draft_tokens[..., None])[..., 0]
        pd_d = pd.gather(-1, draft_tokens[..., None])[..., 0]
        u = torch.rand(draft_tokens.shape, generator=generator, device=device)
        stoch_ok = u * pd_d.clamp_min(1e-20) < pt_d
        ok = torch.where((temps == 0.0)[:, None], ok, stoch_ok)
    # longest accepted prefix: cumprod flips to 0 at the 1st rejection
    a = ok.long().cumprod(dim=-1).sum(dim=-1)
    # the target's logits right after the accepted prefix
    pos_logits = target_logits.gather(1, a[:, None, None].expand(-1, 1, vocab))[:, 0]
    bonus = pos_logits.argmax(dim=-1)
    if temps is not None:
        pt_a = torch.softmax(pos_logits.float() / tscale[:, None], dim=-1)
        pd_a = pd.gather(1, a.clamp_max(k - 1)[:, None, None].expand(-1, 1, vocab))[:, 0]
        resid = torch.where((a < k)[:, None], (pt_a - pd_a).clamp_min(0.0), pt_a)
        # a residual of no mass (p_t == p_d there) falls back to p_t
        resid = torch.where(resid.sum(dim=-1, keepdim=True) > 1e-20, resid, pt_a)
        stoch_bonus = torch.multinomial(resid, 1, generator=generator)[:, 0]
        bonus = torch.where(temps == 0.0, bonus, stoch_bonus)
    counts = a + 1
    jpos = torch.arange(k + 1, device=device)[None, :]
    padded = torch.nn.functional.pad(draft_tokens, (0, 1))
    emitted = torch.where(
        jpos < a[:, None], padded,
        torch.where(jpos == a[:, None], bonus[:, None], torch.zeros_like(padded)),
    )
    return emitted, counts


@dataclasses.dataclass
class GenerationRequest:
    token_ids: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    # multi-tenant LoRA: the server resolves adapter_id to an AdapterStore
    # slot lease before admission and stamps the slot index here; -1 = base
    # model. The engine only reads the index: the lease's pin and release
    # belong to the caller that holds it.
    adapter_id: Optional[str] = None
    adapter_slot: int = -1


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[int]  # generated tokens only
    num_prompt_tokens: int
    finished_reason: str  # "eos" | "length"


class _DecodeModelBase:
    """Prefill and decode over the cached Llama, sharing ``params`` (the
    port's state dict, on ``device``) without copying them, and with an
    ``adapter_store`` reading its slot bank in every call that names an
    adapter. Under a bound ``plan`` of tp > 1, ``params`` are this rank's
    slices (``plan.shard_params``), and so are a draft's."""

    def __init__(self, model_config, params: Dict[str, torch.Tensor],
                 device: DeviceLike = None, adapter_store=None, plan=None):
        self._cfg = model_config
        self._plan = plan
        self._mesh_tag = plan.describe() if plan is not None else MESH_TAG
        self._device = resolve_device(device)
        wrong = {str(t.device) for t in params.values() if t.device != self._device}
        if wrong:
            raise ValueError(f"params on {sorted(wrong)}, engine on {self._device}")
        if adapter_store is not None and adapter_store.device != self._device:
            raise ValueError(
                f"adapter store on {adapter_store.device}, engine on {self._device}"
            )
        self._params = params
        self._model = build_llama(model_config, params, plan=plan)
        self._adapter_store = adapter_store
        self.forward_calls = 0
        # the rank executor's handle (llm/tp_ranks.py), set on every rank of
        # a tensor-parallel replica: it publishes rank 0's commands and
        # holds every sampled array to rank 0's
        self._lockstep = None

    def swap_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Hot weight reload: the model is rebuilt over ``params`` (the
        port's state dict on the engine's device, shared, not copied), so
        the next model call reads only the new weights. The engine then
        holds no reference to the old tensors, so the old copy is freed
        once its other holders (a weight subscriber's previous version)
        let go: a reload does not keep two models on the card. A call
        already running finishes on the model it started with. A draft
        keeps its own weights, as the reference's does. Under tensor
        parallelism each rank would need its new slices: it raises (ROADMAP
        A item 23)."""
        if self._lockstep is not None or (self._plan is not None and self._plan.num_devices > 1):
            raise NotImplementedError(
                "swap_params at tensor-parallel size > 1 is ROADMAP A item 23 "
                "(tensor-parallel hot reload): each rank needs its new slices "
                "over the rank group"
            )
        wrong = {str(t.device) for t in params.values() if t.device != self._device}
        if wrong:
            raise ValueError(f"params on {sorted(wrong)}, engine on {self._device}")
        model = build_llama(self._cfg, params, plan=self._plan)
        self._params, self._model = params, model

    @torch.inference_mode()
    def _forward(self, tokens: torch.Tensor, cache: DecodeCache,
                 slots: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The decode-mode model call every engine path makes: logits for
        every position, ``cache`` updated in place; ``slots`` are the rows'
        adapter slots (-1 = base). A call whose rows are all base skips the
        adapter path and is the call of an engine without a store. Counted
        in ``forward_calls``: on the card each call launches the RMSNorm
        kernel 2 * n_layers + 1 times."""
        self.forward_calls += 1
        if slots is not None and max(slots) >= 0:
            if self._adapter_store is None:
                raise ValueError(
                    f"rows name adapter slots {list(slots)} but the engine has "
                    "no adapter_store"
                )
            return self._model(tokens, cache, self._adapter_store.bank(), slots)
        return self._model(tokens, cache)

    def _prefill(self, tokens: torch.Tensor, slots: Optional[Sequence[int]] = None):
        """tokens (b, plen) -> (last-position logits (b, vocab), new cache)."""
        cache = new_cache(self._cfg, tokens.shape[0], self._device, self._plan)
        return self._forward(tokens, cache, slots)[:, -1, :], cache

    def _decode(self, cache: DecodeCache, last_tokens: torch.Tensor,
                slots: Optional[Sequence[int]] = None):
        """last_tokens (b, s) -> (last-position logits (b, vocab), cache
        updated in place)."""
        return self._forward(last_tokens, cache, slots)[:, -1, :], cache

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self._device)

    def _decide(self, fn):
        """``fn()``, a host decision: under tensor parallelism one that only
        rank 0 can make (it holds the tier client, the shipments and the
        adapter leases), made there and read by the other ranks at the same
        point (``fn`` runs on rank 0 only)."""
        return fn() if self._lockstep is None else self._lockstep.decide(fn)

    def _host_sync(self, x: torch.Tensor) -> np.ndarray:
        """:func:`host_sync`, and under tensor parallelism the check that
        every rank sampled the same (rank 0 raises if not)."""
        out = host_sync(x)
        if self._lockstep is not None:
            self._lockstep.agree(out)
        return out

    def _sample_tokens(self, logits, temps: np.ndarray, generator) -> np.ndarray:
        """Greedy where temps == 0, temperature-categorical elsewhere; an
        all-greedy batch skips the categorical draw."""
        if temps.any():
            t = torch.as_tensor(temps, device=logits.device)
            return self._host_sync(_sample_impl(logits, t, generator))
        return self._host_sync(logits.argmax(dim=-1))


class LLMEngine(_DecodeModelBase):
    def __init__(
        self,
        model_config,
        params: Dict[str, torch.Tensor],
        max_batch_size: int = 8,
        seed: Optional[int] = None,
        device: DeviceLike = None,
        adapter_store=None,
        plan=None,
    ):
        super().__init__(model_config, params, device, adapter_store, plan)
        self._max_batch = max_batch_size
        self._seed = _resolve_seed(seed)
        self._generator = torch.Generator(device=self._device)

    # -- generation ----------------------------------------------------------

    def generate(self, requests: List[GenerationRequest]) -> List[GenerationResult]:
        """Generate for a list of requests, grouping same-length prompts
        into batched prefill/decode loops."""
        if self._lockstep is not None:
            with self._lockstep.command(("generate", requests)):
                return self._generate(requests)
        return self._generate(requests)

    def _generate(self, requests: List[GenerationRequest]) -> List[GenerationResult]:
        groups: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(len(r.token_ids), []).append(i)
        results: List[Optional[GenerationResult]] = [None] * len(requests)
        for _plen, indices in sorted(groups.items()):
            for start in range(0, len(indices), self._max_batch):
                chunk = indices[start:start + self._max_batch]
                out = self._generate_group([requests[i] for i in chunk])
                for i, res in zip(chunk, out):
                    results[i] = res
        return results  # type: ignore[return-value]

    def _generate_group(
        self, requests: List[GenerationRequest]
    ) -> List[GenerationResult]:
        cfg = self._cfg
        b = len(requests)
        plen = len(requests[0].token_ids)
        max_new = max(r.max_new_tokens for r in requests)
        if plen + max_new > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) exceeds "
                f"max_seq_len ({cfg.max_seq_len})"
            )
        slots = [r.adapter_slot for r in requests]
        logits, cache = self._prefill(self._tokens([r.token_ids for r in requests]), slots)
        generated: List[List[int]] = [[] for _ in range(b)]
        finished = [False] * b
        reasons = ["length"] * b

        def record(last):
            for i, r in enumerate(requests):
                if finished[i] or len(generated[i]) >= r.max_new_tokens:
                    continue
                tok = int(last[i])
                generated[i].append(tok)
                if r.eos_token_id is not None and tok == r.eos_token_id:
                    finished[i] = True
                    reasons[i] = "eos"

        last = self._sample(logits, requests, 0)
        record(last)
        for step in range(1, max_new):
            if all(
                finished[i] or len(generated[i]) >= requests[i].max_new_tokens
                for i in range(b)
            ):
                break
            logits, cache = self._decode(cache, self._tokens(last).reshape(b, 1), slots)
            last = self._sample(logits, requests, step)
            record(last)

        return [
            GenerationResult(
                token_ids=generated[i][: r.max_new_tokens],
                num_prompt_tokens=plen,
                finished_reason=reasons[i],
            )
            for i, r in enumerate(requests)
        ]

    def _sample(self, logits, requests, step) -> np.ndarray:
        temps = np.array(
            [max(r.temperature, 0.0) for r in requests], np.float32
        )
        # the counterpart of fold_in(key, step): one stream per step index
        self._generator.manual_seed(_stream_seed(self._seed, step))
        return self._sample_tokens(logits, temps, self._generator)

    def generate_stream(self, request: GenerationRequest):
        """Token-by-token generation for ONE request: yields each generated
        token id as soon as it is sampled, then a final GenerationResult.
        Same programs and sampling rule as generate(), so at temperature 0
        the streamed tokens equal the batch path's. Under tensor
        parallelism a stream closed early still runs to its end, unseen:
        the other ranks run the whole stream."""
        if self._lockstep is None:
            yield from self._stream(request)
            return
        with self._lockstep.command(("stream", request)):
            stream = self._stream(request)
            try:
                for item in stream:
                    yield item
            finally:
                for _ in stream:
                    pass

    def _stream(self, request: GenerationRequest):
        cfg = self._cfg
        plen = len(request.token_ids)
        if plen + request.max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_seq_len "
                f"({cfg.max_seq_len})"
            )
        if request.max_new_tokens <= 0:  # matches generate()'s empty result
            yield GenerationResult(
                token_ids=[], num_prompt_tokens=plen, finished_reason="length"
            )
            return
        slots = [request.adapter_slot]
        logits, cache = self._prefill(self._tokens([request.token_ids]), slots)
        generated: List[int] = []
        reason = "length"
        last = self._sample_step(logits, request, 0)
        generated.append(last)
        yield last
        if request.eos_token_id is not None and last == request.eos_token_id:
            reason = "eos"
        else:
            for step in range(1, request.max_new_tokens):
                logits, cache = self._decode(cache, self._tokens([[last]]), slots)
                last = self._sample_step(logits, request, step)
                generated.append(last)
                yield last
                if (
                    request.eos_token_id is not None
                    and last == request.eos_token_id
                ):
                    reason = "eos"
                    break
        yield GenerationResult(
            token_ids=generated,
            num_prompt_tokens=plen,
            finished_reason=reason,
        )

    def _sample_step(self, logits, request, step) -> int:
        return int(self._sample(logits, [request], step)[0])


@dataclasses.dataclass
class _Prefix:
    """A prompt's prefix from a shipment or the tier, on this rank: the
    payload (this rank's KV heads), its leading blocks to adopt, whether it
    covers the whole prompt with the shipping side's first token."""

    payload: Any
    nblocks: int
    exact: bool
    first_token: Optional[int]


@dataclasses.dataclass
class _Slot:
    request_id: int
    request: GenerationRequest
    generated: List[int]
    last_token: int
    lease: Any = None  # KVCacheLease when the engine runs paged
    trace: Any = None  # {"ctx", "wall"} when the request is traced
    # leading full blocks of (prompt + generated[:-1]) already committed
    # into the radix index: the speculative path commits decode-tail
    # blocks eagerly (accepted runs cross block boundaries mid-flight)
    committed_blocks: int = 0
    last_emit_ts: float = 0.0  # monotonic stamp of the last emitted token


class ContinuousBatchingEngine(_DecodeModelBase):
    """Continuous (in-flight) batching: a fixed pool of decode slots; new
    requests prefill into free slots while other slots keep decoding, so
    short requests don't wait for long ones and the decode batch stays full.

    The decode step is ONE model call over the full (num_slots, 1) batch of
    a pooled :class:`~ray_tpu_torch.models.llama.DecodeCache` with a per-row
    cache index; prefill runs per request at its prompt length and its K/V
    row is copied into its slot. With a ``kv_cache``
    (:class:`~ray_tpu_torch.kvcache.KVCacheManager`) admission serves the
    longest cached prefix, prefills only the suffix, and waits when the
    block pool is full (backpressure); ``kv_cache=None`` is the dense
    per-slot pool.

    ``draft=(draft_config, draft_params)`` with ``spec_tokens=k`` turns on
    speculative decoding: the draft proposes k tokens per row and the target
    verifies them in one (num_slots, k+1) call. ``prefill_chunk_tokens`` caps
    the prefill tokens computed per step, so a long prompt advances in
    chunks beside the in-flight decodes instead of stalling them.

    Every cache here is written in place by each model call (the reference's
    are immutable values), so a prefill row is never shared: each chunked
    prefill starts from a fresh zero row, a slot row handed to the KV
    manager is a view that is committed before the next step writes the
    pool, and the speculative rollback resets the write position of every
    layer of both pools.

    With a ``kv_tier`` (:class:`~ray_tpu_torch.kvtier.KVTierClient`) over
    the ``kv_cache``, a prompt the local radix cannot cover consults the
    tier and adopts pulled blocks before it acquires, and a prefix computed
    here is exported for the other replicas. A directed ``shipment`` (the
    decode role) or an exact tier hit, which carries the whole prompt and
    its first sampled token, takes the zero-prefill path: the payload
    becomes the slot row and no model call runs. Adapter requests stay off
    the tier and off shipments: their K/V is adapter-tinted.

    With an ``adapter_store``, every target-model call carries its rows'
    adapter slots: the pooled step and the verify read
    :meth:`_row_adapter_slots` (free rows -1), every prefill route its
    request's slot. The draft stays the base model: it proposes base tokens
    and the verify holds them to the adapter-applied target.
    """

    def __init__(
        self,
        model_config,
        params: Dict[str, torch.Tensor],
        num_slots: int = 8,
        kv_cache=None,
        seed: Optional[int] = None,
        draft=None,
        spec_tokens: int = 0,
        prefill_chunk_tokens: int = 0,
        kv_tier=None,
        adapter_store=None,
        device: DeviceLike = None,
        plan=None,
    ):
        super().__init__(model_config, params, device, adapter_store, plan)
        self._num_slots = num_slots
        self._slots: Dict[int, _Slot] = {}  # slot index -> active request
        # (request_id, GenerationRequest, shipment or None): the third
        # element carries a directed prefill->decode handoff
        self._pending: List[tuple] = []
        # under tensor parallelism, requests added since the last step: rank
        # 0 publishes them with the step and every rank queues them then
        self._inbox: List[tuple] = []
        self._next_id = 0
        self._seed = _resolve_seed(seed)
        self._generator = torch.Generator(device=self._device)
        self._step_count = 0
        self._cache: Optional[DecodeCache] = None  # pooled, on first admission
        self._kv = kv_cache
        if kv_cache is not None and plan is not None:
            # the block pools hold the same heads-slice as the decode cache
            # they exchange rows with
            kv_cache.adopt_plan(plan)
        # the cluster KV tier (a KVTierClient) over the paged pool, or None
        if kv_tier is not None and kv_tier.device != self._device:
            raise ValueError(f"kv tier on {kv_tier.device}, engine on {self._device}")
        self._tier = kv_tier
        # whether the replica is on the tier: under tensor parallelism every
        # rank runs the tier's paths, on rank 0's decisions, and only rank 0
        # holds the client (llm/tp_ranks.py build_engine sets it there)
        self._on_tier = kv_tier is not None
        # serve replicas call sync methods from a thread pool. One thread
        # at a time steps the shared pool, under _lock; the other callers
        # never wait on it: they enqueue, and wait for the stepper's next
        # step, under _progress only. (A lock that every caller takes to
        # step is taken back at once by the thread that releases it, and
        # the others' requests and results queue behind all of its steps.)
        self._lock = threading.Lock()
        self._progress = threading.Condition(threading.Lock())
        # under _progress: results finished by any step until their
        # generate() call collects them, and the tokens of every request
        # in a slot after the latest step, for generate_stream()
        self._finished_buf: Dict[int, GenerationResult] = {}
        self._in_flight: Dict[int, List[int]] = {}
        self._steps_published = 0
        # rid -> monotonic stamp at add_request, for TTFT; rid -> {"ctx",
        # "wall"} only while the request is traced; rids already reported
        # blocked on KV admission (one event per episode, not one per step)
        self._enqueue_ts: Dict[int, float] = {}
        self._req_trace: Dict[int, Any] = {}
        self._blocked_rids: set = set()
        # -- speculative decoding (draft proposes, target verifies) --------
        # The draft keeps its own dense per-slot pool (no paging: it is
        # small) with the SAME position invariant as the target: K/V for
        # prompt + generated[:-1], last_token not yet fed.
        self._spec_k = int(spec_tokens) if draft is not None else 0
        self._draft: Optional[_DecodeModelBase] = None
        self._draft_cache: Optional[DecodeCache] = None
        if draft is not None and self._spec_k > 0:
            draft_cfg, draft_params = draft
            if draft_cfg.max_seq_len < model_config.max_seq_len:
                raise ValueError(
                    "draft max_seq_len must cover the target's "
                    f"({draft_cfg.max_seq_len} < {model_config.max_seq_len})"
                )
            # sharded under the same plan: the draft runs in lockstep too
            self._draft = _DecodeModelBase(draft_cfg, draft_params, self._device, plan=plan)
        self.spec_proposed = 0  # draft tokens proposed, over all steps
        self.spec_accepted = 0  # of which the target accepted
        # -- chunked prefill ----------------------------------------------
        # per-STEP token budget across all in-progress prefills; 0 = run
        # each admission prefill to completion. In-progress prefills park
        # in _prefilling keyed by their reserved slot index.
        self._prefill_chunk = int(prefill_chunk_tokens or 0)
        self._prefilling: Dict[int, dict] = {}
        # prefill tokens computed by the most recent step()
        self.last_step_prefill_tokens = 0

    def swap_params(self, params: Dict[str, torch.Tensor]) -> None:
        """:meth:`_DecodeModelBase.swap_params` between steps, and the
        cached prefixes dropped: their K/V are projections of the old
        weights, and a later request must not hit them. (The reference keeps
        its prefix index across a swap.)"""
        with self._lock:
            super().swap_params(params)
            self._kv.drop_cached()

    # -- public API ----------------------------------------------------------

    def add_request(self, request: GenerationRequest, shipment=None) -> int:
        """Queue a request; returns its id. ``shipment`` is an optional
        directed KV handoff: a ``(KVShipment, payload)`` pair from a prefill
        replica (fetched by the caller through the tier). Admission adopts
        the shipped blocks instead of running prefill."""
        if len(request.token_ids) + request.max_new_tokens > self._cfg.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        if shipment is not None and self._lockstep is not None and not self._on_tier:
            raise ValueError("a tensor-parallel engine adopts a shipment only on the KV tier")
        if self._spec_k and (
            len(request.token_ids) + request.max_new_tokens + self._spec_k
            > self._cfg.max_seq_len
        ):
            # the verify pass writes k+1 provisional positions past the
            # current index, and the cache write CLAMPS a start past the
            # end, which would silently overwrite earlier entries near
            # max_seq_len: refuse up front instead
            raise ValueError(
                "prompt + max_new_tokens + spec_tokens exceeds max_seq_len "
                "(speculative verification needs headroom)"
            )
        tr = None
        if _tracing.is_tracing_enabled():
            tr = {"ctx": _tracing.current_context(), "wall": time.time()}
        with self._progress:
            rid = self._next_id
            self._next_id += 1
            self._enqueue_ts[rid] = time.monotonic()
            if tr is not None:
                self._req_trace[rid] = tr
            # the stepping thread only pops the head and puts a blocked
            # request back there: an append stays behind both
            (self._pending if self._lockstep is None else self._inbox).append(
                (rid, request, shipment))
        return rid

    @property
    def num_active(self) -> int:
        return (len(self._slots) + len(self._pending) + len(self._prefilling)
                + len(self._inbox))

    def step(self) -> List[tuple]:
        """One engine iteration: admit pending requests into free slots
        (prefill), decode one token for every occupied slot, retire finished
        requests. Returns [(request_id, GenerationResult)] finished now."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> List[tuple]:
        if self._lockstep is not None:
            # every rank queues the same requests before the same step
            with self._progress:
                added, self._inbox = self._inbox, []
            self._lockstep.publish(("step", [(rid, req) for rid, req, _ in added]))
            self._pending.extend(added)
        self.last_step_prefill_tokens = 0
        finished: List[tuple] = self._admit()
        if self._prefilling:
            self._advance_prefills(finished)
        if not self._slots:
            return finished
        if self._draft is not None:
            self._spec_step(finished)
        else:
            self._dense_step(finished)
        return finished

    def _dense_step(self, finished: List[tuple]) -> None:
        # one decode step for the whole pool; free rows compute garbage at
        # their stale positions (both the RoPE rows and the cache write are
        # clamped into range) and are ignored
        last = np.zeros((self._num_slots, 1), np.int64)
        for si, slot in self._slots.items():
            last[si, 0] = slot.last_token
        logits, _ = self._decode(self._cache, self._tokens(last), self._row_adapter_slots())
        self._step_count += 1
        tokens = self._sample_rows(logits)  # ends in _host_sync
        now = time.monotonic()
        for si in list(self._slots):
            slot = self._slots[si]
            tok = int(tokens[si])
            slot.generated.append(tok)
            slot.last_token = tok
            if slot.last_emit_ts:
                _metrics.record_serve_itl(now - slot.last_emit_ts, mesh=self._mesh_tag)
            slot.last_emit_ts = now
            req = slot.request
            done_eos = req.eos_token_id is not None and tok == req.eos_token_id
            done_len = len(slot.generated) >= req.max_new_tokens
            if done_eos or done_len:
                self._finish_slot(
                    si, slot, "eos" if done_eos else "length", finished
                )

    def _spec_step(self, finished: List[tuple]) -> None:
        """One speculative iteration for the whole pool: the draft proposes
        k tokens per row, the target verifies all k in ONE (num_slots, k+1)
        call that also yields the accepted-prefix length and the bonus /
        correction token; both pools roll back to the corrected position.
        One host transfer of (tokens, counts) per step."""
        S, k = self._num_slots, self._spec_k
        last = np.zeros((S, 1), np.int64)
        temps = np.zeros(S, np.float32)
        start = np.zeros(S, np.int64)
        for si, slot in self._slots.items():
            last[si, 0] = slot.last_token
            temps[si] = max(slot.request.temperature, 0.0)
            # cache invariant: K/V covers prompt + generated[:-1]
            start[si] = len(slot.request.token_ids) + len(slot.generated) - 1
        stream = 10_000 + self._step_count
        self._step_count += 1
        # None: every row greedy (decided on the host, no device sync)
        temps_d = torch.as_tensor(temps, device=self._device) if temps.any() else None
        chunk, draft_logits = self._propose(self._tokens(last), temps_d, stream)
        emitted, counts = self._verify(
            chunk, draft_logits, temps_d, self._tokens(start), stream
        )
        em = self._host_sync(emitted)
        cnt = self._host_sync(counts)
        now = time.monotonic()
        proposed = accepted = 0
        for si in list(self._slots):
            slot = self._slots[si]
            req = slot.request
            n = int(cnt[si])
            proposed += k
            accepted += n - 1  # the last emitted is bonus/correction
            done_reason = None
            for j in range(n):
                tok = int(em[si, j])
                slot.generated.append(tok)
                slot.last_token = tok
                if req.eos_token_id is not None and tok == req.eos_token_id:
                    done_reason = "eos"
                    break
                if len(slot.generated) >= req.max_new_tokens:
                    done_reason = "length"
                    break
            if slot.last_emit_ts:
                # n tokens landed in one step: each saw gap/n of latency
                _metrics.record_serve_itl(
                    (now - slot.last_emit_ts) / max(n, 1), n=n, mesh=self._mesh_tag
                )
            slot.last_emit_ts = now
            if done_reason is not None:
                self._finish_slot(si, slot, done_reason, finished)
            else:
                self._commit_decode_tail(si, slot)
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        if proposed:
            _metrics.record_spec_tokens(proposed, accepted, mesh=self._mesh_tag)

    def _row_adapter_slots(self) -> np.ndarray:
        """Per-row adapter slots of the pooled batch; free rows read -1
        (base: their garbage compute stays adapter-free)."""
        slots = np.full(self._num_slots, -1, np.int64)
        for si, slot in self._slots.items():
            slots[si] = slot.request.adapter_slot
        return slots

    @staticmethod
    def _kv_key_tokens(req: GenerationRequest, tokens=None) -> List[int]:
        """The prefix-cache identity of a request's K/V: adapter-tinted K/V
        (wq/wk/wv run through the adapter) must never collide with the base
        model's, or another adapter's, cached prefixes, so an adapter
        request salts every token id with its adapter id, one key space per
        tenant in the shared radix index. Salted ids never reach the device:
        they are index keys only (``_tokens`` takes the plain ids)."""
        toks = list(req.token_ids if tokens is None else tokens)
        if req.adapter_id is None:
            return toks
        salt = (zlib.crc32(req.adapter_id.encode("utf-8")) + 1) << 32
        return [int(t) + salt for t in toks]

    def _finish_slot(self, si: int, slot: _Slot, reason: str,
                     finished: List[tuple]) -> None:
        req = slot.request
        finished.append((slot.request_id, GenerationResult(
            token_ids=slot.generated[: req.max_new_tokens],
            num_prompt_tokens=len(req.token_ids),
            finished_reason=reason,
        )))
        if slot.trace is not None:
            _tracing.emit_span(
                "engine.decode", slot.trace["ctx"], slot.trace["wall"],
                time.time() - slot.trace["wall"], category="engine",
                request_id=slot.request_id, tokens=len(slot.generated),
                finished=reason, mesh=self._mesh_tag,
            )
        self._retire_slot(si)

    def _commit_decode_tail(self, si: int, slot: _Slot) -> None:
        """Speculative mode commits decode-tail blocks eagerly: an accepted
        run can cross several block boundaries in one step, and waiting for
        retire would keep long-lived sequences' tails invisible to
        concurrent shared-prefix requests. Best-effort: the lease is
        extended for the new blocks first; on pool pressure the tail simply
        is not cached (never an error)."""
        if self._kv is None or slot.lease is None or slot.lease.cacheable is False:
            return
        bs = self._kv.block_size
        tokens = list(slot.request.token_ids) + slot.generated[:-1]
        avail = len(tokens) // bs
        if avail <= slot.committed_blocks:
            return
        self._kv.extend(slot.lease, avail - slot.committed_blocks)
        # a view of the slot's row: committed (copied) before any write
        self._kv.commit(
            slot.lease, self._kv_key_tokens(slot.request, tokens[: avail * bs]),
            self._cache.row(si), pin=False,
        )
        slot.committed_blocks = avail

    def _retire_slot(self, si: int) -> None:
        """Free the slot; with a KV manager, first commit the sequence's
        full blocks (prompt + generated tail) so a follow-up request
        sharing the prefix hits, then release the lease's pins."""
        slot = self._slots.pop(si)
        if self._kv is None or slot.lease is None:
            return
        req = slot.request
        # K/V exists for prompt + generated[:-1]: the final sampled token
        # was never fed back through the model
        tokens = list(req.token_ids) + slot.generated[:-1]
        already = max(
            slot.committed_blocks, len(req.token_ids) // self._kv.block_size
        )
        if len(tokens) // self._kv.block_size > already:
            cm_t0 = time.time() if slot.trace else 0.0
            self._kv.commit(
                slot.lease, self._kv_key_tokens(req, tokens), self._cache.row(si), pin=False
            )
            if slot.trace:
                _tracing.emit_span(
                    "kvcache.commit", slot.trace["ctx"], cm_t0,
                    time.time() - cm_t0, category="kvcache",
                    request_id=slot.request_id, tokens=len(tokens), tail=True,
                )
        self._kv.release(slot.lease)

    def run_until_complete(self) -> Dict[int, GenerationResult]:
        """Drain every queued request; returns request_id -> result.
        Long-running callers should consume step()'s return value instead:
        the engine keeps NO finished-result state."""
        out: Dict[int, GenerationResult] = {}
        with self._lock:
            while self.num_active:
                for rid, result in self._step_locked():
                    out[rid] = result
        return out

    def generate(self, requests: List[GenerationRequest]) -> List[GenerationResult]:
        """Batch API matching LLMEngine.generate: enqueue every request and
        wait for all of them. Safe to call from several threads at once:
        one of the callers steps the shared pool for all (see _advance)."""
        return self._collect([self.add_request(r) for r in requests])

    def generate_one(self, request: GenerationRequest,
                     shipment=None) -> GenerationResult:
        """generate() for ONE request, with an optional directed KV
        ``shipment`` (see add_request): the decode role's entry point."""
        return self._collect([self.add_request(request, shipment=shipment)])[0]

    def generate_stream(self, request: GenerationRequest):
        """Streaming API matching LLMEngine.generate_stream: yields each
        token of ONE request as the shared pool produces it, then the final
        GenerationResult. Other requests keep decoding in the same steps.
        Closing the generator early cancels the request (:meth:`cancel`)."""
        rid = self.add_request(request)
        emitted = 0
        done = False
        try:
            while True:
                with self._progress:
                    final = self._finished_buf.pop(rid, None)
                    tokens = self._in_flight.get(rid, []) if final is None else final.token_ids
                for tok in tokens[emitted:]:
                    yield tok
                emitted = max(emitted, len(tokens))
                if final is not None:
                    done = True
                    yield final
                    return
                self._advance()
        finally:
            if not done:
                self.cancel(rid)

    def cancel(self, rid: int) -> None:
        """Drop a request its caller abandoned (a closed stream), wherever
        it is: pending, prefilling or decoding in a slot. It runs under the
        step lock, so on return no step computes the request's row any more:
        the caller may then release what the request held, such as its
        adapter lease, whose slot may be rewritten at once. A decoding row
        retires as a finished one does (its full blocks, computed while the
        adapter was leased, are committed); a prefill in progress releases
        its KV lease. No result is kept."""
        with self._lock:
            if self._lockstep is not None:
                # a request still in the inbox was never published: the
                # other ranks never saw it
                with self._progress:
                    published = all(p[0] != rid for p in self._inbox)
                    self._inbox = [p for p in self._inbox if p[0] != rid]
                if published:
                    self._lockstep.publish(("cancel", rid))
            with self._progress:
                self._pending = [p for p in self._pending if p[0] != rid]
                self._finished_buf.pop(rid, None)
                self._in_flight.pop(rid, None)
                self._enqueue_ts.pop(rid, None)
                self._req_trace.pop(rid, None)
                self._blocked_rids.discard(rid)
            for si, slot in list(self._slots.items()):
                if slot.request_id == rid:
                    self._retire_slot(si)
            for si, st in list(self._prefilling.items()):
                if st["rid"] == rid:
                    del self._prefilling[si]
                    if st["lease"] is not None:
                        self._kv.release(st["lease"])

    def _collect(self, rids: List[int]) -> List[GenerationResult]:
        out: Dict[int, GenerationResult] = {}
        while True:
            with self._progress:
                for rid in rids:
                    if rid in self._finished_buf:
                        out[rid] = self._finished_buf.pop(rid)
            if len(out) == len(rids):
                return [out[rid] for rid in rids]
            self._advance()

    def _advance(self) -> None:
        """Step the pool if no other thread is stepping it, else wait for
        that thread's next step. So one caller runs the steps for all, a
        request sent meanwhile is admitted at its next step, and when it
        leaves, a waiting caller takes over after its last step."""
        with self._progress:
            seen = self._steps_published
        if not self._lock.acquire(blocking=False):
            with self._progress:
                # the timeout covers a stepper that publishes nothing
                # (step() or run_until_complete() called directly)
                self._progress.wait_for(lambda: self._steps_published != seen, timeout=0.05)
            return
        try:
            finished = self._step_locked()
            in_flight = {s.request_id: list(s.generated) for s in self._slots.values()}
        finally:
            self._lock.release()
        with self._progress:
            self._finished_buf.update(finished)
            self._in_flight = in_flight
            self._steps_published += 1
            self._progress.notify_all()

    def prefill_only(self, request: GenerationRequest):
        """The prefill role of disaggregated serving: run the admission
        prefill of ONE request and ship its K/V (every prompt token and the
        first sampled token) through the tier. Returns the KVShipment the
        decode role adopts, or None when this engine cannot serve it now
        (no pool or tier, an adapter request, or an exhausted pool): the
        caller then serves the request fused, so a prefill-side problem
        costs latency, never a request. Under tensor parallelism it is a
        command the other ranks replay (:meth:`_prefill_only`)."""
        if self._kv is None or not self._on_tier:
            return None
        if request.adapter_id is not None:
            return None  # adapter-tinted K/V never ships through the base tier
        if len(request.token_ids) + request.max_new_tokens > self._cfg.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        with self._lock:
            with self._progress:
                rid = self._next_id
                self._next_id += 1
            if self._lockstep is not None:
                self._lockstep.publish(("prefill_only", request, rid))
            return self._prefill_only(request, rid)

    def _prefill_only(self, request: GenerationRequest, rid: int):
        """:meth:`prefill_only`'s work under the step lock, on every rank of
        a tensor-parallel replica (the others with rank 0's request id):
        rank 0 decides whether its pool can take the prompt now, every rank
        prefills its heads, and rank 0 gathers them and ships."""
        plen = len(request.token_ids)
        lease = self._kv.acquire(request.token_ids)
        if not self._decide(lambda: lease is not None):
            if lease is not None:
                self._kv.release(lease)
            return None
        if lease is None:
            raise RuntimeError("tensor-parallel ranks disagree: rank 0's pool took a "
                               "disaggregated prefill that this rank's pool refuses")
        try:
            logits, solo = self._prefill_leased(request, lease)
            first = self._sample_first(logits, request, rid)
            cached = lease.num_cached_tokens
            self._kv.record_prefill(cached, plen - cached)
            self._kv.commit(lease, request.token_ids, solo)
            payload = self._kv.gather_payload(self._kv.extract_row_payload(solo, plen))
            if self._tier is None:
                return None  # another rank of the replica: rank 0 ships
            return self._tier.ship_direct(
                request.token_ids, payload, plen // self._kv.block_size,
                first_token=first,
            )
        finally:
            # committed blocks stay in the radix index (referenced by
            # the index itself): the prefill replica's cache warms
            # though it never decodes
            self._kv.release(lease)

    # -- internals -----------------------------------------------------------

    def _admit(self) -> List[tuple]:
        """Prefill pending requests into free slots; returns the (rare)
        requests that finish AT admission (eos on the first token, or
        max_new_tokens == 1) so step() reports every finish.

        With a KV manager the admission is memory-aware: the request first
        acquires a lease (longest cached prefix + reserved blocks for the
        rest of the prompt). A None lease means the pool is exhausted: the
        request goes back to the HEAD of the pending queue and admission
        stops, preserving FIFO order, until a retiring request releases
        blocks. Cached prefixes are gathered into the slot row and only the
        uncached suffix is prefilled.

        With a KV tier on top, resolution is local-hit -> peer-pull ->
        recompute: a prompt the local radix can't cover consults the tier
        and adopts pulled blocks before acquiring. A directed shipment or
        an exact tier hit that carries the whole prompt and the first
        sampled token takes the zero-prefill path: the shipped payload
        becomes the slot row outright."""
        finished: List[tuple] = []
        free = [
            i for i in range(self._num_slots)
            if i not in self._slots and i not in self._prefilling
        ]
        while free and self._pending:
            si = free.pop(0)
            rid, req, ship = self._pending.pop(0)
            tr = self._req_trace.get(rid)
            plen = len(req.token_ids)
            pulled = None
            # the tier and directed shipments carry BASE-model K/V; adapter
            # requests stay off both (their prefixes live in the adapter-
            # salted local key space)
            if (self._kv is not None and req.adapter_id is None
                    and (ship is not None or self._on_tier)):
                pulled = self._resolve_prefix(req, ship)
            fast = pulled is not None and pulled.exact
            tier_src = "peer" if pulled is not None else None
            lease = None
            if self._kv is not None:
                kv_t0 = time.time() if tr else 0.0
                if pulled is not None:
                    # shipped blocks land in the pool and the radix BEFORE
                    # the acquire, so the lease pins them like a local hit
                    self._kv.initialize_for(self._cfg, self._device)
                    self._kv.adopt_blocks(req.token_ids, pulled.payload["blocks"],
                                          pulled.nblocks)
                lease = self._kv.acquire(self._kv_key_tokens(req))
                if lease is None:  # backpressure: wait for a release
                    self._pending.insert(0, (rid, req, ship))
                    if rid not in self._blocked_rids:
                        self._blocked_rids.add(rid)
                        _events.record_event(
                            _events.ENGINE_ADMISSION_BLOCKED, request_id=rid,
                            prompt_tokens=plen, pending=len(self._pending),
                        )
                    break
                self._blocked_rids.discard(rid)
                if tr:
                    _tracing.emit_span(
                        "kvcache.acquire", tr["ctx"], kv_t0, time.time() - kv_t0,
                        category="kvcache", request_id=rid,
                        cached_tokens=lease.num_cached_tokens,
                    )
            tr = self._req_trace.pop(rid, None)
            if tr:
                _tracing.emit_span(
                    "engine.queue_wait", tr["ctx"], tr["wall"], time.time() - tr["wall"],
                    category="engine", request_id=rid,
                )
            if self._prefill_chunk and not fast:
                # budgeted prefill: the request keeps its slot reservation
                # but computes nothing yet; _advance_prefills spreads the
                # prompt over engine steps alongside in-flight decodes
                self._prefilling[si] = {
                    "rid": rid, "req": req, "lease": lease, "tier_src": tier_src,
                    "tr": tr, "row": None, "pos": 0, "logits": None, "committed": 0,
                    "pf_wall": time.time() if tr else 0.0,
                }
                continue
            pf_wall = time.time() if tr else 0.0
            if fast:
                # zero prefill: the payload covers every prompt token and
                # the shipping replica sampled the first token
                solo = self._kv.build_row(pulled.payload, plen)
                first = pulled.first_token
            else:
                logits, solo = self._prefill_leased(req, lease, trace=tr)
                self.last_step_prefill_tokens += plen - (
                    lease.num_cached_tokens if lease is not None else 0
                )
                first = self._sample_first(logits, req, rid)
            if not self._finish_admission(si, rid, req, lease, solo, first, fast,
                                          tier_src, tr, pf_wall, finished):
                free.insert(0, si)
        return finished

    def _finish_admission(self, si, rid, req, lease, solo: DecodeCache, first: int,
                          fast: bool, tier_src: Optional[str], tr, pf_wall: float,
                          finished: List[tuple]) -> bool:
        """The admission tail every prefill path (inline, chunked, zero-
        prefill) funnels through: TTFT and prefill metrics, prompt-block
        commit and tier export, pool row insert, slot creation. ``first``
        came back through host_sync (or with the shipment), so the TTFT
        stamp is the first token's completion. Returns False when the
        request finished AT admission (eos on the first token /
        max_new_tokens <= 1): the caller returns the slot."""
        plen = len(req.token_ids)
        if tr:
            cached = plen if fast else lease.num_cached_tokens if lease is not None else 0
            _tracing.emit_span(
                "engine.prefill", tr["ctx"], pf_wall, time.time() - pf_wall,
                category="engine", request_id=rid, cached_tokens=cached,
                computed_tokens=plen - cached, hit=cached > 0,
                tier=tier_src or "local", mesh=self._mesh_tag,
            )
        ts = self._enqueue_ts.pop(rid, None)
        if self._kv is not None:
            cached = plen if fast else lease.num_cached_tokens
            self._kv.record_prefill(cached, plen - cached)
            if ts is not None:
                _metrics.record_kvcache_ttft(
                    time.monotonic() - ts, hit=cached > 0, mesh=self._mesh_tag,
                    tier=tier_src or ("local" if cached > 0 else "miss"),
                )
            if not fast:
                # commit the prompt's full blocks while the prefilled row is
                # at hand; reserved blocks are consumed here (the zero-
                # prefill path adopted them instead)
                cm_t0 = time.time() if tr else 0.0
                self._kv.commit(lease, self._kv_key_tokens(req), solo)
                if tr:
                    _tracing.emit_span(
                        "kvcache.commit", tr["ctx"], cm_t0, time.time() - cm_t0,
                        category="kvcache", request_id=rid, tokens=plen,
                    )
                nblocks = plen // self._kv.block_size
                if (
                    self._on_tier
                    and lease.cacheable
                    and req.adapter_id is None
                    and self._decide(lambda: self._tier.should_export(req.token_ids, nblocks))
                ):
                    # the first computation of this prefix here: publish it,
                    # so other replicas (and fresh scale-ups) pull instead
                    # of recomputing
                    payload = self._kv.gather_payload(self._kv.extract_row_payload(solo, plen))
                    if self._tier is not None:  # rank 0 holds the tier client
                        self._tier.export_and_register(req.token_ids, payload, nblocks,
                                                       first_token=first)
        if self._cache is None:
            self._cache = new_cache(self._cfg, self._num_slots, self._device, self._plan)
        self._cache.insert_row(si, solo)
        req_eos = req.eos_token_id is not None and first == req.eos_token_id
        if req_eos or req.max_new_tokens <= 1:
            finished.append((rid, GenerationResult(
                token_ids=[first][: req.max_new_tokens],
                num_prompt_tokens=plen,
                finished_reason="eos" if req_eos else "length",
            )))
            if self._kv is not None:
                self._kv.release(lease)
            return False
        if self._draft is not None:
            self._admit_draft_row(req, si)
        self._slots[si] = _Slot(
            request_id=rid, request=req, generated=[first], last_token=first,
            lease=lease,
            committed_blocks=plen // self._kv.block_size if self._kv is not None else 0,
            last_emit_ts=time.monotonic(),
            trace={"ctx": tr["ctx"], "wall": time.time()} if tr else None,
        )
        return True

    def _advance_prefills(self, finished: List[tuple]) -> None:
        """Advance in-progress chunked prefills, spending at most
        ``prefill_chunk_tokens`` across ALL of them this step. Chunks stay
        <= block_size (paged), as in suffix prefill; a completed prompt
        takes the normal admission tail (first-token sample, commit, slot
        insert) and decodes in the very same step."""
        budget = self._prefill_chunk - self.last_step_prefill_tokens
        chunk_max = self._kv.block_size if self._kv is not None else 32
        for si in list(self._prefilling):
            if budget <= 0:
                break
            st = self._prefilling[si]
            req, lease, tr = st["req"], st["lease"], st["tr"]
            tokens = req.token_ids
            if st["row"] is None:
                if lease is not None and lease.num_cached_tokens:
                    st["row"] = self._assemble(lease, tr)
                    st["pos"] = lease.num_cached_tokens
                    st["committed"] = lease.num_cached_tokens // self._kv.block_size
                else:
                    st["row"] = self._empty_row()
            pos = st["pos"]
            while pos < len(tokens) and budget > 0:
                take = min(chunk_max, len(tokens) - pos, budget)
                st["logits"], _ = self._decode(
                    st["row"], self._tokens([tokens[pos:pos + take]]), [req.adapter_slot]
                )
                pos += take
                budget -= take
                self.last_step_prefill_tokens += take
            st["pos"] = pos
            if pos < len(tokens):
                bs = self._kv.block_size if self._kv is not None else 0
                if (
                    self._kv is not None and lease is not None
                    and pos // bs > st["committed"]
                ):
                    # partial commit: completed full blocks become hittable
                    # for concurrent shared-prefix admissions NOW, not when
                    # the whole prompt lands
                    self._kv.commit(lease, self._kv_key_tokens(req, tokens[:pos]), st["row"])
                    st["committed"] = pos // bs
                continue
            del self._prefilling[si]
            first = self._sample_first(st["logits"], req, st["rid"])
            self._finish_admission(
                si, st["rid"], req, lease, st["row"], first, False, st["tier_src"], tr,
                st["pf_wall"], finished,
            )

    def _resolve_prefix(self, req: GenerationRequest, ship) -> Optional["_Prefix"]:
        """The prefix of ``req`` that comes from elsewhere: the directed
        ``ship`` trimmed to the prompt, or else, past what the local radix
        covers, a tier pull; None when neither covers any of it. Under
        tensor parallelism rank 0, which holds the shipment and the tier
        client, decides, and the payload's KV heads are scattered to the
        ranks through the group."""
        found: List[PulledPrefix] = []

        def decide():
            if ship is not None:
                pulled = self._as_pulled(ship, req)
            else:
                pulled = None
                local = self._kv.cached_blocks(req.token_ids)
                if local < (len(req.token_ids) - 1) // self._kv.block_size:
                    pulled = self._tier.pull(req.token_ids, min_blocks=local)
            if pulled is None:
                return None
            found.append(pulled)
            nblocks = pulled.shipment.nblocks if pulled.exact else pulled.matched_blocks
            first = int(pulled.shipment.first_token) if pulled.exact else None
            return nblocks, pulled.exact, first

        decided = self._decide(decide)
        if decided is None:
            return None
        nblocks, exact, first = decided
        ntokens = len(req.token_ids) if exact else nblocks * self._kv.block_size
        payload = self._kv.scatter_payload(found[0].payload if found else None, nblocks, ntokens)
        return _Prefix(payload, nblocks, exact, first)

    @staticmethod
    def _as_pulled(ship, req: GenerationRequest):
        """A directed ``(KVShipment, payload)`` handoff in the shape a tier
        pull returns, trimmed to OUR prompt: matched blocks is the common
        full-block prefix, and exact means the payload covers the whole
        prompt token for token with a first token. None when it covers none
        of it."""
        shipment, payload = ship
        prompt = [int(t) for t in req.token_ids]
        bs = shipment.block_size
        nb = 0
        for i in range(min(shipment.nblocks, len(prompt) // bs)):
            if prompt[i * bs:(i + 1) * bs] == [
                int(t) for t in shipment.token_ids[i * bs:(i + 1) * bs]
            ]:
                nb += 1
            else:
                break
        exact = (
            shipment.first_token is not None
            and shipment.ntokens == len(prompt)
            and [int(t) for t in shipment.token_ids] == prompt
        )
        if nb == 0 and not exact:
            return None
        return PulledPrefix(shipment=shipment, payload=payload, matched_blocks=nb, exact=exact)

    def _empty_row(self) -> DecodeCache:
        """A fresh all-zero 1-row cache with write position 0: the chunked
        prefill seed when no cached prefix exists. Never shared or reused:
        every decode call writes its row in place, so a shared template
        would carry one prompt's K/V into the next."""
        return new_cache(self._cfg, 1, self._device, self._plan)

    def _admit_draft_row(self, req: GenerationRequest, si: int) -> None:
        """Full-prompt draft prefill into the draft pool. The draft never
        pages or prefix-caches (it is small enough that recomputing its
        prompt K/V is the cheap part of the speculative trade) but it keeps
        the target's exact position invariant, so both caches roll back to
        the same corrected index."""
        _, dsolo = self._draft._prefill(self._tokens([req.token_ids]))
        if self._draft_cache is None:
            self._draft_cache = new_cache(self._draft._cfg, self._num_slots, self._device,
                                          self._plan)
        self._draft_cache.insert_row(si, dsolo)

    def _propose(self, last: torch.Tensor, temps: Optional[torch.Tensor], stream: int):
        """The k-step draft proposal: decode and sample d_1..d_k from the
        draft pool, then one extra feed writes d_k's K/V so that the
        rollback index ``start + counts`` is valid for EVERY acceptance
        count. Tokens stay on the device. Returns (chunk (S, k+1) =
        [last, d_1..d_k], draft logits (S, k, V))."""
        tok, fed, dlogits = last, [], []
        for j in range(self._spec_k):
            lg, _ = self._draft._decode(self._draft_cache, tok)
            if temps is None:
                nxt = lg.argmax(dim=-1)
            else:
                self._generator.manual_seed(_stream_seed(self._seed, stream, j + 1))
                nxt = _sample_impl(lg, temps, self._generator)
            fed.append(tok[:, 0])
            dlogits.append(lg)
            tok = nxt[:, None]
        self._draft._decode(self._draft_cache, tok)
        chunk = torch.cat([torch.stack(fed, dim=1), tok], dim=1)
        return chunk, torch.stack(dlogits, dim=1)

    def _verify(self, chunk, draft_logits, temps, start, stream: int):
        """The speculative verify: ONE target call over the (num_slots, k+1)
        chunk [last_token, d_1..d_k], with the rows' adapters (the draft
        proposed base tokens), scores every proposal; then
        :func:`speculative_accept` and the rollback of both pools' write
        positions. ``temps`` None means every row is greedy. Returns
        (emitted (S, k+1), counts (S,))."""
        logits = self._forward(chunk, self._cache, self._row_adapter_slots())  # (S, k+1, V)
        if temps is not None:
            self._generator.manual_seed(_stream_seed(self._seed, stream, 0))
        emitted, counts = speculative_accept(
            logits, draft_logits, chunk[:, 1:], temps, self._generator
        )
        # rollback-as-index-reset, every layer of both pools: K/V past the
        # new index is garbage the causal mask never reads and the next
        # verify overwrites before attending
        new_idx = start + counts
        self._cache.set_index(new_idx)
        self._draft_cache.set_index(new_idx)
        return emitted, counts

    def _assemble(self, lease, trace) -> DecodeCache:
        """The lease's cached prefix as a fresh row, with its
        ``kvcache.assemble`` span when the request is traced."""
        as_t0 = time.time() if trace else 0.0
        row = self._kv.assemble(lease)
        if trace:
            _tracing.emit_span(
                "kvcache.assemble", trace["ctx"], as_t0, time.time() - as_t0,
                category="kvcache", cached_tokens=lease.num_cached_tokens,
            )
        return row

    def _prefill_leased(self, req: GenerationRequest, lease, trace=None):
        """Prefill a request, reusing the lease's cached prefix: a full
        prefill on a miss; on a hit, gather the cached blocks into a fresh
        row and run only the uncached suffix through the decode path in
        chunks of at most block_size tokens."""
        tokens, slots = req.token_ids, [req.adapter_slot]
        if lease is None or lease.num_cached_tokens == 0:
            return self._prefill(self._tokens([tokens]), slots)
        row = self._assemble(lease, trace)
        logits = None
        pos = lease.num_cached_tokens
        while pos < len(tokens):
            take = min(self._kv.block_size, len(tokens) - pos)
            logits, _ = self._decode(row, self._tokens([tokens[pos:pos + take]]), slots)
            pos += take
        return logits, row

    def _sample_first(self, logits, req: GenerationRequest, rid: int) -> int:
        """A request's first token, from its own stream (fold_in(rng, rid)
        in the reference)."""
        self._generator.manual_seed(_stream_seed(self._seed, rid))
        temps = np.array([max(req.temperature, 0.0)], np.float32)
        return int(self._sample_tokens(logits, temps, self._generator)[0])

    def _sample_rows(self, logits) -> np.ndarray:
        temps = np.zeros(self._num_slots, np.float32)
        for si, slot in self._slots.items():
            temps[si] = max(slot.request.temperature, 0.0)
        self._generator.manual_seed(_stream_seed(self._seed, 10_000 + self._step_count))
        return self._sample_tokens(logits, temps, self._generator)
