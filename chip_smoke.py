#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ray_tpu_torch/csrc with nvcc (one process per
     source, all at once);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it and at edge cases, and time kernel, plain
     version and one PyTorch library call (a yardstick only: the port never
     calls it) with CUDA events, median of 21 timings of 10 launches: RMSNorm
     (beside its pooled-step rows, (8, 4096), the time of a one-element
     elementwise launch timed the same way: the launch floor),
     the flash-attention forward, then the flash-attention backward (dQ, and
     dK/dV) with lse from the forward kernel (at the ring's hops, the lse
     and delta of a merge of the hop's block with a causal one, as the ring
     feeds them); the bf16/f16 flash kernels run
     on the tensor cores and are held both to the plain version that rounds
     P (and dS) as they do (tightly) and to the f32 plain version (within
     the bound of that rounding); then the count of tensor-core instructions
     (HGMMA) in their SASS, with registers and spills, from cuobjdump;
  4. LoRA gradients of a 2-layer model at full Llama-2-7B width: the card
     (all four kernels) against the host CPU (their plain versions) in f32,
     then the card with bf16 activations against the same CPU gradients,
     within twice the error of a control run with bf16 activations on the CPU;
  5. the serving path: LLMServer at full Llama-2-7B width, cut to 4 of its
     32 layers (SERVE_LAYERS; random bf16 weights from seed 0), answers 4
     greedy requests of 128 prompt tokens and 32 new tokens, then streams
     one of them again;
  6. the full forward: Llama's full-sequence forward (flash attention) on the
     same 4 prompts against the cache path's prefill, in bf16 and again with
     f32 activations;
  6b. the runtime core on the card (``runtime_serve``): (a)
     ``ray_tpu_torch.init()`` finds the card as the node's GPU resource (1)
     and builds the native object store (the python fallback fails the
     phase); (b) a ``num_gpus=1`` task runs on cuda:0 through its lease
     (``get_gpu_ids() == [0]``, ``torch.cuda.current_device() == 0``) and
     returns a CUDA tensor drawn from a seed, which arrives as a CPU tensor
     equal bit for bit to this process's own, the first lease's wall (the
     worker's start, its torch import, the CUDA context) printed on a
     ``lap`` line; (c) a ``num_gpus=1`` actor (``RuntimeServer``) builds
     phase 5's LLMServer from the same seed in its worker and answers phase
     5's 4 prompts with 8 new greedy tokens, passed as ObjectRefs: tokens
     equal to this process's server's, K1 and K2 launches (read through an
     actor method) equal to this process's for the same requests and
     forward, K1 2L + 1 a model call; (d) device objects: the actor's full
     forward of the 4 prompts keeps its logits on its card
     (``tensor_transport="device"``), a next call in the actor resolves
     them zero-copy (same ``data_ptr``), this process's ``device_get``
     lands on its card equal to them by SHA-256, ``free_device_object``
     gives their bytes back (the worker's ``memory_allocated`` drops);
     the cluster stays up, the actor alive, for phase 9b;
  7. continuous batching over the paged prefix KV cache (LLMServer with
     kv_cache_blocks, on phase 5's weights): 16 greedy requests sharing a
     256-token prefix from 8 threads, with the exact prefix-hit and
     computed-token counts, no lease pin left, and K1 launched 9 (2L + 1) times
     per model call the engine counts; the pooled decode step with 8 slots
     active (time, and its device busy share under torch.profiler); TTFT
     of a 512-token miss and of a hit sharing 480 tokens. The metrics
     registry (ray_tpu_torch.util) must hold the manager's own counts
     exactly over the 16 requests (3,840 hit and 1,280 computed tokens), 1
     miss and 15 hit TTFT observations and 16 x 31 ITL observations, and
     each of the two TTFTs the engine recorded must be above 0 and no more
     than the one this phase measures on its host clock (both printed);
  7b. the observability plane on phase 7's server (``serve_obs``): (a) a
     wave of phase 7's traffic on a fresh prefix (to fill the cache), then
     the same wave with tracing off and with it on: equal greedy tokens, and
     every traced request's trace holds engine.queue_wait, kvcache.acquire,
     kvcache.assemble, engine.prefill, kvcache.commit and engine.decode;
     (b) the pooled step with 8 slots active, one profile each with tracing
     off and on: equal kernel launches (equal to phase 7's step), device-to-
     host copies and synchronising calls, and 16 timed steps each way in
     turns; (c) the host cost of record_serve_itl, record_kvcache_ttft,
     emit_span and record_event over 10,000 calls each, and 8 ITL records'
     share of phase 7's step; (d) sample_device_memory() beside
     torch.cuda.memory_allocated() and mem_get_info(); (e)
     tracing.device_profile around one served request with an
     annotate_device_trace region: the trace holds the region and K1
     launches; (f) the Prometheus text of this process, parsed back:
     cumulative buckets that never decrease, each _count the registry's;
  8. the continuous-batching engine against the dense engine at full width,
     2 layers, f32 activations: greedy tokens equal with mixed lengths and a
     shared prefix, with chunked prefill, and with speculative decoding (the
     target as its own draft, acceptance 1, and a random 1-layer draft);
  9. speculation (k=4, the 7B target as its own draft) and chunked prefill
     (an 896-token prompt arriving beside 7 decoding requests, which must
     each emit a token in every step) at full width in bf16; the registry's
     spec counters move by the engine's own, the acceptance gauge is their
     lifetime ratio, the ITL observations of the timed steps are the tokens
     they landed and over the engine's life sum(cnt); the chunked runs print
     the ITL histogram's p50 and p99 beside their largest step gap;
  9b. the serve control plane (``serve_deploy``) on 6b's cluster, its
     actor killed first: ``serve.run(build_llm_deployment(LLMConfig(...,
     num_replicas=2, resources_per_replica={"CPU": 1, "GPU": 0.5},
     prefix_affinity_tokens=16)))`` of phase 7's server config, seed-0 bf16
     weights drawn in each replica: (a) both replicas RUNNING, each bound to
     card 0 by its lease (``get_gpu_ids() == [0]``, weights on cuda:0, read
     through the replicas' mesh cards), the lap from ``serve.run`` printed;
     (b) each replica warmed as phase 7's server, then phase 7's 16
     requests from 8 threads through the handle with prefix affinity:
     phase 7's tokens (a parting only at a near-tie of the in-process
     server's top-2 logits, printed), prefix hits exactly 256 x (16 - the
     replicas used) over the replicas' KV stats (which case is printed),
     K1 9 a model call in each replica (its ``kernel_launches``), K2-K4
     none, tokens/s beside phase 7's; a serial wave of 4 requests on a new
     prefix on one replica, 3 x 256 hits; (c) a request through the stdlib
     HTTP proxy (urllib), the same request alone through the handle, and a
     streamed one give phase 7's tokens as (b)'s do (whether the proxy's
     equal the handle's exactly is printed), the stream's first item before
     its end, TTFT printed; (d) a replica killed: the next
     requests answered, the deployment back to 2 RUNNING replicas on card
     0's halves, the seconds printed; then ``shutdown()``: no worker left
     (6b's, the controller, the proxy, the replicas), no kernel library
     rebuilt (the workers load the build phase's);
  10. multi-tenant LoRA serving (LLMServer with kv_cache_blocks and
     adapters, on phase 5's weights; ``serve_lora``): 4 adapters of rank 16
     on every wq/wk/wv/wo from numpy seeds, prewarmed into 8 slots; phase
     7's 16 requests, request i naming tenant i % 5 (0: the base model),
     with the exact salted prefix accounting (one miss per key space) and K1
     launched 9 times per model call; in one pooled step with mixed slots
     the base rows' logits equal those of the same step with every slot at
     -1, and the adapter rows' logits differ from them; adapter rows against
     one model per tenant with the same A and B as static LoRA weights; a
     base-only pooled step with a store launches what phase 7's step
     launched; the pooled step's time, launches and busy share with mixed
     slots against all -1; TTFT of a tenant's miss and hit; then, at 2
     layers in f32 activations, greedy tokens of a mixed batch equal each
     tenant served alone, LLMPredictor, and the speculative and chunked
     engines with adapters; and LLMPredictor at 7B over 8 rows. Over the
     server's traffic the registry's adapter counters move by the store's
     own, with one adapter_cold_attach event per cold attach, at its slot;
  10b. disaggregated prefill/decode and the KV tier (``serve_disagg``, on
     phase 5's weights): (a) a prefill and a decode LLMServer (role=) over
     one kvtier.LocalTierBackend behind _DisaggIngress, 8 distinct
     512-token prompts from 8 threads, 32 new greedy tokens, against a
     fused paged server: tokens equal, the decode side computes no prefill
     token and adopts 16 blocks a prompt, raw wire bytes = logical bytes;
     (b) the same with the int8 shipment codec (a second pair): wire /
     logical <= 0.51, the codes the card made equal quantize_np's of the
     same K copied to the host, adopted K/V within half a scale step of the
     shipped K/V, and the first token where int8 parts from raw printed;
     (d) a prefill holder killed after shipping: the handoff recomputes;
     (c) a fresh server on the tier of a warm fused server (kv_tier=True)
     takes a warm 512-token prompt with zero prefill tokens (16 blocks
     pulled), then one sharing 480 tokens of another (15 pulled, 32
     computed), tokens equal the warm server's. The tier counters,
     kvtier_summary and the KV_SHIPPED events equal the counts the traffic
     implies; K1 launches 9 times per model call and K2 never (admission
     prefill is decode-mode, as in the reference). Each step of a handoff
     is timed on its own (extract, encode, fetch, decode, adopt, build_row;
     median over 8) beside the waves' walls and mean engine TTFTs;
  10c. tensor-parallel serving (``serve_tp``, on phase 5's weights): two
     gloo ranks sharing card 0 (this process is rank 0, rank 1 is spawned;
     NCCL refuses two ranks on one card): (a) LLMServer(tensor_parallel_size
     =2, devices=[0, 0], tp_backend="gloo") with phase 7's settings, rank
     1's slices sent through the group and checked by their sums; 8 greedy
     requests of a shared 128-token prefix + 32 own tokens, 8 new each,
     from 4 threads, then a stream, 8 timed pooled steps with 8 slots (the
     gloo collectives' share of them) and TTFT of a miss and a hit, all
     beside a tp=1 paged server on the same traffic: the exact prefix-hit
     and computed counts, 16 KV heads and half the pool bytes a rank, K1
     9 times per model call on each rank (rank 1's counts read back), K2-K4
     never, the per-sample agreement check never fired, and where each
     request's tokens part from tp=1's; (b) the first 2 layers with f32
     activations, a dense and a paged tp=2 server against tp=1 on the card
     and f32 / f64 host runs: prefill logits within 4x the f32 host's own
     error against f64, greedy tokens over 24 new tokens equal to tp=1's
     except where tp=1's top-2 logit gap is under that bound (printed, not
     failed), speculation with the target as its own draft on every rank
     accepting every proposal; (c) after each close() no child process
     and no process group is left, before train_dp forms its own;
  10d. the serving features of a tensor-parallel replica
     (``serve_tp_features``, on phase 5's weights, two gloo ranks sharing
     card 0): (d) phase 10's 4 adapters prewarmed into a tp=2 server's 8
     slots (each rank's slices sent through the store; each rank's bank
     equal, by SHA-256, to the plan's slices of a tp=1 store's bank) and
     phase 10's 16 requests from 8 threads: the salted accounting equal to
     phase 10's (2,816 hit, 2,304 computed), tokens/s, 16 timed pooled steps
     with mixed slots against all -1 (set on every rank); (e) phase 10b's
     waves across layouts, a tp=2 and a tp=1 server on one tier behind
     _DisaggIngress both ways (tp=2 prefill, tp=1 decode; then tp=1
     prefill, tp=2 decode), raw and int8: the decode side computes no
     prefill token and adopts 16 blocks a prompt, every shipment carries
     all 32 KV heads, int8 wire / logical <= 0.51, the handoff's extract
     (the gather over the ranks included), encode, fetch and adopt (the
     scatter included) timed, and the tp=2 side's raw K/V of a prompt held
     to an f32-activation tp=1 prefill within 4x a bf16 tp=1 prefill's own
     error; K1 9 times a model call on each rank, K2-K4 never, the
     agreement check never fired, no child or process group left;
  11. the device busy share of one served request, under torch.profiler;
  12. the training path: TorchTrainer.fit() of the llama_lora loop at full
     Llama-2-7B width (bf16 weights, seq 2048, batch 2, LoRA rank 16) for 2
     epochs of 2 steps, with its checkpoint and exact per-step launch counts;
     then 3 timed warm steps of lora_train_step and the device busy share of
     one step under torch.profiler, whose launches of each of the port's
     kernels, found by symbol and counted by their wrappers, must equal the
     per-step counts;
  12b. data-parallel training (``train_dp``): (a) NcclGroup at world size 1
     in this process: every op on bf16 and f32 tensors of 4 MiB and 33.5 MB
     (the 7B adapters' gradient) equals its input, timed (a one-rank op is
     a copy on the card, not a link's speed); 10 quantized allreduce rounds
     of each dtype equal the codec's formula on the card with the residual
     carried; wire and logical bytes in collective_summary; an async
     allreduce's overlap split; moe_dispatch / moe_combine over the group
     equal the local ones; (b) phase 12's fit() again in process (the
     bound: two in-process runs), then TorchTrainer of the llama_lora loop
     with a spawned NCCL worker (TorchConfig(backend="nccl"), overlap on;
     the worker then runs 12c (a)'s loop, ``train_nccl_loop``):
     its losses and 256 adapters within that bound, K1-K4 129/64/32/32 a
     step counted in the worker, 8 buckets of 4 MiB and 8 allreduce ops a
     step (33.5 MB), the NCCL kernels a profiled step launches, step ms,
     overlap split and peak memory; (c) two gloo ranks sharing the card
     (ScalingConfig(2, {"GPU": 0.5})) at 2 layers of 7B width, batch 1
     each (the replicated pass of 12c (b)'s gang, checked there): adapters
     equal across ranks after every step and within a stated bound of one
     rank at batch 2; the gloo allreduce timed alone; (d) NCCL for two
     ranks on one card refused before any spawn;
  12c. FSDP (``train_fsdp``): (a) the llama_lora loop at its default mesh
     in a spawned NCCL worker at fsdp=1 (every gather a one-rank op; 12b
     (b)'s worker, after its own loop): its
     losses and full adapters within (b)'s bound of phase 12's, K1-K4
     129/64/32/32 a step, a step's gathers and reduce-scatters, step ms and
     peak memory; (b) two gloo ranks sharing the card at 2 layers of 7B
     width, every parameter replicated and then at fsdp=2: each rank's
     base bytes exactly half, adapters within 2n lr + n bf16 ulps of the
     replicated pair's, gather bytes, step ms and peak a rank; (c) the
     pair's sharded checkpoint restored whole here, bit for bit. (b)'s
     gang (``train_pair_loop``) also runs 12b (c), 12d and 13b (b): one
     gang's start, not four (each costs 15-25 s), with 12d's and 13b's
     in-process yardsticks computed here before its fit;
  12d. sequence parallelism (``train_sp``): two gloo ranks sharing the card
     (``train_sp_loop``, in 12c (b)'s gang). (a) ring and Ulysses attention at Llama-2-7B's
     attention width (b=2, 32 heads, S=4096, 2,048 a rank) and Llama-3-8B's
     GQA one (b=1, 32/8 heads, S=8192), bf16, causal: o and the q/k/v
     gradients within 4x the one-rank flash_attention's own distance from
     f32 plain attention, fwd and bwd ms a rank, the shifts' bytes and
     waits; (b) 4 layers of the 7B LoRA step at b=2 x 4096 with the
     sequence split over the ranks (ring attention in every layer, the
     gradients summed over them), 2 AdamW steps: the ranks bit-identical,
     losses and adapters within twice the in-process one-rank run's
     distance from itself in f32 activations, ring bytes exactly
     1,077,936,128 a step and rank, K1-K4 17 / 8(r+1) / 4(2-r) / 4(2-r) a
     step on rank r, step ms, peak and the collectives' host share;
  13. ResNet-50 training (``train_resnet``): make_trainer(...).fit() of the
     resnet loop at 224, batch 256 (bf16 activations over f32 parameters,
     SGD with momentum), finite losses, running statistics that move, K1-K4
     launched 0 times; median of 5 timed warm steps, images/s, peak memory,
     a profile of one step (convolutions against the elementwise chain);
     f32 card-vs-host parity at full width (4 images at 96x96);
  13b. sync-BN data parallelism (``train_resnet_dp``): (a) the resnet loop
     in a spawned NCCL worker at world size 1, then 3 steps of a fresh
     model whose parameters and running statistics equal the in-process
     run's (bit for bit, or within two in-process runs' spread), exactly
     106 sync-BN allreduces and 102,228,128 B of gradient a step, 5 timed
     steps; (b) two gloo ranks sharing the card at b=128 each, 3 steps
     (in 12c (b)'s gang, the in-process yardsticks before its fit):
     bit-identical to each other, within twice the b=256 run's distance
     from itself in f32 activations, step ms and the collectives' share;
  14. ViT-B/16 training (``train_vit``): batch 128 at 224, AdamW, exactly
     12/12/12 launches of K2/K3/K4 per step (24 K2 with remat), K1 none,
     remat-invariant loss and gradients, 5 timed warm steps, a profile of
     one step (K2-K4's share) and f32 card-vs-host parity at 2 layers of
     ViT-B width;
  15. RLlib PPO (``train_ppo``): PPOConfig().environment(CartPoleEnv)
     .env_runners(...).build().train(), the learner on the card and the env
     runners on the host: (a) the repo's defaults (2 runners x 4 envs x 64
     steps, minibatch 128, 4 epochs) for 3 iterations, the learner's
     parameters and Adam moments on the card, the runners' policies on the
     host, a save/restore round trip bit for bit; (b) upstream RLlib PPO's
     batch (2 x 32 x 64 = 4,096 rows, minibatch 128, 30 epochs: 960
     minibatch updates), one warm and 1 timed iteration split into
     sampling, GAE and learner ms, env steps/s, peak memory, and one learner
     update under torch.profiler (launches per minibatch update, busy
     share); (c) one update of 512 rows card vs host in f32 against an f64
     host run, discrete and Gaussian heads; K1-K4 launched 0 times; the
     rllib step breakdown's efficiency lies in (0, 1] and its components sum
     to its total;
  15b. the rest of RLlib (``train_rl``), each through <Algo>Config(...)
     .build().train() with the learner on the card and the env runners
     and replay buffers on the host, at the reference's network widths and
     config defaults (RL below says where a setting departs): DQN on
     CartPole until 4 iterations have learned, SAC on Pendulum through its
     warm-up and 4 learning iterations (its env actions inside [-2, 2]),
     IMPALA and APPO (mean_rho away from 1: rollouts one update stale),
     BC, MARWIL, CQL and IQL (discrete and continuous) on synthetic
     100,000-transition datasets, and multi-agent PPO on the reference
     test's cooperative toy. For each: iteration ms by timers, env steps
     (offline: rows) per s, learner ms per update, peak memory, launches,
     device ms and busy share per update from a profiled update; finite
     stats; learners on the card and runner policies on the host; a
     save/restore round trip bit for bit. Then one update each of DQN,
     SAC, IMPALA, APPO, CQL and continuous IQL card vs host in f32 against
     an f64 host run; K1-K4 launched 0 times;
  15c. DreamerV3 (``train_dreamer``): DreamerV3Config().environment(...)
     .build().train() at the reference's defaults (deter 256, 16 x 16
     latents, hidden 256, 41 bins, batch 8 x seq 16, horizon 15), the
     learner (world model, actor, critics, three Adam states) on the card
     and the runner and sequence buffer on the host, on CartPole and on
     Pendulum until 3 iterations have learned: iteration ms by timers,
     env steps/s, learner ms per update; 3 timed updates on one of its
     batches and 3 at upstream RLlib's batch (16 x 64: 1,024 imagination
     starts), each with launches, device ms and busy share from a profiled
     update; peak memory; finite stats with kl_dyn at the free-nats floor
     or above; learner on the card and runner nets on the host; a
     save/restore round trip bit for bit; Pendulum's env actions in [-2,
     2]; one update card vs host in f32 against an f64 host run, discrete
     and continuous, with the categorical choices and normal draws
     injected; K1-K4 launched 0 times;
  16. Mixtral-8x7B training (``train_moe``): the MoE transformer at full
     Mixtral-8x7B width, 4 of its 32 layers, bf16 parameters, batch 2 x seq
     4096, remat, AdamW at lr 1e-3 (next_token_loss, backward, step): a
     first step whose routing is recorded (each layer's recompute must
     route as its forward; the dropped fraction per layer), 3 timed warm
     steps with exactly 4L+1 / 2L / L / L launches of K1/K2/K3/K4 a step,
     finite losses, a non-zero router gradient in every layer, tokens/s and
     peak memory; the full forward under no_grad; a profile of one step by
     kernel group; the indexed dispatch/combine against the reference's
     dense one-hot einsums at one layer's call (slabs bit for bit, outputs
     within the rounding of a sum of two products), both timed; card vs
     host at one full-width layer in f32 (routing first, any flip a
     near-tie, then the loss and gradients of the positions routed alike
     against an f64 host run). The kernel phases hold and time K1 at
     (8192, 4096) and K2-K4 at (64, 4096, 4096, d=128) causal, the MoE
     step's calls.
  16b. the ViT and the MoE over multi-axis meshes (``train_mesh``): eight
     gloo ranks sharing the card (``train_mesh_loop``, each rank's groups
     from ``train.collective.gang_mesh``), against one-rank runs on the
     whole global batch in this process, bf16 and f32 activations: (a)
     ViT-B/16 at 224, global batch 128, AdamW, at the reference test's
     dp=2 x fsdp=2 x tp=2, 2 steps; (b) Mixtral-8x7B at full width, 1 of
     its 32 layers, b=2 x 2048, remat, bf16 parameters, at fsdp=2 x ep=2 x
     tp=2, 2 steps. Every rank's K1-K4 launches a step exact (ViT 0/12/12/12,
     MoE 5/2/1/1); its resident parameter bytes the rule table's share
     exactly; the first step's gradients (after the ranks' sums, before
     AdamW) and first loss within twice the one-rank run's distance from its
     f32-activation run, leaf by leaf (every norm, the router, cls_token;
     the MoE's aux loss's router gradients per layer too), and two planted
     faults from the same run outside that bound (a tp-replicated leaf's
     gradient summed over tp; each rank's local aux loss in place of its
     share of the global one); each MoE layer's routing of the first step
     against the one-rank run's (a differing choice only at a near-tie or
     after an earlier layer's, counted; the ranks of a data shard alike).
     Printed: step ms, peak and the collectives' host share a rank. The
     kernel phases hold and time K2-K4 at the ranks' calls, (192, 197,
     d=64) non-causal and (16, 2048, d=128) causal. Then, on the same
     ranks: (c) the ViT at dp=2 x sp=2 x tp=2 (197 tokens, 99 / 98 a sp
     rank, K/V gathered over sp) and (d) the Mixtral layer at sp=2 x
     ep=2 x tp=2 (the ring over sp, routing over the data axes and sp;
     stepped with plain SGD, as AdamW's state for a quarter of the experts
     a rank does not fit eight ranks beside this process), held
     as (a) and (b) (K1-K4 under sp 5 / 2(s+1) / (2-s) / (2-s) at sp
     coordinate s; ``pos_embed``'s padded rows in the resident bytes) with
     planted faults of their own: the ViT's loss counted once per sp rank;
     the MoE's first step with per-rank routing offsets (held by its
     gradients or, where they cannot see it, by its routing against the
     global one on the same logits) and with RoPE at local positions; (e)
     GPipe (``parallel.pipeline_apply``) on ranks 0-3, a stage of 2
     full-width Llama-2-7B blocks each, 8 microbatches of 1 x 2048, forward
     and backward, 2 steps, against one rank applying the 8 blocks in turn:
     K1-K4 32/16/16/16 a step a stage, zeros off the last stage, the
     output, every stage's gradients and the microbatches' gradient within
     twice the one-rank run's distance from f32 activations, the wall a
     step beside the one-rank run's; (f) the hierarchical group on ranks
     4-7 (2 slices of 2, ``HierarchicalGroup.form``) at 33,554,432 B: equal
     to the flat gloo group's sum on integer values, within f32 rounding on
     random ones, through ``GradientReduceScheduler`` too, the reference
     tests' allgather / broadcast / reducescatter, ms beside the flat
     group's. The kernel phases hold and time K2-K4 at (c)-(e)'s calls:
     (384, 99 and 98, 197, d=64) non-causal, (32, 2048, d=128) causal and
     (32, 1024, d=128) non-causal.
  16c. the Llama over the reference's training mesh (``train_tp``): four
     gloo ranks sharing the card for each part, the two parts at once on
     ``train_mesh``'s eight ranks after its own (``_tp_round``, each through
     the LoRA loop's ``lora_model``, ``lora_train_step`` and
     ``mesh_gradients``),
     against one-rank runs on the whole global batch in this process, bf16
     and f32 activations: 2 layers of Llama-2-7B at full width, bf16
     parameters, LoRA rank 16, remat, (a) at tp=2 x fsdp=2, seq 2048,
     batch 2, (b) at sp=2 x tp=2, b=1 x 4096, 2 AdamW steps each. Every
     rank's K1-K4 launches a step exact (9 / 4(s+1) / 2(sp-s) / 2(sp-s) at
     sp coordinate s); its resident parameter bytes the rule table's share
     exactly; the ranks' losses equal, the first the mean of the positions'
     NLLs; those NLLs and the first step's LoRA gradients, leaf by leaf,
     within twice the one-rank run's distance from its f32-activation run;
     the first loss of the ranks' blocks in f32 activations the one-rank
     f32 run's within 1e-6 of itself; and planted faults outside it (the MLP's tp sum dropped; each rank's
     gradient before the sp sum; a tp-replicated factor summed over tp).
     Printed: step ms, peak and the collectives' host share a rank. The
     kernel phases hold and time K2-K4 at the ranks' calls, (16, 2048,
     d=128) causal and non-causal (the ring's hop).
Main paths: the launch counters are set to 0 just before phase 5 and read
just after phase 6 (serving), the actor worker's set to 0 just before phase
6b (c)'s requests and read just after (d)'s forward (``runtime_serve``; this
process's stay 0 meanwhile), set to 0 just before phase 7 and read just
after phase 9 (continuous batching, ``serve_cb``, with ``serve_obs``), the replicas' own
set to 0 just before phase 9b (b)'s traffic and read just after (c) (``serve_deploy``;
this process's stay 0 meanwhile), set to 0 just before
phase 10 and read just after it (``serve_lora``), set to 0 just before phase
10b and read just after it (``serve_disagg``), set to 0 inside phase 10c
just before its first tp=2 server and read just after its last one closes
(its tp=1 comparisons run before and after), with the spawned ranks' own
counts, read just before each closes, added (``serve_tp``), likewise inside
phase 10d (``serve_tp_features``), and set to 0 just before
phase 12's fit() and read just after it (training), set to 0 just before
phase 12b (b)'s fit() and read just after it, with the spawned worker's own
counts, set to 0 before its loop and read after it, added (``train_dp``),
likewise for phase 12c (a)'s loop in that worker, after it, with (b)'s
FSDP ranks' counts of their steps added (``train_fsdp``), for phase 12d's
two ranks (in 12c (b)'s gang), each set to
0 before its ops and again before its steps and read after each
(``train_sp``), and for phase 13b's workers (its pair in 12c (b)'s gang)
(``train_resnet_dp``), and set to 0 at the
start of phases 13 and 14 and read after their timed and profiled steps
(``train_resnet``, ``train_vit``), and set to 0 at the start of phase 15 and
read after its timed iterations and profiled update (``train_ppo``), set
to 0 at the start of phase 15b and read at its end (``train_rl``), set to 0
at the start of phase 15c and read at its end (``train_dreamer``), and
set to 0 at the start of phase 16 and read after its profiled step
(``train_moe``), and for phase 16b's and 16c's ranks, each set to 0 just
before each of its steps and read just after (``train_mesh``,
``train_tp``). The last lines are a
JSON line of the kernels and the result line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

SEED = 0
# every bf16 Llama-2-7B server of the serving phases (5-11): full width, cut
# to 4 of its 32 layers to fit the time limit (a model call launches K1
# 2L + 1 = 9 times)
SERVE_LAYERS = 4
N_REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 128, 32
# continuous batching: 8 slots over 256 blocks of 32 tokens (as much K/V as
# the dense slot pool at max_seq_len 1024)
CB = {"slots": 8, "blocks": 256, "block": 32, "max_seq_len": 1024}
CB_REQUESTS, CB_PREFIX, CB_OWN = 16, 256, 64
CB_LONG = 896  # the chunked phase's long prompt
# multi-tenant LoRA: 4 adapters of rank 16 (alpha 16, so lora_b is scaled by
# 1) in a bank of 8 slots; request i of the serve_cb traffic names tenant
# i % 5, tenant 0 being the base model
LORA = {"max_live": 8, "rank": 16, "alpha": 16.0, "tenants": 4, "lora_b_std": 0.1}
# disaggregated prefill/decode and the KV tier (serve_disagg): servers of the
# serve_cb config (8 slots, 256 blocks of 32 tokens, max_seq_len 1024) over
# one in-process tier backend; waves of 8 distinct 512-token prompts (16
# blocks: 33,554,432 bytes of bf16 K/V at SERVE_LAYERS) with 32 new greedy
# tokens each
DISAGG = {"prompts": 8, "prompt_len": 512, "new_tokens": 32, "partial_shared": 480,
          "roles": {"prefill": 1, "decode": 1}}
# the training path: llama_lora's "7b" loop, 2 epochs of 2 steps
TRAIN_CONFIG = {"model": "7b", "seq": 2048, "batch_per_worker": 2, "lora_rank": 16,
                "epochs": 2, "steps_per_epoch": 2}
TRAIN_STEPS = TRAIN_CONFIG["epochs"] * TRAIN_CONFIG["steps_per_epoch"]
# vision training: ResNet-50 through make_trainer(...).fit() at the NVIDIA
# DeepLearningExamples ResNet-50 v1.5 recipe's 256 images a card, and
# ViT-B/16 at DeiT-B's 128 a card (1024 over 8), both at 224
RESNET_CONFIG = {"model": "50", "image_size": 224, "batch_per_worker": 256, "epochs": 1,
                 "steps_per_epoch": 3, "device": "cuda"}
VIT_BATCH = 128
VIT_SEQ = (224 // 16) ** 2 + 1  # 196 patches + CLS
VISION_STEPS = 5  # timed warm steps of each vision loop
# RLlib PPO on the port's CartPole: the repo's PPOConfig defaults (2 runners
# x 4 envs x 64 steps, minibatch 128, 4 epochs), then upstream RLlib PPO's
# documented train_batch_size 4000, minibatch 128 and 30 epochs, as 2 runners
# x 32 envs x 64 steps (4,096 rows)
PPO_DEFAULT_ENVS = 4
PPO_UPSTREAM = {"envs": 32, "num_epochs": 30, "minibatch_size": 128}
PPO_TIMED_ITERS = 1
PPO_PROFILE_EPOCHS = 3  # of (b)'s 30, in the profiled update: 96 minibatch updates
# a PPO minibatch update's kernels by kind (the first group with a part in a
# kernel's symbol takes it)
PPO_GROUPS = {"gemm": ("gemm", "gemv"), "adam_and_clip": ("multi_tensor_apply",),
              "reductions": ("reduce_kernel",), "gather": ("index", "gather", "scatter"),
              "elementwise": ("elementwise", "unrolled")}
# card-vs-host parity of one update: 512 rows, (obs_dim, action_dim, discrete)
PPO_PARITY_ROWS = 512
PPO_PARITY_HEADS = {"discrete": (4, 2, True), "gaussian": (3, 1, False)}
# the rest of RLlib (train_rl): every algorithm at the reference's network
# widths and config defaults, except where noted beside the setting. DQN's
# runners are train_ppo (a)'s (2 x 4 envs x 64 steps; the DQNConfig default
# is 2 x 2 x 32) and it runs until 4 iterations have learned; SAC runs
# through its warm-up (learning_starts 1000) and 4 learning iterations;
# IMPALA and APPO 4 iterations of 4 batches; the offline algorithms 1
# iteration (one epoch) over synthetic 100,000-transition datasets at
# batch 256 (390 updates an epoch); multi-agent PPO 3 iterations of the
# reference test's cooperative toy at its settings (1 runner x 128 steps,
# lr 5e-3, 6 epochs, minibatch 64, no entropy bonus)
RL = {"dqn_runners": {"num_env_runners": 2, "num_envs_per_env_runner": 4,
                      "rollout_fragment_length": 64},
      "dqn_learning_iters": 4, "sac_learning_iters": 4, "impala_iters": 4,
      "offline_rows": 100_000, "offline_iters": 1, "multi_agent_iters": 3,
      "multi_agent_training": {"lr": 5e-3, "num_epochs": 6, "minibatch_size": 64,
                               "entropy_coeff": 0.0},
      "profiled_offline_steps": 8, "parity_rows": 256}
# DreamerV3 (train_dreamer): the reference's DreamerV3Config defaults (deter
# 256, 16 x 16 latents, hidden 256, 41 bins, batch 8 x seq 16, horizon 15, 1
# runner x 1 env x 64 steps, learning_starts 256) on CartPole and Pendulum
# until 3 iterations have learned; 3 timed updates on one of its batches, and
# 3 more at upstream RLlib's DreamerV3Config batch (batch_size_B 16 x
# batch_length_T 64: 1,024 imagination starts) at the same widths
DREAMER = {"learning_iters": 3, "timed_updates": 3, "upstream_batch": (16, 64)}
# Mixtral-8x7B training (train_moe): MoEConfig.mixtral_8x7b at full width and
# 4 of its 32 layers with bf16 parameters (f32 ones with AdamW would take 16 B
# a parameter, 97 GB at 4 layers), batch 2 x seq 4096 with remat, AdamW at the
# reference program's lr 1e-3 (optax's other defaults, weight decay 1e-4)
MOE = {"n_layers": 4, "batch": 2, "seq": 4096, "lr": 1e-3, "timed_steps": 3}
# card-vs-host parity: one layer at full width, b=1 x seq 64, f32
MOE_PARITY_SEQ = 64
# a routing choice that differs between card and host must be a near-tie:
# the gap between the two probabilities it chose between under this. Router
# logits of a few units computed in f32 in two summation orders differ by
# about 1e-6, and so do their softmax probabilities
MOE_NEAR_TIE = 1e-5
# sequence parallelism (train_sp): two gloo ranks sharing the card. (a) ring
# and Ulysses attention at full width, bf16, causal, head_dim 128: (name,
# batch, query heads, KV heads, global seq), Llama-2-7B's at its published
# context and Llama-3-8B's GQA at 8192; (b) the 7B LoRA step (rank 16 on
# wq/wk/wv/wo, remat, bf16, lr 1e-4) cut to 4 layers, b=2 x 4096 (Llama-2's
# published context) split over the ranks, 2 AdamW steps
SP = {"ranks": 2, "n_layers": 4, "batch": 2, "seq": 4096, "steps": 2, "lr": 1e-4,
      "op_reps": 3}
SP_OPS = (("llama2_7b", 2, 32, 32, 4096), ("llama3_8b_gqa", 1, 32, 8, 8192))
SP_OPS_LOCAL = tuple((n, b, h, hk, s // SP["ranks"]) for n, b, h, hk, s in SP_OPS)
# (a)'s bound: ring and Ulysses within this many times the one-rank
# flash_attention's own distance from its f32 plain version, tensor by tensor
SP_OP_TIMES = 4
# the models over multi-axis meshes (train_mesh): eight gloo ranks sharing
# the card (NCCL refuses two ranks on one card). (a) ViT-B/16 at 224, global
# batch 128, bf16 over f32, AdamW, on the reference test's dp=2 x fsdp=2 x
# tp=2, 2 steps; (b) Mixtral-8x7B at full width cut to 1 of its 32 layers,
# b=2 x 2048 (the experts' f32 partial sums go through host gloo), remat,
# bf16 parameters, AdamW at lr 1e-3, on fsdp=2 x ep=2 x tp=2, 2 steps; (c)
# ViT-B/16 as (a) at dp=2 x sp=2 x tp=2 (197 tokens split 99 / 98), 2
# steps; (d) the Mixtral layer as (b) at sp=2 x ep=2 x tp=2 (a data
# shard holds both rows, so each sp rank's 2 x 1024 tokens interleave in
# the global order), 2 steps with plain SGD (a quarter of the experts a
# rank: AdamW's state, 3.5 GB a rank, left the eight ranks and this process
# more than the card holds); then (e) GPipe on ranks 0-3 (PIPE) and (f)
# the hierarchical group on ranks 4-7 (HIER); then train_tp's round
MESH = {"ranks": 8,
        "vit": {"axes": {"dp": 2, "fsdp": 2, "tp": 2}, "batch": VIT_BATCH, "steps": 2,
                "lr": 1e-4},
        "moe": {"axes": {"fsdp": 2, "ep": 2, "tp": 2}, "n_layers": 1, "batch": 2,
                "seq": 2048, "steps": 2, "lr": 1e-3},
        "vit_sp": {"axes": {"dp": 2, "sp": 2, "tp": 2, "fsdp": 1}, "batch": VIT_BATCH,
                   "steps": 2, "lr": 1e-4},
        "moe_sp": {"axes": {"sp": 2, "ep": 2, "tp": 2, "fsdp": 1}, "n_layers": 1, "batch": 2,
                   "seq": 2048, "steps": 2, "lr": 1e-3, "sgd": True}}
# (e) the pipeline: pp=4 gloo ranks sharing the card, each stage 2 decoder
# blocks of Llama-2-7B at full width in bf16, 8 microbatches of 1 x 2048
# hidden states, forward and backward through pipeline_apply, 2 steps;
# against one rank applying the 8 blocks in turn to each microbatch
PIPE = {"stages": 4, "layers_per_stage": 2, "micro": 8, "rows": 1, "seq": 2048, "steps": 2}
# (f) the hierarchical group: 4 gloo ranks in 2 slices of 2 at the 7B LoRA
# loop's gradient size (f32), against the flat gloo group
HIER = {"ranks": 4, "slice_size": 2, "bytes": 33_554_432, "reps": 3}
# the flash calls a rank of train_mesh makes: (bh, sq, sk, d, causal,
# batch) as the kernel phases take them (bf16): a rank's images or rows of
# the global batch (its data shard) x its heads (tp's share)
_VIT_ROWS = MESH["vit"]["batch"] // (MESH["vit"]["axes"]["dp"] * MESH["vit"]["axes"]["fsdp"])
_MOE_ROWS = MESH["moe"]["batch"] // MESH["moe"]["axes"]["fsdp"]
MESH_ATTENTION_CALLS = (
    (_VIT_ROWS * 12 // MESH["vit"]["axes"]["tp"], VIT_SEQ, VIT_SEQ, 64, False, _VIT_ROWS),
    (_MOE_ROWS * 32 // MESH["moe"]["axes"]["tp"], MESH["moe"]["seq"], MESH["moe"]["seq"], 128,
     True, _MOE_ROWS),
)
# the flash calls of train_mesh's (c)-(e), as MESH_ATTENTION_CALLS: a ViT sp
# rank's 64 images x 6 heads, its 99 or 98 queries over all 197 keys,
# non-causal; the pipeline stage's call (1 row x 32 heads at 2048, causal);
# the MoE sp rank's ring hop (2 rows x 16 heads at 1024, non-causal), whose
# diagonal block is the same call, causal
_VIT_SP_ROWS = MESH["vit_sp"]["batch"] // MESH["vit_sp"]["axes"]["dp"]
_VIT_SP_Q = -(-VIT_SEQ // MESH["vit_sp"]["axes"]["sp"])
SP_MODEL_ATTENTION_CALLS = (
    (_VIT_SP_ROWS * 6, _VIT_SP_Q, VIT_SEQ, 64, False, _VIT_SP_ROWS),
    (_VIT_SP_ROWS * 6, VIT_SEQ - _VIT_SP_Q, VIT_SEQ, 64, False, _VIT_SP_ROWS),
    (32, PIPE["seq"], PIPE["seq"], 128, True, 1),
    (32, MESH["moe_sp"]["seq"] // 2, MESH["moe_sp"]["seq"] // 2, 128, False, 2),
)
# the Llama over the reference's training mesh (train_tp): four gloo ranks
# sharing the card, each running the LoRA loop's own model, step and update
# (llama_lora.lora_model, lora_train_step, mesh_gradients) on Llama-2-7B at
# full width cut to 2 of its 32 layers: bf16 parameters, LoRA rank 16 (each
# lora_b drawn with std 0.1, so every factor has a gradient), remat, AdamW at
# lr 1e-4. (a) tp=2 x fsdp=2 at the loop's seq 2048, global batch 2 (a row a
# data shard); (b) sp=2 x tp=2 at b=1 x 4096, Llama-2's published context
TP_TRAIN = {"ranks": 4, "n_layers": 2, "lr": 1e-4, "lora_b_std": 0.1,
            "a": {"axes": {"tp": 2, "fsdp": 2}, "batch": 2, "seq": 2048, "steps": 2},
            "b": {"axes": {"sp": 2, "tp": 2, "fsdp": 1}, "batch": 1, "seq": 4096, "steps": 2}}
# the flash calls a rank of train_tp makes, as MESH_ATTENTION_CALLS: a row x
# 16 heads (tp's half) at 2048, causal ((a), and (b)'s diagonal block), and
# (b)'s ring hop over the other sp rank's block, non-causal
TP_ATTENTION_CALLS = ((16, 2048, 2048, 128, True, 1), (16, 2048, 2048, 128, False, 1))
# a routing choice of the mesh run that differs from the one-rank run's must
# be a near-tie there (the gap between the two probabilities it chose
# between, from f32 logits of bf16 activations, under this) or follow a
# token that an earlier layer routed otherwise. The two runs' bf16
# activations part by rounding steps of 2^-8 (the tensor-parallel partial
# sums), which move router logits of about one unit by about 1e-3 and their
# probabilities by less
MESH_NEAR_TIE = 1e-2
# the first step's gradients of the mesh run, leaf by leaf: their distance
# from the one-rank f32-activation run's within this many times the one-rank
# bf16 run's distance from them
MESH_GRAD_TIMES = 2
# train_tp's first loss in f32 activations, the mesh's against one rank's,
# relative: two f32 sums of the same terms in other orders (the tp partial
# sums, the ring's merge, the loss's sum over the ranks) part by about 1e-7;
# a bf16 run parts from f32 by about 4e-5 of the loss
TP_F32_LOSS_REL = 1e-6
# rounding unit of each dtype (one ulp of a value in [1, 2))
ULP = {"torch.bfloat16": 2.0 ** -7, "torch.float16": 2.0 ** -10, "torch.float32": 2.0 ** -23}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call, after a warm-up. Each timing starts behind a ~5 ms
    device sleep, so that the host has queued all ``inner`` calls before the
    first runs: the events then bracket device time, not launch overhead.
    Inputs stay in L2 between calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / inner


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rmsnorm_phase(torch, F):
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd, rmsnorm_reference

    g = torch.Generator(device="cuda").manual_seed(SEED)
    eps = 1e-5
    # tolerance: kernel and plain version both compute in f32 and round
    # once, so they differ by at most one ulp of the output type; outputs
    # stay below 8, where a bf16 ulp is 2**-5 and an f16 ulp 2**-8
    tols = {torch.bfloat16: 2.0 ** -5, torch.float16: 2.0 ** -8, torch.float32: 1e-5}
    cases = [
        ((N_REQUESTS * PROMPT_LEN, 4096), torch.bfloat16),  # prefill rows
        ((N_REQUESTS, 4096), torch.bfloat16),  # decode rows
        ((1, 4096), torch.bfloat16),  # one streamed request
        # a training step's rows: batch 2 x seq 2048
        ((TRAIN_CONFIG["batch_per_worker"] * TRAIN_CONFIG["seq"], 4096), torch.bfloat16),
        # the serve_cb path's rows: the pooled decode step, the k=4 verify
        # over the pool, a block-long suffix or chunk, a prompt that misses,
        # and the chunked phase's long prompt prefilled whole
        ((CB["slots"], 4096), torch.bfloat16),
        ((CB["slots"] * 5, 4096), torch.bfloat16),
        ((CB["block"], 4096), torch.bfloat16),
        ((CB_PREFIX + CB_OWN, 4096), torch.bfloat16),
        ((CB_LONG, 4096), torch.bfloat16),
        # the serve_lora path's rows besides those: LLMPredictor's grouped
        # prefill, and the static-LoRA models' prefills of one and two
        # tenants' rows; its 2-layer parity engines run f32 at width 4096
        # (a prompt's suffix, the pooled step)
        ((CB["slots"] * PROMPT_LEN, 4096), torch.bfloat16),
        ((CB_OWN, 4096), torch.bfloat16),
        ((2 * CB_OWN, 4096), torch.bfloat16),
        ((CB_OWN, 4096), torch.float32),
        ((CB["slots"], 4096), torch.float32),
        # a Mixtral-8x7B training step's rows (train_moe): batch 2 x seq 4096
        ((MOE["batch"] * MOE["seq"], 4096), torch.bfloat16),
        # a pipeline stage's microbatch (train_mesh (e)): 1 x 2048
        ((PIPE["rows"] * PIPE["seq"], 4096), torch.bfloat16),
        ((300, 1024), torch.float16),
        ((7, 128), torch.float32),
    ]
    rows = []
    for shape, dtype in cases:
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")).to(dtype)
        out = rmsnorm_fwd(x, w, eps)
        torch.cuda.synchronize()
        err = (out.float() - rmsnorm_reference(x, w, eps).float()).abs().max().item()
        check(err <= tols[dtype], f"rmsnorm {shape} {dtype}: max_abs_err {err} > {tols[dtype]}")
        row = dict(shape=list(shape), dtype=str(dtype), max_abs_err=err, tol=tols[dtype])
        if dtype == torch.bfloat16:
            n, d = shape
            if shape == (CB["slots"], 4096):
                # the launch floor beside the pooled step's launch-bound rows:
                # a one-element elementwise kernel, timed the same way
                one = torch.zeros(1, device="cuda")
                row["launch_floor_ms"] = time_ms(lambda: one.add_(1.0))
            row["ms"] = time_ms(lambda: rmsnorm_fwd(x, w, eps))
            row["plain_ms"] = time_ms(lambda: rmsnorm_reference(x, w, eps))
            row["library_ms"] = time_ms(lambda: F.rms_norm(x, (d,), w, eps))
            row["bound_ms"], row["bound_by"] = bound_ms(2 * (2 * n * d + d), 4 * n * d, F32_FLOPS)
        print("rmsnorm_fwd", json.dumps(row))
        rows.append(row)
    return rows


def flash_phase(torch, F):
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_reference,
        flash_fwd_round_p_tolerance,
        flash_fwd_rounding_bound,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, seq = TRAIN_CONFIG["batch_per_worker"], TRAIN_CONFIG["seq"]
    # (bh, sq, sk, d, causal, dtype, batch); bf16 and f16 run the
    # tensor-core kernel, f32 the CUDA-core one. The calls with a batch are
    # timed (q viewed as (batch, heads, seq, d) for SDPA).
    cases = [
        # the 7B full forward's per-layer call: 4 prompts x 32 heads, 128
        # tokens, head_dim 128
        (N_REQUESTS * 32, PROMPT_LEN, PROMPT_LEN, 128, True, torch.bfloat16, N_REQUESTS),
        # the 7B training call: batch 2 x 32 heads, seq 2048
        (b * 32, seq, seq, 128, True, torch.bfloat16, b),
        # the ViT-B/16 training call: batch 128 x 12 heads, 197 tokens,
        # bidirectional; ragged last q and key tiles (197 = 3 x 64 + 5)
        (VIT_BATCH * 12, VIT_SEQ, VIT_SEQ, 64, False, torch.bfloat16, VIT_BATCH),
        # the Mixtral-8x7B training call (train_moe): batch 2 x 32 heads (its
        # 8 KV heads repeated), seq 4096
        (MOE["batch"] * 32, MOE["seq"], MOE["seq"], 128, True, torch.bfloat16, MOE["batch"]),
        # the ring's hop of train_sp: an earlier rank's whole K/V block,
        # non-causal, at Llama-2-7B width (batch 2 x 32 heads, 2048 a rank)
        # and at Llama-3-8B's GQA call (batch 1 x 32 heads, its 8 KV heads
        # repeated, 4096 a rank)
        *((b_ * h_, s_, s_, 128, False, torch.bfloat16, b_) for _, b_, h_, _, s_ in SP_OPS_LOCAL),
        # train_mesh's calls a rank: ViT-B/16 at dp=2 x fsdp=2 x tp=2 (its 32
        # images x 6 heads) and Mixtral-8x7B at fsdp=2 x ep=2 x tp=2 (1 x 16
        # heads, its 4 KV heads a rank repeated)
        *((bh, sq, sk, d, c, torch.bfloat16, bb) for bh, sq, sk, d, c, bb in MESH_ATTENTION_CALLS),
        # train_tp's calls a rank: Llama-2-7B at tp=2 (1 x 16 heads, 2048),
        # causal and as (b)'s ring hop
        *((bh, sq, sk, d, c, torch.bfloat16, bb) for bh, sq, sk, d, c, bb in TP_ATTENTION_CALLS),
        # train_mesh (c)-(e)'s calls a rank: the ViT's and the MoE's under sp
        # and the pipeline stage's
        *((bh, sq, sk, d, c, torch.bfloat16, bb)
          for bh, sq, sk, d, c, bb in SP_MODEL_ATTENTION_CALLS),
        (12, VIT_SEQ, VIT_SEQ, 64, False, torch.bfloat16, None),
        (8, 100, 100, 64, False, torch.bfloat16, None),
        (8, 96, 96, 32, True, torch.bfloat16, None),  # tiny's head_dim
        (8, 100, 100, 64, False, torch.float16, None),
        (4, 77, 77, 128, True, torch.bfloat16, None),  # ragged q and key tiles
        (4, 77, 77, 128, True, torch.float16, None),
        (2, 40, 130, 128, True, torch.bfloat16, None),  # sq < sk, top-left causal
        (2, 130, 40, 128, True, torch.bfloat16, None),  # sq > sk
        (4, 200, 200, 64, True, torch.float16, None),  # four key tiles, the last of 8 keys
        (2, 40, 130, 64, True, torch.float32, None),
        (2, 130, 40, 128, False, torch.float32, None),
    ]
    rows = []
    for bh, sq, sk, d, causal, dtype, bb in cases:
        q = torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(bh, sk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(bh, sk, d, generator=g, device="cuda").to(dtype)
        kw = dict(sm_scale=d ** -0.5, causal=causal)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = f"flash {(bh, sq, sk, d, causal)} {dtype}"
        check(bool(torch.isfinite(o).all()), f"{tag}: non-finite o")
        # the plain version that rounds P to the input dtype tile by tile as
        # the tensor-core kernel does (for f32 the plain version itself), and
        # the f32 plain version on f32 copies of the same values
        ro, rlse = flash_attention_reference(q, k, v, **kw, round_p=True)
        fo, flse = flash_attention_reference(q.float(), k.float(), v.float(), **kw)
        bound = flash_fwd_rounding_bound(q, k, v, **kw)
        # tight tolerance, against round_p=True, element by element: both
        # round the same tiles' P, computed in f32 each its own way, and o
        # once (flash_fwd_round_p_tolerance: a step of the dtype at |o|, the
        # steps of P that lie within 2^-14 of a rounding midpoint, and 2^-14
        # of P |V| over l); f32: summation-order noise only
        if dtype == torch.float32:
            tol = torch.full_like(fo, 2e-5)
        else:
            tol = flash_fwd_round_p_tolerance(q, k, v, **kw)
        diff = (o.float() - ro.float()).abs()
        err, worst = diff.max().item(), (diff / tol).max().item()
        check(bool((diff <= tol).all()),
              f"{tag}: o vs round_p=True: max_abs_err {err}, {worst:.3f} of the tolerance at worst")
        # lse is f32 in all three, and rounding P does not reach it
        lse_err = max((lse - rlse).abs().max().item(), (lse - flse).abs().max().item())
        check(lse_err <= 1e-4, f"{tag}: lse max_abs_err {lse_err} > 1e-4")
        # wider tolerance, against the f32 plain version, element by element:
        # the tight one plus the most that rounding P to the dtype can move
        # each output (flash_fwd_rounding_bound: unit roundoff times P |V|
        # over l, and half the smallest subnormal per visible key); 0 extra
        # for f32
        f32_diff = (o.float() - fo).abs()
        f32_err, f32_worst = f32_diff.max().item(), (f32_diff / (bound + tol)).max().item()
        check(bool((f32_diff <= bound + tol).all()),
              f"{tag}: o vs the f32 plain version: max_abs_err {f32_err}, "
              f"{f32_worst:.3f} of the rounding bound at worst")
        row = dict(shape=[bh, sq, sk, d], causal=causal, dtype=str(dtype),
                   max_abs_err=err, tol_max=tol.max().item(), tol_median=tol.median().item(),
                   err_over_tol_max=worst, median_abs_o=ro.float().abs().median().item(),
                   max_abs_o=ro.float().abs().max().item(), lse_max_abs_err=lse_err,
                   f32_plain_max_abs_err=f32_err, f32_plain_err_over_tol_max=f32_worst)
        del ro, fo, bound, tol, diff, f32_diff
        if bb is not None:  # the serving, the 7B training and the ViT training call
            q4, k4, v4 = (t.view(bb, bh // bb, -1, d) for t in (q, k, v))
            row["ms"] = time_ms(lambda: flash_attention_fwd(q, k, v, **kw))
            row["plain_ms"] = time_ms(
                lambda: flash_attention_reference(q, k, v, **kw),
                reps=21 if len(rows) == 0 else 5, inner=10 if len(rows) == 0 else 2,
            )
            # sq == sk here, so SDPA's causal mask is the same top-left one
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                                       scale=kw["sm_scale"])
            )
            pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
            n_bytes = 2 * (2 * bh * sq * d + 2 * bh * sk * d) + 4 * bh * sq
            n_ops = 4 * bh * pairs * d
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
            row["flops"], row["bytes"] = n_ops, n_bytes
            row["tflop_s"] = n_ops / row["ms"] / 1e9
        print("flash_attention_fwd", json.dumps(row))
        rows.append(row)
    return rows


def flash_bwd_phase(torch, F):
    from ray_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dq,
        flash_bwd_dq_reference,
        flash_bwd_rounding_bound,
    )
    from ray_tpu_torch.parallel.ring_attention import _merge

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    # (bh, sq, sk, d, causal, dtype, batch); the first is the 7B training
    # call: batch 2 x 32 heads, seq 2048, head_dim 128; the second the
    # ViT-B/16 one, the third the Mixtral-8x7B one (batch 2 x 32 heads, seq
    # 4096). Those three, with a batch, are timed. bf16 and f16 run the
    # tensor-core kernels, f32 the CUDA-core ones.
    b, seq = TRAIN_CONFIG["batch_per_worker"], TRAIN_CONFIG["seq"]
    # the ring's hops (train_sp), as in flash_phase; their lse and delta are
    # the merged result's (the hop's block and a causal diagonal block of
    # other keys, merged by log-sum-exp), not the block's own, as in the ring
    hops = [(b_ * h_, s_, s_, 128, False, torch.bfloat16, b_) for _, b_, h_, _, s_ in SP_OPS_LOCAL]
    cases = [
        (b * 32, seq, seq, 128, True, torch.bfloat16, b),
        (VIT_BATCH * 12, VIT_SEQ, VIT_SEQ, 64, False, torch.bfloat16, VIT_BATCH),
        (MOE["batch"] * 32, MOE["seq"], MOE["seq"], 128, True, torch.bfloat16, MOE["batch"]),
        *hops,
        # train_mesh's calls a rank, as in flash_phase
        *((bh, sq, sk, d, c, torch.bfloat16, bb) for bh, sq, sk, d, c, bb in MESH_ATTENTION_CALLS),
        # train_tp's calls a rank, as in flash_phase
        *((bh, sq, sk, d, c, torch.bfloat16, bb) for bh, sq, sk, d, c, bb in TP_ATTENTION_CALLS),
        # train_mesh (c)-(e)'s calls a rank: the ViT's and the MoE's under sp
        # and the pipeline stage's
        *((bh, sq, sk, d, c, torch.bfloat16, bb)
          for bh, sq, sk, d, c, bb in SP_MODEL_ATTENTION_CALLS),
        (12, VIT_SEQ, VIT_SEQ, 64, False, torch.bfloat16, None),
        (8, 100, 100, 64, False, torch.bfloat16, None),
        (8, 96, 96, 32, True, torch.bfloat16, None),
        (4, 77, 77, 128, True, torch.bfloat16, None),  # ragged last tiles
        (4, 77, 77, 128, True, torch.float16, None),
        (8, 100, 100, 64, False, torch.float16, None),
        (2, 40, 130, 128, True, torch.bfloat16, None),  # sq < sk, top-left causal
        (2, 40, 130, 128, True, torch.float16, None),
        (2, 130, 40, 128, True, torch.bfloat16, None),  # sq > sk
        (2, 130, 40, 128, False, torch.float16, None),
        (2, 40, 130, 64, True, torch.float32, None),
        (2, 130, 40, 128, False, torch.float32, None),
    ]
    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for bh, sq, sk, d, causal, dtype, bb in cases:
        q, do = (torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(bh, sk, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        kw = dict(sm_scale=d ** -0.5, causal=causal)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ring_hop = (bh, sq, sk, d, causal, dtype, bb) in hops
        if ring_hop:
            k2, v2 = (torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype)
                      for _ in range(2))
            o2, lse2 = flash_attention_fwd(q, k2, v2, sm_scale=kw["sm_scale"], causal=True)
            o, lse = _merge(o2, lse2, o, lse)
            del k2, v2, o2, lse2
        delta = attention_delta(do, o)
        args = (q, k, v, do, lse, delta)
        dq = flash_bwd_dq(*args, **kw)
        dk, dv = flash_bwd_dkv(*args, **kw)
        torch.cuda.synchronize()
        out = {"dq": dq, "dk": dk, "dv": dv}
        # the plain version that rounds P and dS to the input dtype as the
        # tensor-core kernels do (for f32 the same as the plain version)
        rounded = {"dq": flash_bwd_dq_reference(*args, **kw, round_ps=True)}
        rounded["dk"], rounded["dv"] = flash_bwd_dkv_reference(*args, **kw, round_ps=True)
        plain = {"dq": flash_bwd_dq_reference(*args, **kw)}
        plain["dk"], plain["dv"] = flash_bwd_dkv_reference(*args, **kw)
        bq, bk, bv, n_sub = flash_bwd_rounding_bound(*args, **kw)
        bound = {"dq": bq, "dk": bk, "dv": bv}
        tag = f"flash bwd {(bh, sq, sk, d, causal)} {dtype}"
        errs = {}
        for name in out:
            check(bool(torch.isfinite(out[name]).all()), f"{tag}: non-finite {name}")
            # tight tolerance, against the plain version that rounds as the
            # kernel does: both compute in f32 from the same rounded P and dS
            # and round once to the output dtype, so they differ by f32
            # summation-order noise (1e-4 of the largest value, for sums over
            # up to 2048 keys) plus one rounding step of the dtype there
            scale = rounded[name].float().abs().max().item()
            tol = scale * (ULP[str(dtype)] + 1e-4)
            err = (out[name].float() - rounded[name].float()).abs().max().item()
            check(err <= tol, f"{tag}: {name} max_abs_err {err} > {tol}")
            # wider tolerance, against the f32 plain version, element by
            # element: the tight one plus the most that rounding P and dS to
            # the dtype can move each output (flash_bwd_rounding_bound: unit
            # roundoff times the sum of |P| or |dS| times |the other factor|,
            # and half the smallest subnormal per term); 0 extra for f32
            diff = (out[name].float() - plain[name].float()).abs()
            within = bool((diff <= bound[name] + tol).all())
            f32_err, wide = diff.max().item(), bound[name].max().item() + tol
            check(within, f"{tag}: {name} vs the f32 plain version: max_abs_err {f32_err} "
                          f"beyond the rounding bound (at most {wide})")
            errs[name] = (err, tol, f32_err, wide)
        for kernel, names in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
            rows[kernel].append(dict(
                shape=[bh, sq, sk, d], causal=causal, dtype=str(dtype), ring_hop=ring_hop,
                max_abs_err=max(errs[n][0] for n in names),
                tol=min(errs[n][1] for n in names),
                f32_plain_max_abs_err=max(errs[n][2] for n in names),
                f32_plain_tol_max=max(errs[n][3] for n in names),
                p_ds_subnormal=n_sub,
            ))
        if bb is not None:
            pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
            reads = 2 * (2 * bh * sq * d + 2 * bh * sk * d) + 2 * 4 * bh * sq
            main = {
                "flash_bwd_dq": (
                    lambda: flash_bwd_dq(*args, **kw),
                    lambda: flash_bwd_dq_reference(*args, **kw, round_ps=True),
                    reads + 2 * bh * sq * d, 6 * d * bh * pairs,
                ),
                "flash_bwd_dkv": (
                    lambda: flash_bwd_dkv(*args, **kw),
                    lambda: flash_bwd_dkv_reference(*args, **kw, round_ps=True),
                    reads + 2 * 2 * bh * sk * d, 8 * d * bh * pairs,
                ),
            }
            # yardstick: SDPA's backward, one call for dQ, dK and dV
            # together, with the forward outside the timing
            q4, k4, v4 = (t.view(bb, bh // bb, -1, d).detach().requires_grad_(True)
                          for t in (q, k, v))
            o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, scale=kw["sm_scale"])
            do4 = do.view(bb, bh // bb, sq, d)
            library_ms = time_ms(
                lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
            )
            for kernel, (fn, plain_fn, n_bytes, n_ops) in main.items():
                row = rows[kernel][-1]
                row["ms"] = time_ms(fn)
                row["plain_ms"] = time_ms(plain_fn, reps=5, inner=2)
                row["library_ms"] = library_ms
                row["library_call"] = "SDPA backward (dQ, dK, dV together)"
                row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
                row["flops"], row["bytes"] = n_ops, n_bytes
                row["tflop_s"] = n_ops / row["ms"] / 1e9
            del q4, k4, v4, o4
        for kernel in rows:
            print(kernel, json.dumps(rows[kernel][-1]))
    return rows


def sass_phase():
    """Count the tensor-core instructions (HGMMA, the warpgroup products;
    HMMA, had any warp-level ones been compiled) in the SASS of every
    bf16/f16 instantiation of the tensor-core kernels (K2 in
    libflash_attention, K3 and K4 in libflash_attention_bwd), from cuobjdump
    of the built libraries, with each one's registers and stack; fail on a
    count of zero, a missing instantiation or a spill (a stack frame)."""
    import re

    from ray_tpu_torch._internal import kernels

    libs = {"flash_attention": ("flash_fwd_tc_kernel",),
            "flash_attention_bwd": ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")}
    cuobjdump = kernels.cuda_tool("cuobjdump")

    def label(mangled):
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_tc_kernel)I(13__nv_bfloat16|6__half)Li(\d+)E",
                      mangled)
        if m is None:
            return None
        return f"{m.group(1)}<{'bf16' if 'bfloat16' in m.group(2) else 'f16'}, d={m.group(3)}>"

    def run(lib, *args):
        return subprocess.run([cuobjdump, *args, str(kernels.lib_path(lib))],
                              capture_output=True, text=True, check=True, timeout=300).stdout

    tc_count, usage, res_usage = {}, {}, ""
    for lib in libs:
        name = None
        for line in run(lib, "-sass").splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = label(m.group(1))
                if name:
                    tc_count[name] = 0
            elif name and re.search(r"\bH(?:G)?MMA\b", line):
                tc_count[name] += 1
        name, lib_usage = None, run(lib, "-res-usage")
        res_usage += lib_usage
        for line in lib_usage.splitlines():
            m = re.search(r"Function\s+(\S+?):", line)
            if m:
                name = label(m.group(1))
            reg, stack = re.search(r"REG:(\d+)", line), re.search(r"STACK:(\d+)", line)
            if reg and stack and name:
                usage[name] = (int(reg.group(1)), int(stack.group(1)))
    want = {f"{k}<{t}, d={d}>" for names in libs.values() for k in names
            for t in ("bf16", "f16") for d in (32, 64, 128)}
    check(set(tc_count) == want, f"tensor-core kernels in the SASS: {sorted(tc_count)}, want {sorted(want)}")
    res = {}
    for name in sorted(want):
        check(tc_count[name] > 0, f"{name}: no tensor-core instruction in its SASS")
        check(name in usage, f"{name}: no resource usage in cuobjdump -res-usage:\n"
                             + "\n".join(res_usage.splitlines()[:20]))
        regs, stack = usage[name]
        check(stack == 0, f"{name}: {stack} bytes of stack (register spills)")
        res[name] = {"tensor_core_instructions": tc_count[name], "registers": regs,
                     "stack_bytes": stack}
    print("sass", json.dumps(res))
    return res


def grad_parity_phase(torch, np):
    """LoRA gradients of one loss through a 2-layer model at full 7B width:
    f32 on the card (K1-K4, K3/K4 on CUDA cores) and on the host CPU (their
    plain versions), then bf16 activations on the card (K3/K4 on the tensor
    cores) against the same f32 CPU gradients, within twice what bf16
    activations cost on the CPU (the control: bf16 CPU vs f32 CPU)."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, next_token_loss
    from ray_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.train.examples.llama_lora import lora_model

    cfg = LlamaConfig.llama2_7b(n_layers=2, max_seq_len=256, lora_rank=16,
                                dtype=torch.float32, param_dtype=torch.float32)
    params = init_params(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for name, t in params.items():
        # lora_b = 0 would make every lora_a gradient exactly 0
        if name.endswith("lora_b"):
            t.normal_(0.0, 0.02, generator=g)
    tokens = np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size, (1, cfg.max_seq_len))
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    runs = {"cuda": (cfg, "cuda"), "cpu": (cfg, "cpu"), "cpu_bf16": (cfg16, "cpu"),
            "cuda_bf16": (cfg16, "cuda")}
    out = {}
    for run, (run_cfg, dev) in runs.items():
        before = flash_bwd_dq.launches + flash_bwd_dkv.launches
        t0 = time.perf_counter()
        model, lora, _ = lora_model(run_cfg, {k: v.to(dev, copy=True) for k, v in params.items()})
        loss = next_token_loss(run_cfg, model, torch.from_numpy(tokens).to(dev))
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in lora.items()}
        out[run] = (loss.item(), grads, time.perf_counter() - t0,
                    flash_bwd_dq.launches + flash_bwd_dkv.launches - before)
        del model, lora, loss
    for run in ("cuda", "cuda_bf16"):
        check(out[run][3] == 2 * cfg.n_layers, f"{run} backward launched {out[run][3]} bwd kernels")

    def rel_err(run):
        """Largest error of each LoRA gradient of ``run`` against the f32
        CPU one, relative to the largest CPU gradient of that tensor."""
        worst = 0.0
        for name, gc in out["cpu"][1].items():
            scale = gc.abs().max().item()
            check(scale > 0, f"{name}: zero gradient on the CPU")
            worst = max(worst, (out[run][1][name] - gc).abs().max().item() / scale)
        return worst

    # tolerances, relative to each tensor's largest CPU gradient:
    # f32: f32 throughout with TF32 off; the card (cuBLAS, K1-K4) and the CPU
    # (plain versions) sum in other orders, which over two layers and the
    # 32000-way lm_head stays within 1e-3;
    # bf16: the control run rounds the same activations to bf16 at the same
    # products, norms and casts on the CPU, with the plain versions; the card
    # adds to those roundings only P and dS inside K3/K4 (two per layer
    # beside the activations' ~20) and another summation order, which are
    # as many independent roundings of the same size again at most, so
    # twice the control's error; the loss, one log-sum-exp over bf16
    # logits, within 1e-2
    control = rel_err("cpu_bf16")
    # a control error of a quarter of a gradient's scale or more would mean
    # the CPU run itself is broken, and would hide a broken kernel
    check(0 < control < 0.25, f"bf16 CPU vs f32 CPU gradient rel err {control}")
    tols = {"cuda": (1e-3, 1e-5), "cuda_bf16": (2 * control, 1e-2)}
    res = dict(n_layers=cfg.n_layers, dim=cfg.dim, seq=cfg.max_seq_len, tensors=len(out["cpu"][1]),
               loss_cpu=out["cpu"][0], cpu_s=out["cpu"][2], max_rel_err_cpu_bf16=control,
               cpu_bf16_s=out["cpu_bf16"][2])
    for run, (tol, loss_tol) in tols.items():
        worst = rel_err(run)
        check(worst <= tol, f"{run} vs CPU gradient rel err {worst} > {tol}")
        loss_rel = abs(out[run][0] - out["cpu"][0]) / abs(out["cpu"][0])
        check(loss_rel <= loss_tol, f"{run} vs CPU loss rel err {loss_rel} > {loss_tol}")
        sfx = "" if run == "cuda" else "_bf16"
        res.update({f"loss_cuda{sfx}": out[run][0], f"loss_rel_err{sfx}": loss_rel,
                    f"max_rel_err{sfx}": worst, f"tol{sfx}": tol, f"cuda_s{sfx}": out[run][2]})
    print("grad_parity", json.dumps(res))
    return res


def serve_model_kwargs(torch):
    """The model of every bf16 serving phase: Llama-2-7B at full width, bf16
    parameters, SERVE_LAYERS of its layers."""
    return {"param_dtype": torch.bfloat16, "n_layers": SERVE_LAYERS}


def serve_phase(torch, np):
    from ray_tpu_torch.llm import LLMConfig, LLMServer

    t0 = time.perf_counter()
    server = LLMServer(LLMConfig(
        model_id="llama2-7b", max_seq_len=1024, max_batch_size=N_REQUESTS,
        model_kwargs=serve_model_kwargs(torch),
    ))
    torch.cuda.synchronize()
    cfg = server.engine._cfg
    check(
        (cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.intermediate, cfg.vocab_size)
        == (SERVE_LAYERS, 4096, 32, 32, 11008, 32000),
        f"not Llama-2-7B width at {SERVE_LAYERS} layers: {cfg}",
    )
    n_params = sum(t.numel() for t in server.engine._params.values())
    print(f"serve: built Llama-2-7B at {SERVE_LAYERS} layers ({n_params} params, bf16) in "
          f"{time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (N_REQUESTS, PROMPT_LEN)).tolist()
    request = {"max_new_tokens": NEW_TOKENS, "temperature": 0.0}
    server({"token_ids": prompts[0], "max_new_tokens": 2})  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd

    for fn in (rmsnorm_fwd, flash_attention_fwd, flash_bwd_dq, flash_bwd_dkv):
        fn.launches = 0
    t0 = time.perf_counter()
    answers = [server(dict(request, token_ids=p)) for p in prompts]
    wall = time.perf_counter() - t0
    for a in answers:
        check(a["num_prompt_tokens"] == PROMPT_LEN and len(a["token_ids"]) == NEW_TOKENS
              and a["finished_reason"] == "length", f"bad answer {a}")
        check(all(0 <= t < cfg.vocab_size for t in a["token_ids"]), "token out of range")

    t0 = time.perf_counter()
    stamps, streamed = [], []
    for item in server.stream(dict(request, token_ids=prompts[0])):
        stamps.append(time.perf_counter())
        if "token_id" in item:
            streamed.append(item["token_id"])
    check(streamed == answers[0]["token_ids"], "streamed tokens differ from the answered ones")
    ttft_ms = (stamps[0] - t0) * 1e3
    gaps = [(b - a) * 1e3 for a, b in zip(stamps[:NEW_TOKENS - 1], stamps[1:NEW_TOKENS])]
    serve = dict(
        requests=N_REQUESTS + 1, prompt_tokens=PROMPT_LEN, new_tokens=NEW_TOKENS,
        call_tokens_per_s=N_REQUESTS * NEW_TOKENS / wall,
        ttft_ms=ttft_ms, decode_ms_per_step_median=statistics.median(gaps),
        decode_ms_per_step_max=max(gaps),
        rmsnorm_launches=rmsnorm_fwd.launches, flash_launches=flash_attention_fwd.launches,
    )
    print("serve", json.dumps(serve))
    check(rmsnorm_fwd.launches > 0, "the serving path launched no rmsnorm kernel")
    return server, prompts, serve


def forward_phase(torch, server, prompts):
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.llama import build_llama
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    engine = server.engine
    model = build_llama(engine._cfg, engine._params)  # shares the weights
    tokens = torch.tensor(prompts, device="cuda")
    before = flash_attention_fwd.launches
    with torch.inference_mode():
        for _ in range(2):  # the second pass is timed warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = model(tokens)
            torch.cuda.synchronize()
            forward_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            prefill, _ = engine._prefill(tokens)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
    check(full.shape == (len(prompts), PROMPT_LEN, engine._cfg.vocab_size), "bad logits shape")
    check(bool(torch.isfinite(full).all()), "non-finite logits")
    last, pre = full[:, -1].float(), prefill.float()
    err = (last - pre).abs().max().item()
    mean_err = (last - pre).abs().mean().item()
    scale = pre.abs().max().item()
    # tolerance: the two paths run the same bf16 weights and activations and
    # differ only in how attention is computed (flash kernel vs f32 einsum over
    # the cache), each rounding its output to bf16 once per layer; over 32
    # layers that stays within 5% of the largest logit
    tol = 0.05 * scale
    check(err <= tol, f"full forward vs prefill logits: max_abs_err {err} > {tol}")
    top = pre.topk(2, dim=-1)
    margin = (top.values[:, 0] - top.values[:, 1]).tolist()
    same = (last.argmax(-1) == pre.argmax(-1)).tolist()
    # a first token may differ only where the prefill's top-2 margin is within
    # the measured disagreement, i.e. a tie at this precision
    for i, (eq, m) in enumerate(zip(same, margin)):
        check(eq or m <= 2 * err, f"row {i}: greedy first token differs at margin {m}")
    n = (flash_attention_fwd.launches - before) // 2
    check(n == engine._cfg.n_layers, f"a full forward launched the flash kernel {n} times")

    # the same comparison with f32 activations over the same bf16 weights:
    # both paths then agree to f32 rounding (tolerance 1e-3 after 32
    # layers), and every greedy first token must be equal
    cfg32 = dataclasses.replace(engine._cfg, dtype=torch.float32)
    engine32 = LLMEngine(cfg32, engine._params, device=tokens.device)
    with torch.inference_mode():
        last32 = build_llama(cfg32, engine._params)(tokens)[:, -1]
        pre32, _ = engine32._prefill(tokens)
    err32 = (last32 - pre32).abs().max().item()
    check(err32 <= 1e-3, f"f32 full forward vs prefill logits: max_abs_err {err32} > 1e-3")
    check(bool((last32.argmax(-1) == pre32.argmax(-1)).all()), "f32 greedy first tokens differ")
    fwd = dict(max_abs_err=err, mean_abs_err=mean_err, tol=tol, max_abs_logit=scale,
               first_tokens_equal=same, top2_margin=margin, flash_launches=n,
               f32_max_abs_err=err32, forward_ms=forward_ms, prefill_ms=prefill_ms)
    print("forward", json.dumps(fwd))
    return fwd


# -- the runtime core on the card (runtime_serve) ---------------------------------------

#: the runtime phase: its requests' new tokens (the prompts are serve_phase's),
#: and the seeded tensor a GPU task returns
RUNTIME = {"new_tokens": 8, "tensor_shape": (1024, 1024)}


def _device_method(fn):
    """``@ray_tpu_torch.method(tensor_transport="device")``: the option the
    port's actors read from a method, set here so that this module's top
    imports nothing of the package (the runtime's workers import it)."""
    fn.__ray_tpu_method_options__ = {"tensor_transport": "device"}
    return fn


def runtime_seeded_tensor():
    """A CUDA tensor drawn from SEED on the current card: the GPU task's and
    this process's own."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return torch.randn(RUNTIME["tensor_shape"], generator=gen, device="cuda")


def runtime_task():
    """The runtime phase's num_gpus=1 task: its lease's ids, its current
    card, and a seeded CUDA tensor (which crosses the object plane as a CPU
    tensor)."""
    import torch

    import ray_tpu_torch

    return {"gpu_ids": ray_tpu_torch.get_gpu_ids(), "device": torch.cuda.current_device(),
            "accelerators": ray_tpu_torch.get_runtime_context().get_accelerator_ids(),
            "tensor": runtime_seeded_tensor(), "pid": os.getpid()}


class RuntimeServer:
    """The runtime phase's actor: serve_phase's LLMServer (the same config,
    the same seeded weights), built in a worker that the port's raylet
    spawned and bound to the card of its num_gpus=1 lease."""

    def __init__(self, warm_request):
        import torch

        from ray_tpu_torch.llm import LLMConfig, LLMServer

        t0 = time.perf_counter()
        self.server = LLMServer(LLMConfig(
            model_id="llama2-7b", max_seq_len=1024, max_batch_size=N_REQUESTS,
            model_kwargs=serve_model_kwargs(torch),
        ))
        self.server(warm_request)  # warm-up (cuBLAS, allocator), as serve_phase's
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0

    def info(self):
        import torch

        import ray_tpu_torch

        param = next(iter(self.server.engine._params.values()))
        return {"gpu_ids": ray_tpu_torch.get_gpu_ids(), "device": torch.cuda.current_device(),
                "param_device": str(param.device), "build_s": self.build_s, "pid": os.getpid()}

    def zero_counts(self):
        for fn in _port_counters().values():
            fn.launches = 0

    def counts(self):
        return {name: fn.launches for name, fn in _port_counters().items()}

    def generate(self, request):
        return self.server(request)

    @_device_method
    def prefill_logits(self, prompts):
        """The full-sequence forward of the prompts (flash attention, K2):
        its logits stay on this actor's card."""
        import torch

        from ray_tpu_torch.models.llama import build_llama

        engine = self.server.engine
        with torch.inference_mode():
            logits = build_llama(engine._cfg, engine._params)(
                torch.tensor(prompts, device=engine._device))
        return {"logits": logits}

    @_device_method
    def local_logits(self, tree, ref_id):
        """A local hit: whether the resolved argument is the stored tensor
        itself, and its digest."""
        from ray_tpu_torch.experimental import device_objects

        stored = device_objects._store[ref_id]["logits"]
        return tree["logits"].data_ptr() == stored.data_ptr(), _digest(stored)

    def memory_allocated(self):
        import torch

        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def runtime_serve_phase(torch, server, prompts, counters):
    """The runtime core on the card: (a) ``init()`` finds the card as the
    node's GPU resource and the native object store; (b) a num_gpus=1 task
    runs on cuda:0 through its lease and its seeded CUDA tensor comes back
    bit for bit; (c) a num_gpus=1 actor builds serve_phase's LLMServer and
    answers the same 4 greedy requests (as ObjectRefs) token for token, with
    the in-process server's K1/K2 launches; (d) device objects: the actor's
    full-forward logits stay on its card, a local hit is zero-copy, the
    device_get here is bit for bit, free gives the memory back. The cluster
    stays up, the actor alive, for ``serve_deploy``, which shuts it down
    (on a failure here it is shut down at once). Returns (the worker's
    launches over (c) and (d), the phase's numbers, the cluster's record)."""
    import chip_smoke as C  # the workers import the remote programs by this name
    import ray_tpu_torch as rt
    from ray_tpu_torch._internal import accelerators
    from ray_tpu_torch.experimental import device_get, free_device_object
    from ray_tpu_torch.models.llama import build_llama
    from ray_tpu_torch.runtime.object_store import native_store

    out = {}
    libs = runtime_kernel_libs()  # built by the script's build phase
    request = {"max_new_tokens": RUNTIME["new_tokens"], "temperature": 0.0}
    t0 = time.perf_counter()
    rt.init()
    out["init_s"] = time.perf_counter() - t0
    pids = []
    try:
        # (a) the card is the node's GPU resource; the native store served
        resources = rt.cluster_resources()
        out.update(gpu=resources.get("GPU"), gpu_source=accelerators.last_gpu_source,
                   store=native_store.store_kind)
        print(f"runtime_serve (a): GPU {out['gpu']} (from {out['gpu_source']}), "
              f"{native_store.store_kind} object store, init {out['init_s']:.3f} s")
        check(out["gpu"] == 1.0, f"cluster_resources() has GPU {out['gpu']}, not 1: {resources}")
        check(native_store.store_kind == "native",
              f"the native object store did not build: {native_store.store_kind}")

        # (b) a num_gpus=1 task on cuda:0; its first lease pays the worker's
        # start, the torch import and the CUDA context
        task = rt.remote(num_gpus=1)(C.runtime_task)
        t0 = time.perf_counter()
        got = rt.get(task.remote(), timeout=300)
        out["first_gpu_lease_s"] = time.perf_counter() - t0
        print(f"lap runtime_serve first_gpu_lease {out['first_gpu_lease_s']:.1f} s")
        t0 = time.perf_counter()
        again = rt.get(task.remote(), timeout=300)
        out["warm_gpu_task_s"] = time.perf_counter() - t0
        pids += [got["pid"], again["pid"]]
        for g in (got, again):
            check(g["gpu_ids"] == [0] and g["device"] == 0
                  and g["accelerators"] == {"GPU": ["0"]},
                  f"the GPU task ran off its lease's card: {g['gpu_ids']} {g['device']}")
            check(g["tensor"].device.type == "cpu"
                  and torch.equal(g["tensor"], runtime_seeded_tensor().cpu()),
                  "the task's seeded CUDA tensor differs from this process's")

        # (c) the LLMServer actor against the in-process server, on the same
        # requests: tokens and K1/K2 launches equal; the in-process run's
        # launches are its own (not the path's)
        tokens = torch.tensor(prompts, device="cuda")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        local = [server(dict(request, token_ids=p)) for p in prompts]
        torch.cuda.synchronize()
        out["in_process_wall_s"] = time.perf_counter() - t0
        engine = server.engine
        with torch.inference_mode():
            local_logits = build_llama(engine._cfg, engine._params)(tokens)
        torch.cuda.synchronize()
        local_counts = {name: fn.launches for name, fn in counters.items()}

        t0 = time.perf_counter()
        actor = rt.remote(num_gpus=1)(C.RuntimeServer).remote(
            dict(request, token_ids=prompts[0], max_new_tokens=2))
        info = rt.get(actor.info.remote(), timeout=600)
        out["actor_start_s"] = time.perf_counter() - t0
        out["actor_build_s"] = info["build_s"]
        pids.append(info["pid"])
        check(info["gpu_ids"] == [0] and info["device"] == 0 and info["param_device"] == "cuda:0",
              f"the actor is not on its lease's card: {info}")
        refs = [rt.put(dict(request, token_ids=p)) for p in prompts]
        for fn in counters.values():
            fn.launches = 0
        rt.get(actor.zero_counts.remote(), timeout=60)
        t0 = time.perf_counter()
        answers = rt.get([actor.generate.remote(r) for r in refs], timeout=600)
        out["actor_wall_s"] = time.perf_counter() - t0
        for i, (a, b) in enumerate(zip(answers, local)):
            check(a["token_ids"] == b["token_ids"] and len(a["token_ids"]) == RUNTIME["new_tokens"],
                  f"request {i}: the actor's tokens {a['token_ids']} differ from the "
                  f"in-process server's {b['token_ids']}")

        # (d) device objects: the full forward's logits stay on the actor's card
        ref = rt.get(actor.prefill_logits.remote(prompts), timeout=600)
        launches = rt.get(actor.counts.remote(), timeout=60)
        own_counts = {name: fn.launches for name, fn in counters.items()}
        check(all(v == 0 for v in own_counts.values()),
              f"the actor's path launched kernels in this process: {own_counts}")
        same_ptr, digest = rt.get(actor.local_logits.remote(ref, ref.id), timeout=60)
        check(same_ptr is True, "a local hit is not the stored logits tensor")
        t0 = time.perf_counter()
        fetched = device_get(ref)["logits"]
        out["device_get_ms"] = (time.perf_counter() - t0) * 1e3
        check(fetched.device == torch.device("cuda", 0), f"device_get landed on {fetched.device}")
        check(_digest(fetched) == digest, "device_get here differs from the actor's logits")
        err = (fetched.float() - local_logits.float()).abs().max().item()
        out["logits_max_abs_err_vs_in_process"] = err
        out["logits_bitwise_equal_in_process"] = bool(torch.equal(fetched, local_logits))
        tol = 0.05 * local_logits.float().abs().max().item()  # forward_phase's tolerance
        check(err <= tol, f"the actor's logits differ from the in-process ones by {err} > {tol}")
        before = rt.get(actor.memory_allocated.remote(), timeout=60)
        check(free_device_object(ref), "free_device_object found nothing to free")
        after = rt.get(actor.memory_allocated.remote(), timeout=60)
        out["freed_bytes"] = before - after
        check(before - after >= fetched.numel() * fetched.element_size(),
              f"free gave back {before - after} B, less than the logits' "
              f"{fetched.numel() * fetched.element_size()} B")
        del fetched

        for name in ("rmsnorm_fwd", "flash_attention_fwd"):
            check(launches[name] == local_counts[name] and launches[name] > 0,
                  f"the actor launched {name} {launches[name]} times, the in-process server "
                  f"{local_counts[name]}")
        model_calls = launches["rmsnorm_fwd"] // (2 * SERVE_LAYERS + 1)
        check(launches["rmsnorm_fwd"] == model_calls * (2 * SERVE_LAYERS + 1),
              f"K1 {launches['rmsnorm_fwd']} is not 2L + 1 a model call")
        check(launches["flash_attention_fwd"] == SERVE_LAYERS,
              f"K2 {launches['flash_attention_fwd']}: one full forward launches L")
        out.update(launches=launches, model_calls=model_calls)
        print("runtime_serve", json.dumps(out))
    except BaseException:
        rt.shutdown()
        raise
    return out["launches"], out, {"actor": actor, "pids": pids, "libs": libs}


def runtime_kernel_libs():
    """The build phase's kernel libraries, by modification time: a worker
    that rebuilt one would change it."""
    from ray_tpu_torch._internal import kernels

    return {n: kernels.lib_path(n).stat().st_mtime_ns for n in kernels.sources()}


# -- the serve control plane on the card (serve_deploy) -----------------------------------

#: two replicas of the serve_cb server's config (8 slots, 256 blocks of 32,
#: max_seq_len 1024) packed on card 0's halves, routed with 16 tokens of
#: prefix affinity; the serial wave's requests; the near-tie bound on the
#: in-process server's top-2 logit gap where a replica's greedy token parts
#: from it (bf16 ulps of the top logit: the replicas' batches differ from
#: the in-process run's, and a GEMM's sums with them)
SERVE_DEPLOY = {"replicas": 2, "gpu_share": 0.5, "affinity_tokens": 16, "serial": 4,
                "near_tie_ulps": 4}


def _replica_calls(rt, app, deployment, method, *args):
    """``method(*args)`` on every RUNNING replica of a deployment, through
    each replica's own actor (a handle routes to one of them), by replica
    id."""
    controller = rt.get_actor("SERVE_CONTROLLER")
    table = rt.get(controller.get_routing_table.remote(app), timeout=30)
    return {rid: rt.get(replica.handle_request.remote(method, args, {}, {}), timeout=300)
            for rid, replica, _q in table[deployment]["replicas"]}


def _wait_running(rt, app, n, timeout_s=300.0):
    """The inventory rows once ``n`` replicas are RUNNING with their mesh
    cards polled (their pid and devices known)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        rows = [r for r in rt.testing.list_serve_replicas(app)
                if r["state"] == "RUNNING" and r["pid"] and r.get("mesh")]
        if len(rows) == n:
            return rows
        time.sleep(0.1)
    fail(f"serve_deploy: {app} did not reach {n} RUNNING replicas in {timeout_s} s: "
         f"{rt.testing.list_serve_replicas(app)}")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_deploy_phase(torch, np, cluster, cb_traffic, cb_out, server, counters):
    """The serve control plane on the card, on runtime_serve's cluster:
    ``serve.run(build_llm_deployment(...))`` of two replicas of the serve_cb
    server's config, each leasing {"CPU": 1, "GPU": 0.5}. (a) both reach
    RUNNING bound to card 0 through their leases; (b) serve_cb's 16
    requests (a shared 256-token prefix and 64 tokens of their own, 32 new
    greedy tokens) from 8 threads through the handle with prefix affinity:
    serve_cb's tokens (or a printed near-tie), prefix hits exactly 256 x
    (16 - the replicas used) over the replicas' KV stats, K1 9 a model
    call in each replica and K2-K4 none; then a serial wave of 4 requests on
    a new prefix lands on one replica and hits 3 x 256; (c) one request
    through the HTTP proxy, the same one alone through the handle and a
    streamed one give serve_cb's tokens as (b)'s do, the stream's first
    item before its end; (d) a replica killed, the next
    requests are answered and the controller brings the deployment back to
    2 RUNNING replicas on card 0. Then the cluster shuts down and no worker
    (runtime_serve's, the controller, the proxy, the replicas) is left.
    This process's counts stay 0; the replicas' own counts are set to 0
    just before (b) and read just after (c). Returns (the path's launches,
    the phase's numbers)."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import ray_tpu_torch as rt
    import ray_tpu_torch.testing  # noqa: F401 - rt.testing
    from ray_tpu_torch import _worker_api, serve
    from ray_tpu_torch.llm import LLMConfig, build_llm_deployment
    from ray_tpu_torch.models.llama import build_llama

    out, app = {}, "llm"
    pool_procs = _worker_api.get_node().raylet.worker_pool._spawned_procs
    try:
        # runtime_serve's actor holds the whole card: its lease goes first
        rt.kill(cluster["actor"])
        del cluster["actor"]
        deadline = time.time() + 60
        while rt.available_resources().get("GPU") != 1.0 and time.time() < deadline:
            time.sleep(0.1)
        check(rt.available_resources().get("GPU") == 1.0,
              f"runtime_serve's actor kept its card: {rt.available_resources()}")
        for fn in counters.values():
            fn.launches = 0
        cfg = LLMConfig(
            model_id="llama2-7b", max_seq_len=CB["max_seq_len"], max_batch_size=CB["slots"],
            kv_cache_blocks=CB["blocks"], kv_block_size=CB["block"],
            model_kwargs=serve_model_kwargs(torch), num_replicas=SERVE_DEPLOY["replicas"],
            resources_per_replica={"CPU": 1.0, "GPU": SERVE_DEPLOY["gpu_share"]},
            prefix_affinity_tokens=SERVE_DEPLOY["affinity_tokens"],
        )
        port = _free_port()
        t0 = time.perf_counter()
        serve.start(http_port=port)
        handle = serve.run(build_llm_deployment(cfg, name=app), name=app, route_prefix="/llm")
        rows = _wait_running(rt, app, SERVE_DEPLOY["replicas"])
        out["run_to_running_s"] = time.perf_counter() - t0
        print(f"lap serve_deploy run_to_running {out['run_to_running_s']:.1f} s")

        # (a) two replicas on card 0's halves, each bound to it by its lease
        out["replicas"] = [dict(replica_id=r["replica_id"], pid=r["pid"],
                                warmup_s=r["warmup_s"], devices=r["mesh"]["devices"],
                                gpu_ids=r["mesh"]["gpu_ids"],
                                allocated_bytes=r["mesh"]["per_device_hbm_bytes"][0],
                                kv_pool_bytes=r["mesh"]["kv_pool_bytes_per_device"])
                           for r in rows]
        for r in out["replicas"]:
            check(r["gpu_ids"] == [0] and r["devices"] == ["cuda:0"],
                  f"serve_deploy (a): a replica is not bound to card 0 by its lease: {r}")
        check(len({r["pid"] for r in out["replicas"]}) == 2, "the replicas share a process")
        check(rt.available_resources().get("GPU", 0.0) == 0.0,
              f"two halves leased, but the node has GPU left: {rt.available_resources()}")
        print("serve_deploy (a)", json.dumps(out["replicas"]))

        # (b) serve_cb's traffic through the handle, from 8 threads
        prompts, want = cb_traffic["prompts"], cb_traffic["tokens"]
        affine = handle.options(prefix_affinity_tokens=SERVE_DEPLOY["affinity_tokens"])

        def ask(prompt, h=affine):
            return h.remote({"token_ids": prompt, "max_new_tokens": NEW_TOKENS,
                             "temperature": 0.0}).result(timeout_s=600)

        # each replica warmed as serve_cb's server was (cuBLAS, the allocator,
        # its KV pool's first commit), on a prefix of its own
        vocab = cfg.build_model_config().vocab_size
        rng = np.random.default_rng(SEED + 23)
        warm = {"token_ids": rng.integers(0, vocab, CB_PREFIX + CB_OWN).tolist(),
                "max_new_tokens": 2}
        _replica_calls(rt, app, app, "__call__", warm)
        _replica_calls(rt, app, app, "kernel_launches", True)
        stats0 = _replica_calls(rt, app, app, "kvcache_stats")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CB["slots"]) as pool:
            answers = list(pool.map(ask, prompts))
        wall = time.perf_counter() - t0
        stats1 = _replica_calls(rt, app, app, "kvcache_stats")
        requests = {rid: stats1[rid]["requests"] - stats0[rid]["requests"] for rid in stats1}
        hits = sum(stats1[rid]["prefix_hit_tokens"] - stats0[rid]["prefix_hit_tokens"]
                   for rid in stats1)
        computed = sum(stats1[rid]["prefill_tokens_computed"]
                       - stats0[rid]["prefill_tokens_computed"] for rid in stats1)
        used = sum(1 for n in requests.values() if n)
        check(sum(requests.values()) == CB_REQUESTS, f"requests by replica {requests}")
        check(hits == CB_PREFIX * (CB_REQUESTS - used),
              f"prefix hits {hits}, want {CB_PREFIX} x (16 - {used} replicas used)")
        check(computed == used * CB_PREFIX + CB_REQUESTS * CB_OWN,
              f"prefill tokens computed {computed} over {used} replica(s)")
        case = ("affinity kept all 16 on one replica" if used == 1 else
                "the handle spilled to the other replica (its queue ran 2 past)")
        print(f"serve_deploy (b): {case}: {requests}; prefix hits {hits} of "
              f"{CB_REQUESTS * (CB_PREFIX + CB_OWN)} prompt tokens")
        tokens = [a["token_ids"] for a in answers]
        compared = [("wave", p, t, w) for p, t, w in zip(prompts, tokens, want)]

        # the serial wave, queues empty: one replica, its prefix computed once
        time.sleep(2.5)  # the routers' tables refresh each second, the controller's polls 4x
        prefix = rng.integers(0, vocab, CB_PREFIX).tolist()
        serial = [prefix + rng.integers(0, vocab, CB_OWN).tolist()
                  for _ in range(SERVE_DEPLOY["serial"])]
        stats2 = _replica_calls(rt, app, app, "kvcache_stats")
        for p in serial:
            ask(p)
        stats3 = _replica_calls(rt, app, app, "kvcache_stats")
        serial_requests = {rid: stats3[rid]["requests"] - stats2[rid]["requests"]
                           for rid in stats3}
        serial_hits = sum(stats3[rid]["prefix_hit_tokens"] - stats2[rid]["prefix_hit_tokens"]
                          for rid in stats3)
        check(sorted(serial_requests.values()) == [0, SERVE_DEPLOY["serial"]],
              f"the serial wave spread over the replicas: {serial_requests}")
        check(serial_hits == (SERVE_DEPLOY["serial"] - 1) * CB_PREFIX,
              f"the serial wave hit {serial_hits} tokens")

        # (c) the HTTP proxy and a stream, beside the same requests sent alone
        # through the handle; all against serve_cb's tokens (a replica that
        # holds the prefix prefills 64 tokens, one that does not all 320:
        # their sums differ, so their greedy tokens may part at a near-tie)
        single = [ask(p, handle)["token_ids"] for p in prompts[:2]]
        body = json.dumps({"token_ids": prompts[0], "max_new_tokens": NEW_TOKENS}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/llm", data=body,
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            http = json.loads(resp.read())["result"]
        out["http_s"] = time.perf_counter() - t0
        out["http_equals_handle"] = http["token_ids"] == single[0]
        compared += [("http", prompts[0], http["token_ids"], want[0]),
                     ("single", prompts[0], single[0], want[0]),
                     ("single", prompts[1], single[1], want[1])]
        streamer = handle.options(stream=True, method_name="stream")
        t0 = time.perf_counter()
        items = streamer.remote({"token_ids": prompts[1], "max_new_tokens": NEW_TOKENS})
        first = next(items)
        ttft_s = time.perf_counter() - t0
        rest = list(items)
        stream_s = time.perf_counter() - t0
        streamed = [first["token_id"]] + [item["token_id"] for item in rest[:-1]]
        check(first.get("index") == 0 and len(rest) == NEW_TOKENS
              and rest[-1].get("finished") and rest[-1]["token_ids"] == streamed,
              f"bad stream: first {first}, {len(rest)} more, last {rest[-1] if rest else None}")
        compared.append(("stream", prompts[1], streamed, want[1]))
        check(ttft_s < stream_s, "the stream's first item came with its end")
        launches = _replica_calls(rt, app, app, "kernel_launches")
        per_call = 2 * SERVE_LAYERS + 1
        for rid, c in launches.items():
            check(c["rmsnorm_fwd"] == per_call * c["forward_calls"],
                  f"replica {rid}: K1 {c['rmsnorm_fwd']} in {c['forward_calls']} model calls, "
                  f"want {per_call} each")
            for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                check(c[name] == 0, f"replica {rid} launched {name} on the serve_deploy path")
        own = {name: fn.launches for name, fn in counters.items()}
        check(all(v == 0 for v in own.values()),
              f"the deployment's path launched kernels in this process: {own}")
        path = {name: sum(c[name] for c in launches.values()) for name in counters}

        # (d) failover: a replica killed; the next requests answered, the
        # deployment back to two RUNNING replicas on card 0
        t0 = time.perf_counter()
        victim, victim_pid = rt.testing.kill_serve_replica(app)
        check(victim is not None, "no replica to kill")
        after_kill = [ask(p, handle)["token_ids"] for p in prompts[:4]]
        out["answered_after_kill_s"] = time.perf_counter() - t0
        compared += [("after_kill", p, t, w) for p, t, w in zip(prompts, after_kill, want)]
        deadline = time.time() + 300
        while time.time() < deadline:
            rows = _wait_running(rt, app, SERVE_DEPLOY["replicas"],
                                 timeout_s=max(1.0, deadline - time.time()))
            if victim not in {r["replica_id"] for r in rows}:
                break
            time.sleep(0.1)
        out["replacement_s"] = time.perf_counter() - t0
        check(victim not in {r["replica_id"] for r in rows}, "the killed replica was not replaced")
        for r in rows:
            check(r["mesh"]["gpu_ids"] == [0] and r["mesh"]["devices"] == ["cuda:0"],
                  f"serve_deploy (d): the replacement is not on card 0: {r}")
        print(f"lap serve_deploy replacement {out['replacement_s']:.1f} s")
        pids = set(cluster["pids"]) | set(pool_procs)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    check(not any(_alive(p) for p in pids), f"a worker outlived shutdown(): {sorted(pids)}")
    check(runtime_kernel_libs() == cluster["libs"], "a worker rebuilt a kernel library")

    # off the path: where a replica's greedy token parted from serve_cb's,
    # the in-process server's top-2 logit gap there must be a near-tie
    engine = server.engine
    ties = []
    for label, p, got_toks, want_toks in compared:
        j = _first_parting(got_toks, want_toks)
        if j is None:
            check(len(got_toks) == len(want_toks) == NEW_TOKENS, f"{label}: {got_toks}")
            continue
        with torch.inference_mode():
            logits = build_llama(engine._cfg, engine._params)(
                torch.tensor([p + want_toks[:j]], device="cuda"))[0, -1].float()
        top2 = logits.topk(2).values
        gap, bound = (top2[0] - top2[1]).item(), (
            SERVE_DEPLOY["near_tie_ulps"] * ULP["torch.bfloat16"] * top2[0].abs().item())
        print(f"serve_deploy ({label}): a replica parts from serve_cb at step {j}: top-2 "
              f"gap {gap} (near-tie bound {bound})")
        check(gap <= bound, f"a replica parts from serve_cb at step {j} where the top-2 gap "
                            f"{gap} is over {bound}")
        ties.append(dict(requests=label, step=j, top2_gap=gap, bound=bound))
    out.update(
        requests=CB_REQUESTS, threads=CB["slots"], replicas_used=used, routing=case,
        requests_by_replica=requests, prefix_hit_tokens=hits, prefill_tokens_computed=computed,
        serial_requests_by_replica=serial_requests, serial_prefix_hit_tokens=serial_hits,
        wall_s=wall, tokens_per_s=CB_REQUESTS * NEW_TOKENS / wall,
        serve_cb_tokens_per_s=cb_out["tokens_per_s"], near_ties=ties,
        stream_ttft_s=ttft_s, stream_s=stream_s, launches_by_replica=launches,
        killed=victim, killed_pid=victim_pid,
    )
    print(f"serve_deploy (b): {out['tokens_per_s']:.1f} tokens/s through two replicas, "
          f"serve_cb in process {cb_out['tokens_per_s']:.1f}; (c) stream TTFT "
          f"{ttft_s * 1e3:.1f} ms of {stream_s * 1e3:.1f} ms")
    print("serve_deploy", json.dumps(out))
    return path, out


# the TTFT histogram's tags (cache, mesh, tier) of a miss and of a local hit
TTFT_MISS, TTFT_HIT = ("miss", "tp=1", "miss"), ("hit", "tp=1", "local")


def _hist_counts(hist):
    """Observations per tag tuple of a registry histogram."""
    with hist._lock:
        return {k: sum(v) for k, v in hist._counts.items()}


def _hist_sums(hist):
    with hist._lock:
        return dict(hist._sums)


def _delta(after, before):
    """The entries of a counter dict that moved, and by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _step_until(engine, cond, limit=400):
    for _ in range(limit):
        if cond():
            return
        engine.step()
    fail("the engine did not reach the awaited state")


def cb_serve_phase(torch, np, dense_server, dense_serve):
    """Continuous batching over the paged prefix cache at 7B width, served
    through LLMServer on the dense server's weights (shared, not copied)."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.llm import GenerationRequest, LLMConfig, LLMServer
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd
    from ray_tpu_torch.util import metrics

    ttft_hist = metrics._ensure_kvcache_metrics()["ttft"]
    server = LLMServer(LLMConfig(
        model_id="llama2-7b", max_seq_len=CB["max_seq_len"], max_batch_size=CB["slots"],
        kv_cache_blocks=CB["blocks"], kv_block_size=CB["block"],
        model_kwargs=serve_model_kwargs(torch),
    ), params=dense_server.engine._params)
    engine, cfg = server.engine, server.engine._cfg
    check(engine._params is dense_server.engine._params, "the paged server copied the weights")
    rng = np.random.default_rng(SEED + 5)

    def tokens(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    # warm-up (cuBLAS, allocator), on a prefix of its own
    server({"token_ids": tokens(CB_PREFIX + CB_OWN), "max_new_tokens": 2})
    torch.cuda.synchronize()
    prefix = tokens(CB_PREFIX)
    prompts = [prefix + tokens(CB_OWN) for _ in range(CB_REQUESTS)]
    before, calls0, k1_0 = server.kvcache_stats(), engine.forward_calls, rmsnorm_fwd.launches
    reg0 = (metrics.kvcache_counters(), _hist_counts(ttft_hist), metrics.llm_counters())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(CB["slots"]) as pool:
        answers = list(pool.map(
            lambda p: server({"token_ids": p, "max_new_tokens": NEW_TOKENS, "temperature": 0.0}),
            prompts))
    wall = time.perf_counter() - t0
    registry = dict(kvcache=_delta(metrics.kvcache_counters(), reg0[0]),
                    ttft_observations=_delta(_hist_counts(ttft_hist), reg0[1]),
                    llm=_delta(metrics.llm_counters(), reg0[2]))
    for a in answers:
        check(a["num_prompt_tokens"] == CB_PREFIX + CB_OWN and len(a["token_ids"]) == NEW_TOKENS
              and a["finished_reason"] == "length", f"bad paged answer {a}")
        check(all(0 <= t < cfg.vocab_size for t in a["token_ids"]), "token out of range")
    after = server.kvcache_stats()
    hit = after["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    computed = after["prefill_tokens_computed"] - before["prefill_tokens_computed"]
    check(hit == (CB_REQUESTS - 1) * CB_PREFIX, f"prefix hit tokens {hit}")
    check(computed == CB_PREFIX + CB_OWN + (CB_REQUESTS - 1) * CB_OWN,
          f"prefill tokens computed {computed}")
    check(after["blocks_in_use"] == after["index_nodes"],
          f"lease pins left: {after['blocks_in_use']} blocks in use, index holds "
          f"{after['index_nodes']}")
    # the registry holds the manager's own counts exactly: one TTFT per
    # request (1 miss, 15 hits), one ITL per token after a request's first
    check(registry["kvcache"] == {"prefix_hit_tokens": hit, "prefill_tokens_computed": computed},
          f"registry kvcache deltas {registry['kvcache']}, stats {hit} / {computed}")
    check(registry["ttft_observations"] == {TTFT_MISS: 1, TTFT_HIT: CB_REQUESTS - 1},
          f"TTFT observations {registry['ttft_observations']}")
    registry["ttft_observations"] = {"/".join(k): v for k, v in registry["ttft_observations"].items()}
    check(registry["llm"] == {"itl_observations": CB_REQUESTS * (NEW_TOKENS - 1)},
          f"ITL observations {registry['llm']}, want {CB_REQUESTS * (NEW_TOKENS - 1)}")
    calls, k1 = engine.forward_calls - calls0, rmsnorm_fwd.launches - k1_0
    per_call = 2 * cfg.n_layers + 1
    check(k1 == per_call * calls, f"K1 launched {k1} times in {calls} model calls, "
                                  f"want {per_call} each")
    # occupancy: one prefill call for the miss, one per 32-token suffix
    # chunk for each hit; the rest are pooled decode steps
    decode_steps = calls - 1 - (CB_REQUESTS - 1) * -(-CB_OWN // CB["block"])

    # the pooled decode step with every slot active
    rids = [engine.add_request(GenerationRequest(token_ids=tokens(CB_OWN), max_new_tokens=24))
            for _ in range(CB["slots"])]
    _step_until(engine, lambda: len(engine._slots) == CB["slots"] and not engine._pending)
    step_ms = []
    for _ in range(16):
        t0 = time.perf_counter()
        engine.step()  # ends in the host transfer of the sampled tokens
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(len(engine._slots) == CB["slots"], "a slot left the timed steps")
    prof = device_profile(torch, engine.step)
    done = engine.run_until_complete()
    check(set(done) == set(rids), "the timed requests did not all finish")

    # TTFT of a miss, then of a hit that shares 480 of its 512 tokens, on
    # the host's clock around the stream and as the engine recorded it (the
    # TTFT histogram's _sum delta: the engine stamps at the first token's
    # host sync in admission, the stream yields it after that step's decode)
    engine_ttft = {}

    def ttft(prompt, tag):
        sums0, n0 = _hist_sums(ttft_hist).get(tag, 0.0), _hist_counts(ttft_hist).get(tag, 0)
        t0 = time.perf_counter()
        items = server.stream({"token_ids": prompt, "max_new_tokens": 4})
        next(items)
        first_ms = (time.perf_counter() - t0) * 1e3
        final = list(items)[-1]
        check(final.get("finished") and len(final["token_ids"]) == 4, f"bad stream end {final}")
        check(_hist_counts(ttft_hist)[tag] - n0 == 1, f"not one TTFT observation tagged {tag}")
        engine_ms = _hist_sums(ttft_hist)[tag] - sums0
        check(0 < engine_ms <= first_ms,
              f"engine TTFT {engine_ms} ms against the host's {first_ms} ms")
        engine_ttft[tag[0]] = dict(engine_ms=engine_ms, host_ms=first_ms,
                                   host_minus_engine_ms=first_ms - engine_ms)
        return first_ms

    miss = tokens(512)
    s0 = server.kvcache_stats()
    ttft_miss = ttft(miss, TTFT_MISS)
    s1 = server.kvcache_stats()
    ttft_hit = ttft(miss[:480] + tokens(32), TTFT_HIT)
    s2 = server.kvcache_stats()
    print("serve_cb: TTFT, engine vs host clock", json.dumps(engine_ttft))
    check(s1["prefix_hit_tokens"] == s0["prefix_hit_tokens"], "the 512-token miss hit the cache")
    check(s2["prefix_hit_tokens"] - s1["prefix_hit_tokens"] == 480, "the hit was not served 480")
    out = dict(
        requests=CB_REQUESTS, threads=CB["slots"], prompt_tokens=CB_PREFIX + CB_OWN,
        new_tokens=NEW_TOKENS, wall_s=wall, tokens_per_s=CB_REQUESTS * NEW_TOKENS / wall,
        dense_tokens_per_s=dense_serve["call_tokens_per_s"],
        prefix_hit_tokens=hit, prefill_tokens_computed=computed,
        prefill_tokens_saved_share=hit / (hit + computed), model_calls=calls,
        decode_steps=decode_steps,
        rows_per_decode_step=CB_REQUESTS * (NEW_TOKENS - 1) / decode_steps,
        rmsnorm_launches=k1, decode_ms_per_step_8_slots=statistics.median(step_ms),
        decode_ms_per_step_all=step_ms, step_profile=prof,
        ttft_ms_miss_512=ttft_miss, ttft_ms_hit_480_of_512=ttft_hit,
        kvcache=server.kvcache_stats(), registry=registry, engine_ttft=engine_ttft,
    )
    print("serve_cb", json.dumps(out))
    return server, out, {"prompts": prompts, "tokens": [a["token_ids"] for a in answers]}


def serve_obs_phase(torch, np, server, cb_out):
    """The observability plane on the serve_cb server: (a) a wave of its
    traffic with tracing off, then on; (b) the pooled step's launches,
    copies and syncs with tracing off and on, and its time each way; (c) the
    host cost of one record of each kind; (d) the device-memory gauges; (e)
    the device profile of one served request; (f) the Prometheus text."""
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.llm import GenerationRequest
    from ray_tpu_torch.util import events, metrics, tracing

    t_phase = time.perf_counter()
    engine, cfg = server.engine, server.engine._cfg
    rng = np.random.default_rng(SEED + 11)

    def tokens(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    # (a) phase 7's traffic on a fresh prefix, once to put its blocks in the
    # cache, then off and on: both serve every prompt from the same cached
    # blocks, so the greedy tokens must be equal
    prefix = tokens(CB_PREFIX)
    prompts = [prefix + tokens(CB_OWN) for _ in range(CB_REQUESTS)]

    def one(prompt):
        ctx = tracing.new_trace_context() if tracing.is_tracing_enabled() else None
        with tracing.request_span("serve_obs.request", ctx):
            answer = server({"token_ids": prompt, "max_new_tokens": NEW_TOKENS, "temperature": 0.0})
        return answer["token_ids"], ctx

    def wave():
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CB["slots"]) as pool:
            got = list(pool.map(one, prompts))
        return got, time.perf_counter() - t0

    wave()
    tracing.clear_spans()
    off, wall_off = wave()
    check(tracing.get_spans() == [], "a wave with tracing off recorded spans")
    tracing.enable_tracing()
    on, wall_on = wave()
    tracing._enabled = False
    check([t for t, _ in on] == [t for t, _ in off], "tracing on changed the greedy tokens")
    spans = tracing.get_spans()
    need = {"serve_obs.request", "engine.queue_wait", "kvcache.acquire", "kvcache.assemble",
            "engine.prefill", "kvcache.commit", "engine.decode"}
    per_request = []
    for _, ctx in on:
        mine = [s for s in spans if s["trace_id"] == ctx["trace_id"]]
        names = {s["name"] for s in mine}
        check(need <= names, f"a traced request lacks {need - names}")
        prefill = [s for s in mine if s["name"] == "engine.prefill"]
        check(len(prefill) == 1 and prefill[0]["args"]["hit"], f"prefill spans {prefill}")
        per_request.append(len(mine))
    tracing.clear_spans()
    traced = dict(wall_s_off=wall_off, wall_s_on=wall_on, spans_per_request=per_request,
                  tokens_equal=True)

    # (b) the pooled step, all 8 slots active: one profile and 16 timed
    # steps each way, in turns
    rids = [engine.add_request(GenerationRequest(token_ids=tokens(CB_OWN), max_new_tokens=48))
            for _ in range(CB["slots"])]
    _step_until(engine, lambda: len(engine._slots) == CB["slots"] and not engine._pending)
    profs, step_ms = {}, {"off": [], "on": []}
    for mode in ("off", "on"):
        tracing._enabled = mode == "on"
        profs[mode] = device_profile(torch, engine.step)
    for i in range(32):
        mode = "on" if i % 2 else "off"
        tracing._enabled = mode == "on"
        t0 = time.perf_counter()
        engine.step()  # ends in the host transfer of the sampled tokens
        step_ms[mode].append((time.perf_counter() - t0) * 1e3)
    tracing._enabled = False
    check(len(engine._slots) == CB["slots"], "a slot left the serve_obs steps")
    done = engine.run_until_complete()
    check(set(done) == set(rids), "the serve_obs step requests did not all finish")
    for key in ("kernel_launches", "dtoh_copies", "sync_calls"):
        check(profs["on"][key] == profs["off"][key],
              f"tracing on: {key} {profs['on'][key]}, off: {profs['off'][key]}")
    check(profs["off"]["kernel_launches"] == cb_out["step_profile"]["kernel_launches"],
          f"pooled step launched {profs['off']['kernel_launches']}, serve_cb's "
          f"{cb_out['step_profile']['kernel_launches']}")
    step = dict(
        kernel_launches=profs["off"]["kernel_launches"], dtoh_copies=profs["off"]["dtoh_copies"],
        sync_calls=profs["off"]["sync_calls"], step_ms_off=statistics.median(step_ms["off"]),
        step_ms_on=statistics.median(step_ms["on"]), step_ms_all=step_ms,
        profile_attempts=[profs[m]["profile_attempts"] for m in ("off", "on")])

    # (c) the host cost of one record, in us, over 10,000 calls each (under
    # a tag of their own, so that no serving series moves); the flight
    # recorder's ring holds 4,096, so most of its calls also drop one
    def per_call_us(fn, n=10_000):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    tracing.enable_tracing()
    ctx = tracing.new_trace_context()
    events.clear_events()
    cost_us = {
        "record_serve_itl": per_call_us(lambda: metrics.record_serve_itl(0.03, mesh="cost")),
        "record_kvcache_ttft": per_call_us(
            lambda: metrics.record_kvcache_ttft(0.1, True, mesh="cost")),
        "emit_span": per_call_us(
            lambda: tracing.emit_span("serve_obs.cost", ctx, time.time(), 0.0, category="engine")),
        "record_event": per_call_us(lambda: events.record_event("serve_obs_cost", n=1)),
    }
    tracing._enabled = False
    tracing.clear_spans()
    events.clear_events()
    serve_cb_step_ms = cb_out["decode_ms_per_step_8_slots"]
    cost = dict(us_per_call=cost_us,
                step_records_share_of_serve_cb_step=CB["slots"] * cost_us["record_serve_itl"]
                / (serve_cb_step_ms * 1e3),
                traced_request_spans_us=statistics.mean(per_request) * cost_us["emit_span"])

    # (d) device memory: one row, cuda:0, read beside the allocator
    rows = metrics.sample_device_memory()
    allocated, (_, total) = torch.cuda.memory_allocated(), torch.cuda.mem_get_info()
    kind = torch.cuda.get_device_name(0)
    check(set(rows) == {"cuda:0"}, f"device memory rows {rows}")
    weight_bytes = sum(t.numel() * t.element_size() for t in server.engine._params.values())
    check(rows["cuda:0"]["used"] == allocated >= weight_bytes,
          f"used {rows['cuda:0']['used']}, memory_allocated {allocated}, "
          f"the served weights alone {weight_bytes}")
    check(rows["cuda:0"]["limit"] == total, f"limit {rows['cuda:0']['limit']}, total {total}")
    check(("", "cuda:0", kind) in metrics._ensure_device_metrics()["used"]._values,
          f"no gauge tagged {kind}")
    memory = dict(rows=rows, memory_allocated=allocated, mem_get_info_total=total, kind=kind)

    # (e) tracing.device_profile around one served request, spin kernels
    # first (the profiler can drop a prefix of its device records)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as logdir:
        request = {"token_ids": tokens(CB_OWN), "max_new_tokens": 8}
        with tracing.device_profile(logdir):
            for _ in range(256):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            with tracing.annotate_device_trace("serve_obs.request"):
                server(request)
            torch.cuda.synchronize()
        files = list(Path(logdir).glob("*.pt.trace.json"))
        check(len(files) == 1, f"device_profile wrote {files}")
        trace = json.loads(files[0].read_text())["traceEvents"]
    region = [e.get("cat") for e in trace if e.get("name") == "serve_obs.request"]
    k1 = sum(e.get("cat") == "kernel" and PORT_KERNELS["rmsnorm_fwd"] in e.get("name", "")
             for e in trace)
    check(region and k1 >= 1, f"the device profile holds region {region} and {k1} K1 launches")
    profile = dict(events=len(trace), region_categories=region, k1_launches=k1,
                   pads_kept=sum("spin_kernel" in e.get("name", "") for e in trace))

    # (f) the Prometheus text over this process's payload, parsed back: the
    # cumulative buckets never decrease and each _count is the registry's
    text = metrics.render_prometheus([metrics.local_payload()])
    series = {}
    for line in text.splitlines():
        m = re.fullmatch(r"(\w+)(?:\{(.*)\})? (\S+)", line)
        if line.startswith("#") or not m:
            continue
        labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group(2) or ""))
        le = labels.pop("le", None)
        series.setdefault((m.group(1), tuple(sorted(labels.items()))), []).append(
            (le, float(m.group(3))))
    prom = {}
    for hist in (metrics._ensure_kvcache_metrics()["ttft"], metrics._ensure_llm_metrics()["itl"]):
        for tags, count in _hist_counts(hist).items():
            key = tuple(sorted((k, v) for k, v in zip(hist._tag_keys, tags) if v))
            buckets = [v for _, v in series[(hist._name + "_bucket", key)]]
            (_, n), = series[(hist._name + "_count", key)]
            check(all(a <= b for a, b in zip(buckets, buckets[1:])) and n == buckets[-1] == count,
                  f"{hist._name}{dict(key)}: buckets {buckets}, _count {n}, registry {count}")
            prom[hist._name + str(dict(key))] = n
    out = dict(traced=traced, step=step, record_cost=cost, device_memory=memory,
               device_profile=profile, prometheus_counts=prom, prometheus_lines=len(text.splitlines()),
               phase_s=time.perf_counter() - t_phase)
    print("serve_obs", json.dumps(out))
    return out


def cb_parity_phase(torch, np, params):
    """ContinuousBatchingEngine against LLMEngine on the first 2 layers of
    the 7B weights with f32 activations: greedy tokens equal, paged, chunked
    and speculative."""
    from ray_tpu_torch.kvcache import KVCacheManager
    from ray_tpu_torch.llm import ContinuousBatchingEngine, GenerationRequest, LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama2_7b(n_layers=2, max_seq_len=512, dtype=torch.float32,
                                param_dtype=torch.bfloat16)
    params2 = {k: v for k, v in params.items()
               if not k.startswith("layer_") or k.split(".")[0] in ("layer_0", "layer_1")}
    dcfg = dataclasses.replace(cfg, n_layers=1)
    drand = init_params(dcfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    rng = np.random.default_rng(SEED + 6)
    shared = rng.integers(0, cfg.vocab_size, 96).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, n).tolist() for n in (0, 9, 40, 70)]
    prompts.append(rng.integers(0, cfg.vocab_size, 20).tolist())
    reqs = [GenerationRequest(token_ids=p, max_new_tokens=24) for p in prompts]
    want = [r.token_ids for r in LLMEngine(cfg, params2, max_batch_size=8).generate(reqs)]
    cases = {
        "paged": {},
        "chunked_64": {"prefill_chunk_tokens": 64},
        "spec_k4_draft_is_target": {"draft": (cfg, params2), "spec_tokens": 4},
        "spec_k4_random_1_layer_draft": {"draft": (dcfg, drand), "spec_tokens": 4},
    }
    out = {}
    for name, kw in cases.items():
        kv = KVCacheManager(64, CB["block"])
        engine = ContinuousBatchingEngine(cfg, params2, num_slots=CB["slots"], kv_cache=kv,
                                          seed=0, **kw)
        runs = []
        for _ in range(2):  # the second run hits every prompt's cached blocks
            in_use = kv.blocks_in_use
            got = [r.token_ids for r in engine.generate(reqs)]
            check(got == want, f"{name}: greedy tokens differ from LLMEngine's")
            check(kv.blocks_in_use == kv.stats()["index_nodes"], f"{name}: lease pins left")
            runs.append((in_use, kv.blocks_in_use))
        # the second run adds nothing to the index: back to its count
        check(runs[1][0] == runs[1][1], f"{name}: blocks in use {runs[1]}")
        stats = kv.stats()
        check(stats["prefix_hit_tokens"] > 0, f"{name}: no prefix hit")
        row = dict(tokens_equal=True, blocks_in_use=runs, prefix_hit_tokens=stats["prefix_hit_tokens"])
        if "draft" in kw:
            acc = engine.spec_accepted / engine.spec_proposed
            row.update(spec_proposed=engine.spec_proposed, spec_accepted=engine.spec_accepted,
                       acceptance=acc)
            if name == "spec_k4_draft_is_target":
                check(acc == 1.0, f"{name}: acceptance {acc}, want 1")
            else:
                check(acc < 1.0, f"{name}: acceptance {acc}: no rejection ran")
        out[name] = row
        del engine, kv
    print("cb_parity", json.dumps(out))
    torch.cuda.empty_cache()
    return out


def cb_spec_chunk_phase(torch, np, params):
    """Speculation and chunked prefill at 7B width in bf16."""
    from ray_tpu_torch.kvcache import KVCacheManager
    from ray_tpu_torch.llm import ContinuousBatchingEngine, GenerationRequest
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.util import metrics

    cfg = LlamaConfig.llama2_7b(max_seq_len=CB["max_seq_len"], **serve_model_kwargs(torch))
    rng = np.random.default_rng(SEED + 7)
    llm = metrics._ensure_llm_metrics()

    def tokens(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def engine(**kw):
        return ContinuousBatchingEngine(cfg, params, num_slots=CB["slots"], seed=0,
                                        kv_cache=KVCacheManager(CB["blocks"], CB["block"]), **kw)

    # speculation, k=4, the target as its own draft (shared weights)
    llm0 = metrics.llm_counters()
    spec = engine(draft=(cfg, params), spec_tokens=4)
    for _ in range(CB["slots"]):
        spec.add_request(GenerationRequest(token_ids=tokens(CB_OWN), max_new_tokens=48))
    _step_until(spec, lambda: len(spec._slots) == CB["slots"] and not spec._pending)
    p0, a0, ms, emitted = spec.spec_proposed, spec.spec_accepted, [], 0
    itl0 = metrics.llm_counters()["itl_observations"]
    for _ in range(4):
        n0 = sum(len(s.generated) for s in spec._slots.values())
        t0 = time.perf_counter()
        spec.step()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(len(spec._slots) == CB["slots"], "a slot finished inside the timed spec steps")
        emitted += sum(len(s.generated) for s in spec._slots.values()) - n0
    # no row stopped in these steps: the ITL observations are the tokens
    # the verify passes landed, counted here from the slots
    itl_timed = metrics.llm_counters()["itl_observations"] - itl0
    check(itl_timed == emitted, f"{itl_timed} ITL observations in steps that emitted {emitted}")
    results = spec.run_until_complete()
    check(all(len(r.token_ids) == 48 for r in results.values()), "bad speculative results")
    acc = (spec.spec_accepted - a0) / (spec.spec_proposed - p0)
    # the registry's spec counters move by the engine's own; the gauge is
    # the registry's lifetime ratio; every verify step records sum(cnt) =
    # accepted + one per row ITL observations (spec_proposed / k row steps)
    reg = _delta(metrics.llm_counters(), llm0)
    want = {"spec_proposed_tokens": spec.spec_proposed, "spec_accepted_tokens": spec.spec_accepted,
            "itl_observations": spec.spec_accepted + spec.spec_proposed // 4}
    check(reg == want, f"registry deltas {reg}, engine {want}")
    totals = metrics.llm_counters()
    gauge = llm["acceptance"]._values[("tp=1",)]
    check(gauge == totals["spec_accepted_tokens"] / totals["spec_proposed_tokens"],
          f"acceptance gauge {gauge}, registry ratio {totals}")
    spec_out = dict(k=4, slots=CB["slots"], step_ms=ms, step_ms_median=statistics.median(ms),
                    tokens_per_step_per_row=emitted / (len(ms) * CB["slots"]),
                    acceptance=acc, acceptance_all=spec.spec_accepted / spec.spec_proposed,
                    registry=reg, itl_observations_timed=itl_timed, acceptance_gauge=gauge)
    del spec, results
    torch.cuda.empty_cache()

    # chunked prefill: 7 decoding requests, then an 896-token prompt
    long_prompt = tokens(CB_LONG)
    short = [tokens(CB_OWN) for _ in range(CB["slots"] - 1)]
    chunk_out = {}
    for name, budget in (("chunked_128", 128), ("unchunked", 0)):
        eng = engine(prefill_chunk_tokens=budget)
        for p in short:
            eng.add_request(GenerationRequest(token_ids=p, max_new_tokens=24))
        _step_until(eng, lambda: len(eng._slots) == len(short) and not eng._pending
                    and not eng._prefilling)
        eng.step()  # warm: every row decoding
        eng.add_request(GenerationRequest(token_ids=long_prompt, max_new_tokens=8))
        gaps, stalls, steps = [], 0, 0
        buckets0 = list(llm["itl"]._counts[("tp=1",)])
        while eng._pending or eng._prefilling or len(eng._slots) < CB["slots"]:
            n0 = {si: len(s.generated) for si, s in eng._slots.items()}
            t0 = time.perf_counter()
            eng.step()
            gaps.append((time.perf_counter() - t0) * 1e3)
            steps += 1
            check(steps <= 64, f"{name}: the long prompt did not land")
            for si, n in n0.items():
                if si in eng._slots and len(eng._slots[si].generated) != n + 1:
                    stalls += 1
        if budget:
            check(stalls == 0, f"{name}: {stalls} in-flight rows missed a step")
            check(steps >= CB_LONG // budget, f"{name}: prefill took {steps} steps")
        # the ITL histogram over the same steps, beside the largest step gap
        itl_counts = [b - a for a, b in zip(buckets0, llm["itl"]._counts[("tp=1",)])]
        itl_q = {f"itl_p{round(q * 100)}_ms": metrics.quantile_from_buckets(
            llm["itl"]._boundaries, itl_counts, q) * 1e3 for q in (0.5, 0.99)}
        chunk_out[name] = dict(steps=steps, max_gap_ms=max(gaps), gaps_ms=gaps, stalls=stalls,
                               itl_observations=sum(itl_counts), **itl_q)
        if budget:
            # one 32-token chunk forward of a 1-row cache, timed and profiled
            row, chunk = eng._empty_row(), eng._tokens([long_prompt[:CB["block"]]])
            fwd_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng._decode(row, chunk)
                torch.cuda.synchronize()
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
            chunk_out[name].update(chunk_forward_ms=fwd_ms, chunk_forward_profile=device_profile(
                torch, lambda: eng._decode(row, chunk)))
            del row
        eng.run_until_complete()
        del eng
        torch.cuda.empty_cache()
    out = dict(spec=spec_out, chunked=chunk_out)
    print("cb_spec_chunk", json.dumps(out))
    return out


def lora_tree(np, cfg, seed):
    """One tenant's adapter from a numpy seed, nested as the reference's
    trees are (numpy leaves): rank LORA["rank"] on every wq/wk/wv/wo,
    lora_a with variance 1/in (lecun, as init_params draws it) and lora_b
    normal with std LORA["lora_b_std"]: each projection's delta is then
    about 0.4 of its base output (4 x 0.1 over the 16 ranks), so adapter
    rows move far from the base model's."""
    from ray_tpu_torch.lora import adapter_target_paths

    rng, r = np.random.default_rng(seed), LORA["rank"]
    tree = {}
    for path, d_in, d_out in adapter_target_paths(cfg):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = {
            "lora_a": rng.standard_normal((d_in, r), dtype=np.float32) / np.sqrt(d_in),
            "lora_b": rng.standard_normal((r, d_out), dtype=np.float32) * LORA["lora_b_std"],
        }
    return tree


def _lora_static_params(torch, tree, device):
    """A tenant's adapter as static LoRADense weights (flat port keys, bf16)."""
    out = {}
    for layer, sub in tree.items():
        for name, factors in sub["attn"].items():
            for factor, value in factors.items():
                out[f"{layer}.attn.{name}.{factor}"] = torch.from_numpy(value).to(
                    device, torch.bfloat16)
    return out


def serve_lora_phase(torch, np, params, cb_out):
    """Multi-tenant LoRA serving at 7B width through LLMServer with an
    adapter store, on the serve_cb weights (shared, not copied)."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.llm import AdapterConfig, GenerationRequest, LLMConfig, LLMEngine, LLMServer
    from ray_tpu_torch.llm import LLMPredictor
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd
    from ray_tpu_torch.util import events, metrics

    adapters = AdapterConfig(max_live=LORA["max_live"], slot_rank=LORA["rank"], alpha=LORA["alpha"])
    # the registry and the flight recorder from here to the server's last
    # request (this server's store is the only one that records meanwhile)
    adapter0, t_events = metrics.adapter_counters(), time.time()
    server = LLMServer(LLMConfig(
        model_id="llama2-7b", max_seq_len=CB["max_seq_len"], max_batch_size=CB["slots"],
        kv_cache_blocks=CB["blocks"], kv_block_size=CB["block"],
        model_kwargs=serve_model_kwargs(torch), adapters=adapters,
    ), params=params)
    engine, cfg, store = server.engine, server.engine._cfg, server.adapter_store
    check(engine._params is params, "the LoRA server copied the weights")
    tenants = [f"tenant_{i}" for i in range(1, LORA["tenants"] + 1)]
    trees = {t: lora_tree(np, cfg, SEED + 10 + i) for i, t in enumerate(tenants)}
    n_adapter = sum(v.size for sub in trees[tenants[0]].values()
                    for fs in sub["attn"].values() for v in fs.values())
    check(n_adapter == cfg.n_layers * 4 * 2 * cfg.dim * LORA["rank"],
          f"an adapter holds {n_adapter} parameters")
    attach_ms = {}
    for t in tenants:
        store.prewarm(t, trees[t])
        attach_ms[t] = store.stats()["last_attach_ms"]
    bank_bytes = sum(x.numel() * x.element_size() for f in store.bank().values() for x in f.values())
    print("serve_lora: prewarm last_attach_ms", json.dumps(attach_ms))

    def tenant(i):  # request i names tenant i % 5; 0 is the base model
        return None if i % (len(tenants) + 1) == 0 else tenants[i % (len(tenants) + 1) - 1]

    rng = np.random.default_rng(SEED + 8)

    def tokens(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    # warm-up (cuBLAS, allocator), an adapter request and a base one, each
    # on a prefix of its own
    for aid in (tenants[0], None):
        server({"token_ids": tokens(CB_PREFIX + CB_OWN), "max_new_tokens": 2, "adapter_id": aid})
    torch.cuda.synchronize()

    # the serve_cb traffic, each wave on a prefix of its own: request i
    # names tenant i % 5 in the mixed wave, no adapter in the base-only
    # waves before and after it (tokens/s compared on one server, in one
    # phase: host time drifts between phases)
    per_call = 2 * cfg.n_layers + 1

    def wave(tenant_of):
        prefix = tokens(CB_PREFIX)
        prompts = [prefix + tokens(CB_OWN) for _ in range(CB_REQUESTS)]
        before, calls0, k1_0 = server.kvcache_stats(), engine.forward_calls, rmsnorm_fwd.launches
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CB["slots"]) as pool:
            answers = list(pool.map(lambda i: server({
                "token_ids": prompts[i], "max_new_tokens": NEW_TOKENS, "temperature": 0.0,
                "adapter_id": tenant_of(i)}), range(CB_REQUESTS)))
        wall = time.perf_counter() - t0
        for a in answers:
            check(a["num_prompt_tokens"] == CB_PREFIX + CB_OWN and len(a["token_ids"]) == NEW_TOKENS
                  and a["finished_reason"] == "length", f"bad LoRA answer {a}")
            check(all(0 <= t < cfg.vocab_size for t in a["token_ids"]), "token out of range")
        after = server.kvcache_stats()
        hit = after["prefix_hit_tokens"] - before["prefix_hit_tokens"]
        computed = after["prefill_tokens_computed"] - before["prefill_tokens_computed"]
        # one miss a key space: a tenant's, or the base model's
        spaces = len({tenant_of(i) for i in range(CB_REQUESTS)})
        check(hit == (CB_REQUESTS - spaces) * CB_PREFIX, f"salted prefix hit tokens {hit}")
        check(computed == spaces * (CB_PREFIX + CB_OWN) + (CB_REQUESTS - spaces) * CB_OWN,
              f"salted prefill tokens computed {computed}")
        check(after["blocks_in_use"] == after["index_nodes"], "lease pins left in the KV pool")
        check(store.stats()["slots_pinned"] == 0, f"adapter pins left: {store.stats()}")
        calls, k1 = engine.forward_calls - calls0, rmsnorm_fwd.launches - k1_0
        check(k1 == per_call * calls, f"K1 launched {k1} times in {calls} model calls, "
                                      f"want {per_call} each")
        return dict(wall_s=wall, tokens_per_s=CB_REQUESTS * NEW_TOKENS / wall, hit=hit,
                    computed=computed, calls=calls, k1=k1)

    waves = [wave(lambda i: None), wave(tenant), wave(lambda i: None)]
    mixed_wave = waves[1]
    wall, hit, computed = mixed_wave["wall_s"], mixed_wave["hit"], mixed_wave["computed"]
    calls, k1 = mixed_wave["calls"], mixed_wave["k1"]
    base_tps = [waves[0]["tokens_per_s"], waves[2]["tokens_per_s"]]

    # the pooled step, 8 rows: base, 4 tenants, base, 2 tenants
    leases = [store.acquire(tenant(i)) if tenant(i) else None for i in range(CB["slots"])]
    for i, lease in enumerate(leases):
        engine.add_request(GenerationRequest(
            token_ids=tokens(CB_OWN), max_new_tokens=48, adapter_id=tenant(i),
            adapter_slot=lease.slot if lease else -1))
    _step_until(engine, lambda: len(engine._slots) == CB["slots"] and not engine._pending)
    mixed = engine._row_adapter_slots().tolist()
    base_rows = [r for r, sl in enumerate(mixed) if sl < 0]
    lora_rows = [r for r, sl in enumerate(mixed) if sl >= 0]
    check(len(base_rows) == 2 and len(lora_rows) == 6, f"pooled slots {mixed}")
    requests = {si: sl.request for si, sl in engine._slots.items()}

    def set_slots(slots):
        for si, req in requests.items():
            req.adapter_slot = slots[si]

    # one pooled step's logits with mixed slots, then with every slot at -1,
    # from the same cache positions
    idx0 = engine._cache.index.clone()
    last = engine._tokens([[engine._slots[si].last_token] for si in range(CB["slots"])])
    step_logits = {}
    for kind, slots in (("mixed", mixed), ("base", [-1] * CB["slots"])):
        engine._cache.index.copy_(idx0)
        step_logits[kind] = engine._forward(last, engine._cache, slots)[:, -1].float()
    engine._cache.index.copy_(idx0)
    check(torch.equal(step_logits["mixed"][base_rows], step_logits["base"][base_rows]),
          "base rows of a mixed pooled step differ from the all-base step")
    step_effect = (step_logits["mixed"] - step_logits["base"])[lora_rows].abs().max().item()

    # the timed steps, mixed and all -1 in turns (host time drifts within a
    # run), then one profiled step of each
    step_ms = {"mixed": [], "base": []}
    for i in range(32):
        kind = "mixed" if i % 2 == 0 else "base"
        set_slots(mixed if kind == "mixed" else [-1] * CB["slots"])
        t0 = time.perf_counter()
        engine.step()  # ends in the host transfer of the sampled tokens
        step_ms[kind].append((time.perf_counter() - t0) * 1e3)
    check(len(engine._slots) == CB["slots"], "a slot left the timed LoRA steps")
    profiles = {}
    for kind in ("base", "mixed"):
        set_slots(mixed if kind == "mixed" else [-1] * CB["slots"])
        profiles[kind] = device_profile(torch, engine.step)
    set_slots(mixed)
    engine.run_until_complete()
    for lease in leases:
        store.release(lease)
    base_launches = profiles["base"]["kernel_launches"]
    check(base_launches == cb_out["step_profile"]["kernel_launches"],
          f"a base-only pooled step with a store launched {base_launches} kernels, the "
          f"serve_cb step {cb_out['step_profile']['kernel_launches']}")
    # the adapter path of one call: one gather per factor and projection,
    # then bmm and baddbmm_ per projection and layer
    extra_ops = {op: profiles["mixed"]["host_ops"][op] - profiles["base"]["host_ops"][op]
                 for op in HOST_OPS}
    want_ops = {"aten::bmm": 4 * cfg.n_layers, "aten::baddbmm_": 4 * cfg.n_layers,
                "aten::index": 8}
    check(extra_ops == want_ops, f"the adapter path ran {extra_ops}, want {want_ops}")
    extra_launches = profiles["mixed"]["kernel_launches"] - base_launches
    check(extra_launches >= sum(want_ops.values()),
          f"the adapter path launched {extra_launches} kernels for {want_ops}")

    # adapter rows at full width against one model per tenant with the same
    # A and B as static LoRA weights (rank 16, alpha 16: the same scale 1),
    # over a fresh cache: a decode-mode prefill of 8 rows of 64 tokens
    rows_t = engine._tokens([tokens(CB_OWN) for _ in range(CB["slots"])])
    gathered, _ = engine._prefill(rows_t, mixed)
    base_pre, _ = engine._prefill(rows_t)
    check(torch.equal(gathered[base_rows], base_pre[base_rows]),
          "base rows of a mixed prefill differ from the all-base prefill")
    static_cfg = dataclasses.replace(cfg, lora_rank=LORA["rank"], lora_alpha=LORA["alpha"])
    static = {"max_abs_err": 0.0, "max_abs_logit": 0.0, "min_effect": float("inf")}
    for t in tenants:
        rows = [r for r in lora_rows if tenant(r) == t]
        s_eng = LLMEngine(static_cfg, {**params, **_lora_static_params(
            torch, trees[t], params["embed"].device)})
        want, _ = s_eng._prefill(rows_t[rows])
        want, got = want.float(), gathered[rows].float()
        static["max_abs_err"] = max(static["max_abs_err"], (got - want).abs().max().item())
        static["max_abs_logit"] = max(static["max_abs_logit"], want.abs().max().item())
        static["min_effect"] = min(static["min_effect"],
                                   (got - base_pre[rows].float()).abs().max().item())
        del s_eng
    # tolerance: the two paths run the same bf16 weights and activations and
    # round the adapter's product differently (static: x@A, then @B, then the
    # add, each rounded to bf16; gathered: x@A, then @B added inside the
    # product and rounded once), one rounding step of bf16 per projection and
    # layer; like the full forward against the prefill (forward phase), that
    # stays within 5% of the largest logit after 32 layers (2.2-2.3% at
    # widths 512 and 1024 with 32 layers on the CPU)
    tol = 0.05 * static["max_abs_logit"]
    check(static["max_abs_err"] <= tol,
          f"adapter rows vs static LoRA: max_abs_err {static['max_abs_err']} > {tol}")
    # "far more than the tolerance": at least 4x, in the prefill and the step
    check(static["min_effect"] >= 4 * tol and step_effect >= 4 * tol,
          f"adapters moved the logits by {static['min_effect']} / {step_effect}, "
          f"want at least {4 * tol}")

    # TTFT of a tenant's miss, then of its hit sharing 480 of 512 tokens
    def ttft(prompt):
        t0 = time.perf_counter()
        items = server.stream({"token_ids": prompt, "max_new_tokens": 4, "adapter_id": tenants[0]})
        next(items)
        first_ms = (time.perf_counter() - t0) * 1e3
        final = list(items)[-1]
        check(final.get("finished") and len(final["token_ids"]) == 4, f"bad stream end {final}")
        return first_ms

    miss = tokens(512)
    s0 = server.kvcache_stats()
    ttft_miss = ttft(miss)
    s1 = server.kvcache_stats()
    ttft_hit = ttft(miss[:480] + tokens(32))
    s2 = server.kvcache_stats()
    check(s1["prefix_hit_tokens"] == s0["prefix_hit_tokens"], "the tenant's miss hit the cache")
    check(s2["prefix_hit_tokens"] - s1["prefix_hit_tokens"] == 480, "the tenant's hit was not 480")
    stats = server.adapters_stats()
    registry = _delta(metrics.adapter_counters(), adapter0)
    want = {"adapter_hits": stats["hits"], "adapter_cold_attaches": stats["cold_attaches"],
            "adapter_evictions": stats["evictions"]}
    check(registry == {k: v for k, v in want.items() if v},
          f"registry adapter deltas {registry}, store {want}")
    cold = [e for e in events.get_events(events.ADAPTER_COLD_ATTACH) if e["ts"] >= t_events]
    check(len(cold) == stats["cold_attaches"]
          and all(e["slot"] == store._slot_of[e["adapter_id"]] for e in cold),
          f"cold-attach events {cold}, store slots {store._slot_of}")
    del server, engine, store
    torch.cuda.empty_cache()

    parity = lora_parity_phase(torch, np, params, trees)

    # LLMPredictor at 7B: one batch of 8 rows over the 4 tenants and the
    # base, its adapters attached cold from a callable source
    pred = LLMPredictor(LLMConfig(
        model_id="llama2-7b", max_seq_len=CB["max_seq_len"], max_batch_size=CB["slots"],
        max_new_tokens=16, kv_cache_blocks=1, model_kwargs=serve_model_kwargs(torch),
        adapters=dataclasses.replace(adapters, source=trees.__getitem__),
    ), params=params)
    batch = {"token_ids": [tokens(PROMPT_LEN) for _ in range(CB["slots"])],
             "adapter_id": [tenant(i) for i in range(CB["slots"])]}
    t0 = time.perf_counter()
    generated = pred(batch)["generated"]
    pred_s = time.perf_counter() - t0
    check(all(len(g) == 16 and all(0 <= t < cfg.vocab_size for t in g) for g in generated),
          "bad LLMPredictor rows")
    pred_stats = pred.adapter_store.stats()
    check(pred_stats["cold_attaches"] == len(tenants) and pred_stats["slots_pinned"] == 0,
          f"LLMPredictor store {pred_stats}")
    del pred
    torch.cuda.empty_cache()

    out = dict(
        tenants=len(tenants), rank=LORA["rank"], max_live=LORA["max_live"],
        adapter_params=n_adapter, bank_bytes=bank_bytes, prewarm_last_attach_ms=attach_ms,
        requests=CB_REQUESTS, threads=CB["slots"], new_tokens=NEW_TOKENS, wall_s=wall,
        tokens_per_s=CB_REQUESTS * NEW_TOKENS / wall, serve_cb_tokens_per_s=cb_out["tokens_per_s"],
        base_only_tokens_per_s=base_tps,
        tokens_per_s_over_base_only=CB_REQUESTS * NEW_TOKENS / wall / statistics.mean(base_tps),
        base_only_waves=[waves[0], waves[2]],
        prefix_hit_tokens=hit, prefill_tokens_computed=computed, model_calls=calls,
        rmsnorm_launches=k1,
        step_ms_mixed=statistics.median(step_ms["mixed"]),
        step_ms_base=statistics.median(step_ms["base"]),
        step_ms_all=step_ms, step_launches_mixed=profiles["mixed"]["kernel_launches"],
        step_launches_base=base_launches,
        step_launches_serve_cb=cb_out["step_profile"]["kernel_launches"],
        adapter_path_ops=extra_ops, adapter_path_launches=extra_launches,
        step_profile_mixed=profiles["mixed"], step_profile_base=profiles["base"],
        base_rows_equal=True, adapter_effect_step=step_effect, static_lora=static, tol=tol,
        ttft_ms_miss_512=ttft_miss, ttft_ms_hit_480_of_512=ttft_hit, adapter_stats=stats,
        predictor_rows=CB["slots"], predictor_new_tokens=16, predictor_s=pred_s,
        predictor_stats=pred_stats, parity=parity, registry=registry,
        cold_attach_events=cold,
    )
    print("serve_lora", json.dumps(out))
    return out


def lora_parity_phase(torch, np, params, trees):
    """Greedy tokens at 2 layers of the 7B weights with f32 activations: a
    mixed batch of tenants and base rows, several sharing one prompt, equals
    each request served alone (LLMEngine with the store), on the paged, the
    chunked (128) and the speculative (k=4, the base target as draft)
    engines, and LLMPredictor on the same rows."""
    from ray_tpu_torch.kvcache import KVCacheManager
    from ray_tpu_torch.llm import (AdapterConfig, ContinuousBatchingEngine, GenerationRequest,
                                   LLMConfig, LLMEngine, LLMPredictor)
    from ray_tpu_torch.lora import AdapterStore
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama2_7b(n_layers=2, max_seq_len=512, dtype=torch.float32,
                                param_dtype=torch.bfloat16)
    params2 = {k: v for k, v in params.items()
               if not k.startswith("layer_") or k.split(".")[0] in ("layer_0", "layer_1")}
    store = AdapterStore(cfg, max_live=LORA["max_live"], rank=LORA["rank"], alpha=LORA["alpha"])
    for t, tree in trees.items():
        store.prewarm(t, tree)  # the serving trees: the store reads layers 0 and 1
    t1, t2, t3, t4 = trees
    rng = np.random.default_rng(SEED + 9)
    shared = rng.integers(0, cfg.vocab_size, 96).tolist()
    p = {n: shared + rng.integers(0, cfg.vocab_size, n).tolist() for n in (9, 40, 70)}
    rows = [(t1, p[9]), (t2, p[9]), (None, p[9]), (t3, p[40]), (t4, p[40]), (t1, p[70]),
            (None, rng.integers(0, cfg.vocab_size, 20).tolist())]

    def requests():
        leases = [store.acquire(t) if t else None for t, _ in rows]
        return [GenerationRequest(token_ids=q, max_new_tokens=24, adapter_id=t,
                                  adapter_slot=lease.slot if lease else -1)
                for (t, q), lease in zip(rows, leases)], leases

    def release(leases):
        for lease in leases:
            store.release(lease)

    reqs, leases = requests()
    alone = LLMEngine(cfg, params2, adapter_store=store)
    want = [alone.generate([r])[0].token_ids for r in reqs]
    release(leases)
    check(want[0] != want[2] and want[0] != want[1], "adapters did not move the greedy tokens")
    cases = {
        "paged": {},
        "chunked_128": {"prefill_chunk_tokens": 128},
        "spec_k4_base_draft": {"draft": (cfg, params2), "spec_tokens": 4},
    }
    out = {}
    for name, kw in cases.items():
        kv = KVCacheManager(64, CB["block"])
        engine = ContinuousBatchingEngine(cfg, params2, num_slots=CB["slots"], kv_cache=kv,
                                          seed=0, adapter_store=store, **kw)
        for _ in range(2):  # the second run hits every key space's cached blocks
            reqs, leases = requests()
            got = [r.token_ids for r in engine.generate(reqs)]
            release(leases)
            check(got == want, f"LoRA {name}: greedy tokens differ from each tenant alone")
            check(kv.blocks_in_use == kv.stats()["index_nodes"], f"LoRA {name}: lease pins left")
        row = dict(tokens_equal=True, prefix_hit_tokens=kv.stats()["prefix_hit_tokens"])
        if "draft" in kw:
            row["acceptance"] = engine.spec_accepted / engine.spec_proposed
        out[name] = row
        del engine, kv
    pred = LLMPredictor(LLMConfig(
        model_id="llama2-7b", max_seq_len=512, max_new_tokens=24, max_batch_size=CB["slots"],
        kv_cache_blocks=1, model_kwargs={"n_layers": 2, "dtype": torch.float32,
                                         "param_dtype": torch.bfloat16},
        adapters=AdapterConfig(max_live=LORA["max_live"], slot_rank=LORA["rank"],
                               alpha=LORA["alpha"], source=trees.__getitem__),
    ), params=params2)
    got = pred({"token_ids": [q for _, q in rows], "adapter_id": [t for t, _ in rows]})
    check(got["generated"] == want, "LLMPredictor's greedy tokens differ from each tenant alone")
    out["predictor"] = dict(tokens_equal=True)
    check(store.stats()["slots_pinned"] == 0, "adapter pins left in the parity store")
    del pred, store, alone
    torch.cuda.empty_cache()
    return out


# the aten ops of the adapter path, counted in a profiled call
HOST_OPS = ("aten::bmm", "aten::baddbmm_", "aten::index")


# the port's kernels in a profile, by a part of their CUDA symbol
# (the forward: flash_fwd_tc_kernel in bf16/f16, flash_fwd_kernel in f32)
PORT_KERNELS = {"rmsnorm_fwd": "rmsnorm_fwd_kernel", "flash_attention_fwd": "flash_fwd_",
                "flash_bwd_dq": "flash_bwd_dq_", "flash_bwd_dkv": "flash_bwd_dkv_"}


TTFT_PEER = ("hit", "tp=1", "peer")


def _first_parting(a, b):
    """The first position where two token lists differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def serve_disagg_phase(torch, np, params):
    """Disaggregated prefill/decode and the KV tier at full Llama-2-7B width,
    on phase 5's weights (shared, not copied): (a) a prefill and a decode
    server (raw codec) behind _DisaggIngress against a fused paged server;
    (b) the same with kv_ship_codec="int8", then (d) a dead prefill holder;
    (c) a scale-up server on the tier of a warm fused server, pulling a whole
    prompt and then a 480-token prefix. Returns the phase's summary."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch._internal.quantization import QuantizedArray, quantize_np, quantize_torch
    from ray_tpu_torch.kvcache import KVCacheManager
    from ray_tpu_torch.kvtier import (
        KVShipment, LocalTierBackend, block_fingerprints, decode_payload, encode_payload)
    from ray_tpu_torch.llm import LLMConfig, LLMServer
    from ray_tpu_torch.llm.serving import _DisaggIngress
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd
    from ray_tpu_torch.util import events, metrics

    n, plen, new, bs = (DISAGG["prompts"], DISAGG["prompt_len"], DISAGG["new_tokens"],
                        CB["block"])
    nblocks = plen // bs
    ttft_hist = metrics._ensure_kvcache_metrics()["ttft"]
    k1_0, k2_0 = rmsnorm_fwd.launches, flash_attention_fwd.launches
    tier_0 = metrics.kvtier_counters()
    summary_0 = metrics.kvtier_summary([metrics.local_payload()])
    shipped_0 = len(events.get_events(events.KV_SHIPPED))
    live, calls_retired, registers = [], [0], []

    def config(**kw):
        return LLMConfig(model_id="llama2-7b", max_seq_len=CB["max_seq_len"],
                         max_batch_size=CB["slots"], kv_cache_blocks=CB["blocks"],
                         kv_block_size=bs, max_new_tokens=new,
                         model_kwargs=serve_model_kwargs(torch), **kw)

    def make(cfg, **kw):
        s = LLMServer(cfg, params=params, **kw)
        check(s.engine._params is params, "a serve_disagg server copied the weights")
        live.append(s)
        return s

    def free(*servers):
        for s in servers:
            calls_retired[0] += s.engine.forward_calls
            live.remove(s)
        gc.collect()
        torch.cuda.empty_cache()

    def retire_backend(backend):
        registers.append(backend.stats()["registers"])

    model_cfg = config().build_model_config()
    esize = torch.empty(0, dtype=model_cfg.dtype).element_size()
    rng = np.random.default_rng(SEED + 11)

    def tokens(k):
        return rng.integers(0, model_cfg.vocab_size, k).tolist()

    def request(prompt):
        return {"token_ids": prompt, "max_new_tokens": new, "temperature": 0.0}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def wave(call, prompts):
        """The prompts from one thread each; (answers, per-request walls ms)."""
        def one(p):
            t0 = time.perf_counter()
            a = call(request(p))
            return a, (time.perf_counter() - t0) * 1e3
        with ThreadPoolExecutor(len(prompts)) as pool:
            res = list(pool.map(one, prompts))
        for a, _ in res:
            check(a["num_prompt_tokens"] == plen and len(a["token_ids"]) == new
                  and a["finished_reason"] == "length", f"bad serve_disagg answer {a}")
        return [a["token_ids"] for a, _ in res], [w for _, w in res]

    def ttft_mean(tag, fn):
        """fn()'s result, and the mean engine TTFT (ms) of what it admitted
        under ``tag`` (the histogram's _sum and count deltas)."""
        s0, c0 = _hist_sums(ttft_hist).get(tag, 0.0), _hist_counts(ttft_hist).get(tag, 0)
        out = fn()
        cnt = _hist_counts(ttft_hist).get(tag, 0) - c0
        return out, (_hist_sums(ttft_hist).get(tag, 0.0) - s0) / max(cnt, 1), cnt

    def shipment_of(backend, prompt):
        """The registered shipment of a prompt's full chain."""
        fps = block_fingerprints(prompt, bs)
        got = backend.resolve("llama2-7b", fps[::-1])
        check(got is not None and got["fp"] == fps[-1], "a prompt's shipment is not registered")
        return KVShipment.from_blob(got["blob"])

    def components(backend, dec, prompts, codec):
        """Each step of a handoff on its own, median over the wave's
        prompts: decode and fetch (host -> card, int8 dequantized on the
        card), build_row and adopt (on the card), extract (card) and encode
        (int8 on the card, then card -> pinned host); and, raw only, adopt
        from the pinned host payload (host -> card)."""
        rows = {}
        for prompt in prompts:
            ship = shipment_of(backend, prompt)
            values = [backend._store[c.object_id] for c in ship.chunks]
            t = {}
            t["decode_ms"], payload = timed(lambda: decode_payload(ship.treedef_blob, values, "cuda"))
            t["fetch_ms"], _ = timed(lambda: backend.fetch_payload(ship, ("local", 0), "cuda"))
            t["build_row_ms"], row = timed(lambda: dec.engine._kv.build_row(payload, plen))
            t["extract_ms"], ext = timed(lambda: dec.engine._kv.extract_row_payload(row, plen))
            t["encode_ms"], enc = timed(lambda: encode_payload(ext, codec))
            check(enc[2:] == (ship.logical_bytes, ship.wire_bytes), "re-encoded bytes differ")
            fresh = KVCacheManager(nblocks, bs)
            fresh.initialize_for(model_cfg, "cuda")
            t["adopt_ms"], got = timed(lambda: fresh.adopt_blocks(prompt, payload["blocks"], nblocks))
            check(got == nblocks, f"adopted {got} of {nblocks} blocks")
            if codec == "raw":
                host = decode_payload(ship.treedef_blob, values)  # the pinned chunks
                check(host["blocks"][0].is_pinned(), "the shipped chunks are not pinned")
                fresh = KVCacheManager(nblocks, bs)
                fresh.initialize_for(model_cfg, "cuda")
                t["adopt_from_host_ms"], _ = timed(
                    lambda: fresh.adopt_blocks(prompt, host["blocks"], nblocks))
            del payload, row, ext, enc, fresh
            for k, v in t.items():
                rows.setdefault(k, []).append(v)
        out = {k: statistics.median(v) for k, v in rows.items()}
        wire = shipment_of(backend, prompts[0]).wire_bytes
        out["encode_gb_per_s"] = wire / out["encode_ms"] / 1e6
        out["fetch_gb_per_s"] = wire / out["fetch_ms"] / 1e6
        if "adopt_from_host_ms" in out:
            out["adopt_from_host_gb_per_s"] = wire / out["adopt_from_host_ms"] / 1e6
        return out

    def pair(backend, codec):
        cfg = config(roles=DISAGG["roles"], kv_ship_codec=codec)
        pre = make(cfg, role="prefill", tier_backend=backend)
        dec = make(cfg, role="decode", tier_backend=backend)
        return pre, dec, _DisaggIngress(pre, dec)

    def disagg_wave(pre, dec, ingress, prompts):
        s_pre, s_dec = pre.kvcache_stats(), dec.kvcache_stats()
        calls_dec, k2 = dec.engine.forward_calls, flash_attention_fwd.launches
        (toks, walls), ttft, cnt = ttft_mean(TTFT_PEER, lambda: wave(ingress, prompts))
        a_pre, a_dec = pre.kvcache_stats(), dec.kvcache_stats()
        d_pre = {k: a_pre[k] - s_pre[k] for k in ("prefill_tokens_computed", "prefix_hit_tokens")}
        d_dec = {k: a_dec[k] - s_dec[k] for k in
                 ("prefill_tokens_computed", "prefix_hit_tokens", "adopted_blocks")}
        # the decode side computed nothing: every prompt token came shipped
        check(d_pre == {"prefill_tokens_computed": n * plen, "prefix_hit_tokens": 0},
              f"prefill side {d_pre}")
        check(d_dec == {"prefill_tokens_computed": 0, "prefix_hit_tokens": n * plen,
                        "adopted_blocks": n * nblocks}, f"decode side {d_dec}")
        check(cnt == n, f"{cnt} peer TTFT observations, want {n}")
        check(flash_attention_fwd.launches == k2, "K2 was launched in a disaggregated wave")
        return toks, walls, ttft, dec.engine.forward_calls - calls_dec

    out = {}
    # -- (a) raw -------------------------------------------------------------
    mem_0 = torch.cuda.memory_allocated()
    backend = LocalTierBackend()
    pre, dec, ingress = pair(backend, "raw")
    fused = make(config())
    warm_prompt = tokens(plen)  # warm-up: cuBLAS, the pools, pinned memory
    check(ingress(request(warm_prompt))["token_ids"] == fused(request(warm_prompt))["token_ids"],
          "the warm-up's disaggregated tokens differ from the fused ones")
    torch.cuda.synchronize()
    mem = {"three_servers_bytes": torch.cuda.memory_allocated() - mem_0,
           "kv_pool_bytes_per_server": dec.kvcache_stats()["kv_pool_bytes_total"],
           "slot_pool_bytes_per_server": sum(
               t.numel() * t.element_size() for t in (dec.engine._cache.key, dec.engine._cache.value))}
    check(mem["kv_pool_bytes_per_server"] == 2 * model_cfg.n_layers * CB["blocks"]
          * model_cfg.n_kv_heads * bs * model_cfg.head_dim * esize,
          f"kv pool bytes {mem['kv_pool_bytes_per_server']}")
    prompts_a = [tokens(plen) for _ in range(n)]
    t0 = metrics.kvtier_counters()
    toks_a, walls_a, ttft_a, dec_calls = disagg_wave(pre, dec, ingress, prompts_a)
    d_a = _delta(metrics.kvtier_counters(), t0)
    (fused_a, fwalls_a), fttft_a, fcnt = ttft_mean(TTFT_MISS, lambda: wave(fused, prompts_a))
    check(fcnt == n, f"{fcnt} miss TTFT observations on the fused server")
    for i, (got, want) in enumerate(zip(toks_a, fused_a)):
        check(got == want, f"raw disaggregated tokens of prompt {i} differ from fused: "
                           f"first at {_first_parting(got, want)}")
    logical = (nblocks * 2 * model_cfg.n_layers * model_cfg.n_kv_heads * bs * model_cfg.head_dim
               * esize)
    check(d_a == {"peer_pull": n, "transfer_logical_bytes": n * logical,
                  "transfer_wire_bytes": n * logical}, f"raw wave tier counters {d_a}")
    for p in prompts_a:
        ship = shipment_of(backend, p)
        check(ship.wire_bytes == ship.logical_bytes == logical and ship.nblocks == nblocks
              and ship.tail_len == 0 and ship.first_token is not None, f"raw shipment {ship}")
    out["raw"] = dict(
        tier=d_a, disagg_wall_ms=statistics.median(walls_a),
        fused_wall_ms=statistics.median(fwalls_a), decode_side_ttft_ms_mean=ttft_a,
        fused_ttft_ms_mean=fttft_a, decode_server_calls=dec_calls,
        **components(backend, dec, prompts_a, "raw"))
    print("serve_disagg raw", json.dumps(out["raw"]))
    free(pre, dec)
    retire_backend(backend)
    del pre, dec, ingress, backend

    # -- (b) int8, then (d) a dead holder --------------------------------------
    backend = LocalTierBackend()
    pre, dec, ingress = pair(backend, "int8")
    check(ingress(request(warm_prompt))["token_ids"] is not None, "int8 warm-up")
    prompts_b = [tokens(plen) for _ in range(n)]
    t0 = metrics.kvtier_counters()
    toks_b, walls_b, ttft_b, _ = disagg_wave(pre, dec, ingress, prompts_b)
    d_b = _delta(metrics.kvtier_counters(), t0)
    fused_b, _ = wave(fused, prompts_b)
    ship = shipment_of(backend, prompts_b[0])
    wire = ship.wire_bytes
    # a code byte an element and an f32 scale per 256 elements
    check(wire == logical // esize + logical // esize // 256 * 4,
          f"int8 wire bytes {wire} for {logical} logical")
    check(wire <= 0.51 * logical, f"int8 wire/logical {wire / logical}")
    check(d_b == {"peer_pull": n, "transfer_logical_bytes": n * logical,
                  "transfer_wire_bytes": n * wire}, f"int8 wave tier counters {d_b}")
    # the codes the card made for the shipment equal quantize_np's of the
    # same K blocks copied to the host, and so do a fresh card encode's
    kv_pre = pre.engine._kv
    bids = torch.tensor([nd.block_id for nd in kv_pre._index.match(prompts_b[0], nblocks)],
                        device="cuda")
    check(len(bids) == nblocks, "the prefill side's radix lost the prompt")
    k_blocks = kv_pre._pool_k[:, bids].transpose(0, 1).contiguous()  # (16, L, hk, bs, d)
    ref = quantize_np(k_blocks.cpu())
    q_card, s_card = quantize_torch(k_blocks)
    # the shipment's first leaf, in flatten order, is the K blocks
    shipped_k = backend._store[ship.chunks[0].object_id][0]
    check(isinstance(shipped_k, QuantizedArray) and shipped_k.shape == tuple(k_blocks.shape),
          f"the shipment's first leaf is not the int8 K blocks: {shipped_k}")
    for q, s, what in ((q_card.cpu(), s_card.cpu(), "a card encode"),
                       (shipped_k.q, shipped_k.scales, "the shipment")):
        check(torch.equal(torch.as_tensor(q), torch.from_numpy(ref.q))
              and torch.equal(torch.as_tensor(s).view(torch.int32),
                              torch.from_numpy(ref.scales).view(torch.int32)),
              f"int8 codes or scales of {what} differ from quantize_np's")
    # adopted K/V within half a scale step (plus the bf16 rounding of the
    # dequantized value) of what the prefill side shipped
    kv_dec = dec.engine._kv
    dbids = torch.tensor([nd.block_id for nd in kv_dec._index.match(prompts_b[0], nblocks)],
                         device="cuda")
    step_err = {}
    for name, pool_pre, pool_dec in (("k", kv_pre._pool_k, kv_dec._pool_k),
                                     ("v", kv_pre._pool_v, kv_dec._pool_v)):
        x = pool_pre[:, bids].transpose(0, 1).contiguous().float()
        y = pool_dec[:, dbids].transpose(0, 1).contiguous().float()
        _, scales = quantize_torch(x)
        half = (scales / 2).repeat_interleave(256)[: x.numel()].view(x.shape)
        tol = half + (x.abs() + half) * 2.0 ** -8
        step_err[name] = float(((y - x).abs() / tol).max())
        check(step_err[name] <= 1.0, f"adopted {name} off by {step_err[name]} of its bound")
    parting = [_first_parting(a, b) for a, b in zip(toks_b, fused_b)]
    out["int8"] = dict(
        tier=d_b, wire_over_logical=wire / logical, disagg_wall_ms=statistics.median(walls_b),
        decode_side_ttft_ms_mean=ttft_b, adopted_err_over_bound=step_err,
        first_token_parting_from_raw=parting,
        **components(backend, dec, prompts_b, "int8"))
    print("serve_disagg int8", json.dumps(out["int8"]))
    # (d) the prefill side dies after shipping: the handoff recomputes
    dead_prompt = tokens(plen)
    blob = pre.prefill(request(dead_prompt))
    backend.kill_holder(pre.kvtier_stats()["holder_id"])
    t0, s0 = metrics.kvtier_counters(), dec.kvcache_stats()
    got = dec.decode_shipped(request(dead_prompt), blob)
    d_d = _delta(metrics.kvtier_counters(), t0)
    computed = dec.kvcache_stats()["prefill_tokens_computed"] - s0["prefill_tokens_computed"]
    check(got["token_ids"] == fused(request(dead_prompt))["token_ids"],
          "the dead-holder request's tokens differ from fused")
    # the directed fetch fails, then admission's pull hits the stale entry
    check(d_d == {"hit": 1, "recompute": 2} and computed == plen,
          f"dead holder: tier {d_d}, computed {computed}")
    out["dead_holder"] = dict(tier=d_d, prefill_tokens_computed=computed)
    free(pre, dec, fused)
    retire_backend(backend)
    del pre, dec, ingress, fused, backend

    # -- (c) a scale-up server pulls through the registered tier ---------------
    backend = LocalTierBackend()
    warm = make(config(kv_tier=True), tier_backend=backend)
    w1, w2 = tokens(plen), tokens(plen)
    check(block_fingerprints(w1, bs)[0] != block_fingerprints(w2, bs)[0], "W1, W2 share a block")
    t0 = metrics.kvtier_counters()
    (want_w1,), warm_ttft, _ = ttft_mean(TTFT_MISS, lambda: [warm(request(w1))["token_ids"]])
    warm(request(w2))
    check(backend.stats()["entries"] == 2, f"warm registered {backend.stats()['entries']}")
    for p in (w1, w2):
        s = shipment_of(backend, p)
        check(s.nblocks == nblocks and s.first_token is not None, "a warm export")
    fresh = make(config(kv_tier=True), tier_backend=backend)
    check(not fresh.engine._kv.ready, "the scale-up server's pools exist before a request")
    s0 = fresh.kvcache_stats()
    (got_w1,), fresh_ttft, _ = ttft_mean(TTFT_PEER, lambda: [fresh(request(w1))["token_ids"]])
    s1 = fresh.kvcache_stats()
    partial = w2[:DISAGG["partial_shared"]] + tokens(plen - DISAGG["partial_shared"])
    got_partial = fresh(request(partial))["token_ids"]
    s2 = fresh.kvcache_stats()
    want_partial = warm(request(partial))["token_ids"]
    d_c = _delta(metrics.kvtier_counters(), t0)
    check(got_w1 == want_w1, "the scale-up server's W1 tokens differ from the warm server's")
    check(got_partial == want_partial, "the partial prompt's tokens differ from the warm server's")
    check((s1["prefill_tokens_computed"] - s0["prefill_tokens_computed"],
           s1["adopted_blocks"] - s0["adopted_blocks"]) == (0, nblocks),
          f"W1 on the scale-up server: {s1}")
    shared_blocks = DISAGG["partial_shared"] // bs
    check((s2["prefill_tokens_computed"] - s1["prefill_tokens_computed"],
           s2["adopted_blocks"] - s1["adopted_blocks"]) == (plen - DISAGG["partial_shared"],
                                                            shared_blocks),
          f"the partial prompt on the scale-up server: {s2}")
    # warm's two misses consult the empty tier (recompute); the scale-up's
    # two pulls hit and fetch whole 16-block entries
    check(d_c == {"hit": 2, "peer_pull": 2, "recompute": 2,
                  "transfer_logical_bytes": 2 * logical, "transfer_wire_bytes": 2 * logical},
          f"scale-up tier counters {d_c}")
    out["scale_up"] = dict(tier=d_c, warm_ttft_ms_w1=warm_ttft, fresh_ttft_ms_w1=fresh_ttft,
                           fresh_kvcache=fresh.kvcache_stats())
    print("serve_disagg scale_up", json.dumps(out["scale_up"]))
    free(warm, fresh)
    retire_backend(backend)
    del warm, fresh, backend

    # -- the phase's records ---------------------------------------------------
    calls = calls_retired[0]
    k1 = rmsnorm_fwd.launches - k1_0
    check(k1 == (2 * model_cfg.n_layers + 1) * calls,
          f"K1 launched {k1} times in {calls} model calls, want "
          f"{2 * model_cfg.n_layers + 1} each")
    check(flash_attention_fwd.launches == k2_0,
          "K2 was launched on the serve_disagg path (admission prefill is decode-mode)")
    tier = _delta(metrics.kvtier_counters(), tier_0)
    # pulls: each pair's warm-up and wave, and the scale-up server's two;
    # hits and recomputes: (d)'s one and two, (c)'s two and two
    want = {"hit": 1 + 2, "peer_pull": 2 * (n + 1) + 2, "recompute": 2 + 2,
            "transfer_logical_bytes": (2 * (n + 1) + 2) * logical,
            "transfer_wire_bytes": (n + 1) * logical + (n + 1) * wire + 2 * logical}
    check(tier == want, f"the phase's tier counters {tier}, want {want}")
    summary = metrics.kvtier_summary([metrics.local_payload()])
    rolled = {"hit": summary["hit"] - summary_0["hit"],
              "peer_pull": summary["peer_pull"] - summary_0["peer_pull"],
              "recompute": summary["recompute"] - summary_0["recompute"],
              "transfer_logical_bytes": summary["transfer_bytes"]["logical"]
              - summary_0["transfer_bytes"]["logical"],
              "transfer_wire_bytes": summary["transfer_bytes"]["wire"]
              - summary_0["transfer_bytes"]["wire"]}
    check(rolled == tier, f"kvtier_summary {rolled} against the counters {tier}")
    peer_ttft = summary["ttft_ms_by_tier"]["peer"]["count"] - summary_0[
        "ttft_ms_by_tier"].get("peer", {}).get("count", 0.0)
    check(peer_ttft == 2 * (n + 1) + 2, f"{peer_ttft} peer TTFT observations")
    shipped = len(events.get_events(events.KV_SHIPPED)) - shipped_0
    # exports: each pair's prefill side ships its warm-up and its wave, (b)'s
    # also the dead holder's prompt, which its decode side then computes and
    # exports; warm exports W1, W2 and the partial, the scale-up server the
    # partial it computed
    check(shipped == sum(registers) == (n + 1) + (n + 3) + 4,
          f"{shipped} KV_SHIPPED events, {sum(registers)} registrations")
    out.update(memory=mem, model_calls=calls, rmsnorm_launches=k1, kv_shipped_events=shipped,
               kvtier_summary={k: summary[k] for k in ("hit", "peer_pull", "recompute",
                                                       "transfer_bytes", "ttft_ms_by_tier")})
    print("kvtier", json.dumps(dict(counters=tier, summary=out["kvtier_summary"])))
    print("serve_disagg", json.dumps({k: v for k, v in out.items() if k != "kvtier_summary"}))
    return out


# -- tensor-parallel serving (``serve_tp``) ----------------------------------

#: two gloo ranks sharing card 0, the serve_cb server's settings (8 slots, 256
#: blocks of 32, max_seq_len 1024); (a) 8 greedy requests of a shared
#: 128-token prefix and 32 own tokens, 8 new tokens each, from 4 threads;
#: (b) parity at 2 layers of 7B width in f32 activations, 24 new tokens
TP = {"ranks": 2, "requests": 8, "threads": 4, "prefix": 128, "own": 32, "new_tokens": 8,
      "timed_steps": 8, "parity_layers": 2, "parity_new": 24, "parity_blocks": 64}


def tp_counts(engine):
    """On every rank of a tensor-parallel server: its own kernel launch
    counts and model calls."""
    counts = {name: fn.launches for name, fn in _port_counters().items()}
    counts["forward_calls"] = engine.forward_calls
    return counts


def tp_shard_sums(engine):
    """On every rank: the f64 sum of each of its parameter slices."""
    return {name: t.contiguous().double().sum().item() for name, t in engine._params.items()}


def tp_prefill_logits(engine, prompt):
    """On every rank: the prefill's last-position logits, on the host."""
    import torch

    logits, _ = engine._prefill(torch.tensor([prompt], device=engine._device))
    return logits.float().cpu()


def tp_spec_tokens(engine, prompts, new_tokens, blocks, block):
    """On every rank: a speculative engine over this rank's slices and plan
    with the target as its own draft (k=4); greedy tokens and counts."""
    from ray_tpu_torch.kvcache import KVCacheManager
    from ray_tpu_torch.llm import ContinuousBatchingEngine, GenerationRequest

    eng = ContinuousBatchingEngine(
        engine._cfg, engine._params, num_slots=8, kv_cache=KVCacheManager(blocks, block),
        seed=0, draft=(engine._cfg, engine._params), spec_tokens=4, device=engine._device,
        plan=engine._plan)
    out = eng.generate([GenerationRequest(token_ids=p, max_new_tokens=new_tokens)
                        for p in prompts])
    return [r.token_ids for r in out], eng.spec_proposed, eng.spec_accepted


def _no_tp_left(torch):
    """(c): nothing of a closed tensor-parallel server may live on: no child
    process, no process group."""
    import multiprocessing

    import torch.distributed as dist

    for p in multiprocessing.active_children():
        p.join(30)
    check(not multiprocessing.active_children(),
          f"child processes left: {multiprocessing.active_children()}")
    check(not dist.is_initialized(), "a process group is left")


def _collective_ms(summary):
    return {op: v["count"] * v["mean_ms"] for op, v in summary.items()}


def tp_traffic(np):
    """(a)'s traffic: a token maker and the shared prefix from one seed,
    and the 8 prompts (prefix + 32 own tokens)."""
    rng = np.random.default_rng(SEED + 15)

    def tokens(n):
        return rng.integers(0, 32000, n).tolist()

    prefix = tokens(TP["prefix"])
    return tokens, prefix, [prefix + tokens(TP["own"]) for _ in range(TP["requests"])]


def tp_config(torch, **kw):
    """The serve_cb server's config (8 slots, 256 blocks of 32, max_seq_len
    1024) at full Llama-2-7B width in bf16, with ``kw``."""
    from ray_tpu_torch.llm import LLMConfig

    return LLMConfig(model_id="llama2-7b", max_seq_len=CB["max_seq_len"],
                     max_batch_size=CB["slots"], kv_cache_blocks=CB["blocks"],
                     kv_block_size=CB["block"], model_kwargs=serve_model_kwargs(torch),
                     **kw)


def tp_serve(torch, server, traffic, profile_groups=None):
    """(a)'s traffic through a paged server of any tp: a warm-up request, the
    8 prompts from 4 threads (greedy tokens, wall, prefix accounting), a
    stream of the first prompt again, 8 timed pooled steps with every slot
    active (and, with ``profile_groups``, one profiled), and TTFT of a miss
    and of a hit; collective ms of this process around the timed steps."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.llm import GenerationRequest
    from ray_tpu_torch.util import metrics

    tokens, prefix, prompts = traffic
    engine, n = server.engine, TP["requests"]
    request = {"max_new_tokens": TP["new_tokens"], "temperature": 0.0}
    server({"token_ids": tokens(TP["prefix"] + TP["own"]), "max_new_tokens": 2})  # warm-up
    before = server.kvcache_stats()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(TP["threads"]) as pool:
        answers = list(pool.map(lambda p: server(dict(request, token_ids=p)), prompts))
    wall = time.perf_counter() - t0
    after = server.kvcache_stats()
    got = [a["token_ids"] for a in answers]
    hit = after["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    computed = after["prefill_tokens_computed"] - before["prefill_tokens_computed"]
    check(hit == (n - 1) * TP["prefix"], f"prefix hit tokens {hit}")
    check(computed == TP["prefix"] + n * TP["own"], f"prefill tokens computed {computed}")
    streamed = [item["token_id"] for item in server.stream(dict(request, token_ids=prompts[0]))
                if "token_id" in item]
    check(len(streamed) == TP["new_tokens"] and all(0 <= t < 32000 for t in streamed),
          f"bad stream {streamed}")

    # the pooled decode step with every slot active, and the collectives'
    # share of it (each waits for the other ranks too)
    rids = [engine.add_request(GenerationRequest(token_ids=prefix + tokens(TP["own"]),
                                                 max_new_tokens=32))
            for _ in range(CB["slots"])]
    _step_until(engine, lambda: len(engine._slots) == CB["slots"] and not engine._pending
                and not engine._inbox)
    col0 = _collective_ms(metrics.collective_summary())
    step_ms = []
    for _ in range(TP["timed_steps"]):
        t0 = time.perf_counter()
        engine.step()  # ends in the host transfer of the sampled tokens
        step_ms.append((time.perf_counter() - t0) * 1e3)
    col1 = _collective_ms(metrics.collective_summary())
    prof = device_profile(torch, engine.step, profile_groups) if profile_groups else None
    check(len(engine._slots) == CB["slots"], "a slot left the timed steps")
    done = engine.run_until_complete()
    check(set(done) == set(rids), "the timed requests did not all finish")

    def ttft(prompt):
        t0 = time.perf_counter()
        items = server.stream({"token_ids": prompt, "max_new_tokens": 2})
        next(items)
        ms = (time.perf_counter() - t0) * 1e3
        list(items)
        return ms

    miss = tokens(TP["prefix"] + TP["own"])
    coll = {op: (ms - col0.get(op, 0.0)) / TP["timed_steps"] for op, ms in col1.items()}
    return dict(
        tokens=got, wall_s=wall, tokens_per_s=n * TP["new_tokens"] / wall,
        prefix_hit_tokens=hit, prefill_tokens_computed=computed,
        stream_parting_vs_answer=_first_parting(streamed, got[0]),
        decode_ms_per_step_8_slots=statistics.median(step_ms), decode_ms_per_step_all=step_ms,
        collective_ms_per_step={op: ms for op, ms in coll.items() if ms},
        allreduce_share_of_step=coll.get("allreduce", 0.0) * TP["timed_steps"] / sum(step_ms),
        ttft_ms_miss=ttft(miss), ttft_ms_hit=ttft(miss[:TP["prefix"]] + tokens(TP["own"])),
        profile=prof, kvcache=after,
    )


def serve_tp_phase(torch, np, params, counters):
    """Tensor-parallel serving at full Llama-2-7B width with two gloo ranks
    sharing card 0 (this process is rank 0; NCCL refuses two ranks on one
    card): (a) (a)'s traffic on phase 5's weights, sliced by the plan and
    sent to rank 1, against a tp=1 paged server on the same weights; (b)
    2-layer f32 parity, dense and paged, of tp=2 against tp=1 and an f64
    host run; (c) no process or process group left. The tp=1 comparisons
    run off the path: before it (a)'s tp=1 server and (b)'s tp=1 engine
    and host runs, after it (b)'s partings. This process's counts are set
    to 0 just before the first tp=2 server starts and read just after the
    last one closes; the spawned ranks' own counts, read before each
    closes, are added. Returns (the phase's summary, the path's launches)."""
    from ray_tpu_torch.llm import LLMServer

    ref = LLMServer(tp_config(torch), params=params)
    want = tp_serve(torch, ref, tp_traffic(np))
    del ref
    torch.cuda.empty_cache()
    parity_ref = tp_parity_reference(torch, np, params)

    for fn in counters.values():
        fn.launches = 0
    # (a) the tp=2 server: rank 0 keeps views of its slices, rank 1 gets its
    # own through the group
    t0 = time.perf_counter()
    server = LLMServer(tp_config(torch, tensor_parallel_size=TP["ranks"]), params=params,
                       devices=[0] * TP["ranks"], tp_backend="gloo")
    start_s = time.perf_counter() - t0
    ranks = server.ranks
    for rank, got in enumerate(ranks.run(tp_shard_sums)):
        for name, value in got.items():
            want_sum = ranks.plan.shard_param(name, params[name], rank)
            check(value == want_sum.contiguous().double().sum().item(),
                  f"rank {rank}'s slice of {name} is not the plan's")
    counts0 = ranks.run(tp_counts)
    got = tp_serve(torch, server, tp_traffic(np))
    counts1 = ranks.run(tp_counts)
    stats = got["kvcache"]
    check(stats["heads_per_device"] == 16, f"heads per device {stats['heads_per_device']}")
    check(stats["kv_pool_bytes_per_device"] * 2 == stats["kv_pool_bytes_total"],
          f"pool bytes {stats['kv_pool_bytes_per_device']} of {stats['kv_pool_bytes_total']}")
    check(stats["mesh"] == "tp=2" and stats["num_devices"] == 2, f"mesh {stats['mesh']}")
    per_call = 2 * SERVE_LAYERS + 1
    launches = []
    for rank, (c0, c1) in enumerate(zip(counts0, counts1)):
        d = {k: c1[k] - c0[k] for k in c0}
        check(d["forward_calls"] > 0 and d["rmsnorm_fwd"] == per_call * d["forward_calls"],
              f"rank {rank}: K1 launched {d['rmsnorm_fwd']} times in {d['forward_calls']} "
              f"model calls, want {per_call} each")
        for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(d[name] == 0, f"rank {rank} launched {name} on the serve_tp path")
        launches.append(d)
    check(launches[0]["forward_calls"] == launches[1]["forward_calls"],
          "the ranks made different numbers of model calls")
    check(ranks.failed is None, f"the agreement check fired: {ranks.failed}")
    rank1 = counts1[1]
    server.close()
    del server, ranks
    torch.cuda.empty_cache()
    _no_tp_left(torch)
    out = dict(ranks=TP["ranks"], backend="gloo", card=0, start_s=start_s,
               requests=TP["requests"], threads=TP["threads"],
               prompt_tokens=TP["prefix"] + TP["own"], new_tokens=TP["new_tokens"],
               launches_per_rank=launches,
               first_parting_vs_tp1=[_first_parting(a, b)
                                     for a, b in zip(got.pop("tokens"), want.pop("tokens"))],
               tp2=got, tp1=want)
    for run in (got, want):
        run["kvcache"] = {k: run["kvcache"][k] for k in (
            "mesh", "num_devices", "heads_per_device", "kv_pool_bytes_per_device",
            "kv_pool_bytes_total")}
    print("serve_tp", json.dumps(out))
    # (b) the tp=2 servers of the parity check
    parity_tokens, parity_rank1 = tp_parity(torch, parity_ref)
    _no_tp_left(torch)
    path = {k: fn.launches + rank1[k] + parity_rank1[k] for k, fn in counters.items()}
    out["parity"] = tp_partings(torch, parity_ref, parity_tokens)
    print("serve_tp parity", json.dumps(out["parity"]))
    return out, path


def tp_parity_reference(torch, np, params):
    """(b)'s comparisons, off the path: the first 2 layers of the 7B
    weights with f32 activations, tp=1 on the card (greedy tokens and
    prefill logits of 4 prompts) and f32 / f64 host runs of the first
    prompt's prefill, whose difference bounds the f32 error."""
    from ray_tpu_torch.llm import GenerationRequest, LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig

    L = TP["parity_layers"]
    cfg = LlamaConfig.llama2_7b(n_layers=L, max_seq_len=512, dtype=torch.float32,
                                param_dtype=torch.bfloat16)
    keep = {f"layer_{i}" for i in range(L)}
    params2 = {k: v for k, v in params.items()
               if not k.startswith("layer_") or k.split(".")[0] in keep}
    rng = np.random.default_rng(SEED + 16)
    shared = rng.integers(0, cfg.vocab_size, 96).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, n).tolist() for n in (0, 9, 40)]
    prompts.append(rng.integers(0, cfg.vocab_size, 20).tolist())
    new = TP["parity_new"]
    tp1 = LLMEngine(cfg, params2, max_batch_size=8, seed=0)
    want = [r.token_ids for r in tp1.generate(
        [GenerationRequest(token_ids=p, max_new_tokens=new) for p in prompts])]
    tp1_logits = tp1._prefill(torch.tensor([prompts[0]], device="cuda"))[0].float().cpu()
    host = {}
    for dtype in (torch.float32, torch.float64):
        hcfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        hp = {k: v.to("cpu", dtype) for k, v in params2.items()}
        eng = LLMEngine(hcfg, hp, max_batch_size=1, seed=0, device="cpu")
        host[dtype] = eng._prefill(torch.tensor([prompts[0]]))[0].double()
        del eng, hp
    control = _rel_err(host[torch.float32], host[torch.float64])
    return dict(L=L, params=params2, prompts=prompts, new=new, tp1=tp1, want=want,
                tp1_logits=tp1_logits, f64=host[torch.float64], control=control,
                gap_tol=4 * control * host[torch.float64].abs().max().item())


def tp_parity(torch, ref):
    """(b)'s tp=2 runs, on the path: a dense and a paged tp=2 server over
    the 2-layer weights. Prefill logits equal on both ranks and within 4x
    the f32 host run's own error against f64 (``_control_check``);
    speculation with the target as its own draft on every rank accepts
    every proposal. Returns (the greedy tokens of the dense, paged and
    speculative runs, and the logits' check; rank 1's own kernel counts)."""
    from ray_tpu_torch.llm import LLMConfig, LLMServer

    prompts, new = ref["prompts"], ref["new"]

    def server(**kw):
        return LLMServer(LLMConfig(
            model_id="llama2-7b", max_seq_len=512, max_batch_size=8, seed=0,
            tensor_parallel_size=TP["ranks"],
            model_kwargs={"n_layers": ref["L"], "dtype": torch.float32,
                          "param_dtype": torch.bfloat16},
            **kw), params=ref["params"], devices=[0] * TP["ranks"], tp_backend="gloo")

    out, rank1 = {}, []
    dense = server()
    logits = dense.ranks.run(tp_prefill_logits, prompts[0])
    check(all(torch.equal(l, logits[0]) for l in logits), "the ranks' logits differ")
    errs = {"tp2_card": _rel_err(logits[0], ref["f64"]),
            "tp1_card": _rel_err(ref["tp1_logits"], ref["f64"])}
    out["logits"] = _control_check("serve_tp parity logits", errs, ref["control"])
    out["logits"].update(errs)
    out["dense"] = [dense({"token_ids": p, "max_new_tokens": new})["token_ids"] for p in prompts]
    check(dense.ranks.failed is None, f"the agreement check fired: {dense.ranks.failed}")
    rank1.append(dense.ranks.run(tp_counts)[1])
    dense.close()
    del dense
    _no_tp_left(torch)

    paged = server(kv_cache_blocks=TP["parity_blocks"], kv_block_size=CB["block"])
    out["paged"] = [paged({"token_ids": p, "max_new_tokens": new})["token_ids"]
                    for p in prompts]
    spec = paged.ranks.run(tp_spec_tokens, prompts, new, TP["parity_blocks"], CB["block"])
    check(all(s[0] == spec[0][0] for s in spec), "the ranks' speculative tokens differ")
    out["spec"], proposed, accepted = spec[0]
    check(proposed > 0 and accepted == proposed,
          f"speculation with the target as its draft accepted {accepted} of {proposed}")
    out.update(spec_proposed=proposed, spec_accepted=accepted,
               paged_kvcache=paged.kvcache_stats())
    check(paged.ranks.failed is None, f"the agreement check fired: {paged.ranks.failed}")
    rank1.append(paged.ranks.run(tp_counts)[1])
    paged.close()
    del paged
    return out, {k: sum(c[k] for c in rank1) for k in rank1[0]}


def tp_partings(torch, ref, got):
    """(b)'s tokens against tp=1's, off the path: greedy tokens over 24 new
    tokens equal to tp=1's, except at a step where tp=1's top-2 logit gap
    is under 4x the f32 host error bound (printed, not failed)."""
    tp1, gap_tol = ref["tp1"], ref["gap_tol"]

    def near_ties(tokens):
        """Each prompt's first parting from tp=1 with tp=1's top-2 logit gap
        there; a gap at or over the bound fails."""
        out = []
        for p, a, b in zip(ref["prompts"], tokens, ref["want"]):
            j = _first_parting(a, b)
            if j is None:
                out.append(None)
                continue
            logits = tp1._prefill(torch.tensor([p + b[:j]], device="cuda"))[0].float()
            top2 = logits.topk(2).values
            gap = (top2[0] - top2[1]).item()
            check(gap < gap_tol, f"tp=2 parts from tp=1 at step {j} where tp=1's top-2 gap "
                                 f"{gap} is not under {gap_tol}")
            out.append(dict(step=j, top2_gap=gap))
        return out

    out = {k: v for k, v in got.items() if k not in ("dense", "paged", "spec")}
    for kind in ("dense", "paged", "spec"):
        out[f"{kind}_partings"] = near_ties(got[kind])
    out["gap_tol"] = gap_tol
    del ref["tp1"]
    torch.cuda.empty_cache()
    return out


# -- the serving features under tensor parallelism (``serve_tp_features``) ----

#: (d) serve_lora's traffic and pooled step through a tp=2 server with
#: adapters; (e) serve_disagg's waves of 8 distinct 512-token prompts through
#: _DisaggIngress across layouts, tp=2 -> tp=1 and tp=1 -> tp=2, raw and int8
# (d)'s requests answer 8 new tokens (serve_lora's 32) and (e)'s waves send 2
# prompts of 8 new tokens a direction and codec (serve_disagg: 8 of 32): cuts
# that make room for train_mesh in the time limit
TPF = {"timed_steps": 16, "directions": ("tp2_to_tp1", "tp1_to_tp2"),
       "codecs": ("raw", "int8"), "timed_handoffs": 2, "prompts": 2, "new_tokens": 8}


def _digest(t):
    """SHA-256 of a tensor's bytes: equal digests, equal tensors."""
    import hashlib

    import torch

    return hashlib.sha256(t.contiguous().cpu().view(-1).view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def tp_bank_digests(engine):
    """On every rank: the digest of each tensor of its adapter bank."""
    return {f"{proj}.{factor}": _digest(t)
            for proj, pair in engine._adapter_store.bank().items() for factor, t in pair.items()}


def _bank_slice_digests(plan, bank, rank):
    """The digests ``tp_bank_digests`` must give on ``rank``: the plan's
    slices of a tp=1 bank, its (layer, slot) axes taken as one replicated
    axis of a row (``PartitionPlan.lora_row_shards``)."""
    n, rows = bank["wq"]["lora_a"].shape[:2]
    merged = {proj: (pair["lora_a"].flatten(0, 1), pair["lora_b"].flatten(0, 1))
              for proj, pair in bank.items()}
    return {f"{proj}.{factor}": _digest(t.unflatten(0, (n, rows)))
            for proj, pair in plan.lora_row_shards(merged, rank).items()
            for factor, t in zip(("lora_a", "lora_b"), pair)}


def tp_set_adapter_slots(engine, slots):
    """On every rank: the adapter slot of each occupied row of the pool."""
    for si, slot in engine._slots.items():
        slot.request.adapter_slot = int(slots[si])


def tp_handoff_extract(engine, plen):
    """On every rank of a replica, or on a tp=1 engine: a row's first
    ``plen`` tokens of K/V extracted as a shipment payload and, under tensor
    parallelism, gathered to rank 0 through the group; card ms."""
    import torch

    from ray_tpu_torch.models.llama import new_cache

    row, kv = new_cache(engine._cfg, 1, engine._device, engine._plan), engine._kv
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv.gather_payload(kv.extract_row_payload(row, plen))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def tp_handoff_adopt(engine, blob, prompt):
    """On every rank of a replica, or on a tp=1 engine: a shipment's
    payload (rank 0 fetches it from the tier, untimed) scattered over the
    ranks' heads through the group and adopted into a fresh pool; (card ms,
    blocks adopted)."""
    import torch

    from ray_tpu_torch.kvcache import KVCacheManager
    from ray_tpu_torch.kvtier import KVShipment

    plan, bs = engine._plan, engine._kv.block_size
    nblocks, full = len(prompt) // bs, None
    if engine._tier is not None:
        ship, backend = KVShipment.from_blob(blob), engine._tier.backend
        full = backend.fetch_payload(ship, backend.holder_of(ship), engine._device)
    fresh = KVCacheManager(nblocks, bs, plan=plan)
    fresh.initialize_for(engine._cfg, engine._device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = fresh.scatter_payload(full, nblocks, len(prompt))
    got = fresh.adopt_blocks(prompt, payload["blocks"], nblocks)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, got


def _on_ranks(server, fn, *args):
    """``fn(engine, *args)`` on every rank of ``server``; rank 0's result."""
    if server.ranks is None:
        return fn(server.engine, *args)
    return server.ranks.run(fn, *args)[0]


def tp_lora_reference(torch, np):
    """(d)'s comparisons, off the path: the 4 tenants' adapters
    (serve_lora's seeds) and the digests each rank's bank must hold, the
    plan's slices of a tp=1 store's bank."""
    from ray_tpu_torch.lora import AdapterStore
    from ray_tpu_torch.parallel.plan import PartitionPlan

    cfg = tp_config(torch).build_model_config()
    trees = {f"tenant_{i}": lora_tree(np, cfg, SEED + 10 + i - 1)
             for i in range(1, LORA["tenants"] + 1)}
    store = AdapterStore(cfg, max_live=LORA["max_live"], rank=LORA["rank"], alpha=LORA["alpha"])
    for t, tree in trees.items():
        store.prewarm(t, tree)
    plan = PartitionPlan.for_model(cfg, TP["ranks"], devices=[0] * TP["ranks"], backend="gloo")
    return dict(trees=trees,
                digests=[_bank_slice_digests(plan, store.bank(), r) for r in range(TP["ranks"])])


def tp_disagg_reference(torch, np, params):
    """(e)'s comparisons, off the path: the prompts, a fused tp=1 server's
    greedy tokens for the raw waves, and the K/V of the first raw
    tp2_to_tp1 prompt from a tp=1 prefill with bf16 and with f32
    activations."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.kvcache import KVCacheManager
    from ray_tpu_torch.llm import LLMEngine, LLMServer

    cfg = tp_config(torch).build_model_config()
    rng = np.random.default_rng(SEED + 18)
    n, plen, new = TPF["prompts"], DISAGG["prompt_len"], TPF["new_tokens"]

    def prompt():
        return rng.integers(0, cfg.vocab_size, plen).tolist()

    prompts = {(codec, d): [prompt() for _ in range(n)]
               for codec in TPF["codecs"] for d in TPF["directions"]}
    warm = {key: prompt() for key in prompts}
    fused = LLMServer(tp_config(torch), params=params)
    with ThreadPoolExecutor(n) as pool:
        want = {d: list(pool.map(lambda p: fused({"token_ids": p, "max_new_tokens": new})[
            "token_ids"], prompts["raw", d])) for d in TPF["directions"]}
    p0 = prompts["raw", TPF["directions"][0]][0]
    kv = {}
    for dtype in (torch.bfloat16, torch.float32):
        eng = (fused.engine if dtype is torch.bfloat16 else
               LLMEngine(dataclasses.replace(cfg, dtype=dtype), params, max_batch_size=1, seed=0))
        _, row = eng._prefill(torch.tensor([p0], device="cuda"))
        kv[dtype] = KVCacheManager(plen // CB["block"], CB["block"]).extract_row_payload(
            row, plen)["blocks"]
        del eng, row
    del fused
    torch.cuda.empty_cache()
    return dict(prompts=prompts, warm=warm, want=want, kv_bf16=kv[torch.bfloat16],
                kv_f32=kv[torch.float32])


def _tp_seeded_check(server, params):
    """Each rank of a tp=2 server without given weights drew its slices of
    the seed-0 weights (the servers' ``PARAMS_SEED``, as ``params`` were
    drawn): the f64 sum of every slice equals that of the plan's slice of
    ``params``."""
    ranks = server.ranks
    for rank, got in enumerate(ranks.run(tp_shard_sums)):
        for name, value in got.items():
            want = ranks.plan.shard_param(name, params[name], rank)
            check(value == want.contiguous().double().sum().item(),
                  f"rank {rank}'s seeded slice of {name} is not the plan's slice")


def tp_lora(torch, np, params, ref, lora_out, devices=(0, 0), backend="gloo"):
    """(d), on the path: serve_lora's traffic through a tp=2 server with an
    adapter store of 8 slots (rank 16), its ranks on ``devices`` over
    ``backend`` (here gloo ranks sharing card 0; chip_multicard.py runs it
    over NCCL on two cards), each drawing its slices of the seed-0 weights
    (``params``). Returns (the summary, rank 1's own kernel counts)."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.llm import AdapterConfig, GenerationRequest, LLMServer

    adapters = AdapterConfig(max_live=LORA["max_live"], slot_rank=LORA["rank"], alpha=LORA["alpha"])
    t0 = time.perf_counter()
    server = LLMServer(tp_config(torch, tensor_parallel_size=TP["ranks"], adapters=adapters),
                       devices=list(devices), tp_backend=backend)
    start_s = time.perf_counter() - t0
    ranks, engine, store = server.ranks, server.engine, server.adapter_store
    _tp_seeded_check(server, params)
    counts0 = ranks.run(tp_counts)
    tenants = list(ref["trees"])
    attach_ms, load_ms = {}, {}
    for t in tenants:  # cold attaches: each rank's slices sent through the store
        t0 = time.perf_counter()
        store._normalize(ref["trees"][t])  # the host's share: the tree as bank rows
        load_ms[t] = (time.perf_counter() - t0) * 1e3
        store.prewarm(t, ref["trees"][t])
        attach_ms[t] = store.stats()["last_attach_ms"]
    for rank, got in enumerate(ranks.run(tp_bank_digests)):
        check(got == ref["digests"][rank],
              f"rank {rank}'s adapter bank is not the plan's slice of a tp=1 store's bank")

    def tenant(i):  # request i names tenant i % 5; 0 is the base model
        return None if i % (len(tenants) + 1) == 0 else tenants[i % (len(tenants) + 1) - 1]

    rng = np.random.default_rng(SEED + 17)

    def tokens(n):
        return rng.integers(0, 32000, n).tolist()

    for aid in (tenants[0], None):  # warm-up, each on a prefix of its own
        server({"token_ids": tokens(CB_PREFIX + CB_OWN), "max_new_tokens": 2, "adapter_id": aid})
    prefix = tokens(CB_PREFIX)
    prompts = [prefix + tokens(CB_OWN) for _ in range(CB_REQUESTS)]
    before = server.kvcache_stats()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(CB["slots"]) as pool:
        answers = list(pool.map(lambda i: server({
            "token_ids": prompts[i], "max_new_tokens": TPF["new_tokens"], "temperature": 0.0,
            "adapter_id": tenant(i)}), range(CB_REQUESTS)))
    wall = time.perf_counter() - t0
    for a in answers:
        check(len(a["token_ids"]) == TPF["new_tokens"]
              and all(0 <= t < 32000 for t in a["token_ids"]), f"bad tp=2 LoRA answer {a}")
    after = server.kvcache_stats()
    hit = after["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    computed = after["prefill_tokens_computed"] - before["prefill_tokens_computed"]
    check((hit, computed) == (lora_out["prefix_hit_tokens"], lora_out["prefill_tokens_computed"])
          == (2816, 2304), f"salted prefix accounting at tp=2 {hit} / {computed}, at tp=1 "
                           f"{lora_out['prefix_hit_tokens']} / {lora_out['prefill_tokens_computed']}")
    check(store.stats()["slots_pinned"] == 0, f"adapter pins left: {store.stats()}")

    # the pooled step, 8 rows (base, 4 tenants, base, 2 tenants), timed with
    # mixed slots and with every slot at -1 in turns; each rank's rows are
    # set through the lockstep, so every rank runs the same slots
    leases = [store.acquire(tenant(i)) if tenant(i) else None for i in range(CB["slots"])]
    for i, lease in enumerate(leases):
        engine.add_request(GenerationRequest(
            token_ids=tokens(CB_OWN), max_new_tokens=32, adapter_id=tenant(i),
            adapter_slot=lease.slot if lease else -1))
    _step_until(engine, lambda: len(engine._slots) == CB["slots"] and not engine._pending
                and not engine._inbox)
    mixed = engine._row_adapter_slots().tolist()
    step_ms = {"mixed": [], "base": []}
    for i in range(TPF["timed_steps"]):
        kind = "mixed" if i % 2 == 0 else "base"
        ranks.run(tp_set_adapter_slots, mixed if kind == "mixed" else [-1] * CB["slots"])
        t0 = time.perf_counter()
        engine.step()  # ends in the host transfer of the sampled tokens
        step_ms[kind].append((time.perf_counter() - t0) * 1e3)
    check(len(engine._slots) == CB["slots"], "a slot left the timed tp=2 LoRA steps")
    ranks.run(tp_set_adapter_slots, mixed)
    engine.run_until_complete()
    for lease in leases:
        store.release(lease)
    counts1 = ranks.run(tp_counts)
    launches = _tp_launch_check("(d)", counts0, counts1)
    check(ranks.failed is None, f"the agreement check fired: {ranks.failed}")
    stats = server.adapters_stats()
    server.close()
    del server, ranks, engine, store
    torch.cuda.empty_cache()
    _no_tp_left(torch)
    return dict(start_s=start_s, cold_attach_ms=attach_ms, of_which_load_ms=load_ms,
                requests=CB_REQUESTS,
                threads=CB["slots"], new_tokens=TPF["new_tokens"], wall_s=wall,
                tokens_per_s=CB_REQUESTS * TPF["new_tokens"] / wall,
                tokens_per_s_tp1=lora_out["tokens_per_s"], prefix_hit_tokens=hit,
                prefill_tokens_computed=computed,
                step_ms_mixed=statistics.median(step_ms["mixed"]),
                step_ms_base=statistics.median(step_ms["base"]),
                step_ms_tp1_mixed=lora_out["step_ms_mixed"],
                step_ms_tp1_base=lora_out["step_ms_base"], step_ms_all=step_ms,
                adapter_stats=stats, launches_per_rank=launches), counts1[1]


def _tp_launch_check(tag, counts0, counts1, extra_calls=0):
    """K1 2L + 1 times a model call on each rank and K2-K4 never, between two
    ``tp_counts`` readings; rank 0's process also ran ``extra_calls`` model
    calls of a tp=1 server. Returns each rank's deltas."""
    per_call, launches = 2 * SERVE_LAYERS + 1, []
    for rank, (c0, c1) in enumerate(zip(counts0, counts1)):
        d = {k: c1[k] - c0[k] for k in c0}
        calls = d["forward_calls"] + (extra_calls if rank == 0 else 0)
        check(d["forward_calls"] > 0 and d["rmsnorm_fwd"] == per_call * calls,
              f"{tag} rank {rank}: K1 launched {d['rmsnorm_fwd']} times in {calls} model "
              f"calls, want {per_call} each")
        for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(d[name] == 0, f"{tag} rank {rank} launched {name}")
        launches.append(d)
    check(launches[0]["forward_calls"] == launches[1]["forward_calls"],
          f"{tag}: the ranks made different numbers of model calls")
    return launches


def tp_disagg(torch, np, params, ref, codec):
    """(e) for one codec, on the path: a tp=2 and a tp=1 server on one
    tier, both on the KV tier (kv_tier=True: each serves prefill() and
    decode_shipped()), behind _DisaggIngress both ways, TPF["prompts"]
    prompts from as many threads a direction. Returns (the summary, rank 1's own kernel counts,
    the raw tp2_to_tp1 shipment's K/V blocks of its first prompt)."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.kvtier import (
        KVShipment, LocalTierBackend, block_fingerprints, encode_payload)
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.llm.serving import _DisaggIngress

    n, plen, new, bs = (TPF["prompts"], DISAGG["prompt_len"], TPF["new_tokens"],
                        CB["block"])
    nblocks = plen // bs
    # the full-head K/V of a prompt: every shipment carries all 32 KV heads
    logical = nblocks * 2 * SERVE_LAYERS * 32 * bs * 128 * 2
    backend = LocalTierBackend()
    kw = dict(kv_tier=True, kv_ship_codec=codec, max_new_tokens=new)
    t0 = time.perf_counter()
    tp2 = LLMServer(tp_config(torch, tensor_parallel_size=TP["ranks"], **kw),
                    devices=[0] * TP["ranks"], tp_backend="gloo", tier_backend=backend)
    start_s = time.perf_counter() - t0
    _tp_seeded_check(tp2, params)
    tp1 = LLMServer(tp_config(torch, **kw), params=params, tier_backend=backend)
    counts0, calls0 = tp2.ranks.run(tp_counts), tp1.engine.forward_calls

    def shipment(prompt):
        fps = block_fingerprints(prompt, bs)
        got = backend.resolve("llama2-7b", fps[::-1])
        check(got is not None and got["fp"] == fps[-1], "a prompt's shipment is not registered")
        return KVShipment.from_blob(got["blob"])

    out, kv_blocks = {}, None
    for d, (pre, dec) in zip(TPF["directions"], ((tp2, tp1), (tp1, tp2))):
        ingress = _DisaggIngress(pre, dec)
        # warm-up: a handoff and two decode steps
        ingress({"token_ids": ref["warm"][codec, d], "max_new_tokens": 2})
        prompts = ref["prompts"][codec, d]
        s_pre, s_dec = pre.kvcache_stats(), dec.kvcache_stats()

        def one(p):
            t = time.perf_counter()
            a = ingress({"token_ids": p, "max_new_tokens": new, "temperature": 0.0})
            return a, (time.perf_counter() - t) * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(n) as pool:
            res = list(pool.map(one, prompts))
        wall = time.perf_counter() - t0
        toks = [a["token_ids"] for a, _ in res]
        check(all(len(t) == new for t in toks), f"(e) {codec} {d}: bad answers")
        a_pre, a_dec = pre.kvcache_stats(), dec.kvcache_stats()
        d_pre = a_pre["prefill_tokens_computed"] - s_pre["prefill_tokens_computed"]
        d_dec = {k: a_dec[k] - s_dec[k] for k in ("prefill_tokens_computed", "adopted_blocks")}
        check(d_pre == n * plen, f"(e) {codec} {d}: the prefill side computed {d_pre}")
        check(d_dec == {"prefill_tokens_computed": 0, "adopted_blocks": n * nblocks},
              f"(e) {codec} {d}: decode side {d_dec}")
        ships = [shipment(p) for p in prompts]
        for s in ships:
            check(s.logical_bytes == logical and s.nblocks == nblocks and s.tail_len == 0
                  and s.first_token is not None, f"(e) {codec} {d}: shipment {s} is not "
                                                 f"all 32 KV heads of 16 blocks")
            if codec == "int8":
                check(s.wire_bytes <= 0.51 * s.logical_bytes,
                      f"(e) int8 wire/logical {s.wire_bytes / s.logical_bytes}")
        if codec == "raw" and d == TPF["directions"][0]:
            full = backend.fetch_payload(ships[0], ("local", 0), "cuda")
            check(full["blocks"][0].shape[2] == 32, "the tp=2 shipment lacks KV heads")
            kv_blocks = full["blocks"]
        comp = {"extract_ms": [], "encode_ms": [], "fetch_ms": [], "adopt_ms": []}
        for p, s in list(zip(prompts, ships))[:TPF["timed_handoffs"]]:
            comp["extract_ms"].append(_on_ranks(pre, tp_handoff_extract, plen))
            payload = backend.fetch_payload(s, ("local", 0), "cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            encode_payload(payload, codec)  # int8 coded on the card, then to the host
            comp["encode_ms"].append((time.perf_counter() - t) * 1e3)
            del payload
            torch.cuda.synchronize()
            t = time.perf_counter()
            backend.fetch_payload(s, ("local", 0), "cuda")
            torch.cuda.synchronize()
            comp["fetch_ms"].append((time.perf_counter() - t) * 1e3)
            ms, got = _on_ranks(dec, tp_handoff_adopt, s.to_blob(), p)
            check(got == nblocks, f"(e) {codec} {d}: adopted {got} of {nblocks} blocks")
            comp["adopt_ms"].append(ms)
        out[d] = dict(wall_s=wall, request_wall_ms=statistics.median(w for _, w in res),
                      wire_over_logical=ships[0].wire_bytes / ships[0].logical_bytes,
                      tokens=toks, **{k: statistics.median(v) for k, v in comp.items()})
        print(f"serve_tp_features (e) {codec} {d}",
              json.dumps({k: v for k, v in out[d].items() if k != "tokens"}))
    counts1 = tp2.ranks.run(tp_counts)
    launches = _tp_launch_check(f"(e) {codec}", counts0, counts1,
                                extra_calls=tp1.engine.forward_calls - calls0)
    check(tp2.ranks.failed is None, f"the agreement check fired: {tp2.ranks.failed}")
    tp2.close()
    del tp2, tp1
    torch.cuda.empty_cache()
    _no_tp_left(torch)
    out.update(start_s=start_s, launches_per_rank=launches)
    return out, counts1[1], kv_blocks


def serve_tp_features_phase(torch, np, params, counters, lora_out):
    """The serving features of a tensor-parallel replica at full
    Llama-2-7B width, two gloo ranks sharing card 0, on phase 5's weights
    ``params``, drawn under seed 0: the tp=1 servers share them, and each
    tp=2 rank draws its own slices from the same seed (the servers'
    ``PARAMS_SEED``; checked by sums), so that no weight crosses between
    the ranks, which takes tens of seconds a server over gloo: (d)
    multi-tenant LoRA at tp=2 on serve_lora's traffic, (e) disaggregation
    across layouts, raw and int8. The comparisons run off the path: before
    it the tp=1 store's bank and (e)'s fused tp=1 tokens and K/V, after it
    the partings and the K/V check. This process's counts are set to 0
    just before the first tp=2 server starts and read just after the last
    one closes; the spawned ranks' own counts, read before each closes, are
    added. Returns (the phase's summary, the path's launches)."""
    lora_ref, ref = tp_lora_reference(torch, np), tp_disagg_reference(torch, np, params)
    for fn in counters.values():
        fn.launches = 0
    lora, rank1 = tp_lora(torch, np, params, lora_ref, lora_out)
    print("serve_tp_features (d)", json.dumps(lora))
    disagg, ranks1 = {}, [rank1]
    for codec in TPF["codecs"]:
        disagg[codec], r1, blocks = tp_disagg(torch, np, params, ref, codec)
        ranks1.append(r1)
        if blocks is not None:
            kv_tp2 = blocks
    path = {k: fn.launches + sum(r[k] for r in ranks1) for k, fn in counters.items()}
    # off the path: the tp=2 shipment's raw K/V against a tp=1 prefill's,
    # both bf16, each held to an f32-activation tp=1 run: tp=2's error within
    # 4x tp=1's own (the allreduces add bf16 roundings of partial sums, of
    # the size of tp=1's roundings)
    errs = {"tp2_vs_f32": max(_rel_err(a, b) for a, b in zip(kv_tp2, ref["kv_f32"]))}
    control = max(_rel_err(a, b) for a, b in zip(ref["kv_bf16"], ref["kv_f32"]))
    kv_check = _control_check("serve_tp_features (e) raw K/V", errs, control)
    kv_check["tp2_vs_tp1_bf16"] = max(_rel_err(a, b) for a, b in zip(kv_tp2, ref["kv_bf16"]))
    partings = {d: [_first_parting(a, b) for a, b in zip(disagg["raw"][d].pop("tokens"),
                                                         ref["want"][d])]
                for d in TPF["directions"]}
    for d in TPF["directions"]:
        disagg["int8"][d].pop("tokens")
    del ref
    torch.cuda.empty_cache()
    out = dict(lora=lora, disagg=disagg, kv_check=kv_check, raw_first_parting_vs_tp1=partings)
    print("serve_tp_features", json.dumps({k: v for k, v in out.items() if k != "lora"}))
    return out, path


def device_profile(torch, fn, groups=None, attempts=3):
    """Wall time, device busy share, the kernels that take the most device
    time of one call of ``fn`` under torch.profiler, and the device time and
    launches of each of the port's kernels in it. ``groups`` (name -> parts
    of kernel symbols) adds the device time and launches of each group, a
    kernel going to the first group with a part in its name, and of the
    kernels in none. ``attempts`` bounds the profiles taken (see below): a
    rank of a gang passes 1, since a retry on one rank alone would add
    collectives the others never join."""
    from torch.profiler import ProfilerActivity, profile

    # the profiler can lose the first device records of a session, whatever
    # idle time precedes them: mostly a few, at times over a hundred, while
    # the host's launch calls are all recorded (chip_profile_loss.py). Short
    # spin kernels ahead of fn take the loss; they are left out of every
    # figure, and their losses are reported. The loss is a prefix of the
    # records, so a profile that kept a pad kept all of fn's; one that lost
    # every pad may have lost fn's first kernels, and fn runs again under a
    # new session behind four times the pads. fn runs once an attempt, so a
    # caller that holds the kernels' launch counters over this call expects
    # ``profile_attempts`` times one run's launches.
    pad_symbol = "spin_kernel"
    for attempt in range(1, attempts + 1):
        pad = 256 * 4 ** (attempt - 1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        # a user annotation on the device timeline (``Optimizer.step#AdamW.step``)
        # spans kernels that are counted on their own: it is no kernel
        notes = [e for e in device if getattr(e, "is_user_annotation", False)]
        kernels = [e for e in device if not getattr(e, "is_user_annotation", False)]
        pads_lost = pad - sum(pad_symbol in e.name for e in kernels)
        if pads_lost < pad:
            break
    check(pads_lost < pad, f"{attempts} profiles in a row lost all their pad records")
    kernels = [e for e in kernels if pad_symbol not in e.name]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name, count_by_name = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
        count_by_name[e.name] = count_by_name.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    port = {}
    for name, symbol in PORT_KERNELS.items():
        mine = [e for e in kernels if symbol in e.name]
        port[name] = {"ms": sum(e.device_time for e in mine) / 1e3, "launches": len(mine)}
    host_ops = {op: 0 for op in HOST_OPS}
    for e in prof.key_averages():
        if e.key in host_ops:
            host_ops[e.key] = e.count
    # device-to-host copies on the device, and the host's synchronising
    # runtime calls (the two this call makes around fn included)
    dtoh = sum("DtoH" in e.name for e in kernels)
    syncs = sum(e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda")
                and "Synchronize" in e.name for e in prof.events())
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, kernel_launches=len(kernels),
               dtoh_copies=dtoh, sync_calls=syncs,
               device_busy_share=busy_ms / wall_ms if busy_ms else None,
               top_kernels_ms=[[name[:80], ms] for name, ms in top], port_kernels=port,
               pad_kernels=pad, pad_kernels_lost=pads_lost, profile_attempts=attempt,
               host_ops=host_ops,
               annotations_ms={e.name: e.device_time / 1e3 for e in notes})
    if groups:
        members = {g: [] for g in [*groups, "other"]}
        for name, t in sorted(by_name.items(), key=lambda kv: -kv[1]):
            hit = [g for g, parts in groups.items() if any(x in name for x in parts)]
            members[hit[0] if hit else "other"].append((name, t))
        out["groups_ms"] = {g: sum(t for _, t in m) for g, m in members.items()}
        out["groups_launches"] = {g: sum(count_by_name[name] for name, _ in m)
                                  for g, m in members.items()}
        out["groups_share"] = {g: t / busy_ms if busy_ms else None
                               for g, t in out["groups_ms"].items()}
        out["groups_top"] = {g: [[name[:100], t] for name, t in m[:3]]
                             for g, m in members.items()}
    return out


def profile_phase(torch, server, prompt):
    """Device busy share of one served request (8 new tokens) under
    torch.profiler, and the kernels that take the most device time."""
    request = {"token_ids": prompt, "max_new_tokens": 8}
    server(request)
    torch.cuda.synchronize()
    print("profile", json.dumps(device_profile(torch, lambda: server(request))))


def train_phase(torch, counters):
    """The training path through TorchTrainer.fit(), then timed steps."""
    import math
    import pickle
    import tempfile

    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train import RunConfig, TorchTrainer
    from ray_tpu_torch.train.examples import llama_lora

    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as storage:
        t0 = time.perf_counter()
        result = TorchTrainer(
            llama_lora.train_loop_per_worker, train_loop_config=dict(TRAIN_CONFIG),
            run_config=RunConfig(name="llama-lora", storage_path=storage),
        ).fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        if result.error is not None:
            raise result.error
        with result.checkpoint.as_directory() as d:
            with open(Path(d) / "lora.pkl", "rb") as f:
                state = pickle.load(f)
    fit_peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in result.metrics_history]
    check(len(losses) == TRAIN_CONFIG["epochs"] and all(math.isfinite(x) for x in losses),
          f"bad losses {losses}")
    lora = state["lora"]
    check(state["epoch"] == TRAIN_CONFIG["epochs"] - 1, f"checkpoint of epoch {state['epoch']}")
    check(len(lora) == 32 * 4 * 2, f"checkpoint holds {len(lora)} adapter tensors, not 256")
    check(any(bool((t != 0).any()) for n, t in lora.items() if n.endswith("lora_b")),
          "every lora_b is still zero after training")
    # per step: K2 forward + recompute per layer, K3/K4 once per layer, K1
    # twice per layer forward + recompute and once for the final norm
    n_layers = 32
    want = {"rmsnorm_fwd": 4 * n_layers + 1, "flash_attention_fwd": 2 * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    for name, per_step in want.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps, want {per_step} each")

    cfg = llama_lora.model_config(TRAIN_CONFIG)
    device = torch.device("cuda", torch.cuda.current_device())
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model, _, optimizer = llama_lora.lora_model(cfg, params)
    del params
    b = TRAIN_CONFIG["batch_per_worker"]
    tokens = llama_lora.step_tokens(cfg, b, 0, 0, 0, device)
    llama_lora.lora_train_step(model, optimizer, tokens)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = llama_lora.lora_train_step(model, optimizer, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(math.isfinite(loss.item()), "non-finite loss in the timed steps")
    step_peak = torch.cuda.max_memory_allocated()
    for fn in counters.values():
        fn.launches = 0
    prof = device_profile(torch, lambda: llama_lora.lora_train_step(model, optimizer, tokens))
    # the profile finds each kernel by its symbol: a renamed one would count 0
    runs = prof["profile_attempts"]
    for name, per_step in want.items():
        got = prof["port_kernels"][name]["launches"]
        launched = counters[name].launches
        check(launched == per_step * runs,
              f"{name}: {launched} launches in {runs} profiled steps, want {per_step * runs}")
        check(got == per_step, f"{name}: {got} launches in the step profile, want {per_step}")
    med = statistics.median(step_ms)
    out = dict(fit_s=fit_s, losses=losses, checkpoint_tensors=len(lora),
               launches=launches, launches_per_step=want, launch_counts_match=True,
               step_ms=step_ms, step_ms_median=med, tokens_per_s=b * cfg.max_seq_len / med * 1e3,
               fit_peak_bytes=fit_peak, step_peak_bytes=step_peak, profile=prof)
    print("train", json.dumps(out))
    del model, optimizer
    return launches, out, lora


def _launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _timed_steps(torch, step, n):
    """Host-clock ms of ``n`` calls of ``step``, each ending in a
    synchronize, after one warm-up call; and the peak memory over them."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, torch.cuda.max_memory_allocated()


def _rel_err(got, want):
    """Largest |got - want| over the largest |want|, in f64 on the host,
    with one temporary of got's size (a leaf of the MoE parity's layer
    holds 470M elements)."""
    import torch

    want = want.detach().double().cpu()
    diff = got.detach().to("cpu", torch.float64, copy=True)
    diff = (diff.sub_(want) if diff.shape == want.shape else diff - want).abs_()
    return (diff.max() / torch.maximum(want.max(), -want.min())).item()


def _rel_l2(got, want):
    """||got - want|| over ||want||, in f64 on the host."""
    want = want.detach().double().cpu()
    return ((got.detach().double().cpu() - want).norm() / want.norm()).item()


def _control_check(tag, errs, control, times=4):
    """Hold the card's f32 errors against an f64 host run to at most
    ``times`` (4) x the host's own f32 errors against it (``control``, the
    largest over the same group of tensors): both are f32 runs of the same
    arithmetic that sum in other orders, so their errors are of one size,
    and 4x leaves room for the spread of a maximum over many elements. A
    control of a quarter or more would mean the host run itself is broken
    and would hide a fault."""
    check(0 < control < 0.25, f"{tag}: f32 host vs f64 host error {control}")
    worst = max(errs.values())
    check(worst <= times * control,
          f"{tag}: card vs f64 host error {worst} > {times} x {control} ({errs})")
    return dict(max_rel_err=worst, control=control, tol=times * control)


# -- data-parallel training (``train_dp``) -----------------------------------

#: (a)'s one-rank operands: 4 MiB, and the 7B adapters' gradient, 32 layers
#: x 4 projections x (4096 x 16 + 16 x 4096) bf16 elements = 33.5 MB
DP_OP_BYTES = (4 << 20, 32 * 4 * (4096 * 16 + 16 * 4096) * 2)
DP_QUANT_ROUNDS = 10
#: the 7B adapters' 256 leaves of 128 KiB, bucketed at 4 MiB: 8 buckets
DP_BUCKETS_PER_STEP = 8
#: what NCCL launches on the card in a step for its 8 one-rank allreduces
#: (torch.profiler, kernels whose symbol holds "nccl")
DP_NCCL_KERNELS_PER_STEP = 0
#: (c): two ranks sharing the card over gloo, 2 layers of 7B width
DP_GLOO = {"n_layers": 2, "steps": 2, "batch": 1}
DP_GROUPS = {"nccl": ("nccl",), "memcpy_dtod": ("Memcpy DtoD",)}


def _port_counters():
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_fwd

    return {"rmsnorm_fwd": rmsnorm_fwd, "flash_attention_fwd": flash_attention_fwd,
            "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}


def _host_ms(torch, fn, n=10):
    """Median host-clock ms of ``n`` calls of ``fn``, each ending in a
    synchronize, after a warm-up call."""
    return statistics.median(_timed_steps(torch, fn, n)[0])


def train_dp_loop(config):
    """The ``train_dp`` worker: llama_lora's own loop (the main path, with
    this process's K1-K4 launches and collective records around it) with
    every parameter replicated (``dp`` = the world size; the loop's default
    mesh is FSDP's, which ``train_fsdp`` runs), then 3 timed steps and a
    profiled one of a fresh model through the same gradient hook; reported
    to the controller."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.train.examples import llama_lora
    from ray_tpu_torch.util import metrics

    # the flags of the in-process run this one is held to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _port_counters()
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llama_lora.train_loop_per_worker(dict(config, dp=train.get_context().world_size))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated()
    summary = metrics.collective_summary()
    overlap = metrics.collective_overlap_summary()
    buckets = tcol.gradient_scheduler()._bucketizer.buckets

    ctx = train.get_context()
    cfg = llama_lora.model_config(config)
    device = torch.device("cuda", torch.cuda.current_device())
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model, _, optimizer = llama_lora.lora_model(cfg, params)
    del params
    reduce = llama_lora.data_parallel_mean(ctx.world_size)
    tokens = llama_lora.step_tokens(cfg, config["batch_per_worker"], 0, 0, ctx.world_rank, device)
    step_ms, step_peak = _timed_steps(
        torch, lambda: llama_lora.lora_train_step(model, optimizer, tokens, reduce), 3)
    ops0 = metrics.collective_summary()["allreduce"]["count"]
    prof = device_profile(torch, lambda: llama_lora.lora_train_step(model, optimizer, tokens, reduce),
                          groups=DP_GROUPS, attempts=3 if ctx.world_size == 1 else 1)
    prof_ops = (metrics.collective_summary()["allreduce"]["count"] - ops0) / prof["profile_attempts"]
    train.report({"dp_stats": dict(
        fit_s=fit_s, launches=launches, peak_bytes=peak, summary=summary, overlap=overlap,
        buckets=[[len(b.paths), b.nbytes, b.dtype] for b in buckets],
        step_ms=step_ms, step_peak_bytes=step_peak, profile=prof, profile_allreduce_ops=prof_ops,
    )})


def train_nccl_loop(config):
    """One spawned NCCL worker for two phases (a gang's start costs 15-25
    s): ``train_dp_loop`` (train_dp (b)), then ``train_fsdp_loop``
    (train_fsdp (a)), each with its own counts, reports and checkpoints."""
    import torch

    train_dp_loop(config)
    torch.cuda.empty_cache()
    train_fsdp_loop(config)


def _dp_gloo_model(torch, device):
    """(c)'s model: llama_lora's 7B config cut to 2 layers, the same seed."""
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train.examples import llama_lora

    cfg = dataclasses.replace(llama_lora.model_config(TRAIN_CONFIG), n_layers=DP_GLOO["n_layers"])
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model, lora, optimizer = llama_lora.lora_model(cfg, params)
    return cfg, model, lora, optimizer


def _dp_gloo_tokens(torch, cfg, device, steps=DP_GLOO["steps"]):
    """The global batch of each step: 2 rows from a seed, rank r takes row r."""
    gen = torch.Generator(device=device).manual_seed(1234)
    return [torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=gen, device=device)
            for _ in range(steps)]


def _host_adapters(lora):
    return {k: p.detach().float().cpu().numpy() for k, p in lora.items()}


def _dp_allreduce_report(torch, ctx, lora, device):
    """train_dp (c)'s end, in the pair's replicated pass before any other
    collective of the rank: the gradient allreduces' record over the steps,
    then the op alone (in the steps its clock also holds the wait for the
    other rank's backward on the shared card, a rendezvous, and for this
    rank's queued backward, the copy to the host)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.collective import get_group
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.util import metrics

    summary = metrics.collective_summary()["allreduce"]
    group = get_group(ctx.collective_tensor_group)
    grads = torch.randn(sum(p.numel() for p in lora.values()), device=device).to(torch.bfloat16)
    alone = []
    for _ in range(6):
        tcol.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        group.allreduce(grads)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
    train.report({"rank": ctx.world_rank, "dp_allreduce": summary,
                  "allreduce_alone_ms": alone[1:],
                  "grad_bytes": grads.numel() * grads.element_size()})


def _dp_nccl_one_rank(torch):
    """(a): every op of NcclGroup at world size 1 in this process."""
    import torch.distributed as dist

    from ray_tpu_torch import collective as col
    from ray_tpu_torch._internal.quantization import (
        dequantize_torch,
        quantize_torch,
        quantized_wire_nbytes,
    )
    from ray_tpu_torch.collective import ReduceOp
    from ray_tpu_torch.collective.scheduler import GradientReduceScheduler
    from ray_tpu_torch.parallel import expert as texp
    from ray_tpu_torch.util import metrics

    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(7)
    g = col.init_collective_group(1, 0, backend="nccl", group_name="dp-smoke")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for nbytes in DP_OP_BYTES:
            n = nbytes // torch.empty((), dtype=dtype).element_size()
            x = torch.randn(n, generator=gen, device=device).to(dtype)
            ops = {"allreduce_sum": lambda: g.allreduce(x),
                   "allreduce_min": lambda: g.allreduce(x, ReduceOp.MIN),
                   "allreduce_max": lambda: g.allreduce(x, ReduceOp.MAX),
                   "allgather": lambda: g.allgather(x),
                   "reducescatter": lambda: g.reducescatter(x),
                   "broadcast": lambda: g.broadcast(x)}
            for op, fn in ops.items():
                check(torch.equal(fn(), x), f"one-rank {op} of {dtype} {nbytes} B is not its input")
                ms = _host_ms(torch, fn)
                rows.append(dict(op=op, dtype=str(dtype), bytes=nbytes, ms=ms,
                                 gb_per_s=nbytes / ms / 1e6))
    try:
        g.allreduce(torch.ones(4, device=device), ReduceOp.PRODUCT)
        fail("NcclGroup reduced with PRODUCT")
    except NotImplementedError:
        pass
    try:
        g.allreduce(torch.ones(4))
        fail("NcclGroup took a host operand")
    except TypeError:
        pass

    # the quantized allreduce: 10 rounds of each dtype at the 7B size, each
    # equal to the codec's formula on the card, the residual carried
    q = col.init_collective_group(1, 0, backend="nccl", group_name="dp-smoke-q", quantized=True)
    before = metrics.collective_summary()["allreduce"]
    logical = wire = 0
    for dtype in (torch.bfloat16, torch.float32):
        n = DP_OP_BYTES[1] // torch.empty((), dtype=dtype).element_size()
        residual = None
        for _ in range(DP_QUANT_ROUNDS):
            x = torch.randn(n, generator=gen, device=device).to(dtype)
            out = q.allreduce(x)
            comp = x.float() if residual is None else x.float() + residual
            codes, scales = quantize_torch(comp, q.quant_block)
            deq = dequantize_torch(codes, scales, comp.shape, torch.float32)
            check(torch.equal(out, deq.to(dtype)), f"quantized {dtype} allreduce is not the codec's")
            residual = comp - deq
            carried = q._ef_residuals[("allreduce", (n,), str(dtype))]
            check(torch.equal(carried, residual), f"quantized {dtype} residual is not carried")
            logical += x.numel() * x.element_size()
            wire += quantized_wire_nbytes(n, q.quant_block)
    after = metrics.collective_summary()["allreduce"]
    check(after["bytes"] - before["bytes"] == logical,
          f"collective_summary logical bytes {after['bytes'] - before['bytes']} != {logical}")
    check(after["wire_bytes"] - before["wire_bytes"] == wire,
          f"collective_summary wire bytes {after['wire_bytes'] - before['wire_bytes']} != {wire}")
    quant_ms = _host_ms(torch, lambda: q.allreduce(x))

    # one async allreduce through the scheduler records an overlap split
    pending = GradientReduceScheduler(g, overlap=True).reduce({"g": x})
    pending.wait()
    split = metrics.collective_overlap_summary()["dp-smoke"]
    check(split["exposed_s"] + split["overlapped_s"] > 0, f"no overlap split recorded: {split}")

    # moe_dispatch / moe_combine through the one-rank all_to_all
    t, e, d = 256, 8, 4096
    xs = torch.randn(t, d, generator=gen, device=device).to(torch.bfloat16)
    logits = torch.randn(t, e, generator=gen, device=device)
    dispatch, combine, _ = texp.top_k_gating(logits, texp.expert_capacity(t, e, 1.0, 2), k=2)
    slabs = texp.moe_dispatch(xs, dispatch, group=g)
    check(torch.equal(slabs, texp.moe_dispatch(xs, dispatch)), "moe_dispatch over NCCL != local")
    check(torch.equal(texp.moe_combine(slabs * 2, combine, group=g),
                      texp.moe_combine(slabs * 2, combine)), "moe_combine over NCCL != local")
    for name in ("dp-smoke", "dp-smoke-q"):
        col.destroy_collective_group(name)
    dist.destroy_process_group()
    return dict(ops=rows, quantized_rounds=2 * DP_QUANT_ROUNDS, quantized_logical_bytes=logical,
                quantized_wire_bytes=wire, quantized_allreduce_ms=quant_ms, overlap_split=split,
                note="one rank: each op is a copy on the card (or nothing), not a link's speed")


def train_dp_phase(torch, np, counters, train_out, train_lora):
    """Data-parallel training: (a) NcclGroup at world size 1; (b) the 7B
    LoRA loop through TorchTrainer with a spawned NCCL worker, held to the
    ``train`` phase's in-process fit() (the worker then runs train_fsdp
    (a)'s loop, ``train_nccl_loop``, whose results go back for that phase);
    (c) two ranks sharing the card over gloo at 2 layers, run and checked in
    train_fsdp's pair gang; (d) NCCL for two ranks on one card is refused.
    Returns (the path's launches, the phase's numbers, train_fsdp (a)'s
    worker results)."""
    import multiprocessing
    import pickle
    import tempfile

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer
    from ray_tpu_torch.train.examples import llama_lora

    out = {"nccl_one_rank": _dp_nccl_one_rank(torch)}
    for row in out["nccl_one_rank"]["ops"]:
        print("train_dp op", json.dumps(row))

    def fit(loop, storage, **kw):
        result = TorchTrainer(loop, train_loop_config=dict(TRAIN_CONFIG),
                              run_config=RunConfig(name="llama-lora", storage_path=storage),
                              **kw).fit()
        if result.error is not None:
            raise result.error
        with open(Path(result.checkpoint.path) / "lora.pkl", "rb") as f:
            return result, pickle.load(f)["lora"]

    def max_diff(a, b):
        check(sorted(a) == sorted(b), "the checkpoints hold other adapters")
        return max((a[k].float() - b[k].float()).abs().max().item() for k in a)

    # the bound: a second in-process fit against the train phase's
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as storage:
        again, again_lora = fit(llama_lora.train_loop_per_worker, storage)
    train_losses = train_out["losses"]
    bound_loss = max(abs(a - b) for a, b in zip(train_losses,
                                                [m["loss"] for m in again.metrics_history]))
    bound_lora = max_diff(train_lora, again_lora)
    del again_lora
    torch.cuda.empty_cache()

    # (b) the worker-group path: one NCCL worker, spawned; it runs
    # train_fsdp (a)'s loop after this one (train_nccl_loop)
    _zero(counters)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as storage:
        t0 = time.perf_counter()
        result = TorchTrainer(train_nccl_loop, train_loop_config=dict(TRAIN_CONFIG),
                              run_config=RunConfig(name="llama-lora", storage_path=storage),
                              scaling_config=ScalingConfig(num_workers=1),
                              backend_config=TorchConfig(backend="nccl"), overlap=True).fit()
        fit_s = time.perf_counter() - t0
        if result.error is not None:
            raise result.error
        # each loop's checkpoints in report order: the dp loop's epochs, then
        # the FSDP loop's
        with open(Path(storage) / "llama-lora" / "checkpoint_manifest.json") as f:
            ckpts = [c["path"] for c in json.load(f)["checkpoints"]]
        check(len(ckpts) == 2 * TRAIN_CONFIG["epochs"], f"the worker's checkpoints {ckpts}")
        adapters = []
        for path in (ckpts[TRAIN_CONFIG["epochs"] - 1], ckpts[-1]):
            with open(Path(path) / "lora.pkl", "rb") as f:
                adapters.append(pickle.load(f)["lora"])
        dp_lora, fsdp_lora = adapters
    parent = _launches(counters)
    check(not any(parent.values()), f"the NCCL worker's loops launched kernels in the parent: "
                                    f"{parent}")
    check(not multiprocessing.active_children(), "the worker group left a process")
    split = next(i for i, m in enumerate(result.metrics_history) if "dp_stats" in m) + 1
    history, fsdp_history = result.metrics_history[:split], result.metrics_history[split:]
    stats = history[-1]["dp_stats"]
    losses = [m["loss"] for m in history if "loss" in m]
    check(len(losses) == TRAIN_CONFIG["epochs"], f"worker losses {losses}")
    loss_diff = max(abs(a - b) for a, b in zip(losses, train_losses))
    lora_diff = max_diff(dp_lora, train_lora)
    check(len(dp_lora) == 32 * 4 * 2, f"the worker's checkpoint holds {len(dp_lora)} adapters")
    check(loss_diff <= bound_loss, f"worker losses part from in-process by {loss_diff} > {bound_loss}")
    check(lora_diff <= bound_lora, f"worker adapters part from in-process by {lora_diff} > {bound_lora}")
    n_layers = 32
    want = {"rmsnorm_fwd": 4 * n_layers + 1, "flash_attention_fwd": 2 * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    launches = {name: parent[name] + stats["launches"][name] for name in counters}
    for name, per_step in want.items():
        check(stats["launches"][name] == per_step * TRAIN_STEPS,
              f"{name}: {stats['launches'][name]} launches in the worker's {TRAIN_STEPS} steps, "
              f"want {per_step} each")
    grad_bytes = DP_OP_BYTES[1]
    check(stats["buckets"] == [[32, 4 << 20, "bfloat16"]] * DP_BUCKETS_PER_STEP,
          f"buckets {stats['buckets']}")
    ar = stats["summary"]["allreduce"]
    check(ar["count"] == DP_BUCKETS_PER_STEP * TRAIN_STEPS,
          f"{ar['count']} allreduce ops in {TRAIN_STEPS} steps, want {DP_BUCKETS_PER_STEP} a step")
    check(ar["bytes"] == grad_bytes * TRAIN_STEPS and ar["wire_bytes"] == ar["bytes"],
          f"allreduce bytes {ar}, want {grad_bytes} a step")
    prof = stats["profile"]
    check(stats["profile_allreduce_ops"] == DP_BUCKETS_PER_STEP,
          f"{stats['profile_allreduce_ops']} allreduce ops in the profiled step")
    nccl = prof["groups_launches"]["nccl"]
    check(nccl == DP_NCCL_KERNELS_PER_STEP,
          f"{nccl} NCCL kernels in the profiled step, want {DP_NCCL_KERNELS_PER_STEP}: "
          f"{prof['groups_top']}")
    for name, per_step in want.items():
        check(prof["port_kernels"][name]["launches"] == per_step,
              f"{name}: {prof['port_kernels'][name]['launches']} launches in the worker's profile")
    out["nccl_worker"] = dict(
        gang_fit_s=fit_s, worker_fit_s=stats["fit_s"], losses=losses, bound_loss=bound_loss,
        loss_diff=loss_diff, bound_adapter=bound_lora, adapter_diff=lora_diff,
        launches=stats["launches"], launches_per_step=want, buckets=stats["buckets"],
        allreduce=ar, overlap=stats["overlap"], step_ms=stats["step_ms"],
        step_ms_median=statistics.median(stats["step_ms"]),
        train_phase_step_ms_median=train_out["step_ms_median"],
        worker_peak_bytes=stats["peak_bytes"], worker_step_peak_bytes=stats["step_peak_bytes"],
        profile=dict(nccl_kernels=nccl, memcpy_dtod=prof["groups_launches"]["memcpy_dtod"],
                     groups_ms=prof["groups_ms"], groups_top=prof["groups_top"],
                     device_busy_share=prof["device_busy_share"], wall_ms=prof["wall_ms"],
                     kernel_launches=prof["kernel_launches"]))
    del dp_lora
    torch.cuda.empty_cache()

    # (d) NCCL for two ranks on one card is the port's refusal, before any spawn
    try:
        TorchTrainer(train_dp_loop, scaling_config=ScalingConfig(2, {"GPU": 0.5}),
                     backend_config=TorchConfig(backend="nccl")).fit()
        fail("NCCL with two ranks on one card was not refused")
    except ValueError as e:
        check('backend="gloo"' in str(e), f"refusal without its advice: {e}")
        out["refusal"] = str(e)
    check(not multiprocessing.active_children(), "the refusal spawned a process")
    print("train_dp", json.dumps(out))
    fsdp_worker = dict(gang_fit_s=fit_s, lora=fsdp_lora, losses=[
        m["loss"] for m in fsdp_history if "loss" in m],
        stats=next(m["fsdp_stats"] for m in fsdp_history if "fsdp_stats" in m))
    return launches, out, fsdp_worker


def _dp_pair_checks(torch, np, history):
    """train_dp (c): two ranks sharing the card over gloo (the replicated
    pass of ``train_pair_loop``), at batch 1 each, against one rank at batch
    2 in this process: each step's adapters equal on the two ranks and
    within the bound of the other's, the gradient allreduce's record, and
    the op timed alone."""
    from ray_tpu_torch.train.examples import llama_lora

    steps = {}
    for m in history:
        if "dp_step" in m:
            steps.setdefault(m["dp_step"], {})[m["rank"]] = m
    check(sorted(steps) == list(range(DP_GLOO["steps"])), f"gloo steps {sorted(steps)}")
    device = torch.device("cuda", torch.cuda.current_device())
    cfg, model, lora, optimizer = _dp_gloo_model(torch, device)
    one = []
    for tokens in _dp_gloo_tokens(torch, cfg, device):
        loss = llama_lora.lora_train_step(model, optimizer, tokens)
        one.append((loss.item(), _host_adapters(lora)))
    lr = 1e-4
    rows = []
    for s, (loss, adapters) in enumerate(one):
        r0, r1 = steps[s][0], steps[s][1]
        check(r0["device"] == r1["device"] == str(device), "the gloo ranks are not on one card")
        for k in adapters:
            check(np.array_equal(r0["adapters"][k], r1["adapters"][k]),
                  f"step {s}: the gloo ranks' {k} differ")
        # the mean of two batch-1 gradients against one batch-2 gradient:
        # each is bf16 arithmetic summed in another order, which can flip
        # the sign of a near-zero element, and Adam moves an element by
        # about lr a step whatever its gradient's size; so after n steps an
        # element may part by 2 n lr, plus a rounding of the bf16 parameter
        # (half an ulp of |p|) per step on each side
        worst = 0.0
        for k, want_a in adapters.items():
            got = r0["adapters"][k]
            ulp = np.spacing(np.abs(want_a).astype(np.float32)) * 2 ** 16  # bf16 ulp
            excess = np.abs(got - want_a) - (2 * (s + 1) * lr + (s + 1) * ulp)
            worst = max(worst, float(excess.max()))
        check(worst <= 0, f"step {s}: gloo adapters part from batch 2 by {worst} past the bound")
        rows.append(dict(step=s, loss_batch2=loss, loss_ranks=[r0["loss"], r1["loss"]],
                         equal_share=float(np.mean(np.concatenate(
                             [(r0["adapters"][k] == a).ravel() for k, a in adapters.items()])))))
    del model, optimizer, lora
    ends = [m for m in history if "dp_allreduce" in m]
    check(len(ends) == 2 and all(m["dp_allreduce"]["count"] == DP_GLOO["steps"] for m in ends),
          f"gloo allreduce records {ends}")
    # 2 layers x 4 projections x (4096 x 16 + 16 x 4096) bf16: one 2 MiB bucket a step
    grad_bytes = DP_GLOO["n_layers"] * 4 * 2 * 4096 * 16 * 2
    check(all(m["grad_bytes"] == grad_bytes
              and m["dp_allreduce"]["bytes"] == grad_bytes * DP_GLOO["steps"] for m in ends),
          f"gloo gradient bytes {[m['dp_allreduce'] for m in ends]}, want {grad_bytes} a step")
    out = dict(
        steps=rows, grad_bytes=grad_bytes,
        allreduce_in_step_mean_ms=[m["dp_allreduce"]["mean_ms"] for m in ends],
        allreduce_alone_ms=[m["allreduce_alone_ms"] for m in ends],
        allreduce_alone_median_ms=[statistics.median(m["allreduce_alone_ms"]) for m in ends])
    print("train_dp (c)", json.dumps(out))
    return out


# -- FSDP for the 7B LoRA loop (``train_fsdp``) -------------------------------

#: (b): two gloo ranks sharing the card, replicated and then at fsdp=2 in
#: one gang, 7B width cut to 2 layers and 2 steps of a 2-row global batch (so
#: that train_mesh and train_tp fit the time limit)
FSDP_GLOO = {"n_layers": 2, "steps": 2, "ranks": 2}


def train_fsdp_loop(config):
    """(a)'s worker: llama_lora's own loop at its default mesh (FSDP, here
    fsdp=1: every gather a one-rank NCCL op), this process's K1-K4 counts
    and collective records around it; then a fresh FSDP model's collectives
    in one step, and timed steps."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.fsdp import FSDP
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.train.examples import llama_lora
    from ray_tpu_torch.util import metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _port_counters()
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llama_lora.train_loop_per_worker(config)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated()

    ctx = train.get_context()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = llama_lora.model_config(config)
    mesh = tcol.gang_mesh(device, fsdp=ctx.world_size)
    fsdp = FSDP.for_llama(cfg, mesh.bind(ctx.world_rank, {"fsdp": tcol.tensor_group()}))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device,
                         shard=fsdp.shard)
    model, _, optimizer = llama_lora.lora_model(cfg, params, mesh=fsdp.mesh)
    del params
    reduce = llama_lora.mesh_gradients(model)
    tokens = llama_lora.step_tokens(cfg, config["batch_per_worker"], 0, 0, ctx.world_rank, device)

    def step():
        llama_lora.lora_train_step(model, optimizer, tokens, reduce)

    step()
    torch.cuda.synchronize()
    before = metrics.collective_summary()
    step()
    torch.cuda.synchronize()
    after = metrics.collective_summary()
    per_step = {op: {k: after[op][k] - before.get(op, {}).get(k, 0) for k in ("count", "bytes")}
                for op in ("allgather", "reducescatter", "allreduce") if op in after}
    step_ms, step_peak = _timed_steps(torch, step, 3)
    train.report({"fsdp_stats": dict(
        fit_s=fit_s, launches=launches, peak_bytes=peak, per_step=per_step,
        sharded=len(fsdp.sharded), step_ms=step_ms, step_peak_bytes=step_peak)})


def train_fsdp_gloo_loop(config):
    """(b)'s worker: one of two ranks sharing the card over gloo, 2 steps of
    the 7B loop's step cut to 2 layers on row r of each global batch, with
    every parameter replicated (``train_dp`` (c)'s pair: each step's loss
    and adapters reported, then the gradient allreduce's record and the op
    alone), then with FSDP at fsdp=2; after each, the full adapters and a
    report, and under FSDP a sharded checkpoint of the rank's adapter blocks
    (``config["ckpt"]``)."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.fsdp import FSDP
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.train.examples import llama_lora
    from ray_tpu_torch.train.lora import split_lora
    from ray_tpu_torch.util import metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = train.get_context()
    r = ctx.world_rank
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(llama_lora.model_config(TRAIN_CONFIG),
                              n_layers=FSDP_GLOO["n_layers"])
    counters = _port_counters()
    for sharded in (False, True):
        fsdp = None
        if sharded:
            mesh = tcol.gang_mesh(device, fsdp=ctx.world_size)
            fsdp = FSDP.for_llama(cfg, mesh.bind(r, {"fsdp": tcol.tensor_group()}))
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device,
                             shard=None if fsdp is None else fsdp.shard)
        model, lora, optimizer = llama_lora.lora_model(
            cfg, params, mesh=None if fsdp is None else fsdp.mesh)
        del params
        base, _ = split_lora(dict(model.named_parameters()))
        reduce = (llama_lora.data_parallel_mean(ctx.world_size) if fsdp is None
                  else llama_lora.mesh_gradients(model))
        _zero(counters)
        torch.cuda.reset_peak_memory_stats()
        rows, losses = [], []
        for step, tokens in enumerate(_dp_gloo_tokens(torch, cfg, device, FSDP_GLOO["steps"])):
            torch.cuda.synchronize()
            before = metrics.collective_summary().get("allgather", {}).get("bytes", 0)
            t0 = time.perf_counter()
            loss = llama_lora.lora_train_step(model, optimizer, tokens[r:r + 1], reduce)
            torch.cuda.synchronize()
            rows.append(dict(step_ms=(time.perf_counter() - t0) * 1e3,
                             gather_bytes=metrics.collective_summary().get("allgather", {}).get(
                                 "bytes", 0) - before))
            # the FSDP model's loss is the global batch's already; the
            # replicated pair's is each rank's, meaned after the steps, and
            # its steps are train_dp (c)'s: each rank's loss and adapters
            losses.append(float(loss) if fsdp is not None else loss)
            if fsdp is None:
                train.report({"dp_step": step, "rank": r, "loss": float(loss),
                              "device": str(device), "adapters": _host_adapters(lora)})
        if fsdp is None:
            _dp_allreduce_report(torch, ctx, lora, device)
            losses = [tcol.gang_mean(loss) for loss in losses]
        launches = _launches(counters)
        peak = torch.cuda.max_memory_allocated()
        full = lora if fsdp is None else fsdp.full_state(lora)
        if fsdp is not None:
            train.save_sharded(config["ckpt"], {"lora": dict(lora)},
                               {"lora": {n: fsdp.shardings[n] for n in lora}})
        train.report({"rank": r, "device": str(device), "fsdp": sharded,
                      "base_bytes": sum(p.numel() * p.element_size() for p in base.values()),
                      "adapters": _host_adapters(full), "steps": rows, "losses": losses,
                      "launches": launches, "peak_bytes": peak})
        del model, lora, optimizer, base, full
        torch.cuda.empty_cache()


def train_pair_loop(config):
    """One gang of two gloo ranks sharing the card for the pairs of four
    phases (a gang's start costs 15-25 s): ``train_fsdp_gloo_loop``
    (train_fsdp (b), its replicated pass train_dp (c)), then
    ``train_sp_loop`` (train_sp), then ``train_resnet_dp_gloo_loop``
    (train_resnet_dp (b))."""
    import torch

    train_fsdp_gloo_loop(config)
    torch.cuda.empty_cache()
    train_sp_loop(config)
    torch.cuda.empty_cache()
    train_resnet_dp_gloo_loop(config)


def train_fsdp_phase(torch, np, counters, train_out, train_lora, dp_out, worker):
    """FSDP of the 7B LoRA loop: (a) a spawned NCCL worker at world size 1
    and fsdp=1 runs the full loop (train_dp (b)'s worker, after its own
    loop; ``worker`` its results), held to the ``train`` phase's in-process
    run (bit for bit, or within the spread of two in-process runs that
    ``train_dp`` measured); (b) two gloo ranks sharing the card at fsdp=2,
    2 layers, against the replicated pair on the same data; (c) the pair's
    sharded checkpoint restored whole in this process."""
    import multiprocessing
    import tempfile

    from ray_tpu_torch.train import (
        RunConfig,
        ScalingConfig,
        TorchConfig,
        TorchTrainer,
        restore_sharded,
    )

    def fit(loop, storage, name, config, **kw):
        result = TorchTrainer(loop, train_loop_config=config,
                              run_config=RunConfig(name=name, storage_path=storage), **kw).fit()
        if result.error is not None:
            raise result.error
        return result

    device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    stats, losses, fsdp_lora = worker["stats"], worker["losses"], worker["lora"]
    bound_loss = dp_out["nccl_worker"]["bound_loss"]
    bound_lora = dp_out["nccl_worker"]["bound_adapter"]
    check(sorted(fsdp_lora) == sorted(train_lora), "the FSDP checkpoint holds other adapters")
    loss_diff = max(abs(a - b) for a, b in zip(losses, train_out["losses"]))
    lora_diff = max((fsdp_lora[k].float() - train_lora[k].float()).abs().max().item()
                    for k in train_lora)
    check(len(losses) == TRAIN_CONFIG["epochs"] and loss_diff <= bound_loss,
          f"FSDP losses {losses} part from in-process by {loss_diff} > {bound_loss}")
    check(lora_diff <= bound_lora, f"FSDP adapters part from in-process by {lora_diff} > {bound_lora}")
    n_layers = 32
    want = {"rmsnorm_fwd": 4 * n_layers + 1, "flash_attention_fwd": 2 * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    for name, per_step in want.items():
        check(stats["launches"][name] == per_step * TRAIN_STEPS,
              f"{name}: {stats['launches'][name]} launches in the FSDP worker's {TRAIN_STEPS} "
              f"steps, want {per_step} each")
    launches = {name: stats["launches"][name] for name in counters}
    out["nccl_worker"] = dict(
        gang_fit_s=worker["gang_fit_s"], worker_fit_s=stats["fit_s"], losses=losses,
        loss_diff=loss_diff,
        bound_loss=bound_loss, adapter_diff=lora_diff, bound_adapter=bound_lora,
        bit_for_bit=loss_diff == 0 and lora_diff == 0, launches=stats["launches"],
        launches_per_step=want, sharded_params=stats["sharded"], per_step=stats["per_step"],
        step_ms=stats["step_ms"], step_ms_median=statistics.median(stats["step_ms"]),
        train_phase_step_ms_median=train_out["step_ms_median"],
        peak_bytes=stats["peak_bytes"], step_peak_bytes=stats["step_peak_bytes"],
        train_phase_step_peak_bytes=train_out["step_peak_bytes"])
    del fsdp_lora
    torch.cuda.empty_cache()

    # (b) two gloo ranks on the card, one gang (train_pair_loop): the
    # replicated pair (train_dp (c)), then FSDP at fsdp=2, then train_sp's
    # pair and train_resnet_dp's, whose in-process yardsticks run here
    # first; this process's counts are set to 0 just before the gang's fit()
    # and must stay 0
    sp = {"yardsticks": _sp_yardsticks(torch)}
    resnet = {"yardsticks": _resnet_yardsticks(torch)}
    _zero(counters)
    pairs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fsdp_") as storage:
        ckpt = str(Path(storage) / "fsdp-ckpt")
        t0 = time.perf_counter()
        result = fit(train_pair_loop, storage, "pair", {"ckpt": ckpt},
                     scaling_config=ScalingConfig(FSDP_GLOO["ranks"], {"GPU": 0.5}),
                     backend_config=TorchConfig(backend="gloo"), overlap=True)
        pair_fit_s = time.perf_counter() - t0
        sp.update(_sp_pair_outputs(torch, Path(storage) / "pair"), fit_s=pair_fit_s,
                  reports=[m for m in result.metrics_history if "ops" in m])
        resnet.update(fit_s=pair_fit_s,
                      ranks=[torch.load(Path(storage) / "pair" / f"resnet_gloo_rank{r}.pt")
                             for r in range(RESNET_GLOO["ranks"])],
                      reports=[m for m in result.metrics_history if "resnet_gloo" in m])
        parent = _launches(counters)
        check(not any(parent.values()), f"the pair gang launched kernels in the parent: {parent}")
        check(not multiprocessing.active_children(), "the pair gang left a process")
        out["dp_pair"] = _dp_pair_checks(torch, np, result.metrics_history)
        for sharded in (False, True):
            reports = sorted((m for m in result.metrics_history if m.get("fsdp") is sharded),
                             key=lambda m: m["rank"])
            check([m["rank"] for m in reports] == [0, 1], f"gloo reports {reports}")
            check(all(m["device"] == str(device) for m in reports),
                  "the gloo ranks are not on one card")
            for k, a in reports[0]["adapters"].items():
                check(np.array_equal(a, reports[1]["adapters"][k]), f"the gloo ranks' {k} differ")
            check(reports[0]["losses"] == reports[1]["losses"], "the ranks report other losses")
            pairs[sharded] = dict(reports=reports)
        # (c) the pair's blocks, restored whole here
        restored = restore_sharded(ckpt)["lora"]
    rep, fs = pairs[False]["reports"], pairs[True]["reports"]
    for m in fs:
        check(m["base_bytes"] * FSDP_GLOO["ranks"] == rep[0]["base_bytes"],
              f"rank {m['rank']} holds {m['base_bytes']} B of a {rep[0]['base_bytes']} B base")
    per_step = {"rmsnorm_fwd": 4 * FSDP_GLOO["n_layers"] + 1,
                "flash_attention_fwd": 2 * FSDP_GLOO["n_layers"],
                "flash_bwd_dq": FSDP_GLOO["n_layers"], "flash_bwd_dkv": FSDP_GLOO["n_layers"]}
    for m in rep + fs:
        check(m["launches"] == {k: v * FSDP_GLOO["steps"] for k, v in per_step.items()},
              f"rank {m['rank']} launches {m['launches']}")
    for m in fs:
        for name in counters:
            launches[name] += m["launches"][name]
    # the same step on the same data, the gradient sums grouped otherwise:
    # Adam moves an element by about lr a step whatever its gradient's size,
    # so a near-zero gradient whose sign a rounding flips parts the two by
    # up to 2 lr a step, plus half a bf16 step of |p| per step on each side
    lr, n = 1e-4, FSDP_GLOO["steps"]
    worst, equal = 0.0, []
    for k, want_a in rep[0]["adapters"].items():
        got = fs[0]["adapters"][k]
        ulp = np.spacing(np.abs(want_a).astype(np.float32)) * 2 ** 16
        worst = max(worst, float((np.abs(got - want_a) - (2 * n * lr + n * ulp)).max()))
        equal.append((got == want_a).ravel())
    check(worst <= 0, f"FSDP adapters part from the replicated pair by {worst} past the bound")
    check(sorted(restored) == sorted(fs[0]["adapters"]), "the sharded checkpoint's adapters")
    for k, t in restored.items():
        check(np.array_equal(t.float().numpy(), fs[0]["adapters"][k]),
              f"the restored {k} is not the pair's")
    out["gloo_shared_card"] = dict(
        fit_s=pair_fit_s,
        base_bytes_replicated=rep[0]["base_bytes"], base_bytes_fsdp=[m["base_bytes"] for m in fs],
        equal_share=float(np.mean(np.concatenate(equal))),
        max_abs_diff=max(float(np.abs(fs[0]["adapters"][k] - a).max())
                         for k, a in rep[0]["adapters"].items()),
        gather_bytes_per_step=[s["gather_bytes"] for s in fs[0]["steps"]],
        step_ms_fsdp=[[s["step_ms"] for s in m["steps"]] for m in fs],
        step_ms_replicated=[[s["step_ms"] for s in m["steps"]] for m in rep],
        peak_bytes_fsdp=[m["peak_bytes"] for m in fs],
        peak_bytes_replicated=[m["peak_bytes"] for m in rep],
        losses_fsdp=fs[0]["losses"], losses_replicated=rep[0]["losses"],
        restored_bit_for_bit=True)
    print("train_fsdp", json.dumps(out))
    return launches, out, {"sp": sp, "resnet": resnet}


# -- sequence parallelism (``train_sp``) -------------------------------------


def _card(torch):
    """This process's card."""
    return torch.device("cuda", torch.cuda.current_device())


class _ShiftMeter:
    """``group`` with its ring shifts metered: each wait's bytes, the host
    time it blocked (``perf_counter`` around it) and, on a card, the time the
    current stream spent between the kernels before the wait and the work
    after it (CUDA events around the wait: over NCCL the stream, not the
    host, waits for the transfer; over gloo it idles while the host
    blocks). Every other attribute is the group's, so a mesh bound with the
    meter as its ``sp`` group runs the model's ring through it."""

    def __init__(self, group):
        self._group = group
        self.shifts = []

    def __getattr__(self, name):
        return getattr(self._group, name)

    def ring_shift(self, tensors):
        return _MeteredShift(self, self._group.ring_shift(tensors))

    def take(self):
        """The shifts since the last call (after a synchronize): their
        count, bytes, host-blocked ms and stream-wait ms."""
        shifts, self.shifts = self.shifts, []
        return dict(count=len(shifts), bytes=sum(n for n, _, _ in shifts),
                    exposed_host_ms=sum(e for _, e, _ in shifts) * 1e3,
                    stream_wait_ms=sum(a.elapsed_time(b) for _, _, (a, b) in shifts))


class _MeteredShift:
    """A posted shift of ``_ShiftMeter``, its wait metered. A class of its
    own, not one made in each call: such a class sits in a reference cycle,
    and would keep the shift's received tensors alive until the cyclic
    collector ran (a whole step's receive buffers, in part 6)."""

    def __init__(self, meter, pending):
        self._meter, self._pending = meter, pending

    def wait(self):
        import torch

        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        t0 = time.perf_counter()
        out = self._pending.wait()
        blocked = time.perf_counter() - t0
        events[1].record()
        self._meter.shifts.append((self._pending.nbytes, blocked, events))
        return out


def _sp_op_inputs(torch, device, b, h, hk, seq):
    """q, do (b, h, seq, 128) and k, v (b, hk, seq, 128) bf16 from one seed."""
    g = torch.Generator(device=device).manual_seed(SEED + 60 + seq + hk)
    q, do = (torch.randn(b, h, seq, 128, generator=g, device=device).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, hk, seq, 128, generator=g, device=device).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, do


def _sp_tokens(torch, cfg, device):
    """(b)'s global batches, (2, 4096) each, from one seed."""
    g = torch.Generator(device=device).manual_seed(SEED + 70)
    return [torch.randint(0, cfg.vocab_size, (SP["batch"], SP["seq"]), generator=g,
                          device=device) for _ in range(SP["steps"])]


def _sp_model_config(dtype=None):
    """llama_lora's 7B config at seq 4096 cut to 4 layers (bf16 parameters,
    LoRA rank 16, remat); ``dtype`` sets the activations' (default bf16)."""
    from ray_tpu_torch.train.examples import llama_lora

    cfg = dataclasses.replace(llama_lora.model_config(dict(TRAIN_CONFIG, seq=SP["seq"])),
                              n_layers=SP["n_layers"])
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


class _FirstGradients:
    """A ``reduce_grads`` hook for ``lora_train_step`` that keeps, on the
    host, the first step's gradients as the rank computed them
    (``local``) and as ``reduce`` returns them (``reduced``, the ones AdamW
    applies); ``reduce=None`` applies them as they are."""

    def __init__(self, reduce=None):
        self._reduce, self.local, self.reduced = reduce, None, None

    def __call__(self, grads):
        first = self.local is None
        if first:  # copies: a hook may sum the gradients in place
            self.local = {k: g.detach().to("cpu", copy=True) for k, g in grads.items()}
        out = grads if self._reduce is None else self._reduce(grads)
        if first:
            self.reduced = {k: g.detach().to("cpu", copy=True) for k, g in out.items()}
        return out


def _sp_one_rank(torch, dtype=None):
    """The in-process one-rank 4-layer model on the whole sequence: (b)'s 3
    steps, its losses, its first step's gradients and its adapters (on the
    host)."""
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train.examples import llama_lora

    device = _card(torch)
    cfg = _sp_model_config(dtype)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model, lora, optimizer = llama_lora.lora_model(cfg, params, lr=SP["lr"])
    first = _FirstGradients()
    losses = [float(llama_lora.lora_train_step(model, optimizer, t, first))
              for t in _sp_tokens(torch, cfg, device)]
    adapters = {k: p.detach().cpu() for k, p in lora.items()}
    del model, lora, optimizer, params
    torch.cuda.empty_cache()
    return losses, first.reduced, adapters


def _sp_op_reference(torch, b, h, hk, seq):
    """(a)'s yardsticks on the whole sequence: the one-rank
    ``flash_attention`` (K2-K4) o and gradients on the host, and each one's
    largest distance from the f32 plain attention (autograd through
    ``reference_attention`` in f32, a KV head's group of query heads at a
    time)."""
    from ray_tpu_torch.ops.flash_attention import flash_attention, reference_attention

    device = _card(torch)
    q, k, v, do = _sp_op_inputs(torch, device, b, h, hk, seq)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*leaves, causal=True)
    o.backward(do)
    one = {"o": o.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad, "dv": leaves[2].grad}
    control = {name: 0.0 for name in one}
    rep = h // hk
    per = max(1, 4 // rep)  # KV heads a chunk: 4 query heads at a time
    for j in range(0, hk, per):
        qs, ks = slice(j * rep, (j + per) * rep), slice(j, j + per)
        part = [t.float().requires_grad_(True) for t in (q[:, qs], k[:, ks], v[:, ks])]
        of = reference_attention(*part, causal=True)
        of.backward(do[:, qs].float())
        for name, got, want in (("o", one["o"][:, qs], of.detach()),
                                ("dq", one["dq"][:, qs], part[0].grad),
                                ("dk", one["dk"][:, ks], part[1].grad),
                                ("dv", one["dv"][:, ks], part[2].grad)):
            control[name] = max(control[name], (got.float() - want).abs().max().item())
        del part, of
    out = {name: t.cpu() for name, t in one.items()}
    del one, leaves, o, q, k, v, do
    torch.cuda.empty_cache()
    return out, control


def train_sp_loop(config):
    """One of two gloo ranks sharing the card: (a) ring and Ulysses
    attention on its shard of each of ``SP_OPS``, timed, the first run's o
    and gradients written beside the run; (b) the 4-layer 7B LoRA step with
    the sequence split over the ranks (``gang_mesh(device, sp=2)`` bound to
    the tensor group), 3 AdamW steps with the gradients summed over the
    group (``train.collective.reduce_gradients``), its first step's local
    and summed gradients and its adapters written beside the run. The K1-K4
    counts of (a) and of (b), each set to 0 just before it and read just
    after, are reported."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.train.examples import llama_lora
    from ray_tpu_torch.util import metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = train.get_context()
    r, n = ctx.world_rank, ctx.world_size
    device = _card(torch)
    run_dir = Path(ctx.get_storage_path())
    meter = _ShiftMeter(tcol.tensor_group())
    counters = _port_counters()

    def op_bytes():
        summary = metrics.collective_summary()
        return {op: summary.get(op, {}).get("bytes", 0) for op in ("ring_shift", "all_to_all")}

    _zero(counters)
    ops = {}
    for name, b, h, hk, seq in SP_OPS:
        q, k, v, do = _sp_op_inputs(torch, device, b, h, hk, seq)
        s = seq // n
        q, k, v, do = (t[:, :, r * s:(r + 1) * s].contiguous() for t in (q, k, v, do))
        for op, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            runs = []
            for rep in range(SP["op_reps"] + 1):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                tcol.barrier()
                torch.cuda.synchronize()
                meter.take()
                bytes0 = op_bytes()
                t0 = time.perf_counter()
                o = fn(*leaves, group=meter)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fwd_shifts = meter.take()
                o.backward(do)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                bwd_shifts = meter.take()
                moved = {k_: v_ - bytes0[k_] for k_, v_ in op_bytes().items()}
                runs.append(dict(fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3,
                                 fwd_shift=fwd_shifts, bwd_shift=bwd_shifts, bytes=moved))
                if rep == 0:
                    torch.save({"o": o.detach().cpu(), "dq": leaves[0].grad.cpu(),
                                "dk": leaves[1].grad.cpu(), "dv": leaves[2].grad.cpu()},
                               run_dir / f"sp_{name}_{op}_rank{r}.pt")
                del o, leaves
            ops[f"{name}_{op}"] = runs[1:]  # the first is a warm-up
        del q, k, v, do
    op_launches = _launches(counters)
    torch.cuda.empty_cache()

    cfg = _sp_model_config()
    mesh = tcol.gang_mesh(device, sp=n).bind(r, {"sp": meter})
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model, lora, optimizer = llama_lora.lora_model(cfg, params, lr=SP["lr"], mesh=mesh)
    del params
    tokens = _sp_tokens(torch, cfg, device)
    first = _FirstGradients(tcol.reduce_gradients)
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    steps, losses = [], []
    for t in tokens:
        torch.cuda.synchronize()
        before = _collective_ms(metrics.collective_summary())
        bytes0 = op_bytes()["ring_shift"]
        meter.take()
        t0 = time.perf_counter()
        loss = llama_lora.lora_train_step(model, optimizer, t, first)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = _collective_ms(metrics.collective_summary())
        steps.append(dict(step_ms=ms, shifts=meter.take(),
                          ring_bytes=op_bytes()["ring_shift"] - bytes0,
                          collective_ms={op: after[op] - before.get(op, 0.0) for op in after}))
        losses.append(float(loss))
    launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated()
    torch.save({k: p.detach().cpu() for k, p in lora.items()}, run_dir / f"sp_lora_rank{r}.pt")
    torch.save({"local": first.local, "summed": first.reduced}, run_dir / f"sp_grad_rank{r}.pt")
    train.report({"rank": r, "device": str(device), "ops": ops, "op_launches": op_launches,
                  "steps": steps, "losses": losses, "launches": launches, "peak_bytes": peak})


def _sp_yardsticks(torch):
    """train_sp's one-rank runs in this process: the 4-layer model at
    b=2 x 4096 in bf16 and f32 activations, and each ``SP_OPS`` call's
    one-rank flash_attention with its distance from f32."""
    one_losses, one_grads, one = _sp_one_rank(torch)
    f32_losses, f32_grads, f32 = _sp_one_rank(torch, torch.float32)
    control_f32 = _state_diff(f32, one)[1]
    control_loss = max(abs(a - b) for a, b in zip(f32_losses, one_losses))
    control_grads = _grad_distance(one_grads, f32_grads)
    del f32, f32_grads
    references = {name: _sp_op_reference(torch, b, h, hk, seq) for name, b, h, hk, seq in SP_OPS}
    return dict(one_losses=one_losses, one_grads=one_grads, one=one, f32_losses=f32_losses,
                control_f32=control_f32, control_loss=control_loss,
                control_grads=control_grads, references=references)


def _sp_pair_outputs(torch, run_dir):
    """The sp ranks' saved ops outputs, adapters and first gradients."""
    return dict(
        shards={key: [torch.load(run_dir / f"sp_{key}_rank{r}.pt") for r in range(SP["ranks"])]
                for key in (f"{name}_{op}" for name, *_ in SP_OPS for op in ("ring", "ulysses"))},
        adapters=[torch.load(run_dir / f"sp_lora_rank{r}.pt") for r in range(SP["ranks"])],
        grads=[torch.load(run_dir / f"sp_grad_rank{r}.pt") for r in range(SP["ranks"])])


def train_sp_phase(torch, counters, pair):
    """Sequence parallelism over two gloo ranks sharing the card
    (``train_sp_loop``, in train_fsdp's pair gang, ``pair`` its outputs,
    with the one-rank yardsticks that ran before the gang's fit): (a) ring
    and Ulysses attention against the one-rank ``flash_attention`` on the
    whole sequence, within ``SP_OP_TIMES`` x its own distance from its f32
    plain version; (b) the 4-layer 7B LoRA step with the sequence split
    over the ranks against the in-process one-rank model on the whole
    sequence: the ranks bit-identical; the first step's summed gradients,
    before AdamW, and the losses and adapters within twice the one-rank
    run's distance from itself in f32 activations (gradients leaf by leaf,
    and two planted faults, one rank's gradient alone and the sum sp times
    over, shown to fail that bound); exact K1-K4 launches a step on each
    rank."""
    device = _card(torch)
    t_phase = time.perf_counter()
    pair = pair["sp"]
    y = pair["yardsticks"]
    one_losses, one_grads, one = y["one_losses"], y["one_grads"], y["one"]
    f32_losses, control_f32 = y["f32_losses"], y["control_f32"]
    control_loss, control_grads = y["control_loss"], y["control_grads"]
    references, shards = y["references"], pair["shards"]
    adapters, grads, fit_s = pair["adapters"], pair["grads"], pair["fit_s"]
    reports = sorted(pair["reports"], key=lambda m: m["rank"])
    check([m["rank"] for m in reports] == [0, 1], f"train_sp reports {reports}")
    check(all(m["device"] == str(device) for m in reports), "the sp ranks are not on one card")

    out = {"ops": {}}
    for name, *_ in SP_OPS:
        ref, control = references[name]
        for op in ("ring", "ulysses"):
            key = f"{name}_{op}"
            errs = {}
            for t in ref:
                got = torch.cat([s[t] for s in shards[key]], dim=2)
                check(got.shape == ref[t].shape and got.dtype == ref[t].dtype,
                      f"{key} {t}: {tuple(got.shape)} {got.dtype}")
                errs[t] = (got.float() - ref[t].float()).abs().max().item()
                check(0 < control[t] < float("inf"), f"{key}: one-rank {t} vs f32 {control[t]}")
                check(errs[t] <= SP_OP_TIMES * control[t],
                      f"{key} {t}: {errs[t]} from the one-rank flash_attention > "
                      f"{SP_OP_TIMES} x its distance from f32, {control[t]}")
            runs = [m["ops"][key] for m in reports]
            out["ops"][key] = dict(
                max_abs_err=errs, one_rank_vs_f32=control,
                err_over_control={t: errs[t] / control[t] for t in errs},
                bit_for_bit=not any(errs.values()),
                fwd_ms=[[x["fwd_ms"] for x in rr] for rr in runs],
                bwd_ms=[[x["bwd_ms"] for x in rr] for rr in runs],
                bytes_per_rank=runs[0][0]["bytes"],
                shift_fwd=[rr[-1]["fwd_shift"] for rr in runs],
                shift_bwd=[rr[-1]["bwd_shift"] for rr in runs])
    del references, shards

    for k, a in adapters[0].items():
        check(torch.equal(a, adapters[1][k]), f"the sp ranks' {k} differ")
    check(reports[0]["losses"] == reports[1]["losses"], "the sp ranks report other losses")
    for k, g in grads[0]["summed"].items():
        check(torch.equal(g, grads[1]["summed"][k]), f"the sp ranks' summed {k} gradients differ")
    # the first step's summed gradients, held before AdamW moves anything
    # (Adam is nearly blind to a gradient's scale and lora_b starts at 0, so
    # the adapters alone cannot show a wrong gradient): leaf by leaf within
    # twice the one-rank run's distance from itself in f32 activations (the
    # adapters' reasoning below). Two planted faults must fail that bound,
    # or it could not tell a wrong gradient: rank 0's gradient alone (no sum
    # over the group), and the sum sp times over (the scale of a loss
    # all-reduced with its cotangent)
    def grads_within(got):
        dist = _grad_distance(got, one_grads)
        return dist, all(dist[k] <= 2 * control_grads[k] for k in dist)

    grad_dist, grads_ok = grads_within(grads[0]["summed"])
    check(grads_ok, f"the sp pair's first summed gradients part from one rank by {grad_dist} "
                    f"> 2 x {control_grads}")
    planted = {"rank0_alone": grads[0]["local"],
               "summed_times_sp": {k: g * SP["ranks"] for k, g in grads[0]["summed"].items()}}
    planted_dist = {}
    for fault, got in planted.items():
        planted_dist[fault], fault_ok = grads_within(got)
        check(not fault_ok, f"the gradient check passes the planted fault {fault}: "
                            f"{planted_dist[fault]} within 2 x {control_grads}")
    abs_err, rel_err = _state_diff(adapters[0], one)
    loss_diff = max(abs(a - b) for a, b in zip(reports[0]["losses"], one_losses))
    # the split regroups attention's sums (a merge and a bf16 sum of two
    # blocks' gradients a hop) where f32 activations undo every bf16
    # rounding of the 4 layers; 3 AdamW steps carry either alike, so the
    # pair stays within twice the one-rank run's distance from itself in
    # f32 activations (twice: room for the spread of a largest error)
    check(rel_err <= 2 * control_f32,
          f"the sp pair's adapters part from one rank by {rel_err} > 2 x {control_f32}")
    check(loss_diff <= 2 * control_loss,
          f"the sp pair's losses part from one rank by {loss_diff} > 2 x {control_loss}")
    n_layers, steps = SP["n_layers"], SP["steps"]
    # a layer's ring moves, a rank: its K/V shard twice forward (the remat
    # recompute), the packet (q, dO, dQ and the f32 lse and delta) once and
    # dQ home once backward
    cfg = _sp_model_config()
    rows_ = SP["batch"] * cfg.n_heads * (SP["seq"] // SP["ranks"])
    shard = rows_ * cfg.head_dim * 2
    ring_bytes = n_layers * (2 * 2 * shard + (3 * shard + 2 * 4 * rows_) + shard)
    for m in reports:
        for st in m["steps"]:
            check(st["ring_bytes"] == ring_bytes,
                  f"rank {m['rank']} shifted {st['ring_bytes']} B in a step, want {ring_bytes}")
    launches = {name: 0 for name in counters}
    for m in reports:
        r = m["rank"]
        want = {"rmsnorm_fwd": 4 * n_layers + 1, "flash_attention_fwd": 2 * n_layers * (r + 1),
                "flash_bwd_dq": n_layers * (2 - r), "flash_bwd_dkv": n_layers * (2 - r)}
        check(m["launches"] == {k: v * steps for k, v in want.items()},
              f"rank {r} launches {m['launches']} in {steps} steps, want {want} a step")
        for name in counters:
            launches[name] += m["launches"][name]
    out["ops"]["launches_per_rank"] = [m["op_launches"] for m in reports]
    grad_ratio = {k: d / control_grads[k] for k, d in grad_dist.items() if control_grads[k]}
    out["model"] = dict(
        fit_s=fit_s, losses=reports[0]["losses"], losses_one_rank=one_losses,
        losses_f32_activations=f32_losses, loss_diff=loss_diff, loss_bound=2 * control_loss,
        adapter_rel_err=rel_err, adapter_abs_err=abs_err, adapter_bound=2 * control_f32,
        first_grad_dist=grad_dist, first_grad_bound={k: 2 * c for k, c in control_grads.items()},
        first_grad_over_control=max(grad_ratio.values()),
        planted_over_control={f: min(d[k] / control_grads[k] for k in grad_ratio)
                              for f, d in planted_dist.items()},
        launches_per_rank=[m["launches"] for m in reports],
        step_ms=[[s["step_ms"] for s in m["steps"]] for m in reports],
        ring_bytes_per_step=[m["steps"][-1]["ring_bytes"] for m in reports],
        shifts_per_step=[m["steps"][-1]["shifts"] for m in reports],
        collective_ms_per_step=[m["steps"][-1]["collective_ms"] for m in reports],
        collective_host_share=[[sum(s["collective_ms"].values()) / s["step_ms"]
                                for s in m["steps"]] for m in reports],
        peak_bytes=[m["peak_bytes"] for m in reports])
    out["phase_s"] = time.perf_counter() - t_phase
    print("train_sp", json.dumps(out))
    return launches, out


def resnet_macs(cfg, size: int) -> int:
    """Multiply-adds of one image's ResNet forward: convolutions (the
    bottleneck's 1x1 conv1 at the block's input size, conv2 and the
    projection at its stride) and the head."""
    s = -(-size // 2)  # the stem, stride 2
    macs = s * s * cfg.width * 3 * 49
    s = (s - 1) // 2 + 1  # max pool 3x3, stride 2, pad 1
    in_ch = cfg.width
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        f = cfg.width * 2 ** stage
        for block in range(n_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            out = -(-s // stride)
            macs += s * s * in_ch * f + out * out * (9 * f * f + 4 * f * f)
            if in_ch != 4 * f or stride != 1:
                macs += out * out * in_ch * 4 * f
            in_ch, s = 4 * f, out
    return macs + in_ch * cfg.num_classes


# device-time groups of a vision step's profile, by parts of kernel symbols
VISION_GROUPS = {
    "flash_attention": ("flash_fwd_", "flash_bwd_"),
    "pooling": ("pool",),
    "convolutions": ("conv", "xmma", "fprop", "dgrad", "wgrad", "cudnn", "implicit_gemm", "nhwc",
                     "nchw"),
    "gemms": ("nvjet", "gemm", "cutlass"),
    "reductions": ("reduce", "norm"),
    "elementwise": ("elementwise", "copy"),
}


def resnet_parity(torch):
    """Card vs host at full ResNet-50 width, 4 images at 96x96 (the last
    stage 3x3, 36 values a channel), TF32 off. In f32: train-mode logits
    and the updated running statistics against an f64 host run, within 4x
    the f32 host run's own error (``_control_check``). The gradients are
    held in f64: in f32 those of the early layers sit 1e-2 to 1e-1 from f64
    on the host itself (BatchNorm's backward cancels across a small batch,
    in 53 norms in a row), which would hide a fault. In f64 only the head
    rounds to f32 (``nn.Dense(dtype=float32)`` in the reference), which
    leaves the host 8.5e-8 from itself with the batch in another order.
    Card f64 against host f64: logits, statistics and six gradients within
    1e-5 of each tensor's largest value, 100x that floor and 1,000x below
    the f32 errors."""
    from ray_tpu_torch.models import resnet as R

    cfg = R.ResNetConfig.resnet50(dtype=torch.float32)
    g = torch.Generator().manual_seed(SEED + 5)
    params, stats = R.init_train_state(cfg, g, "cpu")
    for k, p in params.items():  # bn3's zero scale would silence every block
        if k.endswith("scale"):
            p.uniform_(0.5, 1.5, generator=g)
        elif k.endswith("bias"):
            p.normal_(0.0, 0.1, generator=g)
    images = torch.randn(4, 96, 96, 3, generator=g)
    labels = torch.tensor([3, 7, 500, 999])
    names = ["stem_conv.kernel", "stage0_block0.conv2.kernel", "stage1_block0.proj_conv.kernel",
             "stage2_block5.bn2.scale", "stage3_block2.conv3.kernel", "head.kernel"]

    def run(device, dtype):
        c = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        p = {k: v.to(device, dtype).requires_grad_(True) for k, v in params.items()}
        st = {k: v.to(device, dtype) for k, v in stats.items()}
        logits, new = R.apply_train(c, p, st, images.to(device, dtype))
        grads = torch.autograd.grad(R.cross_entropy(logits, labels.to(device)),
                                    [p[n] for n in names])
        return {"logits": logits}, new, dict(zip(names, grads))

    f32, f64 = torch.float32, torch.float64
    runs = {key: run(*key) for key in (("cuda", f32), ("cpu", f32), ("cuda", f64), ("cpu", f64))}
    truth = runs[("cpu", f64)]

    def errs(run, i):
        return {k: _rel_err(runs[run][i][k], truth[i][k]) for k in truth[i]}

    out = {}
    for i, what in enumerate(("logits", "stats")):
        out[what] = _control_check(f"resnet parity {what}", errs(("cuda", f32), i),
                                   max(errs(("cpu", f32), i).values()))
    f64_err = max(max(errs(("cuda", f64), i).values()) for i in range(3))
    check(f64_err <= 1e-5, f"resnet parity f64: card vs host rel err {f64_err} > 1e-5")
    out["f64"] = dict(max_rel_err=f64_err, tol=1e-5,
                      grads_f32_host_rel_err=max(errs(("cpu", f32), 2).values()),
                      grads_f32_card_rel_err=max(errs(("cuda", f32), 2).values()))
    return out


def train_resnet_phase(torch, counters):
    """ResNet-50 at 224 through DataParallelTrainer.fit() (batch 256, 3
    steps), then warm steps of the same loop body, a profile of one step and
    the f32 card-vs-host parity at full width. No kernel of the port runs on
    this path: K1-K4 must be launched 0 times."""
    import math
    import os
    import tempfile

    from ray_tpu_torch.train.examples import resnet as example

    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_") as storage:
        os.environ["RAY_TPU_STORAGE_PATH"] = storage
        try:
            t0 = time.perf_counter()
            result = example.make_trainer(train_config=dict(RESNET_CONFIG)).fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        finally:
            del os.environ["RAY_TPU_STORAGE_PATH"]
    if result.error is not None:
        raise result.error
    fit_peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in result.metrics_history]
    check(len(losses) == RESNET_CONFIG["epochs"] and all(math.isfinite(x) for x in losses),
          f"bad resnet losses {losses}")

    cfg, size = example.model_config(RESNET_CONFIG)
    b = RESNET_CONFIG["batch_per_worker"]
    device = torch.device("cuda", torch.cuda.current_device())
    model, optimizer = example.sgd_model(cfg, device)
    images, labels = example.step_batch(cfg, b, size, 0, 0, 0, device)
    start = {k: v.clone() for k, v in model.batch_stats().items()}
    losses_timed = []

    def step():
        losses_timed.append(example.train_step(model, optimizer, images, labels))

    step_ms, step_peak = _timed_steps(torch, step, VISION_STEPS)
    check(all(math.isfinite(x.item()) for x in losses_timed), "non-finite resnet loss")
    moved = max((v - start[k]).abs().max().item() for k, v in model.batch_stats().items())
    check(moved > 0, "the running statistics did not move")
    check(model.stem_conv.kernel.is_contiguous(memory_format=torch.channels_last),
          "the conv kernels are not channels_last")
    prof = device_profile(torch, step, groups=VISION_GROUPS)
    launches = _launches(counters)
    check(all(n == 0 for n in launches.values()), f"port kernels launched on ResNet: {launches}")
    del model, optimizer, images, labels
    torch.cuda.empty_cache()
    parity = resnet_parity(torch)
    med = statistics.median(step_ms)
    macs = resnet_macs(cfg, size)
    out = dict(fit_s=fit_s, losses=losses, launches=launches, batch=b, image_size=size,
               step_ms=step_ms, step_ms_median=med, images_per_s=b / med * 1e3,
               fit_peak_bytes=fit_peak, step_peak_bytes=step_peak, stats_moved_max=moved,
               forward_gmac_per_image=macs / 1e9,
               trained_gflop_per_image=6 * macs / 1e9,  # forward 2, backward 4 per MAC
               tflop_s=6 * macs * b / med / 1e9, profile=prof, parity=parity)
    print("train_resnet", json.dumps(out))
    return launches, out


# -- data-parallel ResNet with sync-BN (``train_resnet_dp``) ------------------

#: ResNet-50: 53 BatchNorms over 26,560 channels, 25,557,032 parameters (f32)
RESNET_BNS, RESNET_BN_CHANNELS, RESNET_PARAMS = 53, 26_560, 25_557_032
#: (b): two gloo ranks sharing the card, each half of the b=256 batch
RESNET_GLOO = {"ranks": 2, "batch": RESNET_CONFIG["batch_per_worker"] // 2}


def _resnet_batches(torch, device):
    """The main path's batches of epoch 0 at rank 0: b=256 at 224, one a
    step."""
    from ray_tpu_torch.train.examples import resnet as example

    cfg, size = example.model_config(RESNET_CONFIG)
    return [example.step_batch(cfg, RESNET_CONFIG["batch_per_worker"], size, 0, s, 0, device)
            for s in range(RESNET_CONFIG["steps_per_epoch"])]


def _resnet_steps(torch, device, batches, group=None, reduce=None, rows=slice(None),
                  dtype=None):
    """A fresh seed-0 ResNet-50 (sync-BN over ``group``) after one SGD step
    on ``rows`` of each batch: its parameters and running statistics on the
    host, and the losses."""
    from ray_tpu_torch.train.examples import resnet as example

    cfg, _ = example.model_config(RESNET_CONFIG)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model, optimizer = example.sgd_model(cfg, device, group=group)
    losses = [example.train_step(model, optimizer, images[rows], labels[rows], reduce)
              for images, labels in batches]
    state = {k: p.detach().cpu() for k, p in model.named_parameters()}
    state.update({k: v.cpu() for k, v in model.batch_stats().items()})
    return state, [x.item() for x in losses]


def _grad_distance(got, want):
    """Per gradient, the norm of ``got - want`` (in f64)."""
    assert sorted(got) == sorted(want)
    return {k: (got[k].double() - want[k].double()).norm().item() for k in want}


def _state_diff(got, want):
    """(largest |got - want|, largest relative error per tensor: that
    difference over the tensor's largest |value|), over every tensor."""
    assert sorted(got) == sorted(want)
    abs_err = max((got[k].double() - want[k].double()).abs().max().item() for k in want)
    rel_err = max(((got[k].double() - want[k].double()).abs().max()
                   / want[k].double().abs().max().clamp_min(1e-30)).item() for k in want)
    return abs_err, rel_err


def _collective_totals(metrics):
    """This process's allreduce count, bytes and ms so far."""
    ar = metrics.collective_summary().get("allreduce", {})
    return dict(count=ar.get("count", 0), bytes=ar.get("bytes", 0),
                ms=ar.get("count", 0) * ar.get("mean_ms", 0))


def _totals_delta(after, before):
    return {k: after[k] - before[k] for k in after}


def train_resnet_dp_loop(config):
    """(a)'s worker (and ``chip_multicard.py`` part 4's): the example's own
    loop (the main path, this process's K1-K4 counts around it), then 3
    steps of a fresh model on the main path's batches (rank 0 writes its
    state beside the run for the parent), one step's collectives, and
    timed steps."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.train.examples import resnet as example
    from ray_tpu_torch.util import metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _port_counters()
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    example.train_loop_per_worker(config)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launches(counters)
    peak = torch.cuda.max_memory_allocated()

    ctx = train.get_context()
    device = torch.device("cuda", torch.cuda.current_device())
    reduce = tcol.DataParallelMean(ctx.world_size)
    batches = _resnet_batches(torch, device)
    state, losses = _resnet_steps(torch, device, batches, tcol.tensor_group(), reduce)
    if ctx.world_rank == 0:
        torch.save(state, Path(ctx.get_storage_path()) / "resnet_dp_state.pt")
    del state
    cfg, _ = example.model_config(config)
    model, optimizer = example.sgd_model(cfg, device, group=tcol.tensor_group())
    n_params = sum(p.numel() for p in model.parameters())

    def step():
        example.train_step(model, optimizer, *batches[0], reduce)

    step()
    torch.cuda.synchronize()
    before = _collective_totals(metrics)
    step()
    torch.cuda.synchronize()
    one = _totals_delta(_collective_totals(metrics), before)
    buckets = tcol.gradient_scheduler()._bucketizer.buckets
    step_ms, step_peak = _timed_steps(torch, step, VISION_STEPS)
    train.report({"resnet_dp": dict(
        fit_s=fit_s, launches=launches, peak_bytes=peak, losses=losses, params=n_params,
        step_collectives=one, buckets=[[len(b.paths), b.nbytes, b.dtype] for b in buckets],
        step_ms=step_ms, step_peak_bytes=step_peak)})


def train_resnet_dp_gloo_loop(config):
    """(b)'s worker: one rank of two sharing the card over gloo, 3 steps of
    a fresh sync-BN model on its half of each of the main path's b=256
    batches (``process_local_batch`` of a dp mesh), each timed with its
    collectives; its state written beside the run."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel.sharding import process_local_batch
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.train.examples import resnet as example
    from ray_tpu_torch.util import metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _port_counters()
    _zero(counters)
    ctx = train.get_context()
    r, b = ctx.world_rank, RESNET_GLOO["batch"]
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = tcol.gang_mesh(device, dp=ctx.world_size)
    cfg, _ = example.model_config(RESNET_CONFIG)
    model, optimizer = example.sgd_model(cfg, device, group=tcol.tensor_group())
    reduce = tcol.DataParallelMean(ctx.world_size)
    torch.cuda.reset_peak_memory_stats()
    rows, losses = [], []
    for images, labels in _resnet_batches(torch, device):
        images = process_local_batch(mesh, images[r * b:(r + 1) * b])
        labels = process_local_batch(mesh, labels[r * b:(r + 1) * b])
        torch.cuda.synchronize()
        before = _collective_totals(metrics)
        t0 = time.perf_counter()
        loss = example.train_step(model, optimizer, images, labels, reduce)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict(step_ms=ms, collectives=_totals_delta(_collective_totals(metrics), before)))
        losses.append(tcol.gang_mean(loss))
    state = {k: p.detach().cpu() for k, p in model.named_parameters()}
    state.update({k: v.cpu() for k, v in model.batch_stats().items()})
    torch.save(state, Path(ctx.get_storage_path()) / f"resnet_gloo_rank{r}.pt")
    train.report({"resnet_gloo": True, "rank": r, "device": str(device), "steps": rows,
                  "losses": losses, "launches": _launches(counters),
                  "peak_bytes": torch.cuda.max_memory_allocated()})


def _resnet_yardsticks(torch):
    """train_resnet_dp's in-process runs (3 steps at b=256): the run, again
    (the bound of (a)), and for (b) the halves of each batch swapped and the
    whole run in f32 activations (every output's bf16 rounding undone)."""
    device = torch.device("cuda", torch.cuda.current_device())
    batches = _resnet_batches(torch, device)
    one, one_losses = _resnet_steps(torch, device, batches)
    again, _ = _resnet_steps(torch, device, batches)
    bound = _state_diff(again, one)[0]
    swapped = [(torch.cat([i[128:], i[:128]]), torch.cat([l[128:], l[:128]])) for i, l in batches]
    control_swap = _state_diff(_resnet_steps(torch, device, swapped)[0], one)[1]
    control_f32 = _state_diff(_resnet_steps(torch, device, batches, dtype=torch.float32)[0],
                              one)[1]
    del batches, swapped, again
    torch.cuda.empty_cache()
    return dict(one=one, one_losses=one_losses, bound=bound, control_swap=control_swap,
                control_f32=control_f32)


def train_resnet_dp_phase(torch, counters, resnet_out, pair):
    """Sync-BN data parallelism of ResNet-50: (a) a spawned NCCL worker at
    world size 1 (b=256) against the in-process run, bit for bit or within
    the spread of two in-process runs; (b) two gloo ranks sharing the card
    at b=128 each (in train_fsdp's pair gang; ``pair`` its outputs, with the
    in-process yardsticks that ran before that gang's fit) against one rank
    at b=256."""
    import multiprocessing
    import tempfile

    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig, TorchConfig

    device = torch.device("cuda", torch.cuda.current_device())
    y = pair["yardsticks"]
    one, one_losses, bound = y["one"], y["one_losses"], y["bound"]
    control_swap, control_f32 = y["control_swap"], y["control_f32"]

    def fit(loop, storage, name, **kw):
        result = DataParallelTrainer(
            loop, train_loop_config=dict(RESNET_CONFIG),
            run_config=RunConfig(name=name, storage_path=storage), **kw).fit()
        if result.error is not None:
            raise result.error
        return result, Path(storage) / name

    _zero(counters)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_dp_") as storage:
        t0 = time.perf_counter()
        result, run_dir = fit(train_resnet_dp_loop, storage, "resnet-dp",
                              scaling_config=ScalingConfig(num_workers=1),
                              backend_config=TorchConfig(backend="nccl"), overlap=True)
        fit_s = time.perf_counter() - t0
        worker = torch.load(run_dir / "resnet_dp_state.pt")
    check(not multiprocessing.active_children(), "the worker group left a process")
    stats = next(m["resnet_dp"] for m in result.metrics_history if "resnet_dp" in m)
    diff = _state_diff(worker, one)[0]
    check(diff <= bound, f"the NCCL worker's state parts from in-process by {diff} > {bound}")
    check(stats["params"] == RESNET_PARAMS, f"{stats['params']} parameters")
    grad_bytes = sum(b[1] for b in stats["buckets"])
    check(grad_bytes == 4 * RESNET_PARAMS, f"gradient buckets of {grad_bytes} B")
    ops = stats["step_collectives"]
    bn_ops = ops["count"] - len(stats["buckets"])
    bn_bytes = 2 * 2 * RESNET_BN_CHANNELS * 4  # [mean, mean of squares] f32, forward and backward
    check(bn_ops == 2 * RESNET_BNS, f"{bn_ops} sync-BN allreduces a step, want {2 * RESNET_BNS}")
    check(ops["bytes"] == grad_bytes + bn_bytes,
          f"a step's allreduce bytes {ops['bytes']}, want {grad_bytes} + {bn_bytes}")
    check(not any(stats["launches"].values()), f"port kernels on ResNet: {stats['launches']}")
    losses = [m["loss"] for m in result.metrics_history if "loss" in m]
    med = statistics.median(stats["step_ms"])
    out["nccl_worker"] = dict(
        fit_s=fit_s, worker_fit_s=stats["fit_s"], losses=losses, state_diff=diff,
        bound=bound, bit_for_bit=diff == 0, sync_bn_ops_per_step=bn_ops,
        sync_bn_bytes_per_step=bn_bytes, gradient_bytes_per_step=grad_bytes,
        buckets=len(stats["buckets"]), step_ms=stats["step_ms"], step_ms_median=med,
        in_process_step_ms_median=resnet_out["step_ms_median"],
        images_per_s=RESNET_CONFIG["batch_per_worker"] / med * 1e3,
        peak_bytes=stats["peak_bytes"], step_peak_bytes=stats["step_peak_bytes"])
    launches = dict(stats["launches"])

    fit_s, ranks = pair["fit_s"], pair["ranks"]
    reports = sorted(pair["reports"], key=lambda m: m["rank"])
    check([m["rank"] for m in reports] == [0, 1], f"gloo reports {reports}")
    check(all(m["device"] == str(device) for m in reports), "the gloo ranks are not on one card")
    for k, v in ranks[0].items():
        check(torch.equal(v, ranks[1][k]), f"the gloo ranks' {k} differ")
    check(reports[0]["losses"] == reports[1]["losses"], "the gloo ranks report other losses")
    abs_err, rel_err = _state_diff(ranks[0], one)
    # the split regroups the batch's sums and runs each half's convolutions
    # on their own: a rounding-level change of some outputs, where the f32
    # yardstick changes every output by its bf16 rounding. Three SGD steps
    # amplify either alike, so the pair stays within twice the distance of
    # the b=256 run from itself in f32 activations (twice: room for the
    # spread of a largest error over 267 tensors)
    check(rel_err <= 2 * control_f32,
          f"the gloo pair parts from one rank at b=256 by {rel_err} > 2 x {control_f32}")
    for m in reports:
        for name, n in m["launches"].items():
            launches[name] += n
    steps = reports[0]["steps"]
    out["gloo_shared_card"] = dict(
        pair_gang_fit_s=fit_s, rel_err=rel_err, abs_err=abs_err, bound=2 * control_f32,
        f32_activations=control_f32,
        control_swapped_halves=control_swap, losses=reports[0]["losses"],
        losses_one_rank=one_losses, step_ms=[[s["step_ms"] for s in m["steps"]] for m in reports],
        # the ops' host clocks summed (a BatchNorm's waits for the other
        # rank; the buckets' reduce on the dispatcher thread, under the step)
        collective_host_share=[[s["collectives"]["ms"] / s["step_ms"] for s in m["steps"]]
                               for m in reports],
        collective_ops_per_step=steps[-1]["collectives"]["count"],
        collective_bytes_per_step=steps[-1]["collectives"]["bytes"],
        peak_bytes=[m["peak_bytes"] for m in reports])
    print("train_resnet_dp", json.dumps(out))
    return launches, out


def vit_macs(cfg) -> int:
    """Multiply-adds of one image's ViT forward: the patch embedding, per
    layer the four projections, the MLP and the two attention products, and
    the head."""
    s, dim, p = cfg.num_patches + 1, cfg.dim, cfg.patch_size
    per_layer = 4 * s * dim * dim + 2 * s * dim * cfg.mlp_dim + 2 * s * s * dim
    return cfg.num_patches * dim * 3 * p * p + cfg.n_layers * per_layer + dim * cfg.num_classes


def _vit_randomise(torch, params, g):
    """Random values for the zero-start head and cls_token and the biases:
    at init every logit is 0 and a comparison proves nothing."""
    for k, p in params.items():
        if k in ("head", "cls_token"):
            p.normal_(0.0, 0.05, generator=g)
        elif k.endswith("bias"):
            p.normal_(0.0, 0.1, generator=g)


def vit_parity(torch):
    """Card vs host, 2 layers at ViT-B/16 width (head_dim 64) in f32: logits
    and every gradient of ``classification_loss`` against an f64 host run,
    within 4x the f32 host run's own error (``_control_check``). The keys'
    bias is left out: softmax cancels it, so its true gradient is 0 and
    both sides hold rounding noise."""
    from ray_tpu_torch.models import vit as V

    cfg = V.ViTConfig.base(n_layers=2, dtype=torch.float32)
    g = torch.Generator().manual_seed(SEED + 6)
    params = V.init_params(cfg, g, "cpu")
    _vit_randomise(torch, params, g)
    images = torch.randn(2, cfg.image_size, cfg.image_size, 3, generator=g)
    labels = torch.tensor([3, 7])

    def run(device, dtype):
        c = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        model = V.build_vit(c, {k: v.to(device, dtype) for k, v in params.items()})
        x = images.to(device, dtype)
        logits = model(x)
        V.classification_loss(c, None, model, x, labels.to(device)).backward()
        return logits, {n: p.grad for n, p in model.named_parameters()
                        if not n.endswith("wk.bias")}

    runs = {key: run(*key) for key in (("cuda", torch.float32), ("cpu", torch.float32),
                                       ("cpu", torch.float64))}
    truth = runs[("cpu", torch.float64)]
    out = {}
    for i, what in enumerate(("logits", "grads")):
        def errs(run):
            got = runs[run][i]
            if what == "logits":
                return {"logits": _rel_err(got, truth[0])}
            return {k: _rel_err(got[k], truth[1][k]) for k in truth[1]}

        out[what] = _control_check(f"vit parity {what}", errs(("cuda", torch.float32)),
                                   max(errs(("cpu", torch.float32)).values()))
    return out


def train_vit_phase(torch, counters):
    """ViT-B/16 at 224, batch 128, bf16 activations over f32 parameters,
    AdamW (optax's defaults): exact launches of K1-K4 per step with and
    without remat, remat-invariant loss and gradients, warm steps, a
    profile of one step and the f32 card-vs-host parity at 2 layers."""
    import math

    from ray_tpu_torch.models import vit as V

    _zero(counters)
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = V.ViTConfig.base()
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    params = V.init_params(cfg, g, device)
    _vit_randomise(torch, params, g)
    images = torch.randn(VIT_BATCH, cfg.image_size, cfg.image_size, 3, generator=g,
                         device=device)
    labels = torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=g, device=device)

    # one loss and backward per remat setting on the same parameters and
    # inputs: the launches of each, and the gradients of both
    grads, loss, per_step = {}, {}, {}
    n = cfg.n_layers
    want = {False: {"rmsnorm_fwd": 0, "flash_attention_fwd": n, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n},
            True: {"rmsnorm_fwd": 0, "flash_attention_fwd": 2 * n, "flash_bwd_dq": n,
                   "flash_bwd_dkv": n}}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = V.build_vit(c, {k: v.clone() for k, v in params.items()})
        before = _launches(counters)
        l = V.classification_loss(c, None, model, images, labels)
        l.backward()
        torch.cuda.synchronize()
        per_step[remat] = {k: v - before[k] for k, v in _launches(counters).items()}
        check(per_step[remat] == want[remat],
              f"ViT step launches with remat={remat}: {per_step[remat]}, want {want[remat]}")
        loss[remat] = l.item()
        grads[remat] = {k: p.grad for k, p in model.named_parameters()}
        del model
    check(math.isfinite(loss[False]), f"non-finite ViT loss {loss[False]}")
    # remat recomputes each block from its saved input with the same
    # kernels, so loss and gradients agree to the last bits; a wrong
    # recompute would move them by O(1) of their size. Tolerance: 1e-6 of
    # the loss, 1e-3 of each tensor's largest gradient.
    loss_rel = abs(loss[True] - loss[False]) / abs(loss[False])
    check(loss_rel <= 1e-6, f"ViT loss remat {loss[True]} vs no remat {loss[False]}")
    remat_err = max(_rel_err(grads[True][k], grads[False][k]) for k in grads[False]
                    if not k.endswith("wk.bias"))
    check(remat_err <= 1e-3, f"ViT gradients remat vs no remat: rel err {remat_err} > 1e-3")
    del grads
    torch.cuda.empty_cache()

    # the timed loop: remat off, AdamW with optax's defaults (weight decay
    # 1e-4, as llama_lora.py)
    model = V.build_vit(cfg, {k: v.clone() for k, v in params.items()})
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = V.classification_loss(cfg, None, model, images, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    losses = []
    step_ms, step_peak = _timed_steps(torch, lambda: losses.append(step()), VISION_STEPS)
    check(all(math.isfinite(x.item()) for x in losses), "non-finite ViT loss in the timed steps")
    before = _launches(counters)
    prof = device_profile(torch, step, groups=VISION_GROUPS)
    for name, per in want[False].items():
        got = prof["port_kernels"][name]["launches"]
        check(got == per, f"{name}: {got} launches in the ViT step profile, want {per}")
        runs = prof["profile_attempts"]
        check(counters[name].launches - before[name] == per * runs,
              f"{name}: {counters[name].launches - before[name]} launches in {runs} profiled "
              f"steps, want {per * runs}")
    port_ms = sum(prof["port_kernels"][k]["ms"] for k in ("flash_attention_fwd", "flash_bwd_dq",
                                                          "flash_bwd_dkv"))
    launches = _launches(counters)
    del model, optimizer, step
    torch.cuda.empty_cache()
    parity = vit_parity(torch)
    med = statistics.median(step_ms)
    macs = vit_macs(cfg)
    out = dict(batch=VIT_BATCH, seq=cfg.num_patches + 1, head_dim=cfg.head_dim,
               launches_per_step=per_step[False], launches_per_step_remat=per_step[True],
               loss=loss[False], loss_remat_rel_err=loss_rel, grads_remat_rel_err=remat_err,
               step_ms=step_ms, step_ms_median=med, images_per_s=VIT_BATCH / med * 1e3,
               step_peak_bytes=step_peak, forward_gmac_per_image=macs / 1e9,
               trained_gflop_per_image=6 * macs / 1e9, tflop_s=6 * macs * VIT_BATCH / med / 1e9,
               flash_ms_in_step=port_ms,
               flash_share_of_busy=(port_ms / prof["device_busy_ms"]
                                    if prof["device_busy_ms"] else None),
               launches=launches, profile=prof, parity=parity)
    print("train_vit", json.dumps(out))
    return launches, out


def ppo_parity(torch, np):
    """One PPOLearner update (512 rows, 4 epochs of 4 minibatches, the same
    injected permutations) on the card and on the host, both f32 with TF32
    off, for a discrete and a Gaussian head, from the same initial weights.
    Each run's parameter change and stats are held against an f64 host run
    of the same update; the card's f32 errors within 4x the host's own
    (``_control_check``)."""
    from ray_tpu_torch.rllib.learner import STAT_KEYS, PPOLearner

    out = {}
    for head, (obs_dim, action_dim, discrete) in PPO_PARITY_HEADS.items():
        rng = np.random.default_rng(SEED)
        B = PPO_PARITY_ROWS
        batch = {
            "obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
            "actions": (rng.integers(0, action_dim, B) if discrete
                        else rng.standard_normal((B, action_dim)).astype(np.float32)),
            "logp_old": (rng.standard_normal(B) - 1.0).astype(np.float32),
            "advantages": rng.standard_normal(B).astype(np.float32),
            "returns": rng.standard_normal(B).astype(np.float32),
        }
        perms = np.stack([rng.permutation(B) for _ in range(4)])
        runs = {}
        for name, device, dtype in (("card", "cuda", torch.float32),
                                    ("host", "cpu", torch.float32),
                                    ("f64", "cpu", torch.float64)):
            learner = PPOLearner(obs_dim, action_dim, discrete, num_epochs=4,
                                 minibatch_size=128, seed=SEED, device=device)
            state = learner.state_dict()
            cast = {k: v.to(dtype) for k, v in state["params"].items()}
            learner.load_state_dict({"params": cast, "opt_state": {
                "mu": {k: torch.zeros_like(v) for k, v in cast.items()},
                "nu": {k: torch.zeros_like(v) for k, v in cast.items()}, "count": 0}})
            stats = learner.update(batch, perms=perms)
            check(all(p.device.type == device and p.dtype == dtype
                      for p in learner.model.parameters()),
                  f"ppo parity {head}: the {name} learner's parameters left {device} {dtype}")
            delta = {k: p.double() - cast[k].double() for k, p in learner.get_params().items()}
            runs[name] = (delta, torch.tensor([stats[k] for k in STAT_KEYS]))
        card_vs_host = max(_rel_err(v, runs["host"][0][k]) for k, v in runs["card"][0].items())

        def errs(name):
            delta, stats = runs[name]
            e = {k: _rel_err(v, runs["f64"][0][k]) for k, v in delta.items()}
            e["stats"] = _rel_err(stats, runs["f64"][1])
            return e

        out[head] = dict(_control_check(f"ppo parity {head}", errs("card"),
                                        max(errs("host").values())),
                         card_vs_host_rel_err=card_vs_host)
    return out


def train_ppo_phase(torch, np, counters):
    """RLlib PPO on CartPole through PPOConfig(...).build().train(): (a) the
    repo's defaults for 3 iterations, the learner on the card and the
    runners' policies on the host, and a save/restore round trip; (b)
    upstream RLlib PPO's documented batch (4,096 rows, minibatch 128, 30
    epochs), one warm and 1 timed iteration and a profile of one learner
    update; (c) card-vs-host parity of one update. K1-K4 must be launched 0
    times."""
    import math
    import tempfile

    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.learner import STAT_KEYS
    from ray_tpu_torch.util import metrics

    def config(envs, **training):
        return (rllib.PPOConfig().environment(rllib.CartPoleEnv)
                .env_runners(num_env_runners=2, num_envs_per_env_runner=envs,
                             rollout_fragment_length=64)
                .training(**training).debugging(seed=SEED))

    def finite(result):
        return all(math.isfinite(result[k]) for k in STAT_KEYS)

    _zero(counters)
    # (a) the repo's defaults: 2 runners x 4 envs x 64 steps, minibatch 128,
    # 4 epochs
    algo = config(PPO_DEFAULT_ENVS).build()
    results = [algo.train() for _ in range(3)]
    check(all(finite(r) for r in results), f"non-finite PPO stats {results}")
    card = torch.device("cuda", torch.cuda.current_device())
    on_card = [p.device == card for p in algo.learner.model.parameters()]
    on_card += [t.device == card for m in ("mu", "nu") for t in algo.learner.opt_state[m].values()]
    check(all(on_card), "the PPO learner's parameters or Adam moments are not on the card")
    check(all(p.device.type == "cpu" for r in algo.runners for p in r.model.parameters()),
          "a runner's policy is not on the host")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ppo_") as ckpt:
        algo.save(ckpt)
        fresh = config(PPO_DEFAULT_ENVS).build()
        fresh.restore(ckpt)
    want, got = algo.learner.state_dict(), fresh.learner.state_dict()
    same = [torch.equal(got["params"][k], v) for k, v in want["params"].items()]
    same += [torch.equal(got["opt_state"][m][k], v) for m in ("mu", "nu")
             for k, v in want["opt_state"][m].items()]
    check(all(same) and fresh.iteration == algo.iteration == 3
          and got["opt_state"]["count"] == want["opt_state"]["count"],
          "PPO save/restore did not give the same learner state")
    check(fresh.learner.model.Dense_0.kernel.device == card, "a restored learner left the card")
    algo.stop()
    fresh.stop()
    defaults = dict(rows=results[0]["num_env_steps_sampled"],
                    episode_return_mean=[r["episode_return_mean"] for r in results],
                    iteration_s=[r["time_this_iter_s"] for r in results])

    # (b) upstream RLlib PPO's batch: train_batch_size 4000 -> 2 x 32 x 64 =
    # 4,096 rows, minibatch 128, 30 epochs: 960 minibatch updates
    algo = config(PPO_UPSTREAM["envs"], num_epochs=PPO_UPSTREAM["num_epochs"],
                  minibatch_size=PPO_UPSTREAM["minibatch_size"]).build()
    warm = algo.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = []
    for _ in range(PPO_TIMED_ITERS):
        r = algo.train()
        timed.append(dict(r, **{k.replace("_s", "_ms"): v * 1e3 for k, v in algo.timers.items()}))
    peak = torch.cuda.max_memory_allocated()
    check(all(finite(r) for r in [warm, *timed]), f"non-finite PPO stats {timed}")
    # the rllib step breakdown of the last iteration: no collectives, so
    # the efficiency is the compute share of the step past the idle gap,
    # and the components sum to the total (exactly: the same sum)
    efficiency = metrics.scaling_efficiency("rllib")
    seconds = metrics._ensure_step_metrics()["seconds"]
    step_s = {k[1]: v for k, v in seconds._values.items() if k[0] == "rllib"}
    check(efficiency is not None and 0 < efficiency <= 1, f"rllib scaling efficiency {efficiency}")
    check(step_s["compute"] + step_s["collective"] + step_s["idle"] == step_s["total"],
          f"rllib step_time_seconds {step_s}")
    rows = timed[0]["num_env_steps_sampled"]
    minibatches = PPO_UPSTREAM["num_epochs"] * (rows // PPO_UPSTREAM["minibatch_size"])
    # one update of (b)'s batch under the profiler, cut to a few epochs: the
    # profiler's post-processing of all 960 minibatch updates (~107k kernel
    # records) takes about a minute
    batch, _, _ = algo._postprocess([r.sample(algo.learner.get_params()) for r in algo.runners])
    algo.learner.num_epochs = PPO_PROFILE_EPOCHS
    profiled = PPO_PROFILE_EPOCHS * (rows // PPO_UPSTREAM["minibatch_size"])
    t0 = time.perf_counter()
    prof = device_profile(torch, lambda: algo.learner.update(batch), groups=PPO_GROUPS)
    profile_s = time.perf_counter() - t0
    algo.stop()
    launches = _launches(counters)
    check(all(n == 0 for n in launches.values()), f"port kernels launched on PPO: {launches}")

    learn_ms = [r["learn_ms"] for r in timed]
    iter_ms = [r["time_this_iter_s"] * 1e3 for r in timed]
    upstream = dict(
        rows=rows, minibatch_updates=minibatches,
        episode_return_mean=[r["episode_return_mean"] for r in [warm, *timed]],
        iteration_ms=iter_ms, sample_ms=[r["sample_ms"] for r in timed],
        postprocess_ms=[r["postprocess_ms"] for r in timed], learn_ms=learn_ms,
        env_steps_per_s=[rows / ms * 1e3 for ms in iter_ms],
        sample_env_steps_per_s=[rows / r["sample_ms"] * 1e3 for r in timed],
        learner_ms_per_minibatch=[ms / minibatches for ms in learn_ms],
        peak_bytes=peak, profile_s=profile_s, profiled_minibatch_updates=profiled,
        launches_per_minibatch=prof["kernel_launches"] / profiled,
        device_ms_per_minibatch=prof["device_busy_ms"] / profiled,
        device_busy_share_profiled=prof["device_busy_share"],
        device_busy_share_of_timed_update=(prof["device_busy_ms"] / profiled)
        / (statistics.median(learn_ms) / minibatches),
        profile=prof, scaling_efficiency=efficiency, step_time_seconds=step_s)
    parity = ppo_parity(torch, np)
    out = dict(defaults=defaults, upstream=upstream, launches=launches, parity=parity)
    print("train_ppo", json.dumps(out))
    return launches, out


def rl_datasets(np, n):
    """Synthetic offline datasets of n transitions from SEED, the reference
    tests' rules: CartPole-shaped (obs 4, expert action obs[0] > 0, 20% of
    actions corrupted and rewarded 0, episodes of 20) and Pendulum-shaped
    (obs 3, expert action -obs[0] clipped to the Box's [-2, 2], Gaussian
    noise of 0.5 on half the rows, clipped again; episodes of 50)."""
    rng = np.random.default_rng(SEED)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    actions = (obs[:, 0] > 0).astype(np.int64)
    corrupt = rng.random(n) < 0.2
    actions[corrupt] = rng.integers(0, 2, corrupt.sum())
    dones = np.zeros(n, np.float32)
    dones[19::20] = 1.0
    discrete = {"obs": obs, "actions": actions,
                "rewards": (actions == (obs[:, 0] > 0)).astype(np.float32),
                "dones": dones, "next_obs": np.roll(obs, -1, axis=0)}
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    expert = np.clip(-obs[:, :1], -2.0, 2.0)
    noise = rng.normal(scale=0.5, size=(n, 1)).astype(np.float32)
    actions = np.clip(expert + noise * (rng.random((n, 1)) < 0.5), -2.0, 2.0)
    dones = np.zeros(n, np.float32)
    dones[49::50] = 1.0
    continuous = {"obs": obs, "actions": actions.astype(np.float32),
                  "rewards": -np.abs(actions - expert)[:, 0].astype(np.float32),
                  "dones": dones, "next_obs": np.roll(obs, -1, axis=0)}
    return discrete, continuous


def coop_env_class():
    """The reference multi-agent test's cooperative toy (``CoopMatch``) on
    the port's MultiAgentEnv: two agents see one Discrete(3) context, each
    earns 0.2 for matching it, both 1 more when both match; 8 steps."""
    import numpy as np

    from ray_tpu_torch.rllib import Discrete, MultiAgentEnv

    class CoopMatch(MultiAgentEnv):
        possible_agents = ("a0", "a1")

        def __init__(self, config=None):
            self._rng = np.random.default_rng(0)
            self._t = 0
            self._ctx = 0

        def observation_space(self, agent_id):
            return Discrete(3)

        def action_space(self, agent_id):
            return Discrete(3)

        def _obs(self):
            return {a: self._ctx for a in self.possible_agents}

        def reset(self, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            self._ctx = int(self._rng.integers(3))
            return self._obs(), {}

        def step(self, action_dict):
            hits = {a: int(action_dict[a]) == self._ctx for a in self.possible_agents}
            both = all(hits.values())
            rewards = {a: 0.2 * hits[a] + (1.0 if both else 0.0) for a in self.possible_agents}
            self._t += 1
            done = self._t >= 8
            self._ctx = int(self._rng.integers(3))
            flags = {a: done for a in self.possible_agents}
            return (self._obs(), rewards, dict(flags, __all__=done),
                    {a: False for a in [*self.possible_agents, "__all__"]}, {})

    return CoopMatch


def recorded_pendulum_class():
    """A fresh subclass of the port's PendulumEnv whose class attribute
    ``torque`` holds the least and the largest action any of its instances
    stepped with."""
    import numpy as np

    from ray_tpu_torch.rllib import PendulumEnv

    class RecordedPendulum(PendulumEnv):
        torque = [np.inf, -np.inf]

        def step(self, u):
            self.torque[0] = min(self.torque[0], float(np.min(u)))
            self.torque[1] = max(self.torque[1], float(np.max(u)))
            return super().step(u)

    return RecordedPendulum


def _state_equal(torch, got, want) -> bool:
    """Two checkpoint trees equal bit for bit (tensors: dtype and values)."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _state_equal(torch, got[k], want[k]) for k in want)
    if isinstance(want, torch.Tensor):
        return got.dtype == want.dtype and torch.equal(got, want)
    return got == want


def _learner_tensors(torch, algo):
    """Every tensor an algorithm's learner keeps in its public attributes:
    the parameters of its modules (targets included), its other tensors
    (SAC's log_alpha), every Adam moment, and the same of each per-policy
    learner."""
    out = []

    def walk(v):
        if isinstance(v, torch.nn.Module):
            out.extend(v.parameters())
        elif isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif hasattr(v, "model") and hasattr(v, "opt_state"):  # a PPOLearner
            walk(v.model)
            walk(v.opt_state)

    for key, v in vars(algo).items():
        if not key.startswith("_"):  # not the host snapshot, dataset or constants
            walk(v)
    return out


def _rl_run(torch, name, algo, learning_iters, updates, stat_keys,
            rows_key="num_env_steps_sampled", learned=lambda result: True):
    """``algo.train()`` until ``learning_iters`` iterations have learned
    (``learned(result)``), the card's peak memory over them, and per
    iteration: wall ms, the timers in ms, env steps (offline: rows) per s
    and, of a learning iteration, learner ms per update (``updates`` an
    iteration). Every stat in ``stat_keys`` of a learning iteration must be
    finite."""
    import math

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, timers = [], []
    while sum(map(learned, results)) < learning_iters:
        results.append(algo.train())
        timers.append({k.replace("_s", "_ms"): v * 1e3 for k, v in algo.timers.items()})
        check(len(results) <= 64, f"{name}: no end after 64 iterations")
    peak = torch.cuda.max_memory_allocated()
    learned = [i for i, r in enumerate(results) if learned(r)]
    bad = [(i, k, results[i][k]) for i in learned for k in stat_keys
           if not math.isfinite(results[i][k])]
    check(not bad, f"{name}: non-finite stats {bad}")
    iter_ms = [r["time_this_iter_s"] * 1e3 for r in results]
    return dict(
        iterations=len(results), learning_iterations=learned,
        iteration_ms=iter_ms, timers_ms=timers,
        steps_per_s=[r[rows_key] / ms * 1e3 for r, ms in zip(results, iter_ms)],
        learner_ms_per_update=[timers[i]["learn_ms"] / updates for i in learned],
        updates_per_iteration=updates, peak_bytes=peak,
        stats={k: [results[i][k] for i in learned] for k in stat_keys},
        episode_return_mean=[r.get("episode_return_mean") for r in results])


def _rl_profile(torch, fn, n_updates):
    """Kernel launches, device ms and busy share of one call of ``fn`` (n
    updates) under torch.profiler, per update."""
    prof = device_profile(torch, fn)
    return dict(profiled_updates=n_updates,
                launches_per_update=prof["kernel_launches"] / n_updates,
                device_ms_per_update=prof["device_busy_ms"] / n_updates,
                wall_ms_per_update=prof["wall_ms"] / n_updates,
                device_busy_share=prof["device_busy_share"],
                dtoh_copies=prof["dtoh_copies"], sync_calls=prof["sync_calls"],
                top_kernels_ms=prof["top_kernels_ms"][:3])


def _rl_placement(torch, name, on_card, on_host):
    """Every learner tensor (parameters, targets, Adam moments) on the card,
    every runner policy on the host."""
    card = torch.device("cuda", torch.cuda.current_device())
    check(all(t.device == card for t in on_card),
          f"{name}: a learner tensor is not on the card")
    check(all(t.device.type == "cpu" for t in on_host), f"{name}: a runner policy left the host")


def _rl_roundtrip(torch, name, algo, build, state_of):
    """save, restore into a fresh build, and the same state bit for bit."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as ckpt:
        algo.save(ckpt)
        fresh = build()
        fresh.restore(ckpt)
    check(_state_equal(torch, state_of(fresh), state_of(algo)),
          f"{name}: save/restore did not give the same state")
    fresh.stop()


def _cast_state(torch, tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_state(torch, v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _deltas(torch, after, start, by_value=("target", "slow_critic")):
    """Each floating tensor's change from ``start`` in f64, by dotted name;
    an EMA or polyak target (a name holding one of ``by_value``) by its
    value: its change, tau * (p - t) read back from (1 - tau) * t + tau * p,
    cancels in f32 on every device alike."""
    flat = {}

    def walk(prefix, a, s):
        if isinstance(s, dict):
            for k in s:
                walk(f"{prefix}.{k}", a[k], s[k])
        elif isinstance(s, torch.Tensor) and s.is_floating_point():
            value = a.double()
            flat[prefix] = value if any(x in prefix for x in by_value) else value - s.double()
    walk("", after, start)
    return flat


def rl_parity(torch, np, discrete_data, continuous_data):
    """One update each of DQN, SAC (injected normal draws), IMPALA, APPO,
    CQL and continuous IQL, from the same weights and batch, on the card
    (f32, TF32 off), on the host in f32 and on the host in f64. Each run's
    change of every learner tensor and its stats are held against the f64
    run's; the card's f32 errors within 4x the host's own
    (``_control_check``), as ``ppo_parity`` does."""
    from ray_tpu_torch import rllib

    rng = np.random.default_rng(SEED + 1)
    B = RL["parity_rows"]
    idx = rng.integers(0, RL["offline_rows"], B)
    cases = {
        "dqn": (lambda dev: rllib.DQNConfig().environment(rllib.CartPoleEnv)
                .debugging(seed=SEED).build(device=dev),
                {"obs": rng.standard_normal((1, B, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, (1, B)),
                 "rewards": rng.standard_normal((1, B)).astype(np.float32),
                 "next_obs": rng.standard_normal((1, B, 4)).astype(np.float32),
                 "dones": (rng.random((1, B)) < 0.1).astype(np.float32)},
                lambda a, b: a._update(b)),
        "sac": (lambda dev: rllib.SACConfig().environment(rllib.PendulumEnv)
                .debugging(seed=SEED).build(device=dev),
                {"obs": rng.standard_normal((1, B, 3)).astype(np.float32),
                 "actions": rng.uniform(-1, 1, (1, B, 1)).astype(np.float32),
                 "rewards": rng.standard_normal((1, B)).astype(np.float32),
                 "next_obs": rng.standard_normal((1, B, 3)).astype(np.float32),
                 "dones": (rng.random((1, B)) < 0.1).astype(np.float32),
                 "noise": rng.standard_normal((2, B, 1)).astype(np.float32)},
                lambda a, b: a._update({k: v for k, v in b.items() if k != "noise"},
                                       noises=[b["noise"]])),
    }
    for variant in ("impala", "appo"):
        cls = rllib.APPOConfig if variant == "appo" else rllib.IMPALAConfig
        T, N = 32, 4
        cases[variant] = (
            lambda dev, cls=cls: cls().environment(rllib.CartPoleEnv).debugging(seed=SEED)
            .build(device=dev),
            {"obs": rng.standard_normal((T, N, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
             "behavior_logp": (np.log(0.5) + 0.3 * rng.standard_normal((T, N))).astype(
                 np.float32),
             "rewards": np.ones((T, N), np.float32),
             "dones": (rng.random((T, N)) < 0.05).astype(np.float32),
             "bootstrap_obs": rng.standard_normal((N, 4)).astype(np.float32)},
            lambda a, b: a._update(b))
    for name, cfg_cls, data in (("cql", rllib.CQLConfig, discrete_data),
                                ("iql_continuous", rllib.IQLConfig, continuous_data)):
        env_cls = rllib.CartPoleEnv if name == "cql" else rllib.PendulumEnv
        small = {k: v[:B] for k, v in data.items()}
        cases[name] = (
            lambda dev, c=cfg_cls, e=env_cls, d=small: c().environment(e).offline_data(d)
            .debugging(seed=SEED).build(device=dev),
            {k: v[idx] for k, v in data.items()},
            lambda a, b: a._step({k: torch.as_tensor(v).to(a.device, a._dtype()
                                                           if v.dtype.kind == "f" else None)
                                  for k, v in b.items()})[None])
    out = {}
    for name, (build, batch, update) in cases.items():
        if name.startswith("iql"):
            check(np.sum(np.abs(batch["actions"]) == 2.0) > 0,
                  "iql parity: the batch has no row on the Box's edge")
        base = build("cpu")
        get = (lambda a: a._state_dict()) if hasattr(base, "_state_dict") else (
            lambda a: a.state_dict())
        put = (lambda a, s: a._load_state_dict(s)) if hasattr(base, "_load_state_dict") else (
            lambda a, s: a.load_state_dict(s))
        start = get(base)
        base.stop()
        runs = {}
        for run, device, dtype in (("card", "cuda", torch.float32),
                                   ("host", "cpu", torch.float32),
                                   ("f64", "cpu", torch.float64)):
            algo = build(device)
            put(algo, _cast_state(torch, start, dtype))
            stats = update(algo, batch).detach().double().cpu().reshape(-1)
            check(all(t.device.type == device and t.dtype == dtype
                      for t in _learner_tensors(torch, algo) if t.is_floating_point()),
                  f"rl parity {name}: the {run} learner left {device} {dtype}")
            runs[run] = (get(algo), stats)
            algo.stop()

        want = _deltas(torch, runs["f64"][0], start)
        moved = [k for k, v in want.items() if v.abs().max() > 0]

        def errs(run):
            got = _deltas(torch, runs[run][0], start)
            e = {k: _rel_err(got[k], want[k]) for k in moved}
            e["stats"] = _rel_err(runs[run][1], runs["f64"][1])
            return e

        out[name] = dict(_control_check(f"rl parity {name}", errs("card"),
                                        max(errs("host").values())),
                         tensors_compared=len(moved))
    return out


def train_rl_phase(torch, np, counters):
    """The rest of RLlib through ``<Algo>Config(...).build().train()``, the
    learners on the card and the env runners and replay buffers on the
    host (RL above): DQN, SAC, IMPALA, APPO, BC, MARWIL, CQL, IQL (discrete
    and continuous) and multi-agent PPO. For each: iteration ms split by
    its timers, env steps (offline: rows) per s, learner ms per update,
    launches, device ms and busy share per update from a profiled update,
    peak memory; finite stats; learners on the card and runner policies on
    the host; a save/restore round trip bit for bit. IMPALA's mean_rho
    departs from 1 (stale rollouts); SAC's env actions stay in Pendulum's
    [-2, 2]. Then card-vs-host parity of one update each (rl_parity).
    K1-K4 must be launched 0 times."""
    from ray_tpu_torch import rllib

    _zero(counters)
    t_phase = time.perf_counter()
    out = {"settings": RL}

    def state_of(algo):
        return algo._state_dict() if hasattr(algo, "_state_dict") else algo.state_dict()

    def finish(name, build, algo, run, profile_fn, n_profiled, runner_models):
        _rl_placement(torch, name, _learner_tensors(torch, algo),
                      [p for m in runner_models for p in m.parameters()])
        _rl_roundtrip(torch, name, algo, build, state_of)
        run["profile"] = prof = _rl_profile(torch, profile_fn, n_profiled)
        # the profiler slows the host: the device's share of the timed update
        learn_ms = statistics.median(run["learner_ms_per_update"])
        prof["device_busy_share_of_timed_update"] = prof["device_ms_per_update"] / learn_ms
        out[name] = run
        learning = run["learning_iterations"]
        print(f"train_rl {name}: learning iterations' ms "
              f"{[round(run['iteration_ms'][i], 2) for i in learning]}, steps/s "
              f"{[round(run['steps_per_s'][i]) for i in learning]}, learner ms/update "
              f"{learn_ms:.4f}, launches/update {prof['launches_per_update']:.1f}, device "
              f"ms/update {prof['device_ms_per_update']:.5f}, busy (profiled) "
              f"{prof['device_busy_share']:.3f}, of the timed update "
              f"{prof['device_busy_share_of_timed_update']:.3f}, peak {run['peak_bytes']}",
              flush=True)
        algo.stop()
        torch.cuda.empty_cache()

    # DQN on CartPole
    def dqn_build():
        return (rllib.DQNConfig().environment(rllib.CartPoleEnv)
                .env_runners(**RL["dqn_runners"]).debugging(seed=SEED).build())
    algo = dqn_build()
    cfg = algo.config
    run = _rl_run(torch, "dqn", algo, RL["dqn_learning_iters"], cfg.num_updates_per_iter,
                  ("loss_mean",), learned=lambda r: r["buffer_size"] >= cfg.learning_starts)
    batches = rllib.dqn.stack_batches([algo.buffer.sample(cfg.train_batch_size, seed=u)
                                       for u in range(cfg.num_updates_per_iter)])
    finish("dqn", dqn_build, algo, run, lambda: algo._update(batches),
           cfg.num_updates_per_iter, [r.model for r in algo.runners])

    # SAC on Pendulum, its env actions recorded
    RecordedPendulum = recorded_pendulum_class()

    def sac_build():
        return rllib.SACConfig().environment(RecordedPendulum).debugging(seed=SEED).build()
    algo = sac_build()
    cfg = algo.config
    run = _rl_run(torch, "sac", algo, RL["sac_learning_iters"], cfg.num_updates_per_iter,
                  rllib.sac.STAT_KEYS, learned=lambda r: "critic_loss" in r)
    lo, hi = RecordedPendulum.torque
    check(-2.0 <= lo < hi <= 2.0, f"sac: env actions outside Pendulum's [-2, 2]: {lo}, {hi}")
    run["env_action_range"] = [lo, hi]
    batches = algo.buffer.sample_many(cfg.train_batch_size, cfg.num_updates_per_iter, seed=SEED)
    finish("sac", sac_build, algo, run, lambda: algo._update(batches),
           cfg.num_updates_per_iter, [r.actor for r in algo.runners])

    # IMPALA and APPO on CartPole
    for name, cls in (("impala", rllib.IMPALAConfig), ("appo", rllib.APPOConfig)):
        def build(cls=cls):
            return cls().environment(rllib.CartPoleEnv).debugging(seed=SEED).build()
        algo = build()
        run = _rl_run(torch, name, algo, RL["impala_iters"], algo.config.num_batches_per_iter,
                      rllib.impala.STAT_KEYS)
        rhos = run["stats"]["mean_rho"]
        # an on-policy update's ratio is 1 within f32 rounding (1e-7): each
        # iteration holds three updates on rollouts one update stale
        check(all(abs(r - 1) > 1e-5 for r in rhos), f"{name}: mean_rho stays at 1: {rhos}")
        rollout = algo.runners[0].sample(algo.get_params())
        finish(name, build, algo, run, lambda: algo._update(rollout), 1,
               [r.model for r in algo.runners])

    # the offline algorithms on synthetic datasets
    discrete, continuous = rl_datasets(np, RL["offline_rows"])
    for name, cls, env_cls, data in (
            ("bc", rllib.BCConfig, rllib.CartPoleEnv, discrete),
            ("marwil", rllib.MARWILConfig, rllib.CartPoleEnv, discrete),
            ("cql", rllib.CQLConfig, rllib.CartPoleEnv, discrete),
            ("iql", rllib.IQLConfig, rllib.CartPoleEnv, discrete),
            ("iql_continuous", rllib.IQLConfig, rllib.PendulumEnv, continuous)):
        def build(cls=cls, env_cls=env_cls, data=data):
            return cls().environment(env_cls).offline_data(data).debugging(seed=SEED).build()
        algo = build()
        per_epoch = RL["offline_rows"] // algo.config.train_batch_size
        run = _rl_run(torch, name, algo, RL["offline_iters"], per_epoch, (algo.loss_key,),
                      rows_key="num_samples")
        n = RL["profiled_offline_steps"]
        rows = torch.arange(n * algo.config.train_batch_size, device=algo.device).view(n, -1)
        steps = [{k: v[r] for k, v in algo._data.items()} for r in rows]
        finish(name, build, algo, run, lambda: [algo._step(b) for b in steps], n, [])

    # multi-agent PPO on the cooperative toy
    coop = coop_env_class()

    def ma_build():
        return (rllib.MultiAgentPPOConfig().environment(coop)
                .multi_agent(["shared"], lambda agent: "shared")
                .env_runners(num_env_runners=1, rollout_fragment_length=128)
                .training(**RL["multi_agent_training"]).debugging(seed=SEED).build())
    algo = ma_build()
    cfg = algo.config
    updates = cfg.num_epochs * (128 * 2 // cfg.minibatch_size)
    run = _rl_run(torch, "multi_agent_ppo", algo, RL["multi_agent_iters"], updates,
                  tuple(f"shared/{k}" for k in rllib.learner.STAT_KEYS))
    learner = algo.learners["shared"]
    ro = algo.runners[0].sample({"shared": learner.get_params()})
    batch = rllib.algorithm.gae_batch([ro["policies"]["shared"]], cfg.gamma, cfg.lam)
    finish("multi_agent_ppo", ma_build, algo, run, lambda: learner.update(batch), updates,
           [m for r in algo.runners for m in r.models.values()])

    out["parity"] = rl_parity(torch, np, discrete, continuous)
    launches = _launches(counters)
    check(all(n == 0 for n in launches.values()), f"port kernels launched on RL: {launches}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"train_rl parity {json.dumps(out['parity'])}; phase {out['phase_s']:.1f} s")
    print("train_rl", json.dumps(out))
    return launches, out


def dreamer_parity(torch, np):
    """One DreamerV3 update at the reference's defaults, discrete (CartPole)
    and continuous (Pendulum), from the same weights and batch, on the card
    (f32, TF32 off), on the host in f32 and on the host in f64. The draws
    are injected: every categorical choice (latents and discrete actions) as
    its class index, drawn uniformly from numpy, so that a near-tie cannot
    send the f32 and f64 runs down different latents, and the continuous
    actions' normal noise. Each run's change of every learner tensor
    (parameters, the slow critic by value, Adam moments, retnorm) and its
    stats against the f64 run's; the card's f32 errors within 4x the host's
    own (``_control_check``). Errors are relative L2 norms over each tensor
    (``_rel_l2``), not its largest element: a first Adam step moves each of
    the 2 M parameters by about lr x the sign of its gradient, so an element
    whose gradient cancels to f32 rounding moves either way on either
    device, and the largest elementwise error is that one element's."""
    from ray_tpu_torch import rllib

    out = {}
    for name, env_cls in (("cartpole", rllib.CartPoleEnv), ("pendulum", rllib.PendulumEnv)):
        def build(dev, env_cls=env_cls):
            return rllib.DreamerV3Config().environment(env_cls).debugging(seed=SEED).build(
                device=dev)
        base = build("cpu")
        cfg, nets = base.config, base.nets
        B, T, H = cfg.batch_size, cfg.seq_len, cfg.horizon
        N, G, C = B * T, cfg.stoch_groups, cfg.stoch_classes
        rng = np.random.default_rng(SEED + 2)
        if nets.discrete:
            action = np.eye(nets.act_dim, dtype=np.float32)[rng.integers(0, nets.act_dim, (B, T))]
        else:
            action = rng.uniform(-1, 1, (B, T, nets.act_dim)).astype(np.float32)
        first = rng.random((B, T)) < 0.1
        first[:, 0] = True
        batch = {"obs": rng.standard_normal((B, T, nets.obs_dim)).astype(np.float32),
                 "action": action, "reward": rng.standard_normal((B, T)).astype(np.float32),
                 "is_first": first, "is_terminal": rng.random((B, T)) < 0.05}
        draws = {"observe": [rng.integers(0, C, (B, G)) for _ in range(T)],
                 "imagine": [(rng.integers(0, nets.act_dim, N) if nets.discrete
                              else rng.standard_normal((N, nets.act_dim)),
                              rng.integers(0, C, (N, G))) for _ in range(H)]}
        start = base.state_dict()
        base.stop()
        runs = {}
        for run, device, dtype in (("card", "cuda", torch.float32),
                                   ("host", "cpu", torch.float32),
                                   ("f64", "cpu", torch.float64)):
            algo = build(device)
            algo.load_state_dict(_cast_state(torch, start, dtype))
            stats = algo._update(batch, draws=draws).detach().double().cpu()
            check(all(t.device.type == device and t.dtype == dtype
                      for t in _learner_tensors(torch, algo) if t.is_floating_point()),
                  f"dreamer parity {name}: the {run} learner left {device} {dtype}")
            runs[run] = (algo.state_dict(), stats)
            algo.stop()
        want = _deltas(torch, runs["f64"][0], start)
        moved = [k for k, v in want.items() if v.abs().max() > 0]

        def errs(run):
            got = _deltas(torch, runs[run][0], start)
            e = {k: _rel_l2(got[k], want[k]) for k in moved}
            e["stats"] = _rel_l2(runs[run][1], runs["f64"][1])
            return e

        out[name] = dict(_control_check(f"dreamer parity {name}", errs("card"),
                                        max(errs("host").values())),
                         tensors_compared=len(moved))
    return out


def train_dreamer_phase(torch, np, counters):
    """DreamerV3 through ``DreamerV3Config().environment(...).build().train()``
    at the reference's defaults (DREAMER above), the learner on the card and
    the runner and sequence buffer on the host, on CartPole and Pendulum:
    iteration ms by timers (sample, buffer, learn), env steps/s and learner
    ms per update over the iterations that learned; then 3 timed updates on
    one of its batches and 3 at upstream RLlib's batch (16 x 64), each with
    launches, device ms and busy share from one profiled update; peak
    memory. Checks: finite stats with kl_dyn at the free-nats floor or
    above, learner tensors on the card and runner nets on the host,
    save/restore bit for bit, Pendulum's env actions in [-2, 2]; then
    card-vs-host parity of one update (dreamer_parity). K1-K4 must be
    launched 0 times."""
    from ray_tpu_torch import rllib

    _zero(counters)
    t_phase = time.perf_counter()
    out = {"settings": DREAMER}

    RecordedPendulum = recorded_pendulum_class()
    for name, env_cls in (("cartpole", rllib.CartPoleEnv), ("pendulum", RecordedPendulum)):
        def build(env_cls=env_cls):
            return rllib.DreamerV3Config().environment(env_cls).debugging(seed=SEED).build()
        algo = build()
        cfg = algo.config
        run = _rl_run(torch, f"dreamer {name}", algo, DREAMER["learning_iters"], 1,
                      rllib.dreamer.STAT_KEYS, learned=lambda r: "wm_loss" in r)
        kl = run["stats"]["kl_dyn"]
        check(all(k >= cfg.free_nats - 1e-5 for k in kl),
              f"dreamer {name}: kl_dyn under the free-nats floor: {kl}")
        _rl_placement(torch, f"dreamer {name}", _learner_tensors(torch, algo),
                      [p for r in algo.runners for p in r.nets.parameters()])
        _rl_roundtrip(torch, f"dreamer {name}", algo, build, lambda a: a.state_dict())
        timed = {}
        for size, (B, T) in (("default", (cfg.batch_size, cfg.seq_len)),
                             ("upstream", DREAMER["upstream_batch"])):
            batch = algo.buffer.sample(B, T, seed=SEED)
            times, peak = _timed_steps(torch, lambda: algo._update(batch),
                                       DREAMER["timed_updates"])
            prof = _rl_profile(torch, lambda: algo._update(batch), 1)
            prof["device_busy_share_of_timed_update"] = (
                prof["device_ms_per_update"] / statistics.median(times))
            timed[size] = dict(batch=[B, T], imagination_starts=B * T, update_ms=times,
                               peak_bytes=peak, profile=prof)
        run["timed_updates"] = timed
        if name == "pendulum":
            lo, hi = RecordedPendulum.torque
            check(-2.0 <= lo < hi <= 2.0,
                  f"dreamer: env actions outside Pendulum's [-2, 2]: {lo}, {hi}")
            run["env_action_range"] = [lo, hi]
            a = algo.compute_single_action(np.zeros(3, np.float32))
            check(a.shape == (1,) and -2.0 <= float(a[0]) <= 2.0,
                  f"dreamer: deployed action {a} outside [-2, 2]")
        else:
            check(algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1),
                  "dreamer: CartPole's deployed action is not 0 or 1")
        out[name] = run
        learning = run["learning_iterations"]
        d, u = timed["default"], timed["upstream"]
        print(f"train_dreamer {name}: learning iterations' ms "
              f"{[round(run['iteration_ms'][i], 2) for i in learning]} (timers "
              f"{[{k: round(v, 2) for k, v in run['timers_ms'][i].items()} for i in learning]}), "
              f"steps/s {[round(run['steps_per_s'][i]) for i in learning]}, learner ms/update "
              f"{[round(x, 2) for x in run['learner_ms_per_update']]}; timed update ms "
              f"{[round(x, 2) for x in d['update_ms']]} (8 x 16), "
              f"{[round(x, 2) for x in u['update_ms']]} (16 x 64); launches/update "
              f"{d['profile']['launches_per_update']:.0f}, "
              f"{u['profile']['launches_per_update']:.0f}; device ms/update "
              f"{d['profile']['device_ms_per_update']:.4f}, "
              f"{u['profile']['device_ms_per_update']:.4f}; busy of the timed update "
              f"{d['profile']['device_busy_share_of_timed_update']:.4f}, "
              f"{u['profile']['device_busy_share_of_timed_update']:.4f}; peak "
              f"{run['peak_bytes']}, {d['peak_bytes']}, {u['peak_bytes']}", flush=True)
        algo.stop()
        del algo
        torch.cuda.empty_cache()

    out["parity"] = dreamer_parity(torch, np)
    launches = _launches(counters)
    check(all(n == 0 for n in launches.values()), f"port kernels launched on DreamerV3: {launches}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"train_dreamer parity {json.dumps(out['parity'])}; phase {out['phase_s']:.1f} s")
    print("train_dreamer", json.dumps(out))
    return launches, out


# a MoE training step's kernels by kind (the first group with a part in a
# kernel's symbol takes it): K1-K4; cuBLAS GEMMs (projections, experts, the
# router, the head); gating (softmax, argmax, cumsum); dispatch and combine
# (gathers, index_put, scatters, the embedding's lookup); AdamW (fused);
# reductions; elementwise
MOE_GROUPS = {
    "k1_k4": tuple(PORT_KERNELS.values()),
    "gemm": ("nvjet", "gemm", "gemv", "cutlass", "xmma"),
    "adamw": ("Adam", "adam"),
    "gating": ("SoftMax", "softmax", "ArgMax", "scan", "cumsum"),
    "dispatch_combine": ("index", "gather", "scatter", "put_"),
    "reductions": ("reduce",),
    "elementwise": ("elementwise", "unrolled", "vectorized", "copy"),
}


def moe_flops(cfg, batch: int, seq: int):
    """FLOPs of the MoE forward and of a training step with remat: per
    layer the q/k/v/o projections, causal attention (4d a visible pair),
    the f32 router and the three expert products over every capacity slot
    (E·C, padding included), and the head. A step is 4 forwards of the
    layers (the forward, the recompute and a backward of twice the work)
    and 3 of the head. ``expert_padding`` is the share of the expert
    products spent on empty slots of this shape's capacity (E·C slots
    against t·k choices; dropped choices are not subtracted)."""
    from ray_tpu_torch.parallel.expert import expert_capacity

    t, d, f, e = batch * seq, cfg.dim, cfg.intermediate, cfg.n_experts
    hd, h, hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    c = expert_capacity(t, e, cfg.capacity_factor, cfg.experts_per_token)
    proj = 2 * t * d * (h + 2 * hk) * hd + 2 * t * h * hd * d
    attn = 4 * batch * h * (seq * (seq + 1) // 2) * hd
    experts = 3 * 2 * e * c * d * f
    layer = proj + attn + 2 * t * d * e + experts
    head = 2 * t * d * cfg.vocab_size
    return dict(capacity=c, layer_forward=layer, experts_forward=experts,
                forward=cfg.n_layers * layer + head, step=4 * cfg.n_layers * layer + 3 * head,
                expert_padding=1 - t * cfg.experts_per_token / (e * c))


def moe_dense_vs_indexed(torch, moe, x):
    """One layer's call (x: the layer's MoE input from a training step, the
    layer's own router): the indexed dispatch/combine against the dense
    one-hot einsums, then both timed. The slabs handed to the experts must
    be equal bit for bit (each is a copy of one token's row, or zero); each
    combined output sums at most k products w·y, which the indexed form
    rounds and adds and a GEMM may fuse into one multiply-add, so outputs
    must agree within 2^-22 of sum |w·y| (three roundings of 2^-24), plus
    one bf16 step of the output for bf16 x; the count of outputs that are
    not equal is printed. Checked for bf16 x (the layer's call) and again
    for its f32 copy (outputs in f32)."""
    from ray_tpu_torch.parallel import expert as X

    out = {}
    with torch.no_grad():
        r = moe.route(x)
        e, c, k = r.n_experts, r.capacity, r.keep.shape[1]
        logits = x.float() @ moe.router.float()
        dispatch, combine, _ = X.top_k_gating(logits, c, k=k)
        torch.cuda.synchronize()
        check(int(dispatch.sum().item()) == int(r.keep.sum().item()),
              "the dense dispatch does not hold each kept choice once")
        slabs = {}

        def experts(name):
            def fn(inp):
                slabs[name] = inp
                return moe.experts(inp.to(x.dtype))
            return fn

        y = slab = None
        for tag, xin in (("bf16", x), ("f32", x.float())):
            dense = X.moe_apply_gspmd(xin, dispatch, combine, experts("dense"))
            indexed = X.moe_apply_indexed(xin, r, experts("indexed"))
            check(torch.equal(slabs["dense"], slabs["indexed"]),
                  f"moe {tag}: the indexed dispatch's slabs differ from the dense einsum's")
            if y is None:
                slab = slabs["indexed"]
                y = moe.experts(slab).reshape(e * c, -1).float()
                at = torch.where(r.keep, r.expert * c + r.slot, 0)
                mag = (y[at] * r.weight[..., None]).abs().sum(dim=1)
                del at
            tol = 2.0 ** -22 * mag
            if tag == "bf16":
                tol = tol + 2.0 ** -7 * indexed.float().abs()
            diff = (dense.float() - indexed.float()).abs()
            worst = (diff / tol.clamp_min(1e-30)).max().item()
            check(bool((diff <= tol).all()),
                  f"moe {tag}: indexed vs dense combine beyond the rounding bound ({worst:.3f})")
            out[tag] = dict(outputs=dense.numel(), unequal=int((dense != indexed).sum().item()),
                            max_abs_diff=diff.max().item(), worst_over_tol=worst)
            del dense, indexed, diff, tol
        x32, y3 = x.float(), y.view(e, c, -1)
        heavy = dict(reps=5, inner=2)
        out["ms"] = dict(
            route=time_ms(lambda: moe.route(x)),
            top_k_gating_dense=time_ms(lambda: X.top_k_gating(logits, c, k=k), **heavy),
            experts=time_ms(lambda: moe.experts(slab), **heavy),
            apply_indexed=time_ms(lambda: X.moe_apply_indexed(x, r, moe.experts), **heavy),
            apply_dense=time_ms(lambda: X.moe_apply_gspmd(x, dispatch, combine, moe.experts),
                                **heavy),
            dispatch_einsum_f32=time_ms(lambda: torch.einsum("td,tec->ecd", x32, dispatch),
                                        **heavy),
            combine_einsum_f32=time_ms(lambda: torch.einsum("ecd,tec->td", y3, combine), **heavy),
        )
    ms = out["ms"]
    out["dispatch_combine_ms"] = {"indexed": ms["apply_indexed"] - ms["experts"],
                                  "dense": ms["apply_dense"] - ms["experts"]}
    einsum_flops = 2 * x.shape[0] * e * c * x.shape[1]
    out["einsum_flops"] = einsum_flops
    out["einsum_tflop_s"] = {k_: einsum_flops / ms[k_] / 1e9
                             for k_ in ("dispatch_einsum_f32", "combine_einsum_f32")}
    out["dropped_fraction"] = (~r.keep).float().mean().item()
    return out


def moe_parity(torch, card="cuda"):
    """Card vs host at one layer of full Mixtral-8x7B width, b=1 x seq 64,
    f32, TF32 off. Routing first: each run's expert choices and kept flags
    (from the layer's own ``route`` on its MoE input) against an f64 host
    run's; a choice that differs must come from a near-tie (the first pass
    that differs chose between probabilities closer than MOE_NEAR_TIE, on
    the f64 run) and a kept flag may differ only behind such a choice.
    Then the loss and every gradient of the positions routed alike in all
    runs (in one layer a position's experts reach only its own logits):
    the NLL averaged over those positions, plus the weighted aux losses if
    every position is routed alike. The card's f32 logits against the f64
    run within 4x the f32 host run's own error, its gradients within 8x
    (``_control_check``; see there why 8x); the loss within 1e-5."""
    from ray_tpu_torch.models import moe as M

    cfg = M.MoEConfig.mixtral_8x7b(n_layers=1, max_seq_len=MOE_PARITY_SEQ,
                                   dtype=torch.float32, remat=False)
    g = torch.Generator(device=card).manual_seed(SEED + 9)
    base = {k: v.cpu() for k, v in M.init_params(cfg, g, card).items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_PARITY_SEQ),
                           generator=torch.Generator().manual_seed(SEED + 9))
    runs = {"f64": ("cpu", torch.float64), "host": ("cpu", torch.float32),
            "card": (card, torch.float32)}

    def build(run):
        dev, dtype = runs[run]
        c = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        params = {k: v.to(dev, dtype, copy=True) for k, v in base.items()}
        return c, M.build_moe(c, params, trainable=True)

    class Routed(Exception):
        """Raised by pass 1's hook: nothing after the layer's routing is read."""

    # pass 1: each run's routing, from the layer's own route() on its input;
    # each run's model is built once and kept for pass 2
    routing, gaps, models = {}, None, {}
    for run in runs:
        models[run] = model = build(run)[1]
        seen = []

        def record(mod, args):
            h = args[0].reshape(-1, cfg.dim)
            seen.append((mod.route(h), h.float() @ mod.router.float()))
            raise Routed

        hook = model.layer_0.moe.register_forward_pre_hook(record)
        with torch.no_grad():
            try:
                model(tokens.to(runs[run][0]))
            except Routed:
                pass
        hook.remove()
        r, logits = seen[0]
        routing[run] = (r.expert.cpu(), r.keep.cpu())
        if run == "f64":
            p = torch.softmax(logits.cpu(), dim=-1).sort(dim=-1, descending=True).values
            gaps = p[:, :-1] - p[:, 1:]  # (t, E - 1): pass j chose between p[j] and p[j + 1]
        del model, seen
    del base
    same = torch.ones(MOE_PARITY_SEQ, dtype=torch.bool)
    flips = {}
    for run in ("host", "card"):
        choice = routing[run][0] != routing["f64"][0]  # (t, k)
        kept = routing[run][1] != routing["f64"][1]
        differs = choice.any(dim=1)
        first = choice.float().argmax(dim=1)
        gap = gaps.gather(1, first[:, None])[:, 0]
        check(bool((gap[differs] < MOE_NEAR_TIE).all()),
              f"moe parity {run}: a routing choice differs by more than a near-tie "
              f"(gaps {gap[differs].tolist()})")
        check(bool(differs.any()) or not bool(kept.any()),
              f"moe parity {run}: kept flags differ with every choice equal")
        flips[run] = dict(tokens_choice_differs=int(differs.sum()),
                          tokens_kept_differs=int(kept.any(dim=1).sum()),
                          min_gap=gaps[:, : cfg.experts_per_token].min().item())
        same &= ~(choice.any(dim=1) | kept.any(dim=1))
    mask = same[:-1].double()  # position i's logits predict token i + 1
    check(mask.sum() > MOE_PARITY_SEQ // 2, f"moe parity: only {int(mask.sum())} positions alike")
    all_same = bool(same.all())

    # pass 2: the loss of the positions routed alike and its gradients
    results, truth = {}, None
    for run in runs:
        model = models.pop(run)
        dev = runs[run][0]
        logits, aux = model(tokens.to(dev))
        lse = torch.logsumexp(logits[0, :-1].float(), dim=-1)
        tgt = logits[0, :-1].gather(-1, tokens[0, 1:, None].to(dev))[:, 0].float()
        m = mask.to(dev, lse.dtype)
        loss = ((lse - tgt) * m).sum() / m.sum()
        if all_same:
            loss = loss + aux.sum().to(loss.dtype)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        if run == "f64":
            truth = (loss.item(), logits.detach()[0, same], grads)
        else:
            errs = {n: _rel_err(gr, truth[2][n]) for n, gr in grads.items()}
            results[run] = dict(loss=loss.item(),
                                loss_rel_err=abs(loss.item() - truth[0]) / abs(truth[0]),
                                logits_rel_err=_rel_err(logits.detach()[0, same], truth[1]),
                                grads_rel_err=errs)
        del model, logits, aux, loss, grads
    check(all(bool((g.max() > 0) | (g.min() < 0)) for g in truth[2].values()),
          "moe parity: a zero gradient")
    host, cardr = results["host"], results["card"]
    out = dict(seq=MOE_PARITY_SEQ, positions_alike=int(same.sum()), all_alike=all_same,
               near_tie_bound=MOE_NEAR_TIE, flips=flips, loss_f64=truth[0],
               loss_rel_err={r: results[r]["loss_rel_err"] for r in results})
    check(cardr["loss_rel_err"] <= 1e-5, f"moe parity: card loss rel err {cardr['loss_rel_err']}")
    out["logits"] = _control_check("moe parity logits", {"logits": cardr["logits_rel_err"]},
                                   host["logits_rel_err"])
    # 8x, not 4x: at this width the products sum over d = 4096, f = 14336
    # and the vocabulary's 32,000, and the card's f32 GEMMs sum such long
    # reductions less accurately than the host's. chip_moe_error.py splits
    # it on this layer (NVIDIA H100 80GB HBM3, 700.00 W): w_down's own
    # product (80 slots) errs alike on both (3.5e-7 and 3.4e-7 of its
    # largest value), but its inputs err 3.1x (the SwiGLU product, from d =
    # 4096) and 4.4x (its output gradient, from the head's 32,000) the
    # host's, and w_down's gradient 5.1x. A fault in routing or in a kernel
    # moves a gradient by 1e-3 of its size or more, 100x beyond.
    out["grads"] = _control_check("moe parity grads", cardr["grads_rel_err"],
                                  max(host["grads_rel_err"].values()), times=8)
    out["host_grads_rel_err"] = host["grads_rel_err"]
    out["card_grads_rel_err"] = cardr["grads_rel_err"]
    out["router_grad_rel_err"] = cardr["grads_rel_err"]["layer_0.moe.router"]
    return out


def train_moe_phase(torch, counters):
    """Mixtral-8x7B at full width, 4 layers, bf16 parameters, batch 2 x seq
    4096, remat, AdamW: (a) a first step with its routing recorded (each
    layer's forward and recompute must route alike; the dropped fraction
    per layer), then 3 timed warm steps with exactly 4L+1 / 2L / L / L
    launches of K1/K2/K3/K4 a step, finite losses and a non-zero router
    gradient in every layer, and the peak memory; (b) the full forward
    under no_grad; (c) one profiled step, by kernel group; (d) the indexed
    dispatch/combine against the dense einsums at one layer's call; (e)
    card vs host at one full-width layer."""
    import math

    from ray_tpu_torch.models import moe as M

    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = M.MoEConfig.mixtral_8x7b(n_layers=MOE["n_layers"], param_dtype=torch.bfloat16,
                                   max_seq_len=MOE["seq"])
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    t0 = time.perf_counter()
    model = M.build_moe(cfg, M.init_params(cfg, g, device), trainable=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    # fused: one multi-tensor kernel per group, no temporary parameter list
    optimizer = torch.optim.AdamW(model.parameters(), lr=MOE["lr"], betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4, fused=True)
    b, s = MOE["batch"], MOE["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=device)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = M.next_token_loss(cfg, model, tokens)
        loss.backward()
        optimizer.step()
        return loss.detach()

    n = cfg.n_layers
    per_step = {"rmsnorm_fwd": 4 * n + 1, "flash_attention_fwd": 2 * n, "flash_bwd_dq": n,
                "flash_bwd_dkv": n}
    per_forward = {"rmsnorm_fwd": 2 * n + 1, "flash_attention_fwd": n, "flash_bwd_dq": 0,
                   "flash_bwd_dkv": 0}

    def launched_since(before):
        return {k: v - before[k] for k, v in _launches(counters).items()}

    # (a) the first step, each layer's routing recorded on every call
    records = {i: [] for i in range(n)}
    layer0_input = []

    def recorder(i):
        def pre(mod, args):
            h = args[0].reshape(-1, cfg.dim)
            with torch.no_grad():
                records[i].append(mod.route(h))
            if i == 0 and not layer0_input:
                layer0_input.append(h.detach())
        return pre

    hooks = [blk.moe.register_forward_pre_hook(recorder(i)) for i, blk in enumerate(model.blocks())]
    before = _launches(counters)
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_step_ms = (time.perf_counter() - t0) * 1e3
    for hk in hooks:
        hk.remove()
    got = launched_since(before)
    check(got == per_step, f"MoE first step launches {got}, want {per_step}")
    first_peak = torch.cuda.max_memory_allocated()
    dropped = []
    for i, rec in records.items():
        check(len(rec) == 2, f"MoE layer {i} routed {len(rec)} times in a remat step, want 2")
        fwd, rec2 = rec
        check(all(torch.equal(getattr(fwd, a), getattr(rec2, a))
                  for a in ("expert", "slot", "keep", "weight")),
              f"MoE layer {i}: the recompute routed otherwise than the forward")
        dropped.append((~fwd.keep).float().mean().item())
    del records
    router_grad = [blk.moe.router.grad.float().abs().max().item() for blk in model.blocks()]
    check(all(x > 0 for x in router_grad), f"a router has no gradient: {router_grad}")

    before = _launches(counters)
    step_ms, step_peak = _timed_steps(torch, lambda: losses.append(step()), MOE["timed_steps"])
    got = launched_since(before)
    want = {k: v * (MOE["timed_steps"] + 1) for k, v in per_step.items()}
    check(got == want, f"MoE launches over the warm-up and timed steps {got}, want {want}")
    losses = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite MoE losses {losses}")

    # (b) the full forward, no autograd
    before = _launches(counters)
    with torch.no_grad():
        fwd_ms, fwd_peak = _timed_steps(torch, lambda: model(tokens), MOE["timed_steps"])
    got = launched_since(before)
    want = {k: v * (MOE["timed_steps"] + 1) for k, v in per_forward.items()}
    check(got == want, f"MoE forward launches {got}, want {want}")

    # (c) one step under the profiler
    before = _launches(counters)
    prof = device_profile(torch, step, groups=MOE_GROUPS)
    for name, per in per_step.items():
        got_prof = prof["port_kernels"][name]["launches"]
        check(got_prof == per, f"{name}: {got_prof} launches in the MoE step profile, want {per}")
    runs = prof["profile_attempts"]
    got, want = launched_since(before), {k: v * runs for k, v in per_step.items()}
    check(got == want, f"MoE launches in {runs} profiled steps {got}, want {want}")
    launches = _launches(counters)

    # (d) dense against indexed at layer 0's call, on the step's input
    del optimizer
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    dense_vs_indexed = moe_dense_vs_indexed(torch, model.layer_0.moe, layer0_input[0])
    del model, layer0_input
    torch.cuda.empty_cache()

    flops = moe_flops(cfg, b, s)
    med, fmed = statistics.median(step_ms), statistics.median(fwd_ms)
    out = dict(n_layers=n, batch=b, seq=s, params=n_params, init_s=init_s,
               launches_per_step=per_step, launches_per_forward=per_forward,
               losses=losses, router_grad_max=router_grad, dropped_fraction=dropped,
               first_step_ms=first_step_ms, step_ms=step_ms, step_ms_median=med,
               tokens_per_s=b * s / med * 1e3, forward_ms=fwd_ms, forward_ms_median=fmed,
               forward_tokens_per_s=b * s / fmed * 1e3,
               peak_bytes_first_step=first_peak, peak_bytes_timed_steps=step_peak,
               peak_bytes_forward=fwd_peak, flops=flops,
               step_tflop_s=flops["step"] / med / 1e9,
               forward_tflop_s=flops["forward"] / fmed / 1e9,
               step_bound_ms=flops["step"] / BF16_TENSOR_FLOPS * 1e3,
               forward_bound_ms=flops["forward"] / BF16_TENSOR_FLOPS * 1e3,
               launches=launches, profile=prof, dense_vs_indexed=dense_vs_indexed)
    print("train_moe", json.dumps(out))
    # (e) card vs host
    t0 = time.perf_counter()
    parity = moe_parity(torch)
    parity["s"] = time.perf_counter() - t0
    print("train_moe_parity", json.dumps(parity))
    return launches, out


# -- the models over multi-axis meshes (``train_mesh``) -----------------------


def _mesh_vit_config():
    from ray_tpu_torch.models import vit as V

    return V.ViTConfig.base()


def _mesh_vit_inputs(torch, device):
    """ViT-B/16's parameters (the reference's initialisers, the zero-start
    leaves given values) and the global batch, from one seed: each rank
    draws the whole and keeps its part."""
    from ray_tpu_torch.models import vit as V

    cfg = _mesh_vit_config()
    g = torch.Generator(device=device).manual_seed(SEED + 11)
    params = V.init_params(cfg, g, device)
    _vit_randomise(torch, params, g)
    n = MESH["vit"]["batch"]
    images = torch.randn(n, cfg.image_size, cfg.image_size, 3, generator=g, device=device)
    labels = torch.randint(0, cfg.num_classes, (n,), generator=g, device=device)
    return cfg, params, images, labels


def _mesh_moe_config(torch, dtype=None):
    """Mixtral-8x7B at full width, ``MESH["moe"]["n_layers"]`` layers, bf16
    parameters, remat; ``dtype`` sets the activations' (default bf16)."""
    from ray_tpu_torch.models import moe as M

    cfg = M.MoEConfig.mixtral_8x7b(n_layers=MESH["moe"]["n_layers"],
                                   param_dtype=torch.bfloat16, max_seq_len=MESH["moe"]["seq"])
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _mesh_moe_inputs(torch, cfg, device, shard=None):
    """The MoE's parameters (each rank keeps its blocks through ``shard``)
    and the global batch of tokens, from one seed."""
    from ray_tpu_torch.models import moe as M

    g = torch.Generator(device=device).manual_seed(SEED + 12)
    params = M.init_params(cfg, g, device, shard=shard)
    b, s = MESH["moe"]["batch"], MESH["moe"]["seq"]
    return params, torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=device)


class _MoERecorder:
    """Each layer's MoE input and routing on a model's first forward: a
    pre-hook on every block's ``moe`` and ``models.moe.route`` wrapped
    while it is on (the remat recompute's calls come after and are not
    kept)."""

    def __init__(self, M, model):
        self._M, self._route = M, M.route
        self.inputs, self.routes = [], []
        self._n = model.config.n_layers
        self._hooks = [blk.moe.register_forward_pre_hook(self._pre) for blk in model.blocks()]
        M.route = self._record

    def _pre(self, mod, args):
        if len(self.inputs) < self._n:
            self.inputs.append(args[0].detach())

    def _record(self, logits, *args, **kwargs):
        out = self._route(logits, *args, **kwargs)
        if len(self.routes) < self._n:
            self.routes.append((out, logits.detach()))
        return out

    def close(self):
        self._M.route = self._route
        for hook in self._hooks:
            hook.remove()


def _aux_router_grads(torch, cfg, routers, inputs, group=None, n_data=1, local=False,
                      seq_shards=1):
    """Per layer: the gradient of its weighted aux loss alone with respect
    to its whole router (d, E), f32 on the host, from the layer's MoE input
    of the first step and its router (whole). Over a mesh (``group``: the
    loss axes' group of ``n_data`` ranks, ``seq_shards`` of them along sp)
    the routing is the global batch's and the gradients are summed over the
    group; ``local``: each rank's own aux loss (its tokens' means) in place
    of its share of the global one, the planted fault."""
    import torch.nn.functional as F

    from ray_tpu_torch.parallel.expert import expert_capacity, route

    out = []
    for router, x in zip(routers, inputs):
        w = router.detach().float().requires_grad_(True)
        tokens = x.reshape(-1, cfg.dim)
        logits = tokens.float() @ w
        capacity = expert_capacity(tokens.shape[0] * n_data, cfg.n_experts, cfg.capacity_factor,
                                   cfg.experts_per_token)
        r = route(logits, capacity, k=cfg.experts_per_token, group=group,
                  seq_shards=seq_shards, rows=x.shape[0])
        aux = r.aux_loss
        if local:
            probs = torch.softmax(logits.float(), dim=-1)
            ft = (F.one_hot(r.expert, cfg.n_experts) * r.keep[..., None]).amax(dim=1).float()
            aux = cfg.n_experts * torch.sum(ft.mean(dim=0) * probs.mean(dim=0))
        (cfg.router_aux_weight * aux).backward()
        g = w.grad
        if group is not None:
            group.allreduce_(g)
        out.append(g.cpu())
    return out


def _mesh_step_stats(torch, metrics, counters, step):
    """``step()`` between a barrier and synchronizes: its ms, its K1-K4
    launches and the host ms of its collectives by op."""
    from ray_tpu_torch.train import collective as tcol

    tcol.barrier()
    torch.cuda.synchronize()
    _zero(counters)
    before = _collective_ms(metrics.collective_summary())
    t0 = time.perf_counter()
    out = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = _collective_ms(metrics.collective_summary())
    coll = {op: after[op] - before.get(op, 0.0) for op in after}
    return out, dict(step_ms=ms, launches=_launches(counters), collective_ms=coll,
                     collective_host_share=sum(coll.values()) / ms)


def _mesh_vit_round(torch, part, rank, device, counters, run_dir):
    """One rank's ViT-B/16 over ``MESH[part]``'s mesh: its steps, the first
    step's gradient blocks (after ``sync_gradients``, before AdamW) written
    beside the run. Returns the rank's report."""
    from ray_tpu_torch.models import vit as V
    from ray_tpu_torch.parallel.mesh import BATCH_AXES
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.util import metrics

    spec = MESH[part]
    mesh = tcol.gang_mesh(device, **spec["axes"])
    cfg, params, images, labels = _mesh_vit_inputs(torch, device)
    model = V.build_vit(cfg, params, mesh)
    del params
    n = mesh.axes_size(BATCH_AXES)
    i = mesh.axes_index(BATCH_AXES)
    rows = slice(i * images.shape[0] // n, (i + 1) * images.shape[0] // n)
    images, labels = images[rows].contiguous(), labels[rows].contiguous()
    optimizer = torch.optim.AdamW(model.parameters(), lr=spec["lr"], betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
    first = {}

    def vit_step():
        optimizer.zero_grad(set_to_none=True)
        loss = V.classification_loss(cfg, mesh, model, images, labels)
        loss.backward()
        model.fsdp.sync_gradients(model.named_parameters())
        if not first:
            first.update({k: p.grad.cpu() for k, p in model.named_parameters()})
        optimizer.step()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    steps, losses = [], []
    for _ in range(spec["steps"]):
        loss, stats = _mesh_step_stats(torch, metrics, counters, vit_step)
        steps.append(stats)
        losses.append(tcol.gang_mean(loss, mesh))
    torch.save(first, run_dir / f"mesh_{part}_grad_rank{rank}.pt")
    report = dict(coords=mesh.coords(), data_index=i, steps=steps, losses=losses,
                  peak_bytes=torch.cuda.max_memory_allocated(), positions=list(model.positions),
                  param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))
    del model, optimizer, images, labels, first
    torch.cuda.empty_cache()
    return report


def _moe_fault_step(torch, M, cfg, mesh, model, tokens, fault):
    """A planted fault's first step under sp, on the first step's weights:
    its loss and synced gradients of every leaf but the experts' (those are
    neither summed nor kept: their sum over sp is most of a step's gloo
    bytes, and the sums are elementwise, so leaving them out changes no bit
    of the others). ``fault``: "rope", every block's attention rotating at offset 0
    (sp rank 1 at its local positions); "routing", each layer's routing
    offsets taken per rank (``route`` with ``seq_shards=1``, as it stood
    before sequence parallelism)."""
    attns = [blk.attn for blk in model.blocks()]
    route = M.route
    if fault == "rope":
        for a in attns:
            a.sp_rank = 0
    else:
        M.route = lambda *args, **kw: route(*args, **{**kw, "seq_shards": 1})
    try:
        loss = M.next_token_loss(cfg, mesh, model, tokens)
        loss.backward()
        kept = [(k, p) for k, p in model.named_parameters()
                if not k.endswith(("w_gate", "w_up", "w_down"))]
        model.fsdp.sync_gradients(kept)
        grads = {k: p.grad.cpu() for k, p in kept}
    finally:
        for a in attns:
            a.sp_rank = mesh.coords()["sp"]
        M.route = route
        model.zero_grad(set_to_none=True)
    return {"loss": loss.item(), "grads": grads}


def _mesh_moe_round(torch, part, rank, device, counters, run_dir):
    """One rank's Mixtral layers over ``MESH[part]``'s mesh: its steps,
    the first step's gradient blocks, each layer's routing of the rank's
    tokens, the aux loss's router gradients (the global one and the planted
    local one) and, under sp, the planted faults' first steps
    (:func:`_moe_fault_step`, before the first real step) and the routing
    fault's routing, written beside the run. Returns the rank's report."""
    from ray_tpu_torch.models import moe as M
    from ray_tpu_torch.parallel.expert import route
    from ray_tpu_torch.parallel.fsdp import FSDP
    from ray_tpu_torch.parallel.mesh import BATCH_AXES, LOSS_AXES
    from ray_tpu_torch.parallel.sharding import moe_logical_axes
    from ray_tpu_torch.train import collective as tcol
    from ray_tpu_torch.util import metrics

    spec = MESH[part]
    mesh = tcol.gang_mesh(device, **spec["axes"])
    cfg = _mesh_moe_config(torch)
    layout = FSDP.for_model(mesh, M.param_shapes(cfg), moe_logical_axes)
    params, tokens = _mesh_moe_inputs(torch, cfg, device, shard=layout.shard)
    model = M.build_moe(cfg, params, trainable=True, mesh=mesh)
    del params
    n = mesh.axes_size(BATCH_AXES)
    i = mesh.axes_index(BATCH_AXES)
    tokens = tokens[i * tokens.shape[0] // n:(i + 1) * tokens.shape[0] // n].contiguous()
    if spec.get("sgd"):
        optimizer = torch.optim.SGD(model.parameters(), lr=spec["lr"])
    else:
        optimizer = torch.optim.AdamW(model.parameters(), lr=spec["lr"], betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=1e-4, fused=True)
    sp = mesh.shape["sp"]
    faults = {f: _moe_fault_step(torch, M, cfg, mesh, model, tokens, f)
              for f in (("rope", "routing") if sp > 1 else ())}
    first, routers = {}, []
    recorder = _MoERecorder(M, model)

    def moe_step():
        optimizer.zero_grad(set_to_none=True)
        loss = M.next_token_loss(cfg, mesh, model, tokens)
        loss.backward()
        model.fsdp.sync_gradients(model.named_parameters())
        if not first:
            first.update({k: p.grad.cpu() for k, p in model.named_parameters()})
            recorder.close()
            # each layer's whole router as the first step read it (its
            # blocks gathered over fsdp and ep), for the aux gradients below
            for li, blk in enumerate(model.blocks()):
                routers.append(model.fsdp.full(f"layer_{li}.moe.router", blk.moe.router.detach()))
        optimizer.step()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    steps, losses = [], []
    for _ in range(spec["steps"]):
        loss, stats = _mesh_step_stats(torch, metrics, counters, moe_step)
        steps.append(stats)
        losses.append(tcol.gang_mean(loss, mesh))
    peak = torch.cuda.max_memory_allocated()
    torch.save(first, run_dir / f"mesh_{part}_grad_rank{rank}.pt")
    del first
    # the aux loss's router gradients on the first step's inputs and routers
    group, n_loss = mesh.group(LOSS_AXES), mesh.axes_size(LOSS_AXES)
    aux = {kind: _aux_router_grads(torch, cfg, routers, recorder.inputs, group, n_loss, local, sp)
           for kind, local in (("global", False), ("local", True))}
    routes = [{"expert": rt.expert.cpu(), "slot": rt.slot.cpu(), "keep": rt.keep.cpu()}
              for rt, _ in recorder.routes]
    extra = {"aux": aux, "routes": routes, "faults": faults}
    if faults:
        # the routing fault's own routing: each layer routed again from the
        # same router logits with the per-rank offsets
        extra["per_rank_routes"] = []
        for rt, logits in recorder.routes:
            bad = route(logits, rt.capacity, k=cfg.experts_per_token, group=group)
            extra["per_rank_routes"].append({"expert": bad.expert.cpu(), "slot": bad.slot.cpu(),
                                             "keep": bad.keep.cpu()})
    torch.save(extra, run_dir / f"mesh_{part}_routes_rank{rank}.pt")
    report = dict(coords=mesh.coords(), data_index=i, steps=steps, losses=losses,
                  peak_bytes=peak, fault_losses={f: v["loss"] for f, v in faults.items()},
                  param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))
    del model, optimizer, tokens, recorder, aux, routes, routers, moe_step, extra, faults
    torch.cuda.empty_cache()
    return report


def _pipe_model(torch, device, layers, dtype=None, n=None):
    """Llama-2-7B's decoder blocks ``layers`` (of ``n``, default PIPE's
    stages x layers a stage; bf16 parameters drawn from one seed: every
    rank draws every tensor and keeps its layers'), as one module whose
    forward applies them in turn; the microbatches of hidden states and the
    loss's weights (bf16, one seed); ``dtype`` sets the activations'
    (default bf16)."""
    from torch import nn

    from ray_tpu_torch.models import llama as L

    n = PIPE["stages"] * PIPE["layers_per_stage"] if n is None else n
    cfg = L.LlamaConfig.llama2_7b(n_layers=n, param_dtype=torch.bfloat16,
                                  max_seq_len=PIPE["seq"])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    keep = tuple(f"layer_{i}." for i in layers)
    g = torch.Generator(device=device).manual_seed(SEED + 13)
    params = L.init_params(cfg, g, device,
                           shard=lambda name, t: t if name.startswith(keep) else t.new_empty(0))
    shape = (PIPE["micro"], PIPE["rows"], PIPE["seq"], cfg.dim)
    xs = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    weights = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    cos, sin = L.rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, device)

    class Stage(nn.Module):
        def forward(self, x):
            x = x.to(cfg.dtype)
            for i in layers:
                x = getattr(self, f"layer_{i}")(x, cos, sin)
            return x

    with torch.device("meta"):
        stage = Stage()
        for i in layers:
            stage.add_module(f"layer_{i}", L.Block(cfg))
    stage.load_state_dict({k: v for k, v in params.items() if k.startswith(keep)}, strict=True,
                          assign=True)
    del params
    for p in stage.parameters():
        p.requires_grad_(True)
    return stage, xs, weights


def _pipe_loss(torch, out, weights):
    """The pipeline's loss: the weighted mean of its output, in f32."""
    return (out.float() * weights.float()).sum() / out.numel()


def _pipe_round(torch, mesh, counters, run_dir):
    """One of PIPE's stages on gang ranks 0-3: ``pipeline_apply`` of its 2
    blocks over the ``pp`` group, forward and backward of the weighted-mean
    loss, PIPE["steps"] steps (K1-K4 set to 0 just before each, read just
    after), the first step's gradients (and the output on the last stage,
    the microbatches' gradient on the first) written beside the run.
    Returns the rank's report."""
    from torch.func import functional_call

    from ray_tpu_torch.parallel import pipeline_apply

    device = _card(torch)
    group = mesh.group("pp")
    s = group.rank
    per = PIPE["layers_per_stage"]
    stage, xs, weights = _pipe_model(torch, device, range(s * per, (s + 1) * per))
    params = dict(stage.named_parameters())
    xs.requires_grad_(True)
    steps, first = [], None
    for _ in range(PIPE["steps"]):
        for p in params.values():
            p.grad = None
        xs.grad = None
        torch.cuda.synchronize()
        group.barrier()
        _zero(counters)
        t0 = time.perf_counter()
        out = pipeline_apply(lambda p, x: functional_call(stage, p, (x,)), params, xs,
                             group=group)
        loss = _pipe_loss(torch, out, weights)
        loss.backward()
        torch.cuda.synchronize()
        steps.append(dict(step_ms=(time.perf_counter() - t0) * 1e3, launches=_launches(counters),
                          loss=loss.item()))
        if first is None:
            first = {"grads": {k: p.grad.cpu() for k, p in params.items()},
                     "out": out.detach().cpu() if s == group.world_size - 1 else None,
                     "out_nonzero": bool(out.detach().any()),
                     "dxs": xs.grad.cpu() if s == 0 else None,
                     "dxs_nonzero": bool(xs.grad.any())}
    torch.save(first, run_dir / f"pipe_stage{s}.pt")
    report = dict(stage=s, steps=steps, out_nonzero=first["out_nonzero"],
                  dxs_nonzero=first["dxs_nonzero"], peak_bytes=torch.cuda.max_memory_allocated())
    del stage, params, xs, weights, out, loss, first
    torch.cuda.empty_cache()
    return report


def _hier_round(torch, hier, flat):
    """HIER's round on one of gang ranks 4-7: ``hier`` (2 slices of 2) and
    ``flat`` (the same ranks' gloo group): the allreduce of the 7B loop's
    gradient size on integer values and on random ones, the same reduce
    through ``GradientReduceScheduler``, both against the flat sum; the
    reference tests' allgather, broadcast from rank 3 and reducescatter;
    ms of the hierarchical and the flat allreduce beside each other."""
    import numpy as np

    from ray_tpu_torch.collective import GradientReduceScheduler

    device = _card(torch)
    r = hier.rank
    n = HIER["bytes"] // 4
    g = torch.Generator(device=device).manual_seed(SEED + 20 + r)
    ints = torch.randint(-1000, 1000, (n,), generator=g, device=device).float()
    rand = torch.randn(n, generator=g, device=device)
    out = {}
    out["int_exact"] = torch.equal(hier.allreduce(ints), flat.allreduce(ints))
    got, want = hier.allreduce(rand), flat.allreduce(rand)
    # four f32 terms summed in two orders: the flat sum is within 3
    # roundings of the magnitudes' sum from the exact one, the slices' sum
    # of sums within 2, so they part by 5 at most
    mag = flat.allreduce(rand.abs())
    out["rand_err_over_bound"] = ((got - want).abs() / (5 * 2.0 ** -24 * mag)).max().item()
    sched = GradientReduceScheduler(hier, overlap=True)
    reduced = sched.reduce({"g": ints, "h": rand}).wait()
    out["scheduled_int_exact"] = torch.equal(reduced["g"], flat.allreduce(ints))
    out["scheduled_rand_err_over_bound"] = (
        (reduced["h"] - want).abs() / (5 * 2.0 ** -24 * mag)).max().item()
    out["allgather"] = list(hier.allgather(r * 11))
    out["broadcast"] = hier.broadcast(100 + r, src_rank=3)
    rows = torch.arange(30, dtype=torch.float32, device=device).view(10, 3) * (r + 1)
    shard = hier.reducescatter(rows)
    out["reducescatter_ok"] = torch.equal(
        shard.cpu(), torch.from_numpy(np.array_split(
            (torch.arange(30, dtype=torch.float32).view(10, 3) * 10).numpy(), 4, axis=0)[r]))
    for name, group in (("hier", hier), ("flat", flat)):
        times = []
        for _ in range(HIER["reps"]):
            flat.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group.allreduce(rand)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_ms"] = times
    return out


def train_mesh_loop(config):
    """One of eight gloo ranks sharing the card: (a) ViT-B/16 over
    ``gang_mesh(device, dp=2, fsdp=2, tp=2)``, (b) 2 layers of Mixtral-8x7B
    over ``gang_mesh(device, fsdp=2, ep=2, tp=2)``, (c) the ViT at dp=2 x
    sp=2 x tp=2, (d) the MoE at sp=2 x ep=2 x tp=2, each with its first
    step's gradient blocks (after ``sync_gradients``, before AdamW) written
    beside the run, and for the MoE each layer's routing of the rank's
    tokens and the aux loss's router gradients (the global one and the
    planted local one; under sp the planted routing and RoPE faults); every
    step's ms, K1-K4 launches (set to 0 just before it, read just after) and
    collectives reported; then (e) the pipeline on ranks 0-3
    (:func:`_pipe_round`) and (f) the hierarchical group on ranks 4-7
    (:func:`_hier_round`), one after the other; then ``train_tp``'s round
    (:func:`_tp_round`)."""
    import gc

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.collective import GlooGroup, HierarchicalGroup
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import collective as tcol

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)  # eight ranks share the host's cores
    ctx = train.get_context()
    r = ctx.world_rank
    device = _card(torch)
    run_dir = Path(ctx.get_storage_path())
    counters = _port_counters()
    report = {"rank": r, "device": str(device)}
    for part in ("vit", "moe", "vit_sp", "moe_sp"):
        gc.collect()  # the last round's leftovers leave the card first
        torch.cuda.empty_cache()
        rnd = _mesh_vit_round if part.startswith("vit") else _mesh_moe_round
        report[part] = rnd(torch, part, r, device, counters, run_dir)
    # (e) and (f): every rank forms both rounds' groups, in one order
    pipe = make_mesh(devices=[str(device)] * PIPE["stages"], pp=PIPE["stages"],
                     fsdp=1).form_groups("gloo", world_ranks=range(PIPE["stages"]), name="pipe")
    members = list(range(MESH["ranks"] - HIER["ranks"], MESH["ranks"]))
    hier = HierarchicalGroup.form(members, "hier", slice_size=HIER["slice_size"])
    flat_pg = dist.new_group(ranks=members, backend="gloo")
    if pipe is not None:
        report["pipe"] = _pipe_round(torch, pipe, counters, run_dir)
    tcol.barrier()
    if hier is not None:
        flat = GlooGroup(len(members), members.index(r), "hier_flat", process_group=flat_pg)
        report["hier"] = _hier_round(torch, hier, flat)
        hier.destroy()
    tcol.barrier()
    torch.cuda.empty_cache()
    # then train_tp's round, in this gang (its phase reads it)
    report["tp"] = _tp_round(torch, r, counters, run_dir)
    train.report(report)


def _card_distance(torch, got, want):
    """||got - want|| in f32 on the card (the leaves are too large for an
    f64 copy on the host)."""
    device = _card(torch)
    return (got.to(device).float() - want.to(device).float()).norm().item()


def _mesh_vit_one_rank(torch):
    """ViT-B/16 on the whole global batch on one rank, in bf16 and in f32
    activations: the bf16 run's first loss and gradients (host) and, per
    leaf, its distance from the f32 run's."""
    from ray_tpu_torch.models import vit as V

    device = _card(torch)
    cfg, params, images, labels = _mesh_vit_inputs(torch, device)
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = V.build_vit(c, {k: v.clone() for k, v in params.items()})
        loss = V.classification_loss(c, None, model, images, labels)
        loss.backward()
        runs[dtype] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
        del model, loss
    loss, grads = runs[torch.bfloat16]
    f32_loss, f32_grads = runs[torch.float32]
    control = {k: _card_distance(torch, g, f32_grads[k]) for k, g in grads.items()}
    del params, images, labels, runs
    torch.cuda.empty_cache()
    return dict(loss=loss, grads=grads, control=control, f32_loss=f32_loss, f32_grads=f32_grads)


def _mesh_moe_one_rank(torch):
    """The 2-layer MoE on the whole global batch on one rank, in bf16 and in
    f32 activations: the bf16 run's first loss, gradients, routing (with
    the gaps of its f32 probabilities) and aux router gradients (host), and
    each one's distance from the f32 run's."""
    from ray_tpu_torch.models import moe as M

    device = _card(torch)
    runs = {}
    for dtype in (None, torch.float32):
        cfg = _mesh_moe_config(torch, dtype)
        params, tokens = _mesh_moe_inputs(torch, cfg, device)
        model = M.build_moe(cfg, params, trainable=True)
        del params
        recorder = _MoERecorder(M, model)
        loss = M.next_token_loss(cfg, model, tokens)
        recorder.close()
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        routers = [blk.moe.router.detach() for blk in model.blocks()]
        model.zero_grad(set_to_none=True)
        aux = _aux_router_grads(torch, cfg, routers, recorder.inputs)
        routes = []
        for rt, logits in recorder.routes:
            p = torch.softmax(logits.float(), dim=-1).sort(dim=-1, descending=True).values
            routes.append({"expert": rt.expert.cpu(), "slot": rt.slot.cpu(),
                           "keep": rt.keep.cpu(), "gaps": (p[:, :-1] - p[:, 1:]).cpu()})
        runs[dtype] = dict(loss=loss.item(), grads=grads, aux=aux, routes=routes)
        del model, loss, recorder, routers, tokens
        torch.cuda.empty_cache()
    one, f32 = runs[None], runs[torch.float32]
    one["control"] = {k: _card_distance(torch, g, f32["grads"][k]) for k, g in one["grads"].items()}
    one["aux_control"] = [_card_distance(torch, a, b) for a, b in zip(one["aux"], f32["aux"])]
    one.update(f32_loss=f32["loss"], f32_grads=f32["grads"], f32_aux=f32["aux"])
    return one


def _assemble(torch, name, shape, dtype, sharding, blocks, same=True):
    """The whole of a leaf from every rank's block (``blocks[r]``), on the
    card; the ranks that hold one block must hold it bit for bit (with
    ``same``; else the first one's is taken)."""
    device = _card(torch)
    full = torch.zeros(shape, dtype=dtype, device=device)
    seen = {}
    for r, block in enumerate(blocks):
        index = sharding.index(shape, r)
        key = tuple((s.start, s.stop) for s in index)
        block = block.to(device)
        if key in seen:
            check(not same or torch.equal(block, seen[key]),
                  f"{name}: ranks holding one block differ")
            continue
        seen[key] = block
        full[index] = block
    return full


def _mesh_grad_check(torch, tag, grads, f32, control, one, times, replicated_tp, tp,
                     skip=(), faults=None):
    """Each leaf's distance from the f32-activation run within ``times`` x
    the one-rank bf16 run's (``control``): the mesh run's bf16 error
    against the error of the same model on one rank. (Held against each
    other instead, the two bf16 runs part by about sqrt(2) of one run's
    error, their roundings being independent, and the largest of some 150
    such ratios reaches 2 by chance; those ratios are printed.) The planted
    fault of a tp-replicated leaf's gradient summed over tp (``tp`` x it)
    must break the bound, as must each of ``faults`` (name -> the leaf's
    gradient under the fault, from its name and gradient) on some leaf.
    Returns the ratios."""
    ratio, planted, to_one = {}, {}, {}
    faults = faults or {}
    extra = {name: {} for name in faults}
    for k, g in grads:  # (name, gradient) pairs, each made as it is read
        if k in skip:
            continue
        check(control[k] > 0, f"{tag} {k}: the one-rank run's distance from f32 is 0")
        ratio[k] = _card_distance(torch, g, f32[k]) / control[k]
        to_one[k] = _card_distance(torch, g, one[k]) / control[k]
        if k in replicated_tp:
            planted[k] = _card_distance(torch, g.float() * tp, f32[k]) / control[k]
        for name, fault in faults.items():
            extra[name][k] = _card_distance(torch, fault(k, g), f32[k]) / control[k]
    worst = max(ratio, key=ratio.get)
    for name, got in extra.items():
        check(max(got.values()) > times,
              f"{tag}: the planted fault {name} passes the gradient check: {got}")
    check(ratio[worst] <= times,
          f"{tag}: {worst}'s first gradient is {ratio[worst]:.3f} x the one-rank run's distance "
          f"from f32 activations away from them, over {times}")
    check(planted and max(planted.values()) > times,
          f"{tag}: the planted fault (a tp-replicated leaf's gradient summed over tp) passes "
          f"the gradient check: {planted}")
    return dict(max_over_control=ratio[worst], worst_leaf=worst, over_control=ratio,
                to_one_rank_over_control_max=max(to_one.values()),
                to_one_rank_over_control=to_one,
                planted_tp_sum_over_control=max(planted.values()),
                **{f"planted_{name}_over_control": max(got.values())
                   for name, got in extra.items()})


def _mesh_routing_check(torch, layer_routes, one_routes):
    """Each layer's routing of the mesh run (``layer_routes[l][i]``: data
    shard i's) against the one-rank run's of the same tokens: a choice may
    differ only at a near-tie (MESH_NEAR_TIE) or at a token an earlier layer
    routed otherwise; without a differing choice in the layer, slots and
    kept flags are equal. Returns the counts."""
    out, moved = [], None
    for layer, (shards, want) in enumerate(zip(layer_routes, one_routes)):
        got = {k: torch.cat([sh[k] for sh in shards]) for k in ("expert", "slot", "keep")}
        choice = got["expert"] != want["expert"]
        differs = choice.any(dim=1)
        first = choice.float().argmax(dim=1)
        gap = want["gaps"].gather(1, first[:, None])[:, 0]
        allowed = gap < MESH_NEAR_TIE
        if moved is not None:
            allowed |= moved
        check(bool(allowed[differs].all()),
              f"mesh MoE layer {layer}: routing choices differ beyond a near-tie at "
              f"{int((differs & ~allowed).sum())} tokens (gaps {gap[differs & ~allowed][:8].tolist()})")
        if not bool(differs.any()):
            check(torch.equal(got["slot"], want["slot"]) and torch.equal(got["keep"], want["keep"]),
                  f"mesh MoE layer {layer}: every choice equal, but slots or kept flags differ")
        slot_differs = (got["slot"] != want["slot"]).any(dim=1)
        out.append(dict(tokens=int(differs.numel()), choice_differs=int(differs.sum()),
                        near_ties=int((differs & (gap < MESH_NEAR_TIE)).sum()),
                        after_earlier_layer=int((differs & ~(gap < MESH_NEAR_TIE)).sum()),
                        slot_differs=int(slot_differs.sum()),
                        dropped=(~got["keep"]).float().mean().item(),
                        dropped_one_rank=(~want["keep"]).float().mean().item()))
        moved = differs if moved is None else moved | differs
    return out


def _pipe_one_rank(torch):
    """The pipeline's 8 blocks on one rank, each microbatch through all of
    them in turn, forward and backward of the same loss, in bf16 and in f32
    activations: the bf16 run's output, gradients and microbatch gradient
    (host), each one's distance from the f32 run's, and the bf16 run's step
    ms (two runs, the first for the values)."""
    device = _card(torch)
    n = PIPE["stages"] * PIPE["layers_per_stage"]
    runs = {}
    for dtype in (None, torch.float32):
        model, xs, weights = _pipe_model(torch, device, range(n), dtype)
        xs.requires_grad_(True)
        times, first = [], None
        for _ in range(2 if dtype is None else 1):
            model.zero_grad(set_to_none=True)
            xs.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs, loss = [], 0.0
            for m in range(PIPE["micro"]):
                y = model(xs[m])
                part = (y.float() * weights[m].float()).sum() / (y.numel() * PIPE["micro"])
                part.backward()
                outs.append(y.detach())
                loss = loss + part.detach()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = dict(out=torch.stack(outs).cpu(), loss=float(loss), dxs=xs.grad.cpu(),
                             grads={k: p.grad.cpu() for k, p in model.named_parameters()})
        runs[dtype] = dict(first, step_ms=times)
        del model, xs, weights, outs, y
        torch.cuda.empty_cache()
    one, f32 = runs[None], runs[torch.float32]
    one["control"] = {k: _card_distance(torch, g, f32["grads"][k]) for k, g in one["grads"].items()}
    for name in ("out", "dxs"):
        one[f"{name}_control"] = _card_distance(torch, one[name], f32[name])
    one.update(f32_grads=f32["grads"], f32_out=f32["out"], f32_dxs=f32["dxs"],
               f32_loss=f32["loss"])
    return one


def _pipe_check(torch, reports, run_dir, one):
    """The pipeline round against the one-rank runs: K1-K4 a step a stage
    exact (each of its 2 blocks: 2 K1 and a K2 a microbatch forward, a K3 and
    a K4 backward); zeros off the last stage; the output, every stage's
    gradients leaf by leaf and the microbatches' gradient within
    MESH_GRAD_TIMES x the one-rank bf16 run's distance from its
    f32-activation run; the wall a step beside the one-rank run's."""
    import math

    per_step = {"rmsnorm_fwd": 4 * PIPE["micro"], "flash_attention_fwd": 2 * PIPE["micro"],
                "flash_bwd_dq": 2 * PIPE["micro"], "flash_bwd_dkv": 2 * PIPE["micro"]}
    launches = {name: 0 for name in per_step}
    stages = sorted((m["pipe"] for m in reports if "pipe" in m), key=lambda p: p["stage"])
    check([p["stage"] for p in stages] == list(range(PIPE["stages"])), f"pipe stages {stages}")
    last = PIPE["stages"] - 1
    for p in stages:
        for st in p["steps"]:
            check(st["launches"] == per_step,
                  f"pipe stage {p['stage']}: {st['launches']} a step, want {per_step}")
            for name in per_step:
                launches[name] += st["launches"][name]
        check(p["out_nonzero"] == (p["stage"] == last),
              f"pipe stage {p['stage']}: output non-zero {p['out_nonzero']}")
        check(p["dxs_nonzero"] == (p["stage"] == 0),
              f"pipe stage {p['stage']}: microbatch gradient non-zero {p['dxs_nonzero']}")
        check(all(math.isfinite(st["loss"]) for st in p["steps"]), f"pipe losses {p['steps']}")
    files = [torch.load(run_dir / f"pipe_stage{s}.pt") for s in range(PIPE["stages"])]
    ratio = {}
    for name, got, want, control in (
            ("out", files[last]["out"], one["f32_out"], one["out_control"]),
            ("dxs", files[0]["dxs"], one["f32_dxs"], one["dxs_control"]),
            *((k, g, one["f32_grads"][k], one["control"][k])
              for f in files for k, g in f["grads"].items())):
        check(control > 0, f"pipe {name}: the one-rank run's distance from f32 is 0")
        ratio[name] = _card_distance(torch, got, want) / control
    worst = max(ratio, key=ratio.get)
    check(ratio[worst] <= MESH_GRAD_TIMES,
          f"pipe: {worst} is {ratio[worst]:.3f} x the one-rank run's distance from f32 "
          f"activations away from them, over {MESH_GRAD_TIMES}")
    check(len(ratio) == 2 + len(one["grads"]), "pipe: a stage's gradients are missing")
    step_ms = [[st["step_ms"] for st in p["steps"]] for p in stages]
    return launches, dict(
        launches_per_step=per_step, max_over_control=ratio[worst], worst=worst,
        out_over_control=ratio["out"], dxs_over_control=ratio["dxs"], step_ms=step_ms,
        one_rank_step_ms=one["step_ms"],
        wall_over_one_rank=max(ms[-1] for ms in step_ms) / one["step_ms"][-1],
        losses=[st["loss"] for st in stages[last]["steps"]], loss_one_rank=one["loss"],
        loss_f32_activations=one["f32_loss"], peak_bytes=[p["peak_bytes"] for p in stages])


def _hier_check(reports):
    """The hierarchical round on its four ranks: the flat sum exactly on
    integer values and within five f32 roundings of the magnitudes' sum on
    random ones (three for the flat order, two for the slices'), directly and through the scheduler; the reference tests'
    allgather, broadcast and reducescatter. Returns the ms beside the
    flat group's."""
    hier = [m["hier"] for m in reports if "hier" in m]
    check(len(hier) == HIER["ranks"], f"hier: {len(hier)} reports")
    for h in hier:
        check(h["int_exact"] and h["scheduled_int_exact"],
              f"hier: the integer-valued sums differ from the flat group's: {h}")
        check(h["rand_err_over_bound"] <= 1 and h["scheduled_rand_err_over_bound"] <= 1,
              f"hier: random sums beyond f32 rounding of the flat group's: {h}")
        check(h["allgather"] == [0, 11, 22, 33] and h["broadcast"] == 103
              and h["reducescatter_ok"], f"hier: the reference tests' values: {h}")
    return dict(hier_ms=[h["hier_ms"] for h in hier], flat_ms=[h["flat_ms"] for h in hier],
                rand_err_over_bound=max(h["rand_err_over_bound"] for h in hier),
                bytes=HIER["bytes"], slices=HIER["ranks"] // HIER["slice_size"])


def _sp_routes(torch, extras, reports, key, layers):
    """Each layer's routing of the whole global batch, in the (b, s) order,
    from the ranks' routes under sp (``extras[r][key]``): a rank's rows at
    its sequence shard's positions; the ranks of one shard route alike."""
    spec = MESH["moe_sp"]
    b, s = spec["batch"], spec["seq"]
    local = s // spec["axes"]["sp"]
    out = []
    for layer in range(layers):
        full, seen = {}, {}
        for m, e in zip(reports, extras):
            q = m["moe_sp"]["coords"]["sp"]
            got = e[key][layer]
            if q in seen:
                check(all(torch.equal(got[k], seen[q][k]) for k in got),
                      "mesh MoE sp: the ranks of one sequence shard route otherwise")
                continue
            seen[q] = got
            idx = (torch.arange(b)[:, None] * s + q * local + torch.arange(local)[None]).reshape(-1)
            for k, v in got.items():
                full.setdefault(k, torch.zeros((b * s, *v.shape[1:]), dtype=v.dtype))[idx] = v
        out.append([full])
    return out


def train_mesh_phase(torch, counters):
    """The ViT and the MoE over multi-axis meshes, the pipeline and the
    hierarchical group on eight gloo ranks sharing the card
    (``train_mesh_loop``), against one-rank runs in this process: (a)
    ViT-B/16 at dp=2 x fsdp=2 x tp=2 and (c) at dp=2 x sp=2 x tp=2, 2 steps
    each; (b) 1 layer of Mixtral-8x7B (b=2 x 2048) at fsdp=2 x ep=2 x tp=2
    and (d) at sp=2 x ep=2 x tp=2, 2 steps each; (e) the pipeline on ranks 0-3 and (f)
    the hierarchical group on ranks 4-7; the same ranks then run
    ``train_tp``'s round, returned for its phase. Held: every rank's K1-K4
    launches a step exact (ViT 0/12/12/12, MoE 4L+1 / 2L / L / L, under sp
    4L+1 / 2L(s+1) / L(2-s) / L(2-s) at sp coordinate s); each rank's
    resident parameter bytes the rule table's share exactly (``pos_embed``'s
    padded rows under sp); the first step's gradients, leaf by leaf (the
    MoE's aux router gradients too), and the first loss within
    MESH_GRAD_TIMES x the one-rank run's distance from its f32-activation
    run, and planted faults from the same run beyond it (a tp-replicated
    leaf's gradient summed over tp; each rank's local aux loss in place of
    the global one; under sp the ViT's loss counted once per sp rank, every
    gradient twice over, and the MoE's first step with per-rank routing
    offsets and with RoPE at local positions); the MoE's routing of each
    layer against the one-rank run's (near-ties counted, dropped shares
    printed); finite losses; (e) and (f) as :func:`_pipe_check` and
    :func:`_hier_check`. Printed: step ms, peak and the collectives' host
    share a rank."""
    import math
    import multiprocessing
    import tempfile

    from ray_tpu_torch.models import moe as M
    from ray_tpu_torch.models import vit as V
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import (
        moe_logical_axes, param_shardings, vit_logical_axes)
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    import gc

    # what earlier phases left for the cyclic collector (a model a closure
    # holds) leaves the card before eight ranks share it
    gc.collect()
    torch.cuda.empty_cache()
    print("train_mesh_parent_bytes", json.dumps(dict(
        allocated=torch.cuda.memory_allocated(), reserved=torch.cuda.memory_reserved())))
    t_phase = time.perf_counter()
    vit_one = _mesh_vit_one_rank(torch)
    moe_one = _mesh_moe_one_rank(torch)
    pipe_one = _pipe_one_rank(torch)
    one_rank_s = time.perf_counter() - t_phase
    n = MESH["ranks"]

    _zero(counters)
    torch.cuda.empty_cache()
    # eight ranks' models fill most of the card ((d) holds a quarter of the
    # experts a rank, with AdamW's state): the ranks' allocators grow their
    # segments in place rather than keep a cached block per size
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as storage:
        t0 = time.perf_counter()
        try:
            result = TorchTrainer(train_mesh_loop, train_loop_config={},
                                  run_config=RunConfig(name="mesh", storage_path=storage),
                                  scaling_config=ScalingConfig(n, {"GPU": 1.0 / n}),
                                  backend_config=TorchConfig(backend="gloo")).fit()
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        fit_s = time.perf_counter() - t0
        if result.error is not None:
            raise result.error
        parent = _launches(counters)
        check(not any(parent.values()), f"the train_mesh loop launched kernels in the parent: {parent}")
        check(not multiprocessing.active_children(), "the worker group left a process")
        reports = sorted(result.metrics_history, key=lambda m: m["rank"])
        print("train_mesh_fit", json.dumps(dict(one_rank_s=one_rank_s, fit_s=fit_s,
                                                reports=[{k: v for k, v in m.items() if k != "tp"}
                                                         for m in reports])))
        check([m["rank"] for m in reports] == list(range(n)), f"train_mesh reports {reports}")
        run_dir = Path(storage) / "mesh"
        tp_gang = _tp_gang(torch, result, run_dir, fit_s)
        for m in reports:
            del m["tp"]  # train_tp's, read by its phase
        t0 = time.perf_counter()
        out = {}
        launches = {name: 0 for name in counters}
        vit_layers, moe_layers = _mesh_vit_config().n_layers, MESH["moe"]["n_layers"]

        def vit_per_step(part, coords):
            return {"rmsnorm_fwd": 0, "flash_attention_fwd": vit_layers,
                    "flash_bwd_dq": vit_layers, "flash_bwd_dkv": vit_layers}

        def moe_per_step(part, coords):  # the ring's share at sp coordinate s
            s, sp = coords["sp"], MESH[part]["axes"].get("sp", 1)
            return {"rmsnorm_fwd": 4 * moe_layers + 1,
                    "flash_attention_fwd": 2 * moe_layers * (s + 1),
                    "flash_bwd_dq": moe_layers * (sp - s),
                    "flash_bwd_dkv": moe_layers * (sp - s)}

        for part, cfg, axes_fn, one, per_step in (
                ("vit", _mesh_vit_config(), vit_logical_axes, vit_one, vit_per_step),
                ("moe", _mesh_moe_config(torch), moe_logical_axes, moe_one, moe_per_step),
                ("vit_sp", _mesh_vit_config(), vit_logical_axes, vit_one, vit_per_step),
                ("moe_sp", _mesh_moe_config(torch), moe_logical_axes, moe_one, moe_per_step)):
            mod = V if part.startswith("vit") else M
            spec = MESH[part]
            mesh = make_mesh(devices=[0] * n, **spec["axes"])
            shapes = mod.param_shapes(cfg)
            shardings = param_shardings(mesh, shapes, None, axes_fn)
            for m in reports:
                rep = m[part]
                want_steps = per_step(part, rep["coords"])
                for st in rep["steps"]:
                    check(st["launches"] == want_steps,
                          f"{part} rank {m['rank']}: {st['launches']} a step, want {want_steps}")
                    for name in counters:
                        launches[name] += st["launches"][name]
                itemsize = torch.empty(0, dtype=cfg.param_dtype).element_size()
                want_bytes = sum(math.prod(shardings[k].shard_shape(shapes[k], m["rank"]))
                                 * itemsize for k in shapes)
                check(rep["param_bytes"] == want_bytes,
                      f"{part} rank {m['rank']}: {rep['param_bytes']} parameter bytes resident, "
                      f"the rule table's share is {want_bytes}")
                check(all(math.isfinite(x) for x in rep["losses"]), f"{part}: losses {rep['losses']}")
                check(rep["losses"] == reports[0][part]["losses"], f"{part}: the ranks' losses differ")
            files = [torch.load(run_dir / f"mesh_{part}_grad_rank{r}.pt", mmap=True)
                     for r in range(n)]
            grads = ((k, _assemble(torch, k, shapes[k], files[0][k].dtype, shardings[k],
                                   [f[k] for f in files])) for k in shapes)
            replicated_tp = {k for k, sh in shardings.items() if "tp" not in sh.split_axes()}
            skip = {k for k in shapes if k.endswith("wk.bias")}  # its true gradient is 0
            # the ViT under sp: its loss counted once per sp rank doubles
            # every gradient
            faults = {"loss_per_sp_rank": lambda k, g: g.float() * 2} if part == "vit_sp" else {}
            res = _mesh_grad_check(torch, f"mesh {part}", grads, one["f32_grads"], one["control"],
                                   one["grads"], MESH_GRAD_TIMES, replicated_tp, mesh.shape["tp"],
                                   skip, faults)
            del grads, files
            # the first loss likewise: its distance from the f32-activation
            # run's within twice the one-rank run's
            first_loss = reports[0][part]["losses"][0]
            loss_diff = abs(first_loss - one["f32_loss"])
            loss_control = abs(one["loss"] - one["f32_loss"])
            check(loss_diff <= MESH_GRAD_TIMES * loss_control,
                  f"mesh {part}: first loss {first_loss} vs f32 activations' "
                  f"{one['f32_loss']}: {loss_diff} > {MESH_GRAD_TIMES} x {loss_control}")
            out[part] = dict(
                axes=spec["axes"], grads=res, first_loss=first_loss,
                first_loss_one_rank=one["loss"], first_loss_diff_from_f32=loss_diff,
                first_loss_one_rank_diff_from_f32=loss_control,
                first_loss_f32_activations=one["f32_loss"],
                losses=reports[0][part]["losses"],
                step_ms=[[st["step_ms"] for st in m[part]["steps"]] for m in reports],
                collective_host_share=[[st["collective_host_share"] for st in m[part]["steps"]]
                                       for m in reports],
                collective_ms_last_step=reports[0][part]["steps"][-1]["collective_ms"],
                peak_bytes=[m[part]["peak_bytes"] for m in reports],
                param_bytes=[m[part]["param_bytes"] for m in reports])
            if part == "vit_sp":
                out[part]["positions"] = sorted({tuple(m[part]["positions"]) for m in reports})
                out[part]["first_loss_per_sp_rank_over_control"] = (
                    abs(2 * first_loss - one["f32_loss"]) / loss_control)
            if part.startswith("moe"):
                out[part].update(_mesh_moe_checks(torch, part, reports, run_dir, one, shapes,
                                                  shardings))
        pipe_launches, out["pipe"] = _pipe_check(torch, reports, run_dir, pipe_one)
        for name in counters:
            launches[name] += pipe_launches[name]
        out["hier"] = _hier_check(reports)
        compare_s = time.perf_counter() - t0
    out.update(one_rank_s=one_rank_s, fit_s=fit_s, compare_s=compare_s,
               phase_s=time.perf_counter() - t_phase)
    print("train_mesh", json.dumps(out))
    return launches, out, tp_gang


def _mesh_moe_checks(torch, part, reports, run_dir, one, shapes, shardings):
    """The MoE's routing of each layer against the one-rank run's, its aux
    router gradients (and the planted local aux loss), and under sp the
    planted faults' first steps (per-rank routing offsets, RoPE at local
    positions), each of whose gradients must leave the bound on some leaf.
    Returns what it printed."""
    n = MESH["ranks"]
    layers = MESH[part]["n_layers"]
    extra = [torch.load(run_dir / f"mesh_{part}_routes_rank{r}.pt") for r in range(n)]
    out = {}
    if part == "moe_sp":
        layer_routes = _sp_routes(torch, extra, reports, "routes", layers)
    else:
        shards = {}
        for m, e in zip(reports, extra):
            i = m[part]["data_index"]
            if i in shards:  # the ep and tp ranks of one data shard route alike
                for a, b in zip(shards[i]["routes"], e["routes"]):
                    check(all(torch.equal(a[k], b[k]) for k in a),
                          "mesh MoE: the ranks of one data shard route otherwise")
            else:
                shards[i] = e
        layer_routes = [[shards[i]["routes"][l] for i in sorted(shards)] for l in range(layers)]
    out["routing"] = _mesh_routing_check(torch, layer_routes, one["routes"])
    aux_ratio, aux_planted = [], []
    for l, (a, fault) in enumerate(zip(extra[0]["aux"]["global"], extra[0]["aux"]["local"])):
        control = one["aux_control"][l]
        check(control > 0, f"mesh {part} layer {l}: aux router control 0")
        aux_ratio.append(_card_distance(torch, a, one["f32_aux"][l]) / control)
        aux_planted.append(_card_distance(torch, fault, one["f32_aux"][l]) / control)
    check(max(aux_ratio) <= MESH_GRAD_TIMES,
          f"mesh {part}: the aux loss's router gradients are {aux_ratio} x the one-rank "
          f"run's distance from f32, over {MESH_GRAD_TIMES}")
    check(max(aux_planted) > MESH_GRAD_TIMES,
          f"mesh {part}: the planted local aux loss passes the gradient check: {aux_planted}")
    out["aux_router_grad_over_control"] = aux_ratio
    out["planted_local_aux_over_control"] = aux_planted
    if part == "moe_sp":
        # the routing fault's own routing against the mesh run's: its slots
        # move; its kept flags move only where tokens drop
        bad = _sp_routes(torch, extra, reports, "per_rank_routes", layers)
        out["routing_fault"] = [
            dict(slot_differs=int((b_[0]["slot"] != g[0]["slot"]).any(dim=1).sum()),
                 keep_differs=int((b_[0]["keep"] != g[0]["keep"]).any(dim=1).sum()),
                 dropped=(~g[0]["keep"]).float().mean().item())
            for b_, g in zip(bad, layer_routes)]
        for fault in ("rope", "routing"):
            ratio = {}
            for k in extra[0]["faults"][fault]["grads"]:
                g = _assemble(torch, k, shapes[k], extra[0]["faults"][fault]["grads"][k].dtype,
                              shardings[k], [e["faults"][fault]["grads"][k] for e in extra])
                if one["control"].get(k, 0) > 0:
                    ratio[k] = _card_distance(torch, g, one["f32_grads"][k]) / one["control"][k]
            worst = max(ratio, key=ratio.get)
            out[f"planted_{fault}_over_control"] = ratio[worst]
            out[f"planted_{fault}_worst_leaf"] = worst
            out[f"planted_{fault}_loss"] = reports[0][part]["fault_losses"][fault]
            caught = ratio[worst] > MESH_GRAD_TIMES
            if fault == "routing":
                # its gradients move only through the tokens whose kept flag
                # it moves (slot numbers alone change no product), so it is
                # held by its routing too: on the same router logits it must
                # part from the global routing the mesh run took
                out["routing_fault_caught_by"] = [
                    by for by, hit in (("gradients", caught), ("routing", any(
                        r["slot_differs"] for r in out["routing_fault"]))) if hit]
                caught = bool(out["routing_fault_caught_by"])
            check(caught, f"mesh {part}: the planted {fault} fault passes the checks "
                          f"({ratio[worst]:.3f} at {worst})")
    del extra
    return out


# -- the Llama over the reference's training mesh (``train_tp``) ------------


def _tp_model_config(torch, part, dtype=None):
    """The LoRA loop's "7b" config at (a)'s or (b)'s sequence, cut to
    TP_TRAIN["n_layers"]; ``dtype`` sets the activations' (default bf16)."""
    from ray_tpu_torch.train.examples import llama_lora

    cfg = dataclasses.replace(llama_lora.model_config({**TRAIN_CONFIG, "seq": TP_TRAIN[part]["seq"]}),
                              n_layers=TP_TRAIN["n_layers"])
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _tp_inputs(torch, cfg, part, device, shard=None):
    """The parameters (each ``lora_b`` drawn too) and every step's global
    batch, from one seed: each rank draws the whole and keeps its blocks
    through ``shard``."""
    from ray_tpu_torch.models.llama import init_params

    g = torch.Generator(device=device).manual_seed(SEED + 13)

    def keep(name, t):
        if name.endswith("lora_b"):
            t.normal_(0.0, TP_TRAIN["lora_b_std"], generator=g)
        return t if shard is None else shard(name, t)

    params = init_params(cfg, g, device=device, shard=keep)
    spec = TP_TRAIN[part]
    tokens = torch.randint(0, cfg.vocab_size, (spec["steps"], spec["batch"], spec["seq"]),
                           generator=g, device=device)
    return params, tokens


def _tp_token_nll(torch, L, model, tokens):
    """Each of the rank's positions' NLL of its next token under the
    first step's weights (f32, host): (rows, S / sp), one fewer on the last
    sequence shard, as ``next_token_loss`` pairs them."""
    with torch.no_grad():
        logits = model(tokens)
    s = logits.shape[1]
    first = model.sp_rank * s + 1
    targets = tokens[:, first:first + s]
    return L.token_nll(logits[:, :targets.shape[1]], targets).cpu()


def _tp_f32_loss(torch, L, model, part, mesh, tokens):
    """The first loss of the mesh model's blocks in f32 activations: a
    model of the part's f32 config over the same tensors (no copy), forward
    only."""
    cfg = _tp_model_config(torch, part, torch.float32)
    f32 = L.build_llama(cfg, {k: p.detach() for k, p in model.named_parameters()}, mesh)
    with torch.no_grad():
        return L.next_token_loss(cfg, f32, tokens).item()


def _tp_mlp_fault(torch, L, model, cfg, tokens):
    """The planted fault: the first step's LoRA gradients, synced, with the
    MLP's tp sum dropped (each rank's w_down partial sums taken for the
    sum), on the host; no update."""
    import torch.nn.functional as F

    forward = L.MLP.forward

    def no_sum(self, x):
        x = L.copy_to_group(x, self.tp_group)
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))

    L.MLP.forward = no_sum
    try:
        L.next_token_loss(cfg, model, tokens).backward()
        model.fsdp.sync_gradients(model.named_parameters())
        out = {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}
    finally:
        L.MLP.forward = forward
    model.zero_grad(set_to_none=True)
    return out


def _tp_round(torch, rank, counters, run_dir):
    """This rank's part of ``train_tp`` in a gang of eight gloo ranks
    sharing the card: ranks 0-3 run (a), the 2-layer 7B LoRA model over
    tp=2 x fsdp=2, and ranks 4-7 (b), over sp=2 x tp=2, at once (every rank
    forms both meshes' groups, in one order), each through the loop's
    ``lora_model``, ``lora_train_step`` and ``mesh_gradients``; the first
    step's LoRA gradient blocks (the rank's own and synced), the
    positions' NLLs and for (a) the MLP fault's gradients written to
    ``run_dir``; every step's ms, K1-K4 launches (set to 0 just before it,
    read just after) and collectives. Returns the rank's report."""
    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.parallel.fsdp import FSDP
    from ray_tpu_torch.parallel.mesh import BATCH_AXES, make_mesh
    from ray_tpu_torch.train.examples import llama_lora
    from ray_tpu_torch.util import metrics

    device = _card(torch)
    meshes = {}
    for i, part in enumerate(("a", "b")):
        ranks = list(range(i * TP_TRAIN["ranks"], (i + 1) * TP_TRAIN["ranks"]))
        meshes[part] = make_mesh(devices=[str(device)] * len(ranks),
                                 **TP_TRAIN[part]["axes"]).form_groups(
            "gloo", world_ranks=ranks, name=f"tp_{part}")
    part = "a" if rank < TP_TRAIN["ranks"] else "b"
    mesh, spec = meshes[part], TP_TRAIN[part]
    cfg = _tp_model_config(torch, part)
    params, tokens = _tp_inputs(torch, cfg, part, device, shard=FSDP.for_llama(cfg, mesh).shard)
    model, lora, optimizer = llama_lora.lora_model(cfg, params, lr=TP_TRAIN["lr"], mesh=mesh)
    del params
    n, i = mesh.axes_size(BATCH_AXES), mesh.axes_index(BATCH_AXES)
    tokens = tokens[:, i * spec["batch"] // n:(i + 1) * spec["batch"] // n].contiguous()
    nll = _tp_token_nll(torch, L, model, tokens[0])
    f32_loss = _tp_f32_loss(torch, L, model, part, mesh, tokens[0])
    fault = _tp_mlp_fault(torch, L, model, cfg, tokens[0]) if part == "a" else None
    first = _FirstGradients(llama_lora.mesh_gradients(model))
    torch.cuda.reset_peak_memory_stats()
    steps, losses = [], []
    for t in tokens:  # (a) and (b) take as many steps: the steps' barriers pair up
        loss, stats = _mesh_step_stats(
            torch, metrics, counters,
            lambda t=t: llama_lora.lora_train_step(model, optimizer, t, first))
        steps.append(stats)
        losses.append(float(loss))  # the global batch's on every rank
    peak = torch.cuda.max_memory_allocated()
    torch.save({"synced": first.reduced, "local": first.local, "mlp_fault": fault, "nll": nll},
               Path(run_dir) / f"tp_{part}_grad_rank{mesh.rank}.pt")
    return dict(part=part, mesh_rank=mesh.rank, coords=mesh.coords(), data_index=i,
                steps=steps, losses=losses, f32_loss=f32_loss, peak_bytes=peak,
                param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))


def train_tp_loop(config):
    """``train_tp`` alone: one of eight gloo ranks sharing the card, running
    its :func:`_tp_round` (``train_mesh_loop`` runs the same round after its
    own, in its gang)."""
    import torch

    from ray_tpu_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)  # eight ranks share the host's cores
    ctx = train.get_context()
    train.report({"rank": ctx.world_rank, "device": str(_card(torch)),
                  "tp": _tp_round(torch, ctx.world_rank, _port_counters(),
                                  ctx.get_storage_path())})


def _tp_gang(torch, result, run_dir, fit_s):
    """What ``train_tp_phase`` reads of a gang that ran :func:`_tp_round`:
    each part's four reports in mesh-rank order and their files."""
    by_part = {"a": {}, "b": {}}
    for m in result.metrics_history:
        if "tp" in m:
            by_part[m["tp"]["part"]][m["tp"]["mesh_rank"]] = m["tp"]
    n = TP_TRAIN["ranks"]
    check(all(sorted(v) == list(range(n)) for v in by_part.values()),
          f"train_tp reports {by_part}")
    return dict(fit_s=fit_s, reports={p: [v[r] for r in range(n)] for p, v in by_part.items()},
                files={p: [torch.load(Path(run_dir) / f"tp_{p}_grad_rank{r}.pt")
                           for r in range(n)] for p in by_part})


def _tp_one_rank(torch, part):
    """(a)'s or (b)'s 2-layer model on the whole first global batch on one
    rank, in bf16 and in f32 activations: the bf16 run's first loss and
    LoRA gradients (host) and, per leaf, its distance from the f32 run's."""
    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.train.examples import llama_lora

    device = _card(torch)
    runs = {}
    for dtype in (None, torch.float32):
        cfg = _tp_model_config(torch, part, dtype)
        params, tokens = _tp_inputs(torch, cfg, part, device)
        model, lora, _ = llama_lora.lora_model(cfg, params, lr=TP_TRAIN["lr"])
        del params
        nll = _tp_token_nll(torch, L, model, tokens[0])
        loss = L.next_token_loss(cfg, model, tokens[0])
        loss.backward()
        runs[dtype] = (loss.item(), {k: p.grad.cpu() for k, p in lora.items()}, nll)
        del model, lora, loss, tokens
        torch.cuda.empty_cache()
    (loss, grads, nll), (f32_loss, f32_grads, f32_nll) = runs[None], runs[torch.float32]
    control = {k: _card_distance(torch, g, f32_grads[k]) for k, g in grads.items()}
    return dict(loss=loss, grads=grads, control=control, f32_loss=f32_loss, f32_grads=f32_grads,
                nll=nll, f32_nll=f32_nll, nll_control=(nll - f32_nll).norm().item())


def train_tp_phase(torch, counters, gang=None):
    """The Llama over the reference's training mesh, each part on four
    gloo ranks sharing the card (:func:`_tp_round`, in ``train_mesh``'s
    gang when ``gang`` holds its reports, else in a gang of its own),
    against one-rank runs on the whole global batch in this process: (a)
    tp=2 x fsdp=2, seq 2048, batch 2; (b) sp=2 x tp=2, b=1 x 4096; 2 AdamW
    steps each. Held: every rank's K1-K4 launches a step exact (4L+1 /
    2L(s+1) / L(sp-s) / L(sp-s) at sp coordinate s); each rank's resident
    parameter bytes the rule table's share exactly; the ranks' losses
    equal and finite, the first one the mean of the positions' NLLs; those
    NLLs and the first step's LoRA gradients, leaf by leaf, within
    MESH_GRAD_TIMES x the one-rank run's distance from its f32-activation
    run; the first loss of the ranks' blocks in f32 activations the
    one-rank f32 run's within TP_F32_LOSS_REL of itself; and three planted
    faults beyond it: the MLP's tp sum dropped
    ((a)), the sp sum of the gradients dropped ((b): each rank's own
    term), a tp-replicated factor's gradient summed over tp (both).
    Printed: step ms, peak and the collectives' host share a rank."""
    import math
    import multiprocessing
    import tempfile

    from ray_tpu_torch.models.llama import param_shapes
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import param_shardings
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    t_phase = time.perf_counter()
    n = TP_TRAIN["ranks"]
    if gang is None:
        _zero(counters)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as storage:
            t0 = time.perf_counter()
            result = TorchTrainer(train_tp_loop, train_loop_config={},
                                  run_config=RunConfig(name="tp", storage_path=storage),
                                  scaling_config=ScalingConfig(2 * n, {"GPU": 0.5 / n}),
                                  backend_config=TorchConfig(backend="gloo")).fit()
            if result.error is not None:
                raise result.error
            parent = _launches(counters)
            check(not any(parent.values()),
                  f"the train_tp loop launched kernels in the parent: {parent}")
            check(not multiprocessing.active_children(), "the worker group left a process")
            gang = _tp_gang(torch, result, Path(storage) / "tp", time.perf_counter() - t0)
    print("train_tp_fit", json.dumps(dict(fit_s=gang["fit_s"], reports=gang["reports"])))
    # the yardsticks after the ranks' fit: this process's counts were read
    # just after it
    t0 = time.perf_counter()
    one = {part: _tp_one_rank(torch, part) for part in ("a", "b")}
    one_rank_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = {}
    launches = {name: 0 for name in counters}
    for part in ("a", "b"):
        spec = TP_TRAIN[part]
        cfg = _tp_model_config(torch, part)
        layers = cfg.n_layers
        mesh = make_mesh(devices=[0] * n, **spec["axes"])
        sp = mesh.shape["sp"]
        shapes = param_shapes(cfg)
        shardings = param_shardings(mesh, shapes)
        itemsize = torch.empty(0, dtype=cfg.param_dtype).element_size()
        want_bytes = sum(math.prod(shardings[k].shard_shape(shapes[k])) * itemsize
                         for k in shapes)
        per_rank = []
        reports = gang["reports"][part]
        for r, rep in enumerate(reports):
            s = rep["coords"]["sp"]
            per_step = {"rmsnorm_fwd": 4 * layers + 1,
                        "flash_attention_fwd": 2 * layers * (s + 1),
                        "flash_bwd_dq": layers * (sp - s), "flash_bwd_dkv": layers * (sp - s)}
            per_rank.append(per_step)
            for st in rep["steps"]:
                check(st["launches"] == per_step,
                      f"tp {part} rank {r}: {st['launches']} a step, want {per_step}")
                for name in counters:
                    launches[name] += st["launches"][name]
            check(rep["param_bytes"] == want_bytes,
                  f"tp {part} rank {r}: {rep['param_bytes']} parameter bytes "
                  f"resident, the rule table's share is {want_bytes}")
            check(all(math.isfinite(x) for x in rep["losses"]), f"tp {part}: {rep['losses']}")
            check(rep["losses"] == reports[0]["losses"],
                  f"tp {part}: the ranks' losses differ")
        files = gang["files"][part]
        names = sorted(files[0]["synced"])
        grads = ((k, _assemble(torch, k, shapes[k], files[0]["synced"][k].dtype,
                               shardings[k], [f["synced"][k] for f in files]))
                 for k in names)
        replicated_tp = {k for k in names if "tp" not in shardings[k].split_axes()}
        res = _mesh_grad_check(torch, f"tp {part}", grads, one[part]["f32_grads"],
                               one[part]["control"], one[part]["grads"], MESH_GRAD_TIMES,
                               replicated_tp, mesh.shape["tp"])
        # the part's own planted fault, from its files: beyond the bound
        key, what = (("mlp_fault", "the MLP's tp sum dropped") if part == "a" else
                     ("local", "the sp sum of the gradients dropped"))
        planted = max(
            _card_distance(torch, _assemble(torch, k, shapes[k], files[0][key][k].dtype,
                                            shardings[k], [f[key][k] for f in files],
                                            same=False), one[part]["f32_grads"][k])
            / one[part]["control"][k] for k in names)
        check(planted > MESH_GRAD_TIMES,
              f"tp {part}: the planted fault ({what}) passes the gradient check: {planted}")
        # the first loss: every position's NLL (the ranks' positions
        # assembled; the ranks of a tp group hold one, bit for bit)
        # within MESH_GRAD_TIMES x the one-rank run's distance from f32
        # (a scalar alone is one draw of the rounding: two bf16 runs'
        # losses part from f32 by ratios of 3 and more by chance), and
        # the loss every rank returned the mean of them (its sums over
        # the ranks and its count)
        b, seq = spec["batch"], spec["seq"]
        nll = torch.full((b, seq - 1), float("nan"))
        for rep, f in zip(reports, files):
            i, c = rep["data_index"], rep["coords"]["sp"]
            rows = slice(i * b // mesh.axes_size(("dcn", "dp", "fsdp")),
                         (i + 1) * b // mesh.axes_size(("dcn", "dp", "fsdp")))
            cols = slice(c * seq // sp, c * seq // sp + f["nll"].shape[1])
            held = nll[rows, cols]
            check(held.isnan().all() or torch.equal(held, f["nll"]),
                  f"tp {part}: the ranks of one tp group have other NLLs")
            nll[rows, cols] = f["nll"]
        check(not nll.isnan().any(), f"tp {part}: positions without an NLL")
        nll_ratio = (nll - one[part]["f32_nll"]).norm().item() / one[part]["nll_control"]
        check(nll_ratio <= MESH_GRAD_TIMES,
              f"tp {part}: the first step's NLLs are {nll_ratio:.3f} x the one-rank run's "
              f"distance from f32 activations away from them, over {MESH_GRAD_TIMES}")
        first_loss = reports[0]["losses"][0]
        mean = nll.double().mean().item()
        check(abs(first_loss - mean) <= 1e-5 * abs(mean),
              f"tp {part}: first loss {first_loss}, its positions' mean NLL {mean}")
        loss_diff = abs(first_loss - one[part]["f32_loss"])
        loss_control = abs(one[part]["loss"] - one[part]["f32_loss"])
        # the second witness of the first loss: the mesh's blocks in f32
        # activations against the one-rank f32 run, where rounding leaves
        # no room for a shift (a bf16 run's scalar is one draw of it)
        f32_losses = {rep["f32_loss"] for rep in reports}
        check(len(f32_losses) == 1, f"tp {part}: the ranks' f32 losses differ: {f32_losses}")
        f32_rel = abs(reports[0]["f32_loss"] - one[part]["f32_loss"]) / abs(one[part]["f32_loss"])
        check(f32_rel <= TP_F32_LOSS_REL,
              f"tp {part}: the f32 first loss {reports[0]['f32_loss']} is {f32_rel:.3g} of "
              f"itself from the one-rank f32 run's {one[part]['f32_loss']}, over "
              f"{TP_F32_LOSS_REL}")
        out[part] = dict(
            axes=spec["axes"], grads=res, planted_fault=what, planted_over_control=planted,
            nll_over_control=nll_ratio, first_loss_minus_nll_mean=first_loss - mean,
            first_loss=first_loss, first_loss_one_rank=one[part]["loss"],
            first_loss_diff_from_f32=loss_diff,
            first_loss_one_rank_diff_from_f32=loss_control,
            first_loss_f32_activations=one[part]["f32_loss"],
            mesh_first_loss_f32_activations=reports[0]["f32_loss"],
            f32_first_loss_rel_diff=f32_rel,
            losses=reports[0]["losses"],
            step_ms=[[st["step_ms"] for st in rep["steps"]] for rep in reports],
            collective_host_share=[[st["collective_host_share"] for st in rep["steps"]]
                                   for rep in reports],
            collective_ms_last_step=reports[0]["steps"][-1]["collective_ms"],
            peak_bytes=[rep["peak_bytes"] for rep in reports],
            param_bytes=[rep["param_bytes"] for rep in reports],
            param_bytes_whole=sum(math.prod(shapes[k]) * itemsize for k in shapes),
            launches_per_step=per_rank)
    compare_s = time.perf_counter() - t0
    out.update(one_rank_s=one_rank_s, fit_s=gang["fit_s"], compare_s=compare_s,
               phase_s=time.perf_counter() - t_phase)
    print("train_tp", json.dumps(out))
    return launches, out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    if not (ROOT / "ray_tpu_torch" / "csrc").is_dir():
        fail(f"no ray_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    # each phase's wall seconds, from the end of the one before (where the
    # time limit goes)
    wall = {"start": time.perf_counter()}
    phase_s = {}

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - wall["start"]
        wall["start"] = now
        print(f"lap {name} {phase_s[name]:.1f} s", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from ray_tpu_torch._internal import kernels

    build_s = kernels.build()
    lap("build")
    print(f"build: {kernels.sources()} in {build_s:.3f} s")

    rms_rows = rmsnorm_phase(torch, F)
    lap("rmsnorm")
    flash_rows = flash_phase(torch, F)
    lap("flash")
    bwd_rows = flash_bwd_phase(torch, F)
    lap("flash_bwd")
    sass_phase()
    lap("sass")
    grad_parity_phase(torch, np)
    lap("grad_parity")

    counters = _port_counters()
    # the serving path: serving, then the full forward; counts set to 0
    # inside serve_phase just before its requests and read here, after both
    server, prompts, serve = serve_phase(torch, np)
    forward_phase(torch, server, prompts)
    lap("serve")
    serve_launches = {name: fn.launches for name, fn in counters.items()}
    for name in ("rmsnorm_fwd", "flash_attention_fwd"):
        check(serve_launches[name] > 0, f"{name} was not launched on the serving path")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(serve_launches[name] == 0, f"{name} was launched on the serving path")

    # the runtime core: an LLMServer actor on the card's GPU lease serves the
    # same requests in a worker process; the worker's counts are set to 0
    # just before its requests and read just after its device-object
    # prefill (this process's stay 0 meanwhile). Its cluster stays up for
    # serve_deploy
    runtime_launches, _, cluster = runtime_serve_phase(torch, server, prompts, counters)
    lap("runtime_serve")
    for name in ("rmsnorm_fwd", "flash_attention_fwd"):
        check(runtime_launches[name] > 0, f"{name} was not launched on the runtime_serve path")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(runtime_launches[name] == 0, f"{name} was launched on the runtime_serve path")
    torch.cuda.empty_cache()

    # the continuous-batching path: counts set to 0 here, read after its
    # three phases; it runs K1 only (decode-mode attention throughout)
    for fn in counters.values():
        fn.launches = 0
    cb_server, cb, cb_traffic = cb_serve_phase(torch, np, server, serve)
    serve_obs_phase(torch, np, cb_server, cb)
    del cb_server
    torch.cuda.empty_cache()
    cb_parity_phase(torch, np, server.engine._params)
    cb_spec_chunk_phase(torch, np, server.engine._params)
    lap("serve_cb")
    cb_launches = {name: fn.launches for name, fn in counters.items()}
    check(cb_launches["rmsnorm_fwd"] > 0, "rmsnorm_fwd was not launched on the serve_cb path")
    for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(cb_launches[name] == 0, f"{name} was launched on the serve_cb path")

    # the serve control plane on runtime_serve's cluster: two replicas on
    # card 0's halves answer serve_cb's traffic; this process's counts stay
    # 0, the replicas' own are set to 0 just before the traffic and read
    # just after the HTTP and streamed requests; it runs K1 only
    deploy_launches, _ = serve_deploy_phase(torch, np, cluster, cb_traffic, cb, server,
                                            counters)
    del cluster
    lap("serve_deploy")
    check(deploy_launches["rmsnorm_fwd"] > 0,
          "rmsnorm_fwd was not launched on the serve_deploy path")
    for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(deploy_launches[name] == 0, f"{name} was launched on the serve_deploy path")
    torch.cuda.empty_cache()

    # the multi-tenant LoRA path: counts set to 0 here, read after its phase;
    # it runs K1 only, as serve_cb does
    for fn in counters.values():
        fn.launches = 0
    lora_out = serve_lora_phase(torch, np, server.engine._params, cb)
    lap("serve_lora")
    lora_launches = {name: fn.launches for name, fn in counters.items()}
    check(lora_launches["rmsnorm_fwd"] > 0, "rmsnorm_fwd was not launched on the serve_lora path")
    for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(lora_launches[name] == 0, f"{name} was launched on the serve_lora path")

    # disaggregated prefill/decode and the KV tier: counts set to 0 here,
    # read after its phase; it runs K1 only: both roles' admission prefill
    # is decode-mode, as the reference's (no flash attention)
    for fn in counters.values():
        fn.launches = 0
    serve_disagg_phase(torch, np, server.engine._params)
    lap("serve_disagg")
    disagg_launches = {name: fn.launches for name, fn in counters.items()}
    check(disagg_launches["rmsnorm_fwd"] > 0,
          "rmsnorm_fwd was not launched on the serve_disagg path")
    for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(disagg_launches[name] == 0, f"{name} was launched on the serve_disagg path")
    # tensor-parallel serving: counts of this process (rank 0) set to 0 inside
    # the phase just before its first tp=2 server and read just after its
    # last one closes (the tp=1 comparisons run outside), with the spawned
    # ranks' own counts, read before each closes, added; it runs K1 only, as
    # serve_cb does
    torch.cuda.empty_cache()
    _, tp_launches = serve_tp_phase(torch, np, server.engine._params, counters)
    lap("serve_tp")
    check(tp_launches["rmsnorm_fwd"] > 0, "rmsnorm_fwd was not launched on the serve_tp path")
    for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(tp_launches[name] == 0, f"{name} was launched on the serve_tp path")
    torch.cuda.empty_cache()
    # the serving features of a tensor-parallel replica: counts set to 0
    # inside the phase just before its first tp=2 server and read just after
    # its last one closes, the spawned ranks' own counts added, as serve_tp;
    # it runs K1 only
    _, tpf_launches = serve_tp_features_phase(torch, np, server.engine._params, counters,
                                              lora_out)
    lap("serve_tp_features")
    check(tpf_launches["rmsnorm_fwd"] > 0,
          "rmsnorm_fwd was not launched on the serve_tp_features path")
    for name in ("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(tpf_launches[name] == 0, f"{name} was launched on the serve_tp_features path")
    torch.cuda.empty_cache()
    profile_phase(torch, server, prompts[1])
    lap("profile")
    del server  # the training phase's peak memory is its own
    torch.cuda.empty_cache()

    # the training path: counts set to 0 inside train_phase just before
    # fit() and read just after it
    train_launches, train_out, train_lora = train_phase(torch, counters)
    lap("train")
    torch.cuda.empty_cache()
    # data-parallel training: the counts of this process are set to 0 just
    # before (b)'s fit() and read just after it (they must stay 0: the loop
    # runs in a spawned worker), and the worker's own counts, set to 0 just
    # before its loop and read just after it, are added
    dp_launches, dp_out, fsdp_worker = train_dp_phase(torch, np, counters, train_out,
                                                      train_lora)
    lap("train_dp")
    torch.cuda.empty_cache()
    # FSDP: the counts of this process are set to 0 just before (a)'s fit()
    # and must stay 0 (the loops run in spawned workers); each worker's own
    # counts, set to 0 just before its loop or steps and read just after,
    # are added ((a) and (b)'s FSDP pair; the replicated pair is its yardstick)
    fsdp_launches, _, pair = train_fsdp_phase(torch, np, counters, train_out, train_lora,
                                              dp_out, fsdp_worker)
    del fsdp_worker
    lap("train_fsdp")
    del train_lora
    torch.cuda.empty_cache()
    # sequence parallelism: the counts of this process are set to 0 just
    # before the pair's fit() and must stay 0 (the one-rank yardsticks run
    # before it); each rank's own counts, set to 0 just before its ops and
    # again before its steps and read just after each, are added
    sp_launches, _ = train_sp_phase(torch, counters, pair)
    del pair["sp"]
    lap("train_sp")
    torch.cuda.empty_cache()
    # the vision training paths: counts set to 0 inside each phase just
    # before its first step and read just after its last (before its parity
    # runs)
    resnet_launches, resnet_out = train_resnet_phase(torch, counters)
    lap("train_resnet")
    torch.cuda.empty_cache()
    # sync-BN data parallelism: the counts of this process are set to 0 just
    # before (a)'s fit(); the workers' own counts are added (0: ResNet runs
    # none of the port's kernels)
    resnet_dp_launches, _ = train_resnet_dp_phase(torch, counters, resnet_out, pair["resnet"])
    del pair
    lap("train_resnet_dp")
    torch.cuda.empty_cache()
    vit_launches, _ = train_vit_phase(torch, counters)
    lap("train_vit")
    torch.cuda.empty_cache()
    # RLlib PPO: counts set to 0 at the start of the phase and read after
    # its timed iterations and profiled update (before its parity runs)
    ppo_launches, _ = train_ppo_phase(torch, np, counters)
    lap("train_ppo")
    torch.cuda.empty_cache()
    # the rest of RLlib: counts set to 0 at the start of the phase and read
    # at its end (its parity runs included)
    rl_launches, _ = train_rl_phase(torch, np, counters)
    lap("train_rl")
    torch.cuda.empty_cache()
    # DreamerV3: counts set to 0 at the start of the phase and read at its
    # end (its parity runs included)
    dreamer_launches, _ = train_dreamer_phase(torch, np, counters)
    lap("train_dreamer")
    torch.cuda.empty_cache()
    # Mixtral-8x7B training: counts set to 0 at the start of the phase and
    # read after its profiled step (before its dense-vs-indexed and parity
    # runs)
    moe_launches, _ = train_moe_phase(torch, counters)
    lap("train_moe")
    torch.cuda.empty_cache()
    # the models over multi-axis meshes: the counts of this process are set
    # to 0 just before the ranks' fit() and must stay 0 (the one-rank
    # yardsticks run before it); each rank's own counts, set to 0 just
    # before each of its steps and read just after, are added
    mesh_launches, _, tp_gang = train_mesh_phase(torch, counters)
    lap("train_mesh")
    torch.cuda.empty_cache()
    # the Llama over the reference's training mesh, whose round the
    # train_mesh ranks ran after their own (this process's counts stayed 0
    # through that fit); each rank's own counts, set to 0 just before each
    # of its steps and read just after, are added
    tp_train_launches, _ = train_tp_phase(torch, counters, tp_gang)
    lap("train_tp")
    paths = {"serve": serve_launches, "runtime_serve": runtime_launches,
             "serve_cb": cb_launches, "serve_deploy": deploy_launches,
             "serve_lora": lora_launches,
             "serve_disagg": disagg_launches, "serve_tp": tp_launches,
             "serve_tp_features": tpf_launches, "train": train_launches,
             "train_dp": dp_launches, "train_fsdp": fsdp_launches, "train_sp": sp_launches,
             "train_resnet": resnet_launches, "train_resnet_dp": resnet_dp_launches,
             "train_vit": vit_launches,
             "train_ppo": ppo_launches, "train_rl": rl_launches,
             "train_dreamer": dreamer_launches, "train_moe": moe_launches,
             "train_mesh": mesh_launches, "train_tp": tp_train_launches}
    launches = {name: sum(p[name] for p in paths.values()) for name in counters}

    def entry(name, source, replaces, rows):
        main_row = rows[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "launches_by_path": {path: p[name] for path, p in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        }

    print("phase_s", json.dumps(phase_s))
    print(json.dumps({"kernels": [
        entry("rmsnorm_fwd", "ray_tpu_torch/csrc/rmsnorm.cu",
              "ray_tpu/ops/rmsnorm.py:25", rms_rows),
        entry("flash_attention_fwd", "ray_tpu_torch/csrc/flash_attention.cu",
              "ray_tpu/ops/flash_attention.py:44", flash_rows),
        entry("flash_bwd_dq", "ray_tpu_torch/csrc/flash_attention_bwd.cu",
              "ray_tpu/ops/flash_attention.py:180", bwd_rows["flash_bwd_dq"]),
        entry("flash_bwd_dkv", "ray_tpu_torch/csrc/flash_attention_bwd.cu",
              "ray_tpu/ops/flash_attention.py:240", bwd_rows["flash_bwd_dkv"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
