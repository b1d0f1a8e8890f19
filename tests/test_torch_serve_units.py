"""The port's serve control plane, unit by unit, against ray_tpu.serve, and
its repairs on a fake two-card node.

In process, on both packages: the rendezvous ring's picks
(``ReplicaRing``), the SLO autoscaler's pure ``evaluate`` over seeded
signal streams with its TTFT and shed readers over the same metric
payloads, the configs and their errors, and the ``@serve.batch`` and
``@serve.multiplexed`` sequences; results must be equal. Then one port
cluster on a node detected with two cards (``CUDA_VISIBLE_DEVICES=0,1``,
the workers importing the two-card stand-in for torch of
tests/torch_fake_cuda): kept item 38 (``resources_per_replica`` reaches
the lease), kept item 39 (a fractional ``GPU`` lease takes its share of
one card and binds to it), and the closed-loop SLO autoscaler of
tests/test_autoscale_serve.py, whose reference test fails for a fault of
its own (kept item 41).
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import threading
import time
from pathlib import Path

import pytest
import torch  # the real torch, cached before the fake one goes on the workers' path

import ray_tpu.serve as ref_serve
import ray_tpu_torch.serve as port_serve
import torch_serve_programs as P
from ray_tpu.serve import autoscale as ref_as
from ray_tpu.serve import batching as ref_batching
from ray_tpu.serve import config as ref_config
from ray_tpu.serve import multiplex as ref_mux
from ray_tpu.serve.hash_ring import ReplicaRing as RefRing
from ray_tpu_torch.serve import autoscale as port_as
from ray_tpu_torch.serve import batching as port_batching
from ray_tpu_torch.serve import config as port_config
from ray_tpu_torch.serve import multiplex as port_mux
from ray_tpu_torch.serve.hash_ring import ReplicaRing as PortRing

_HERE = Path(__file__).resolve().parent


# -- the rendezvous ring ------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16])
def test_replica_ring_picks_match_reference(n):
    """Every key, signed or past 64 bits included, picks the reference's
    replica, with and without exclusions (an exclusion of every id falls
    back to the unfiltered winner)."""
    rng = random.Random(n)
    ids = [f"app#Dep#{rng.randrange(10_000)}" for _ in range(n)]
    ref, port = RefRing(ids), PortRing(ids)
    assert port.ids == ref.ids and len(port) == len(ref)
    keys = [rng.getrandbits(64) for _ in range(300)] + [-1, 0, 2**70 + 5, -(2**40)]
    for key in keys:
        assert port.lookup_index(key) == ref.lookup_index(key)
        assert port.lookup(key) == ref.lookup(key)
        exclude = set(rng.sample(ids, rng.randrange(0, n + 1)))
        assert port.lookup_excluding(key, exclude) == ref.lookup_excluding(key, exclude)


# -- the SLO autoscaler --------------------------------------------------------------

_POLICIES = [
    {},
    {"target_ttft_p99_ms": 200.0, "max_shed_per_interval": 1.0, "up_hysteresis": 2,
     "down_hysteresis": 2, "cooldown_up_s": 1.0, "cooldown_down_s": 2.0,
     "scale_up_step": 2, "max_replicas": 6},
    {"target_queue_per_replica": 0.0, "target_ttft_p99_ms": 50.0, "min_replicas": 2,
     "max_replicas": 3, "idle_queue_per_replica": 1.0, "scale_down_step": 3},
]


@pytest.mark.parametrize("case", range(len(_POLICIES)))
def test_evaluate_matches_reference_over_seeded_signals(case):
    """200 ticks of seeded signals (queue, sheds, TTFT p99 or none,
    starting replicas) through both state machines: every decision and
    every state field equal, the target following the decisions."""
    rng = random.Random(case)
    ref_pol = ref_as.AutoscalePolicy(**_POLICIES[case])
    port_pol = port_as.AutoscalePolicy(**_POLICIES[case])
    assert port_pol.as_dict() == ref_pol.as_dict()
    ref_st, port_st = ref_as.AutoscaleState(), port_as.AutoscaleState()
    target, now, decisions = ref_pol.min_replicas, 100.0, 0
    for _ in range(200):
        now += rng.choice([0.25, 0.5, 1.0, 3.0])
        sig = dict(queue_depth=0.0, queue_per_replica=rng.choice([0.0, 0.3, 1.0, 2.5, 5.0, 9.0]),
                   shed_delta=rng.choice([0.0, 0.0, 0.0, 1.0, 4.0]),
                   ttft_p99_ms=rng.choice([None, 20.0, 80.0, 400.0]),
                   running=target, starting=rng.choice([0, 0, 0, 1]), target=target)
        want = ref_as.evaluate(ref_pol, ref_st, ref_as.AutoscaleSignals(**sig), now)
        got = port_as.evaluate(port_pol, port_st, port_as.AutoscaleSignals(**sig), now)
        assert (dataclasses.asdict(got) if got else None) == (
            dataclasses.asdict(want) if want else None)
        assert dataclasses.asdict(port_st) == dataclasses.asdict(ref_st)
        if want is not None:
            target, decisions = want.to_replicas, decisions + 1
    assert decisions >= 3  # the state machine was exercised both ways


def test_ttft_and_shed_readers_match_reference():
    """The windowed TTFT p99 (serve's histogram, else the engine's
    kvcache_ttft_ms) and the cumulative shed total over the same payloads,
    window after window, with the baselines each keeps."""
    from ray_tpu_torch.util import metrics

    dep = "app#Dep"
    ref_st, port_st = ref_as.AutoscaleState(), port_as.AutoscaleState()
    rng = random.Random(3)
    seen = []
    for window in range(6):
        for _ in range(rng.randrange(0, 30)):
            metrics.record_serve_ttft(dep, rng.choice([0.004, 0.03, 0.2, 0.7, 3.0]))
        for _ in range(window % 3):
            metrics.record_serve_shed(dep)
        payloads = [metrics.local_payload()]
        got = (port_as.shed_total(payloads, dep), port_as.ttft_p99_ms(payloads, dep, port_st))
        want = (ref_as.shed_total(payloads, dep), ref_as.ttft_p99_ms(payloads, dep, ref_st))
        assert got == want
        assert dataclasses.asdict(port_st) == dataclasses.asdict(ref_st)
        seen.append(got)
    assert any(t is not None for _, t in seen) and seen[-1][0] > 0
    assert port_as.ttft_p99_ms([], dep, port_st) is None  # nothing pushed: the port's cluster


# -- configs and their errors ----------------------------------------------------------


class _Plain:
    def __call__(self, x):
        return x


def _sync_loader(self, model_id):
    return model_id


def _errors(serve, config, autoscale):
    def attempt(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, str(e)
        return None

    return [
        attempt(lambda: autoscale.AutoscalePolicy(min_replicas=0)),
        attempt(lambda: autoscale.AutoscalePolicy(min_replicas=3, max_replicas=2)),
        attempt(lambda: autoscale.AutoscalePolicy(interval_s=0)),
        attempt(lambda: serve.deployment(_Plain, bogus=1)),
        attempt(lambda: serve.deployment(_Plain).options(bogus=1)),
        attempt(lambda: serve.deployment(_Plain, autoscaling_config={"bogus": 1})),
        attempt(lambda: serve.batch(_sync_loader)),
        attempt(lambda: serve.multiplexed(_sync_loader)),
        dataclasses.asdict(config.DeploymentConfig()),
        config.RequestRouterConfig().as_dict(),
        [config.AutoscalingConfig(min_replicas=1, max_replicas=5,
                                  target_ongoing_requests=2).desired_replicas(q, cur)
         for q in (0, 1, 3, 9, 40) for cur in (0, 1, 3)],
        serve.deployment(_Plain, num_replicas=3, name="X").options(
            max_ongoing_requests=7)._config.__dict__.keys() == config.DeploymentConfig().__dict__.keys(),
    ]


def test_config_errors_and_defaults_match_reference():
    got = _errors(port_serve, port_config, port_as)
    assert got == _errors(ref_serve, ref_config, ref_as)
    assert got[0] == ("ValueError", "min_replicas must be >= 1")
    assert got[3][0] == "TypeError" and got[4] == ("ValueError", "unknown deployment option 'bogus'")


# -- @serve.batch and @serve.multiplexed --------------------------------------------------


def _batch_sequence(batching, mux):
    """Twelve calls in three model partitions, 8 at once then 4 more after
    a pause, through ``batch(max_batch_size=3)``: the batches each handler
    run saw, with the model id it ran under."""
    seen = []

    async def handler(items):
        seen.append((mux.get_multiplexed_model_id(), list(items)))
        if "boom" in items:
            raise RuntimeError("batch exploded")
        return [f"{mux.get_multiplexed_model_id()}:{i}" for i in items]

    batched = batching.batch(max_batch_size=3, batch_wait_timeout_s=0.05)(handler)

    async def call(item, model):
        mux._set_multiplexed_model_id(model)
        try:
            return await batched(item)
        except RuntimeError as e:
            return f"error:{e}"

    async def main():
        first = await asyncio.gather(*(call(i, ["", "a", "b"][i % 3]) for i in range(8)))
        await asyncio.sleep(0.1)
        second = await asyncio.gather(*(call(x, "a") for x in (8, "boom", 10, 11)))
        return first + second

    results = asyncio.run(main())
    return results, seen


def _mux_sequence(mux):
    loads = []

    class Holder:
        @mux.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            loads.append(model_id)
            return {"id": model_id}

    holder = Holder()

    async def main():
        out = []
        for m in ["m1", "m2", "m1", "m3", "m2", "m2", "m1", "m3"]:
            out.append((await holder.get_model(m))["id"])
        mux._set_multiplexed_model_id("m4")
        out.append((await holder.get_model())["id"])
        # concurrent misses of one id load it once
        out += [r["id"] for r in await asyncio.gather(*(holder.get_model("m5") for _ in range(3)))]
        return out

    got = asyncio.run(main())
    return got, loads


def test_batch_sequences_match_reference():
    got = _batch_sequence(port_batching, port_mux)
    assert got == _batch_sequence(ref_batching, ref_mux)
    results, seen = got
    assert results[:3] == [":0", "a:1", "b:2"]
    assert results[9] == "error:batch exploded" and results[8] == "error:batch exploded"
    assert all(len(items) <= 3 for _m, items in seen)
    assert {m for m, _items in seen} == {"", "a", "b"}


def test_multiplex_lru_sequences_match_reference():
    got = _mux_sequence(port_mux)
    assert got == _mux_sequence(ref_mux)
    out, loads = got
    assert out[:9] == ["m1", "m2", "m1", "m3", "m2", "m2", "m1", "m3", "m4"]
    assert loads == ["m1", "m2", "m3", "m2", "m1", "m3", "m4", "m5"]


# -- on a fake two-card node: the repairs, and the closed loop ------------------------------


_POLICY = {
    "min_replicas": 1, "max_replicas": 3, "interval_s": 0.5,
    "target_queue_per_replica": 2.0, "up_hysteresis": 1,
    "down_hysteresis": 2, "idle_queue_per_replica": 0.5,
    "cooldown_up_s": 1.0, "cooldown_down_s": 1.5,
    "scale_up_step": 2, "scale_down_step": 2,
}


def _running(rt, app):
    return [r for r in rt.testing.list_serve_replicas(app)
            if r["state"] == "RUNNING" and r["pid"]]


def _closed_loop(rt):
    """tests/test_autoscale_serve.py::test_closed_loop_scale_up_then_drain_down
    on the port: open-loop Poisson arrivals at 14 requests/s for 3 s (seed
    5) against a 6.7 requests/s replica, then nothing. The reference's
    loadgen plane is not ported, so seeded threads send the arrivals."""
    serve = rt.serve
    dep = serve.deployment(P.Work, num_replicas=1, max_ongoing_requests=1,
                           max_queued_requests=64, graceful_shutdown_timeout_s=10.0,
                           autoscale_policy=dict(_POLICY))
    handle = serve.run(dep.bind(), name="slo", _proxy=False)
    P._wait_replicas(rt, "slo", 1)
    rng = random.Random(5)
    arrivals, t = [], 0.0
    while True:
        t += rng.expovariate(14.0)
        if t >= 3.0:
            break
        arrivals.append((t, [rng.randrange(1000)] * 8))
    results, lock = [], threading.Lock()

    def send(at, tokens):
        time.sleep(max(0.0, at - (time.time() - t0)))
        try:
            out = handle.options(timeout_s=60.0).remote(
                {"token_ids": tokens, "max_new_tokens": 2}).result()
        except Exception as e:  # noqa: BLE001
            out = repr(e)
        with lock:
            results.append(out)

    t0 = time.time()
    threads = [threading.Thread(target=send, args=a) for a in arrivals]
    for th in threads:
        th.start()
    peak = 1
    while any(th.is_alive() for th in threads):
        peak = max(peak, len(_running(rt, "slo")))
        time.sleep(0.1)
    controller = rt.get_actor("SERVE_CONTROLLER")
    ups = [e for e in rt.get(controller.autoscale_log.remote(), timeout=10)
           if e["direction"] == "up"]
    # the fault of the reference's test: one RUNNING replica also means the
    # scaled-up ones are still STARTING, so first see them RUNNING
    deadline = time.time() + 40
    while ups and peak < ups[0]["to"] and time.time() < deadline:
        peak = max(peak, len(_running(rt, "slo")))
        time.sleep(0.1)
    deadline = time.time() + 40
    while time.time() < deadline and len(_running(rt, "slo")) > 1:
        time.sleep(0.2)
    events = rt.get(controller.autoscale_log.remote(), timeout=10)
    running_after = len(_running(rt, "slo"))
    serve.delete("slo")
    return {"n": len(arrivals), "ok": sum(isinstance(r, int) for r in results),
            "events": events, "peak": peak, "running_after": running_after}


@pytest.fixture(scope="module")
def fake_node():
    """One port cluster on a node detected with two cards: the serve
    replicas of kept item 38, the actors of kept item 39, then the closed
    loop. This process holds the real torch; the workers import the fake."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.testing  # noqa: F401 - rt.testing
    from ray_tpu_torch.llm.config import LLMConfig
    from ray_tpu_torch.llm.serving import _actor_options

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDA_VISIBLE_DEVICES", "0,1")
        mp.syspath_prepend(str(_HERE / "torch_fake_cuda"))
        rt.init(num_cpus=8)
        try:
            out["resources"] = rt.cluster_resources().get("GPU")
            opts = _actor_options({"CPU": 1, "GPU": 0.5})
            out["options"] = opts
            handle = rt.serve.run(rt.serve.deployment(
                P.CardReport, num_replicas=2, ray_actor_options=opts).bind(),
                name="cards", _proxy=False)
            reports = {}
            for _ in range(12):
                ids, dev, pid = handle.remote(None).result(timeout_s=60)
                reports[pid] = (ids, dev, pid)
            out["replicas"] = sorted(reports.values(), key=lambda r: r[2])
            rows = rt.testing.list_serve_replicas("cards")
            out["replica_states"] = sorted(r["state"] for r in rows)
            rt.serve.delete("cards")
            out["default"] = LLMConfig().resources_per_replica
            # the deleted replicas' shares of card 0 come back when their
            # workers exit; until then a half would land on card 1
            deadline = time.time() + 30
            while rt.available_resources().get("GPU") != 2.0 and time.time() < deadline:
                time.sleep(0.1)
            halves = [rt.remote(num_gpus=0.5)(P.CardActor).remote() for _ in range(2)]
            out["halves"] = [rt.get(a.device.remote(), timeout=120) for a in halves]
            whole = rt.remote(num_gpus=1)(P.CardActor).remote()
            out["whole"] = rt.get(whole.device.remote(), timeout=120)
            out["available"] = rt.available_resources().get("GPU", 0.0)
            out["too_big"] = P._raised(lambda: rt.remote(num_gpus=1.5)(P.CardActor).remote())
            for a in halves + [whole]:
                rt.kill(a)
            out["closed_loop"] = _closed_loop(rt)
        finally:
            try:
                rt.serve.shutdown()
            finally:
                rt.shutdown()
    return out


def test_resources_per_replica_reach_the_lease(fake_node):
    """Kept item 38: two {"CPU": 1, "GPU": 0.5} replicas (num_cpus 1,
    num_gpus 0.5) both run on card 0, whose lease names it: get_gpu_ids()
    is [0], and their request threads' current device is 0. The port's
    default asks for a whole card. The reference's controller hands the
    dict's keys to build_resources, which reads none of them: its replica
    leases one CPU and no card."""
    from ray_tpu import remote_function as ref_rf
    from ray_tpu.llm.config import LLMConfig as RefConfig

    assert fake_node["resources"] == 2.0
    assert fake_node["options"] == {"num_cpus": 1.0, "num_gpus": 0.5}
    replicas = fake_node["replicas"]
    assert [(ids, dev) for ids, dev, _pid in replicas] == [([0], 0), ([0], 0)]
    assert len({pid for *_x, pid in replicas}) == 2
    assert fake_node["replica_states"] == ["RUNNING", "RUNNING"]
    assert fake_node["default"] == {"CPU": 1.0, "GPU": 1.0}
    ref_default = RefConfig().resources_per_replica
    assert ref_default == {"TPU": 0.0, "CPU": 1.0}
    assert ref_rf.build_resources(dict(ref_default, num_cpus=1)) == {"CPU": 1.0}
    assert ref_rf.build_resources({"CPU": 1, "GPU": 0.5, "num_cpus": 1}) == {"CPU": 1.0}


def test_a_fractional_gpu_lease_names_its_card(fake_node):
    """Kept item 39: two num_gpus=0.5 actors share card 0, each bound to it;
    a num_gpus=1 actor then gets card 1, the one whole free card; a
    non-integer demand above 1 raises a ValueError at .remote(), as Ray's
    does. The allocator's rules, in process: a share goes to the
    lowest-numbered card with that much left, a whole demand to whole free
    cards, and a release gives the share back."""
    from ray_tpu_torch.runtime.raylet.resources import ResourcePool

    assert fake_node["halves"] == [([0], 0), ([0], 0)]
    assert fake_node["whole"] == ([1], 1)
    assert fake_node["available"] == 0.0
    name, msg = fake_node["too_big"]
    assert name == "ValueError" and "1.5" in msg
    pool = ResourcePool({"GPU": 2, "CPU": 4})
    a = pool.allocate({"GPU": 0.25})
    b = pool.allocate({"GPU": 0.5})
    c = pool.allocate({"GPU": 0.5})
    assert (a.instance_ids, b.instance_ids, c.instance_ids) == (
        {"GPU": [0]}, {"GPU": [0]}, {"GPU": [1]})
    assert pool.allocate({"GPU": 1}) is None  # no whole card is free
    assert pool.allocate({"GPU": 0.5}).instance_ids == {"GPU": [1]}
    pool.release(a)
    assert pool.allocate({"GPU": 0.25}).instance_ids == {"GPU": [0]}
    assert pool.allocate({"GPU": 0.3}) is None  # 0.25 left on card 0, none on 1


def test_closed_loop_scale_up_then_drain_down(fake_node):
    """What tests/test_autoscale_serve.py's closed-loop test asserts, on the
    port: every request completes; a scale-up within one evaluation
    interval (+ 0.3 s) of the breach, on queue pressure over 2 a replica
    (the TTFT and shed signals read empty: no process pushes metrics yet);
    its replicas come up; then a drain back to one replica, with a
    scale-down decision in the log. The reference's test reads its log
    while its scaled-up replicas are still STARTING (kept item 41)."""
    res = fake_node["closed_loop"]
    assert res["ok"] == res["n"] > 20
    ups = [e for e in res["events"] if e["direction"] == "up"]
    assert ups, res["events"]
    assert ups[0]["breach_age_s"] <= _POLICY["interval_s"] + 0.3
    assert ups[0]["deployment"].endswith("Work")
    assert ups[0]["to"] > ups[0]["from"]
    assert ups[0]["signals"]["queue_per_replica"] > 2.0
    assert ups[0]["signals"]["ttft_p99_ms"] is None
    assert _POLICY["max_replicas"] >= max(res["peak"], ups[0]["to"])
    assert res["peak"] >= ups[0]["to"], res
    downs = [e for e in res["events"] if e["direction"] == "down"]
    assert downs, res["events"]
    assert downs[-1]["to"] < downs[-1]["from"]
    assert res["running_after"] == 1
