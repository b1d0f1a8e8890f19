"""The cluster KV tier (``kvtier.GcsTierBackend``) on the port's runtime
against the reference's.

One program runs against ``ray_tpu``'s cluster and then against
``ray_tpu_torch``'s (``cluster_utils.Cluster``: a head node and two
subscriber nodes in this process, the python transfer path), one cluster
at a time: a holder actor on one node exports a prefix payload (drawn by
numpy; torch tensors on the port) through ``KVTierClient`` over the GCS
backend, raw and int8; the driver's backend resolves, leases, releases and
the holder's client collects, reply for reply; a puller actor on the other
node pulls each prefix (the raw payload bit for bit, the int8 one decoded
from the reference's codes), and fetches a directed shipment. On the port
alone: the holder killed, the next pull and fetch are counted recomputes;
a corrupt payload raises (ROADMAP kept item 13), the backend
refuses to exist without the runtime, and a tiny role graph with
``weights_name`` over a two-node cluster gives the fused server's tokens
with one peer pull and no recompute on the decode side.
"""

from __future__ import annotations

import importlib
import os
import signal
import time

import numpy as np
import pytest

BLOCK = 8
MODEL = "m"
TOKENS = list(range(100, 124))  # three blocks of 8
OTHER = list(range(300, 316))   # two blocks
FRESH = list(range(500, 524))


def _payload(seed, nblocks):
    rng = np.random.default_rng(seed)
    return {"blocks": [rng.standard_normal((2, BLOCK, 4, 16)).astype(np.float32)
                       for _ in range(nblocks)], "tail": None}


def _to(package, tree):
    if package == "ray_tpu_torch":
        import torch

        return {"blocks": [torch.from_numpy(b) for b in tree["blocks"]], "tail": None}
    return tree


def _np_tree(tree):
    out = []
    for b in tree["blocks"]:
        out.append(b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b))
    return out


def _client(package, codec, holder_id):
    kvtier = importlib.import_module(package + ".kvtier")
    kw = {"device": "cpu"} if package == "ray_tpu_torch" else {}
    return kvtier.KVTierClient(MODEL, kvtier.GcsTierBackend(), BLOCK, codec=codec,
                               holder_id=holder_id, **kw)


class Holder:
    """Exports prefixes through the GCS backend and keeps its client (and
    so its chunks) alive."""

    def __init__(self, package):
        self.package = package
        self.clients = {}

    def export(self, codec, tokens, seed, first_token):
        client = self.clients.setdefault(codec, _client(self.package, codec, f"h-{codec}"))
        ship = client.export_and_register(tokens, _to(self.package, _payload(seed, 3)), 3,
                                          first_token=first_token)
        return (ship.to_blob(), ship.nblocks, ship.logical_bytes, ship.wire_bytes,
                [c.num_leaves for c in ship.chunks])

    def direct(self, tokens, seed):
        client = self.clients.setdefault("raw", _client(self.package, "raw", "h-raw"))
        return client.ship_direct(tokens, _to(self.package, _payload(seed, 2)), 2,
                                  first_token=7).to_blob()

    def collect(self, codec):
        return self.clients[codec].collect()

    def pid(self):
        return os.getpid()


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie child of a process of this test is dead
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


class Puller:
    def __init__(self, package):
        self.package = package
        self.client = _client(package, "raw", "puller")

    def pull(self, tokens):
        pulled = self.client.pull(tokens)
        if pulled is None:
            return None
        return pulled.matched_blocks, pulled.exact, _np_tree(pulled.payload)

    def fetch(self, blob):
        kvtier = importlib.import_module(self.package + ".kvtier")
        payload = self.client.fetch_shipment(kvtier.KVShipment.from_blob(blob))
        return None if payload is None else _np_tree(payload)

    def counters(self):
        metrics = importlib.import_module(self.package + ".util.metrics")
        return {k: metrics.kvtier_counters()[k] for k in ("hit", "peer_pull", "recompute")}


def prog_gcs_tier(rt):
    package = rt.__name__
    cu = importlib.import_module(package + ".cluster_utils")
    kvtier = importlib.import_module(package + ".kvtier")
    cluster = cu.Cluster(head_node_args=dict(num_cpus=2),
                         _system_config={"object_transfer_native_enabled": False})
    for i in range(2):
        cluster.add_node(num_cpus=1, resources={f"n{i}": 2.0})
    cluster.connect()
    out = {}
    try:
        holder = rt.remote(num_cpus=0)(Holder).options(resources={"n0": 1.0}).remote(package)
        puller = rt.remote(num_cpus=0)(Puller).options(resources={"n1": 1.0}).remote(package)
        raw = rt.get(holder.export.remote("raw", TOKENS, 1, 5))
        q = rt.get(holder.export.remote("int8", OTHER + [1] * 8, 2, None))
        out["exports"] = [r[1:] for r in (raw, q)]
        backend = kvtier.GcsTierBackend()
        ship = kvtier.KVShipment.from_blob(raw[0])
        fps = ship.fingerprints()
        resolved = backend.resolve(MODEL, list(reversed(fps)))
        out["resolve"] = (resolved["entry_id"], resolved["fp"] == fps[-1],
                          resolved["holder_id"], kvtier.KVShipment.from_blob(
                              resolved["blob"]).token_ids == TOKENS)
        out["lease"] = (backend.lease(resolved["entry_id"], "l1"),
                        backend.release_lease(resolved["entry_id"], "l1"))
        out["miss"] = backend.resolve(MODEL, ["nope"])
        out["pull_raw"] = rt.get(puller.pull.remote(TOKENS))
        out["pull_int8"] = rt.get(puller.pull.remote(OTHER + [1] * 8))
        out["want_raw"] = _payload(1, 3)["blocks"]
        direct = rt.get(holder.direct.remote(TOKENS[:16] + [1, 2], 4))
        out["direct"] = rt.get(puller.fetch.remote(direct))
        stats = backend.stats()
        out["stats"] = {k: stats[k] for k in ("entries", "registers", "resolves",
                                              "resolve_hits", "resolve_misses")}
        out["counters"] = rt.get(puller.counters.remote())
        q_ship = kvtier.KVShipment.from_blob(q[0])
        backend.evict([backend.resolve(MODEL, list(reversed(q_ship.fingerprints())))[
            "entry_id"]], "h-int8")
        out["collect"] = rt.get(holder.collect.remote("int8"))
        out["after_evict"] = backend.resolve(MODEL, list(reversed(q_ship.fingerprints())))
        if package == "ray_tpu":
            return out  # its dead-holder pulls take over a minute each to give up
        # a prefix and a directed shipment the puller never pulled, then the
        # holder killed
        rt.get(holder.export.remote("raw", FRESH, 5, 6))
        direct2 = rt.get(holder.direct.remote(FRESH[:16] + [3], 6))
        pid = rt.get(holder.pid.remote())
        os.kill(pid, signal.SIGKILL)  # a crashed holder
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and _alive(pid):
            time.sleep(0.05)
        out["dead"] = (rt.get(puller.pull.remote(FRESH)), rt.get(puller.fetch.remote(direct2)))
        after = rt.get(puller.counters.remote())
        out["dead_counters"] = {k: after[k] - out["counters"][k] for k in after}
        # the first prefix, whose chunks an earlier pull left in the
        # puller's store
        pulled = rt.get(puller.pull.remote(TOKENS))
        out["dead_local"] = pulled if pulled is None else pulled[:2]
        return out
    finally:
        rt.shutdown()
        cluster.shutdown()


@pytest.fixture(scope="module")
def runs():
    out = {}
    for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
        rt = importlib.import_module(name)
        try:
            out[key] = prog_gcs_tier(rt)
        except Exception as e:  # noqa: BLE001 - the program's failure fails the tests
            out[key] = {"raised": (type(e).__name__, str(e)[:300])}
    return out


def test_registry_replies_match_reference(runs):
    """Register (the shipments' accounting), resolve, lease and release,
    the registry's stats, evict and collect: reply for reply."""
    ref, port = runs["ref"], runs["port"]
    for key in ("exports", "resolve", "lease", "miss", "stats", "collect", "after_evict"):
        assert port[key] == ref[key], key
    assert ref["resolve"][1:] == (True, "h-raw", True) and ref["lease"] == (True, None)
    assert ref["miss"] is None and ref["collect"] == 0 and ref["after_evict"] is None


def test_pulled_payloads_match_reference(runs):
    """The raw prefix arrives bit for bit; the int8 one decodes from the
    reference's codes to the reference's values; a directed shipment
    arrives whole."""
    ref, port = runs["ref"], runs["port"]
    for key in ("pull_raw", "pull_int8"):
        (rm, re, rv), (pm, pe, pv) = ref[key], port[key]
        assert (pm, pe) == (rm, re) and all(np.array_equal(a, b) for a, b in zip(pv, rv))
    assert ref["pull_raw"][:2] == (3, True)
    assert all(np.array_equal(a, b) for a, b in zip(port["pull_raw"][2], port["want_raw"]))
    assert not all(np.array_equal(a, b) for a, b in zip(
        port["pull_int8"][2], _payload(2, 3)["blocks"]))  # int8: not the raw values
    assert all(np.array_equal(a, b) for a, b in zip(port["direct"], _payload(4, 2)["blocks"]))
    assert [len(x) for x in (port["direct"], ref["direct"])] == [2, 2]
    assert port["counters"] == ref["counters"] == {"hit": 2.0, "peer_pull": 3.0,
                                                   "recompute": 0.0}


def test_killed_holder_is_a_recompute(runs):
    """On the port (the reference's pull of a killed holder's prefix spends
    over a minute in owner lookups before it gives up, so it is not run
    here): after the holder is killed, a pull of a prefix of its and a
    fetch of its directed shipment are recomputes (None), counted once
    each, each within the probe's bound. Where an earlier pull left a copy
    of the dead holder's chunks in the puller's store, the port recomputes
    too: it probes the chunks' owner first (ROADMAP kept item 42), where
    the reference would read the copy."""
    port = runs["port"]
    assert port["dead"] == (None, None)
    assert port["dead_counters"] == {"hit": 1.0, "peer_pull": 0.0, "recompute": 2.0}
    assert port["dead_local"] is None


def test_backend_needs_the_runtime_and_corrupt_payload_raises():
    """Built outside an initialized runtime the backend raises (the
    reference's fails at its first call); a corrupt payload propagates
    (kept item 13), where a dead holder is a recompute."""
    from ray_tpu_torch import kvtier
    from ray_tpu_torch.kvtier import GcsTierBackend, KVTierClient

    with pytest.raises(RuntimeError, match="init"):
        GcsTierBackend()

    class Corrupt(kvtier.LocalTierBackend):
        def fetch_payload(self, shipment, holder, device=None):
            raise ValueError("corrupt chunk")

    backend = Corrupt()
    holder = KVTierClient(MODEL, backend, BLOCK, holder_id="h", device="cpu")
    holder.export_and_register(TOKENS, _to("ray_tpu_torch", _payload(1, 3)), 3, first_token=5)
    puller = KVTierClient(MODEL, backend, BLOCK, holder_id="p", device="cpu")
    with pytest.raises(ValueError, match="corrupt"):
        puller.pull(TOKENS)


def test_role_graph_with_weights_name_over_a_cluster():
    """``build_llm_deployment`` with roles and ``weights_name`` and no
    ``tier_backend`` over a two-node cluster (the prefill pool on one node,
    the decode pool on the other): each replica builds ``GcsTierBackend()``,
    resolves the published weights, and the ingress's tokens equal the
    fused in-process server's; the decode side pulls one shipment a
    request, computes no prefill and recomputes nothing."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.llm import LLMConfig, LLMServer, build_llm_deployment
    from ray_tpu_torch.llm.serving import publish_llm_weights
    from ray_tpu_torch.models.llama import init_params

    kw = dict(model_id="llama-tiny", max_seq_len=64, max_new_tokens=4, kv_cache_blocks=32,
              kv_block_size=BLOCK, model_kwargs={"dtype": torch.float32})
    cfg = LLMConfig(**kw, roles={"prefill": 1, "decode": 1},
                    resources_per_replica={"CPU": 1.0, "node": 1.0})
    params = init_params(cfg.build_model_config(), torch.Generator().manual_seed(3), device="cpu")
    fused = LLMServer(LLMConfig(**kw), params=params, device="cpu")
    prompts = [list(range(5, 30)), list(range(40, 51))]
    want = [fused({"token_ids": p, "max_new_tokens": 4})["token_ids"] for p in prompts]
    cluster = Cluster(head_node_args=dict(num_cpus=3))
    for _ in range(2):
        cluster.add_node(num_cpus=1, resources={"node": 1.0})
    cluster.connect()
    try:
        publish_llm_weights(cfg, params, weights_name="t/roles")
        handle = serve.run(build_llm_deployment(cfg, weights_name="t/roles", device="cpu"),
                           name="roles", route_prefix=None)
        got = [handle.remote({"token_ids": p, "max_new_tokens": 4}).result(timeout_s=120)[
            "token_ids"] for p in prompts]
        ctl = rt.get_actor("SERVE_CONTROLLER")
        table = rt.get(ctl.get_routing_table.remote("roles"), timeout=30)
        info = {}
        for dep in ("llama-tiny-prefill", "llama-tiny-decode"):
            (_, replica, _), = table[dep]["replicas"]
            call = lambda m, *a: rt.get(replica.handle_request.remote(m, a, {}, {}), timeout=60)
            info[dep] = (call("kvtier_stats"), call("kvcache_stats"), call("weights_info"),
                         call("mesh_info"))
    finally:
        serve.shutdown()
        rt.shutdown()
        cluster.shutdown()
    assert got == want
    tier, cache, weights, mesh = info["llama-tiny-decode"]
    assert tier["role"] == "decode" and tier["counters"]["peer_pull"] == 2.0
    assert tier["counters"]["recompute"] == 0.0 and cache["prefill_tokens_computed"] == 0
    assert weights["version"] == 1 and weights["codec"] == "raw"
    assert mesh["weight_chunk_pulls"] == 1
    assert info["llama-tiny-prefill"][0]["role"] == "prefill"
    assert info["llama-tiny-prefill"][2]["version"] == 1
