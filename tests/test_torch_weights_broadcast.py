"""The weight plane's broadcast across nodes, on the port's
``cluster_utils.Cluster`` against the reference's.

The three programs of tests/test_weights_broadcast.py run against
``ray_tpu``'s cluster and then against ``ray_tpu_torch``'s, one cluster at
a time (the head node, whose driver publishes, and subscriber nodes, each
with its own raylet and object store, in this process; the python transfer
path, the native plane off, for exact serve accounting): each chunk leaves
the publisher's node at most once and every subscriber node pulls each
chunk once, subscribers on one node sharing its store; under a directional
partition (the child's route to its tree parent drops) the weights still
arrive once a node and two fallback reports prune the parent; the registry
spreads tree positions over the nodes. The results must be equal between
the runtimes. The leaves are drawn by numpy, torch tensors on the port.

The subscriber actor is a plain top-level class, wrapped by each
package's ``remote`` in the program: the port's workers import it by
module and name, so this module imports neither package at its top.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

N_SUB_NODES = 3
MODEL = "bcast/model"


class Sub:
    """A subscriber on the node its custom resource names."""

    def fetch(self, package, name):
        w = importlib.import_module(package + ".weights")
        sub = w.WeightSubscriber(name)
        version, value = sub.get(timeout=60)
        checksum = float(sum(float(np.asarray(value[k]).sum()) for k in value))
        staleness = sub.staleness()
        sub.release()
        return version, checksum, staleness


def _leaf(rt, a):
    if rt.__name__ == "ray_tpu_torch":
        import torch

        return torch.from_numpy(a)
    return a


def _transfer_stats(node):
    return node.loop_thread.run(node.raylet.handle_transfer_stats())


def _serves(cluster):
    total = {}
    for node in cluster.list_nodes():
        for hex_id, n in _transfer_stats(node)["fetch_serves"].items():
            total[hex_id] = total.get(hex_id, 0) + n
    return total


def _gcs(rt, method, *args):
    api = importlib.import_module(rt.__name__ + "._worker_api")
    worker = api.get_core_worker()
    return api.run_on_worker_loop(
        worker.client_pool.get(*worker.gcs_address).call(method, *args, timeout=10.0))


def _cluster(rt, n_subs, **config):
    cu = importlib.import_module(rt.__name__ + ".cluster_utils")
    cluster = cu.Cluster(head_node_args=dict(num_cpus=2),
                         _system_config={"object_transfer_native_enabled": False, **config})
    subs = [cluster.add_node(num_cpus=1, resources={f"sub{i}": 4.0}) for i in range(n_subs)]
    cluster.connect()
    return cluster, subs


def prog_publisher_upload_is_o1(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    cluster, _ = _cluster(rt, N_SUB_NODES)
    try:
        actor = rt.remote(num_cpus=0)(Sub)
        actors = [actor.options(resources={f"sub{i}": 1.0}).remote() for i in (0, 0, 1, 2)]
        params = {f"l{i}": _leaf(rt, np.arange(125_000, dtype=np.float64) + i) for i in range(4)}
        pub = w.WeightPublisher(MODEL, chunk_size=1 << 20)
        version = pub.publish(params)
        chunk_ids = pub._held_ids[version]
        expected = float(sum(float(np.asarray(params[k]).sum()) for k in params))
        results = rt.get([a.fetch.remote(rt.__name__, MODEL) for a in actors], timeout=300)
        head = _transfer_stats(cluster.head_node)["fetch_serves"]
        total = _serves(cluster)
        return (
            len(chunk_ids),
            [r == (version, expected, 0) for r in results],
            max(head.get(oid.hex(), 0) for oid in chunk_ids),
            any(head.get(oid.hex(), 0) == 1 for oid in chunk_ids),
            [total.get(oid.hex(), 0) for oid in chunk_ids],
        )
    finally:
        rt.shutdown()
        cluster.shutdown()


def prog_broadcast_repair_under_directional_partition(rt):
    w = importlib.import_module(rt.__name__ + ".weights")
    testing = importlib.import_module(rt.__name__ + ".testing")
    model = "repair/model"
    cluster, (seed_node, child_node) = _cluster(rt, 2, chaos_poll_period_s=0.2)
    out = []
    try:
        seed_addr = tuple(seed_node.raylet.address)
        child_addr = tuple(child_node.raylet.address)
        out.append(_gcs(rt, "weights_plan", model, seed_addr)["position"])
        plan = _gcs(rt, "weights_plan", model, child_addr)
        out.append((plan["position"], tuple(plan["parent"]) == seed_addr))
        actor = rt.remote(num_cpus=0)(Sub)
        actors = [actor.options(resources={f"sub{i}": 1.0}).remote() for i in range(2)]
        testing.set_network_chaos({"seed": 3, "rules": [{
            "src": child_node.node_id.hex()[:12],
            "dst": f"{seed_addr[0]}:{seed_addr[1]}",
            "fail": 1.0,
        }]})
        time.sleep(0.8)  # every process polls the spec
        pub = w.WeightPublisher(model, chunk_size=1 << 20)
        params = {f"l{i}": np.arange(125_000, dtype=np.float64) + i for i in range(2)}
        v1 = pub.publish({k: _leaf(rt, v) for k, v in params.items()})
        expected = float(sum(v.sum() for v in params.values()))
        results = rt.get([a.fetch.remote(rt.__name__, model) for a in actors], timeout=300)
        out.append([r[:2] == (v1, expected) for r in results])
        plan = _gcs(rt, "weights_plan", model, child_addr)
        out.append(tuple(plan["parent"] or ()) == seed_addr)  # one report: not pruned
        total = _serves(cluster)
        out.append([total.get(oid.hex(), 0) for oid in pub._held_ids[v1]])
        v2 = pub.publish({k: _leaf(rt, v + 1) for k, v in params.items()})
        results = rt.get([a.fetch.remote(rt.__name__, model) for a in actors], timeout=300)
        out.append([r[0] == v2 for r in results])
        plan = _gcs(rt, "weights_plan", model, child_addr)
        out.append((plan["position"], plan["parent"]))  # the second report prunes
        return out
    finally:
        try:
            testing.clear_network_chaos()
        finally:
            rt.shutdown()
            cluster.shutdown()


def prog_tree_positions_span_nodes(rt):
    cluster, _ = _cluster(rt, N_SUB_NODES)
    try:
        addrs = [tuple(n.raylet.address) for n in cluster.list_nodes()[1:]]
        plans = [_gcs(rt, "weights_plan", "plan/model", a) for a in addrs]
        by_pos = {p["position"]: p for p in plans}
        seed = addrs[[p["position"] for p in plans].index(0)]
        again = _gcs(rt, "weights_plan", "plan/model", addrs[0])
        return (sorted(p["position"] for p in plans), by_pos[0]["parent"],
                tuple(by_pos[1]["parent"]) == seed, tuple(by_pos[2]["parent"]) == seed,
                again["position"] == plans[0]["position"], again["depth"])
    finally:
        rt.shutdown()
        cluster.shutdown()


#: what tests/test_weights_broadcast.py asserts of each program
EXPECTED = {
    "prog_publisher_upload_is_o1": (4, [True] * 4, 1, True, [N_SUB_NODES] * 4),
    "prog_broadcast_repair_under_directional_partition": [
        0, (1, True), [True, True], True, [2, 2], [True, True], (0, None)],
    "prog_tree_positions_span_nodes": ([0, 1, 2], None, True, True, True, 2),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for key, name in (("ref", "ray_tpu"), ("port", "ray_tpu_torch")):
        rt = importlib.import_module(name)
        res = {}
        for prog in EXPECTED:
            try:
                res[prog] = globals()[prog](rt)
            except Exception as e:  # noqa: BLE001 - a failing program fails its own test
                res[prog] = ("raised", type(e).__name__, str(e)[:300])
        out[key] = res
    return out


@pytest.mark.parametrize("name", list(EXPECTED))
def test_program_matches_reference(runs, name):
    assert runs["ref"][name] == EXPECTED[name]
    assert runs["port"][name] == runs["ref"][name]
