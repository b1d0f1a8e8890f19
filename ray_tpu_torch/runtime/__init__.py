"""ray_tpu_torch.runtime: the port of ray_tpu/runtime, the runtime core.

The GCS (``gcs/``: actors, placement groups, the KV, the function table,
and the KV tier's and the weight plane's registries), the raylet
(``raylet/``: resources with the card's GPU instances, the worker pool,
leases), the object store (``object_store/``: the g++ arena of
``_native/store.cc`` and its Python fallback) and the core worker
(``worker/``), brought up in process by ``node.Node``. Copies of the
reference's host code, except where a module's docstring says how it
departs: no cloudpickle, leases bound to their card, tensors on the object
plane.
"""
