"""The chunk transfer layer's error: the port of ray_tpu/_internal/transfer.py.

The reference moves bulk tensor bytes between processes (weight-plane
chunks, KV tier shipments) through its object store here, with a bounded
reachability probe of the holder. The port has no object store yet: the KV
tier's in-process backend (``kvtier.LocalTierBackend``) holds its chunks
inline, and raises this error for a chunk whose holder is gone, as the
reference's pull does for a holder that fails its probe.
"""


class DeadHolderError(Exception):
    """The designated holder of a chunk is gone (killed, or its chunks
    dropped). The KV tier's pull treats it as *recompute*."""
