"""ray_tpu_torch.runtime: host-side pieces of the runtime that the port's
device planes need before the runtime itself is ported (so far the GCS's KV
tier registry, which ``kvtier.LocalTierBackend`` runs in process)."""
