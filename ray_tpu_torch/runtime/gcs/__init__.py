"""The GCS's registries that run in process in the port (so far the KV
tier's, :mod:`.kvtier_registry`)."""
