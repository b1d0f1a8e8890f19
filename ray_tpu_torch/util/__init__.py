"""Process-local observability: the port of ray_tpu/util's serving plane.

- :mod:`.metrics`: counters, gauges and histograms in one process
  registry, the families the serving path and the PPO loop record (KV cache,
  LLM decode, adapters, step breakdown, device memory), their rollups and
  the Prometheus exposition;
- :mod:`.tracing`: spans with trace, span and parent ids, the chrome-trace
  export, and the device profile over ``torch.profiler``;
- :mod:`.events`: the flight recorder, a bounded ring of named events.

The reference pushes each process's metrics, spans and events to its GCS
from background threads. The port has no runtime yet, so nothing is pushed
and no thread is started: :func:`.metrics.local_payload` returns the payload
the metrics pusher would send, and the readers (summaries, Prometheus text)
run on it. Metric names, tags, histogram boundaries, span names and
attributes, and event names and fields are the reference's, so that one
dashboard reads both packages.
"""
