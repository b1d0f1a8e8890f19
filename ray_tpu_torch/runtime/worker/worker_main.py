"""Worker process entry point.

Role-equivalent of the reference's default_worker.py (python/ray/_private/
workers/default_worker.py) + CoreWorker::RunTaskExecutionLoop: a subprocess
spawned by the raylet's worker pool; it builds a CoreWorker in WORKER mode,
registers with its raylet, and serves task execution until told to exit or
its raylet dies.

A copy of ``ray_tpu/runtime/worker/worker_main.py`` (host code: the port
imports nothing of ``ray_tpu``) without the JAX platform pin. A worker
imports ``torch`` only when it needs it: when a lease names a card (the
core worker binds to it) or a tensor reaches it.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys


async def main(args):
    from ..._internal.config import Config
    from ..._internal.rpc import RpcClient
    from .core_worker import CoreWorker, WorkerMode

    config = Config()
    if args.config:
        config = Config.from_json(args.config)
    if config.cluster_auth_token:
        from ..._internal.rpc import set_auth_token

        set_auth_token(config.cluster_auth_token)
    if config.testing_rpc_failure:
        import json

        from ..._internal.rpc import set_rpc_chaos

        set_rpc_chaos(json.loads(config.testing_rpc_failure))
    from ..._internal.rpc import configure_circuit_breaker

    configure_circuit_breaker(
        config.rpc_breaker_threshold, config.rpc_breaker_cooldown_s
    )
    loop = asyncio.get_event_loop()
    gcs_address = (args.gcs_host, args.gcs_port)
    raylet_address = ("127.0.0.1", args.raylet_port)
    worker = CoreWorker(
        WorkerMode.WORKER, config, gcs_address, raylet_address, loop
    )
    await worker.start()

    # Materialize this worker's runtime env (download packages, set cwd /
    # sys.path / env vars) before registering, so the first leased task
    # already sees it (reference: runtime-env agent CreateRuntimeEnv before
    # worker handshake).
    runtime_env_json = os.environ.get("RAY_TPU_RUNTIME_ENV")
    if runtime_env_json:
        import json

        from ..._internal.runtime_env import materialize

        gcs_client = worker.client_pool.get(*gcs_address)
        await materialize(json.loads(runtime_env_json), gcs_client)

    await worker.connect_to_raylet()

    # expose this worker for API calls made inside executed tasks
    from ... import _worker_api

    _worker_api.set_core_worker(worker, config)

    # pick up the cluster-wide chaos-mesh spec from the GCS KV
    if config.chaos_poll_period_s > 0:
        from ...util import chaosnet

        asyncio.ensure_future(
            chaosnet.poll_loop(
                worker.client_pool.get(*gcs_address),
                period_s=config.chaos_poll_period_s,
            )
        )

    # Die with the raylet: keep a dedicated connection pinging it
    # (reference: workers exit when their raylet's socket closes).
    raylet_watch = RpcClient(
        *raylet_address,
        name="raylet-watch",
        register_meta={"worker_id": worker.worker_id},
    )
    while True:
        try:
            await raylet_watch.call("ping", timeout=10.0)
        except Exception:
            logging.warning("raylet unreachable; worker exiting")
            os._exit(1)
        await asyncio.sleep(2.0)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-port", type=int, required=True)
    parser.add_argument("--gcs-host", default="127.0.0.1")
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--node-id", default="")
    parser.add_argument("--session", default="")
    parser.add_argument("--config", default="")
    args = parser.parse_args()
    # debugging hook: `kill -USR1 <worker pid>` dumps all thread stacks
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_LOG_LEVEL", "WARNING"),
        format=f"[worker {os.getpid()}] %(levelname)s %(name)s: %(message)s",
    )
    try:
        asyncio.run(main(args))
    except KeyboardInterrupt:
        sys.exit(0)
    except Exception as e:
        # raylet gone before/while we started: exit quietly
        logging.warning("worker startup failed: %s", e)
        sys.exit(1)
