"""Cluster-wide network chaos-mesh distribution.

The mesh spec (see ``_internal.rpc.set_rpc_chaos`` structured format) is a
JSON document stored under :data:`keys.CHAOS_NET_SPEC` in the GCS KV —
written by ``ray_tpu chaos net`` / ``testing.set_network_chaos`` and polled
by every process (raylet periodic tick, worker/driver poll loop) through
the chaos-EXEMPT ``chaos_fetch`` RPC, so *healing* a partition propagates
through the partition it heals. Change detection is by raw-spec equality:
an unchanged KV value never re-seeds the deterministic rng mid-run.

A copy of ``ray_tpu/util/chaosnet.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from .._internal.rpc import set_rpc_chaos

logger = logging.getLogger(__name__)

# Raw value of the last spec applied from the KV. None means "never saw a
# cluster spec", which deliberately does NOT clear locally-set chaos (tests
# call set_rpc_chaos directly without the KV); clearing only happens on an
# observed transition from a cluster spec to no/empty spec.
_last_applied: Optional[str] = None


def reset() -> None:
    global _last_applied
    _last_applied = None


def maybe_apply(raw) -> bool:
    """Apply a fetched raw spec if it changed since the last application.
    Returns True when the process-local chaos state was updated."""
    global _last_applied
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = bytes(raw).decode("utf-8", "replace")
    if raw == _last_applied:
        return False
    if not raw:
        _last_applied = raw
        set_rpc_chaos({})
        return True
    try:
        spec = json.loads(raw)
    except (ValueError, TypeError):
        logger.warning("ignoring malformed chaos-net spec %r", raw[:200])
        return False
    _last_applied = raw
    set_rpc_chaos(spec)
    return True


async def poll_once(client) -> bool:
    """One best-effort fetch-and-apply against a GCS client. Unreachable
    GCS (e.g. under the very partition being injected) keeps the current
    local spec."""
    try:
        raw = await client.call("chaos_fetch", timeout=2.0)
    except Exception:
        return False
    return maybe_apply(raw)


async def poll_loop(client, period_s: float = 1.0):
    """Long-lived poller for processes without a periodic runner (workers,
    address-mode drivers). Run as a task on the process's event loop."""
    while True:
        try:
            await poll_once(client)
        except Exception:  # pragma: no cover — the poller must never die
            logger.exception("chaosnet poll failed")
        await asyncio.sleep(period_s)
