"""GCS pubsub: long-poll publisher/subscriber.

Role-equivalent of the reference's pubsub layer (src/ray/pubsub/publisher.h,
subscriber.h) used for actor/node/job change feeds and object-eviction
channels. Subscribers long-poll the publisher; messages are buffered per
subscriber with a bounded queue.

A copy of ``ray_tpu/runtime/gcs/pubsub.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import asyncio
import fnmatch
import logging
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Tuple

logger = logging.getLogger(__name__)

_MAX_BUFFER = 10_000


class Publisher:
    """Server side: per-subscriber message queues with long-poll delivery."""

    def __init__(self):
        # subscriber_id -> deque of (channel, message)
        self._queues: Dict[str, deque] = {}
        # subscriber_id -> set of channel patterns
        self._subscriptions: Dict[str, set] = defaultdict(set)
        self._wakeups: Dict[str, asyncio.Event] = {}

    def subscribe(self, subscriber_id: str, channel: str):
        self._subscriptions[subscriber_id].add(channel)
        self._queues.setdefault(subscriber_id, deque(maxlen=_MAX_BUFFER))
        self._wakeups.setdefault(subscriber_id, asyncio.Event())

    def unsubscribe(self, subscriber_id: str, channel: str | None = None):
        if channel is None:
            self._subscriptions.pop(subscriber_id, None)
            self._queues.pop(subscriber_id, None)
            ev = self._wakeups.pop(subscriber_id, None)
            if ev:
                ev.set()
        else:
            self._subscriptions.get(subscriber_id, set()).discard(channel)

    def publish(self, channel: str, message: Any):
        for sub_id, patterns in self._subscriptions.items():
            if any(fnmatch.fnmatch(channel, p) for p in patterns):
                self._queues[sub_id].append((channel, message))
                self._wakeups[sub_id].set()

    async def poll(self, subscriber_id: str, timeout: float = 30.0) -> List[Tuple[str, Any]]:
        """Long-poll: return buffered messages, waiting up to ``timeout`` if
        none are pending. Empty list on timeout (client re-polls)."""
        queue = self._queues.get(subscriber_id)
        if queue is None:
            # auto-register so subscribe/poll ordering doesn't race
            self._queues[subscriber_id] = queue = deque(maxlen=_MAX_BUFFER)
            self._wakeups[subscriber_id] = asyncio.Event()
        if not queue:
            ev = self._wakeups[subscriber_id]
            ev.clear()
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                return []
        out = list(queue)
        queue.clear()
        return out


class SubscriberClient:
    """Client side: background poll loop dispatching to channel callbacks
    (reference: subscriber.h / python _private/gcs_pubsub.py)."""

    def __init__(self, rpc_client, subscriber_id: str):
        self._client = rpc_client
        self.subscriber_id = subscriber_id
        self._callbacks: Dict[str, Callable] = {}
        self._task: asyncio.Task | None = None
        self._stopped = False

    async def subscribe(self, channel_pattern: str, callback: Callable):
        self._callbacks[channel_pattern] = callback
        await self._client.call(
            "subscribe", self.subscriber_id, channel_pattern, timeout=10.0
        )
        if self._task is None:
            self._task = asyncio.ensure_future(self._poll_loop())

    async def _poll_loop(self):
        resubscribe = False
        while not self._stopped:
            if resubscribe:
                # the publisher process restarted and lost its subscription
                # table: re-announce every channel before polling again, or
                # published messages silently stop routing to us
                try:
                    for pattern in list(self._callbacks):
                        await self._client.call(
                            "subscribe", self.subscriber_id, pattern,
                            timeout=10.0,
                        )
                    resubscribe = False
                except asyncio.CancelledError:
                    return
                except Exception:
                    if self._stopped:
                        return
                    await asyncio.sleep(0.5)
                    continue
            try:
                messages = await self._client.call(
                    "subscriber_poll", self.subscriber_id, timeout=60.0
                )
            except asyncio.CancelledError:
                return
            except Exception:
                if self._stopped:
                    return
                resubscribe = True
                await asyncio.sleep(0.5)
                continue
            for channel, message in messages:
                for pattern, cb in self._callbacks.items():
                    if fnmatch.fnmatch(channel, pattern):
                        try:
                            res = cb(channel, message)
                            if asyncio.iscoroutine(res):
                                await res
                        except Exception:
                            logger.exception("pubsub callback failed for %s", channel)

    async def close(self):
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
