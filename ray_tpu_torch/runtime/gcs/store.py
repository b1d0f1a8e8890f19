"""Pluggable GCS metadata storage.

Role-equivalent of the reference's store-client abstraction
(src/ray/gcs/store_client/store_client.h, redis_store_client.h:126,
in_memory_store_client.h): the GCS keeps every table behind a tiny
key-value interface so cluster metadata can outlive the GCS process. The
persistent backend here is sqlite in WAL mode — one dependency-free file
giving the Redis *semantics* the reference relies on (durable namespaced
tables, atomic single-key writes), which is what GCS fault tolerance
actually needs.

Tables in use: ``kv`` (internal KV), ``jobs``, ``actors``, ``pgs``
(placement groups), ``meta`` (counters). Values are pickled protocol
dataclasses, the same bytes that travel on the wire.

A copy of ``ray_tpu/runtime/gcs/store.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

import abc
import os
import sqlite3
import threading
from typing import Dict, Optional


class StoreClient(abc.ABC):
    """Minimal namespaced KV used by every GCS table."""

    @abc.abstractmethod
    def put(self, table: str, key: str, value: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, table: str, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def delete(self, table: str, key: str) -> None: ...

    @abc.abstractmethod
    def get_all(self, table: str) -> Dict[str, bytes]: ...

    def close(self) -> None:
        pass


class InMemoryStoreClient(StoreClient):
    """Process-local storage (reference: InMemoryStoreClient) — the default
    when no persistence path is configured; GCS death loses the tables."""

    def __init__(self):
        self._tables: Dict[str, Dict[str, bytes]] = {}

    def put(self, table: str, key: str, value: bytes) -> None:
        self._tables.setdefault(table, {})[key] = value

    def get(self, table: str, key: str) -> Optional[bytes]:
        return self._tables.get(table, {}).get(key)

    def delete(self, table: str, key: str) -> None:
        self._tables.get(table, {}).pop(key, None)

    def get_all(self, table: str) -> Dict[str, bytes]:
        return dict(self._tables.get(table, {}))


class SqliteStoreClient(StoreClient):
    """Durable storage backend (reference role: RedisStoreClient). WAL mode
    keeps single-key writes cheap; the GCS event loop calls are synchronous
    by design — metadata mutations are small and rare relative to the RPC
    work around them."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        # The GCS event loop runs on one thread, but tests may construct/
        # inspect stores from others; a lock keeps the connection safe.
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " tbl TEXT NOT NULL, key TEXT NOT NULL, value BLOB NOT NULL,"
            " PRIMARY KEY (tbl, key))"
        )
        self._conn.commit()

    def put(self, table: str, key: str, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (tbl, key, value) VALUES (?, ?, ?)"
                " ON CONFLICT (tbl, key) DO UPDATE SET value = excluded.value",
                (table, key, value),
            )
            self._conn.commit()

    def get(self, table: str, key: str) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE tbl = ? AND key = ?", (table, key)
            ).fetchone()
        return row[0] if row else None

    def delete(self, table: str, key: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM kv WHERE tbl = ? AND key = ?", (table, key)
            )
            self._conn.commit()

    def get_all(self, table: str) -> Dict[str, bytes]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE tbl = ?", (table,)
            ).fetchall()
        return {k: v for k, v in rows}

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def make_store(path: str = "") -> StoreClient:
    """Storage factory: a configured path selects the durable backend."""
    return SqliteStoreClient(path) if path else InMemoryStoreClient()
