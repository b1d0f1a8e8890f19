"""Central GCS key-space registry.

Every reserved prefix of the GCS internal KV (and every pubsub channel
minted from an entity id) is declared here, once. Call sites build keys
through :class:`KeyPrefix` helpers instead of ad-hoc f-strings so that

- the full key space is auditable in one place (what can collide, what a
  GCS restart must sweep, which prefixes carry per-epoch garbage);
- scan/strip logic (``kv_keys`` prefixes, ``key[len(prefix):]`` slicing)
  cannot drift out of sync with the writer's format (a collective seq-key
  leak was once exactly an untracked prefix nobody swept);
- the RT005 static checker (``ray_tpu lint``) can flag any stray
  ``f"colmember:..."``-style literal that bypasses the registry.

This module is intentionally dependency-free (stdlib only): it is imported
by the collective layer, metrics, serve, train, the dashboard and the
static analyzer, and must never create an import cycle.

A copy of ``ray_tpu/runtime/gcs/keys.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

_SEP = ":"
_REGISTRY: Dict[str, "KeyPrefix"] = {}


class KeyPrefix:
    """One reserved prefix of the GCS key space (or pubsub channel space).

    ``KeyPrefix("colmember").key(group, epoch, rank)`` →
    ``"colmember:<group>:<epoch>:<rank>"``; ``.scan`` is the string to hand
    ``kv_keys``; ``.strip(key)`` removes the prefix for parsing. Segments
    after the first may themselves contain ``:`` (group names do) — parsers
    must split from the right for trailing fixed-arity segments, which is
    what :meth:`rsplit_tail` does.
    """

    __slots__ = ("name", "doc")

    def __init__(self, name: str, doc: str = ""):
        if name in _REGISTRY:
            raise ValueError(f"GCS key prefix {name!r} registered twice")
        self.name = name
        self.doc = doc
        _REGISTRY[name] = self

    def __repr__(self) -> str:
        return f"KeyPrefix({self.name!r})"

    @property
    def scan(self) -> str:
        """Prefix string for ``kv_keys`` / ``startswith`` enumeration."""
        return self.name + _SEP

    def key(self, *parts) -> str:
        """Mint a key: the prefix joined with ``parts`` by ``:``."""
        return _SEP.join((self.name, *(str(p) for p in parts)))

    def matches(self, key: str) -> bool:
        return key.startswith(self.name + _SEP)

    def strip(self, key: str) -> str:
        """Drop the leading ``<prefix>:`` from a matching key."""
        if not self.matches(key):
            raise ValueError(f"key {key!r} is not under prefix {self.name!r}")
        return key[len(self.name) + 1:]

    def rsplit_tail(self, key: str, n: int) -> list:
        """Strip the prefix, then right-split off the last ``n`` segments
        (for keys whose head segment — e.g. a group name — may itself
        contain ``:``). Returns ``[head, seg1, ..., segn]``."""
        return self.strip(key).rsplit(_SEP, n)


# -- KV key prefixes --------------------------------------------------------

FUNCTION = KeyPrefix(
    "fn", "pickled function/actor-class table, content-addressed by hash"
)
DEBUG_SESSION = KeyPrefix(
    "debug", "live remote-pdb sessions advertised for `ray_tpu debug`"
)
RUNTIME_ENV_PKG = KeyPrefix(
    "pkg", "zipped working_dir packages, content-addressed by sha1"
)
XLA_COORD = KeyPrefix(
    "xla_coord", "rank-0 coordinator address per XLA collective group"
)
COLLECTIVE = KeyPrefix(
    "col",
    "collective rendezvous slots: col:<group>:<epoch>:<seq>:<phase>:<rank> "
    "and col:<group>:<epoch>:p2p:<src>:<dst>:<n>; swept per dead epoch",
)
COLLECTIVE_MEMBER = KeyPrefix(
    "colmember",
    "member registration colmember:<group>:<epoch>:<rank> → worker/node "
    "identity JSON; scanned by the GCS death paths to abort groups",
)
COLLECTIVE_ABORT = KeyPrefix(
    "colabort",
    "monotonic ascii abort epoch per group; pollers raise "
    "CollectiveAbortedError when abort_epoch >= their epoch",
)
COLLECTIVE_DELAY = KeyPrefix(
    "coldelay", "chaos injection: per-group per-op delay seconds"
)
METRICS = KeyPrefix(
    "metrics",
    "per-worker pushed metrics snapshot metrics:<worker_hex>; reaped on "
    "worker/node death",
)
TRAIN_RUN = KeyPrefix(
    "trainrun", "live train-run record (state, group, epoch, rank pids)"
)
TRAIN_STATE = KeyPrefix(
    "train-state",
    "weight-plane model name (not a KV key) for elastic-training resume "
    "state, per experiment",
)
SERVE = KeyPrefix(
    "serve", "serve control-plane records (controller_ckpt, autoscale_log)"
)
CHAOS_NET = KeyPrefix(
    "chaosnet",
    "cluster-wide network chaos-mesh spec (JSON rules), polled by every "
    "process and applied client-side in the RPC layer",
)
KVTIER = KeyPrefix(
    "kvtier",
    "cluster-wide KV prefix tier: kvtier:fp:<model>:<fingerprint> → entry id "
    "and kvtier:entry:<id> → shipment descriptor blob (holder + pinned "
    "chunk refs); written by the GCS KVTierRegistry, swept on holder-node "
    "death and on LRU eviction so stale holders never accrete",
)
TIMESERIES = KeyPrefix(
    "ts",
    "telemetry time-series store: ts:<name>:<digest> → series entry "
    "(identity + labels + retention-trimmed points); written by the GCS "
    "TimeseriesStore on every ts_push, persisted write-through so series "
    "history survives a GCS restart like the weight registry",
)
SERVE_PROXY = KeyPrefix(
    "proxy",
    "serve ingress proxy registry proxy:<proxy_id> → identity JSON (kind, "
    "host, port, pid, node); written by the controller on register, "
    "removed on drain/death so CLI/dashboard/chaos see live proxies only",
)

# -- fixed keys under the serve prefix --------------------------------------

SERVE_CONTROLLER_CKPT = SERVE.key("controller_ckpt")
SERVE_AUTOSCALE_LOG = SERVE.key("autoscale_log")
# replica inventory mirror (JSON rows incl. mesh ownership + per-device
# HBM), refreshed every reconcile tick; read by `ray_tpu list replicas`
# and the dashboard /api/serve without a controller round-trip
SERVE_REPLICAS = SERVE.key("replicas")

# -- fixed keys under the chaosnet prefix -----------------------------------

CHAOS_NET_SPEC = CHAOS_NET.key("spec")

# -- pubsub channel prefixes ------------------------------------------------

ACTOR_CHANNEL = KeyPrefix(
    "actor", "pubsub channel actor:<actor_hex> carrying ActorInfo updates"
)


def known_prefixes() -> Tuple[str, ...]:
    """All registered prefix names (the RT005 checker's source of truth)."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> KeyPrefix:
    return _REGISTRY[name]
