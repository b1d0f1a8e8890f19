"""GCS-backed telemetry time-series store + cluster-side evaluation.

The server half of util/timeseries.py: every process's TelemetryStream
pushes raw point deltas here (``ts_push``); the store keys each
(name, labels, worker) stream under a ``ts:`` GCS key, applies
per-series retention and pair-merge compaction, and persists entries
write-through to a dedicated storage table so series history survives a
GCS restart exactly like the weight registry.

Evaluation runs where the data already is: each push (rate-limited) and
each health-check tick re-runs the MAD straggler detector and the alert
rule engine (util/alerts.py) over the resident series, emitting
STRAGGLER_DETECTED / ALERT_FIRING / ALERT_RESOLVED into the cluster
event store — so detection keeps working when the slow worker is the
one that stopped talking.

A copy of ``ray_tpu/runtime/gcs/timeseries_store.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own. ``series_id`` is copied here from
``ray_tpu/util/timeseries.py``, whose process-side stream is not ported.
"""

import hashlib
import json
import logging
import os
import time
from typing import Dict, List, Optional, TYPE_CHECKING

from ...util.alerts import AlertEngine, AlertRule, StragglerDetector
from . import keys as gcs_keys

if TYPE_CHECKING:
    from .server import GcsServer
    from .store import StoreClient

logger = logging.getLogger(__name__)

_TABLE = "timeseries"
_RULES_TABLE = "alert_rules"


def _compact_points(points: List[list], now: float, retention_s: float,
                    max_points: int) -> List[list]:
    """Reap points past retention, then pair-merge until under the cap —
    same degrade-resolution-not-span policy as the client ring, but on
    raw [ts, value, exemplar] triples (merged value = pair mean)."""
    horizon = now - retention_s
    if points and points[0][0] < horizon:
        points = [p for p in points if p[0] >= horizon]
    while len(points) > max_points:
        merged = []
        for i in range(0, len(points) - 1, 2):
            a, b = points[i], points[i + 1]
            merged.append([b[0], (a[1] + b[1]) / 2.0, b[2] or a[2]])
        if len(points) % 2:
            merged.append(points[-1])
        points = merged
    return points



def series_id(name: str, labels: Optional[dict], worker_id: str = "") -> str:
    """Stable id for one (name, labels, worker) stream: the tail of its
    ``ts:`` GCS key. Deterministic so re-pushes append, not fork."""
    lk = tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))
    blob = json.dumps(lk, separators=(",", ":"))
    digest = hashlib.sha1((worker_id + "|" + blob).encode()).hexdigest()[:10]
    return f"{name}:{digest}"

class GcsTimeseriesStore:
    """Server-resident series entries + the detectors that watch them."""

    def __init__(self, gcs: "GcsServer"):
        self._gcs = gcs
        self._series: Dict[str, dict] = {}
        self.retention_s = float(
            os.environ.get("RAY_TPU_TS_RETENTION_S", "3600")
        )
        self.max_points = int(
            os.environ.get("RAY_TPU_TS_MAX_POINTS", "1024")
        )
        self.alert_engine = AlertEngine()
        self.straggler_detector = StragglerDetector()
        self._last_eval = 0.0
        self.eval_period_s = 0.5

    # -- persistence ---------------------------------------------------------

    def _persist(self, entry: dict) -> None:
        try:
            self._gcs.storage.put(
                _TABLE,
                gcs_keys.TIMESERIES.key(entry["id"]),
                json.dumps(entry).encode(),
            )
        except Exception:
            logger.exception("failed to persist series %s", entry["id"])

    def restore_from(self, storage: "StoreClient") -> None:
        """Reload series entries and alert rules after a GCS restart.
        Alert/straggler *state* is deliberately not persisted: the next
        evaluation tick re-derives it from the restored points, which is
        both simpler and correct (a restart must not resurrect an alert
        whose window has since recovered)."""
        for key, raw in storage.get_all(_TABLE).items():
            try:
                entry = json.loads(raw)
                self._series[entry["id"]] = entry
            except Exception:
                logger.exception("dropping unreadable series record %s", key)
        for name, raw in storage.get_all(_RULES_TABLE).items():
            try:
                self.alert_engine.set_rule(AlertRule.from_dict(json.loads(raw)))
            except Exception:
                logger.exception("dropping unreadable alert rule %s", name)
        if self._series:
            logger.info("restored %d telemetry series", len(self._series))

    # -- write path ----------------------------------------------------------

    def push(self, payload: dict) -> int:
        """Ingest one worker's delta payload; returns points accepted."""
        now = time.time()
        worker_id = payload.get("worker_id", "")
        node_id = payload.get("node_id", "")
        accepted = 0
        for row in payload.get("series", ()):
            name = row.get("name")
            labels = row.get("labels") or {}
            points = row.get("points") or []
            if not name or not points:
                continue
            sid = series_id(name, labels, worker_id)
            entry = self._series.get(sid)
            if entry is None:
                entry = {
                    "id": sid,
                    "name": str(name),
                    "labels": {str(k): str(v) for k, v in labels.items()},
                    "worker_id": worker_id,
                    "node_id": node_id,
                    "pid": payload.get("pid"),
                    "created": now,
                    "points": [],
                }
                self._series[sid] = entry
            pts = entry["points"]
            for p in points:
                # normalize to [ts, value, exemplar]
                pts.append([
                    float(p[0]), float(p[1]),
                    p[2] if len(p) > 2 else None,
                ])
                accepted += 1
            pts.sort(key=lambda p: p[0])
            entry["points"] = _compact_points(
                pts, now, self.retention_s, self.max_points
            )
            entry["updated"] = now
            entry["node_id"] = node_id or entry.get("node_id", "")
            self._persist(entry)
        if accepted:
            self.evaluate(now)
        return accepted

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None, force: bool = False):
        """Run retention + both detectors. Rate-limited so a push storm
        costs one evaluation per ``eval_period_s``; the server's
        health-check tick also calls this so alerts resolve (and dead
        workers get reaped) even when nobody is pushing."""
        if now is None:
            now = time.time()
        if not force and now - self._last_eval < self.eval_period_s:
            return
        self._last_eval = now
        self._reap(now)
        entries = list(self._series.values())
        emit = self._gcs.append_synthetic_event
        try:
            self.straggler_detector.evaluate(entries, now, emit)
        except Exception:
            logger.exception("straggler evaluation failed")
        try:
            self.alert_engine.evaluate(entries, now, emit)
        except Exception:
            logger.exception("alert evaluation failed")

    def _reap(self, now: float) -> None:
        """Drop series whose entire history aged out of retention."""
        horizon = now - self.retention_s
        for sid in [
            sid for sid, e in self._series.items()
            if not e["points"] or e["points"][-1][0] < horizon
        ]:
            del self._series[sid]
            try:
                self._gcs.storage.delete(
                    _TABLE, gcs_keys.TIMESERIES.key(sid)
                )
            except Exception:
                logger.exception("failed to delete series %s", sid)

    # -- read path -----------------------------------------------------------

    def query(self, name: Optional[str] = None,
              labels: Optional[dict] = None,
              since: Optional[float] = None,
              worker_id: Optional[str] = None,
              limit_points: int = 500) -> List[dict]:
        out = []
        for entry in self._series.values():
            if name is not None and entry["name"] != name:
                continue
            if worker_id is not None and entry["worker_id"] != worker_id:
                continue
            if labels:
                el = entry.get("labels") or {}
                if any(el.get(str(k)) != str(v) for k, v in labels.items()):
                    continue
            points = entry["points"]
            if since is not None:
                points = [p for p in points if p[0] >= since]
            out.append({**entry, "points": points[-int(limit_points):]})
        out.sort(key=lambda e: (e["name"], e["id"]))
        return out

    def list_series(self) -> List[dict]:
        """Index rows only — no points — for the dashboard series picker."""
        out = []
        for entry in self._series.values():
            pts = entry["points"]
            out.append({
                "id": entry["id"],
                "name": entry["name"],
                "labels": entry["labels"],
                "worker_id": entry["worker_id"],
                "node_id": entry["node_id"],
                "points": len(pts),
                "updated": entry.get("updated"),
                "last": pts[-1][1] if pts else None,
            })
        out.sort(key=lambda e: (e["name"], e["id"]))
        return out

    # -- alert rule plumbing (RPC surface) -----------------------------------

    def set_rule(self, rule_dict: dict) -> dict:
        rule = AlertRule.from_dict(rule_dict)
        self.alert_engine.set_rule(rule)
        try:
            self._gcs.storage.put(
                _RULES_TABLE, rule.name, json.dumps(rule.to_dict()).encode()
            )
        except Exception:
            logger.exception("failed to persist alert rule %s", rule.name)
        return rule.to_dict()

    def delete_rule(self, name: str) -> bool:
        ok = self.alert_engine.delete_rule(name)
        try:
            self._gcs.storage.delete(_RULES_TABLE, name)
        except Exception:
            logger.exception("failed to delete alert rule %s", name)
        return ok

    def alerts_snapshot(self) -> dict:
        """Everything /api/alerts and ``ray_tpu alerts`` render in one
        round-trip: active alerts, rules, recent transitions, straggler
        verdicts."""
        self.evaluate()
        return {
            "active": self.alert_engine.active(),
            "rules": self.alert_engine.rules(),
            "log": self.alert_engine.log[-100:],
            "stragglers": self.straggler_detector.verdicts(),
        }
