"""Alerting engine + cross-worker straggler detector.

Both run *cluster-side*, driven by the GCS timeseries store on its
evaluation tick (runtime/gcs/timeseries_store.py): the store hands them
its series entries, they hand back verdicts and emit flight-recorder
events through the store's synthetic-event callback — so alerts work
even when the offending worker is too wedged to push anything but its
(old) series history.

AlertEngine: declarative rules (threshold, rate-of-change, burn-rate)
with a firing/resolved lifecycle per (rule, series). A firing alert
carries the trace_id of the most recent exemplar-bearing point in its
window — the timeseries→trace link that turns "TTFT is bad" into "look
at THIS request".

StragglerDetector: median-absolute-deviation comparison of per-worker
step-time medians inside a training group. MAD (not stddev) because the
signal it hunts is exactly the heavy tail that wrecks a stddev; the
``rel_floor`` term keeps a tight group (MAD ~ 0) from flagging noise.

A copy of ``ray_tpu/util/alerts.py`` (host code): the port imports nothing of
``ray_tpu``, so it keeps its own.
"""

import statistics
import time
from typing import Callable, Dict, List, Optional

from . import events as _events

# point layout inside store entries: [ts, value, exemplar]
_TS, _VALUE, _EXEMPLAR = 0, 1, 2

EmitFn = Callable[..., None]  # emit(event_name, **fields)

_RULE_KINDS = ("threshold", "rate_of_change", "burn_rate")
_CMPS = ("gt", "lt")


class AlertRule:
    """One declarative rule. JSON-round-trippable (rules persist in the
    GCS storage backend next to the series they watch)."""

    def __init__(self, name: str, series: str, kind: str = "threshold",
                 threshold: float = 0.0, cmp: str = "gt",
                 window_s: float = 60.0, for_s: float = 0.0,
                 burn_fraction: float = 0.5,
                 labels: Optional[dict] = None):
        if kind not in _RULE_KINDS:
            raise ValueError(f"unknown rule kind {kind!r}; one of {_RULE_KINDS}")
        if cmp not in _CMPS:
            raise ValueError(f"unknown cmp {cmp!r}; one of {_CMPS}")
        self.name = str(name)
        self.series = str(series)
        self.kind = kind
        self.threshold = float(threshold)
        self.cmp = cmp
        self.window_s = float(window_s)
        self.for_s = float(for_s)
        self.burn_fraction = float(burn_fraction)
        self.labels = {str(k): str(v) for k, v in (labels or {}).items()}

    def to_dict(self) -> dict:
        return {
            "name": self.name, "series": self.series, "kind": self.kind,
            "threshold": self.threshold, "cmp": self.cmp,
            "window_s": self.window_s, "for_s": self.for_s,
            "burn_fraction": self.burn_fraction, "labels": self.labels,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AlertRule":
        return cls(**{k: d[k] for k in (
            "name", "series", "kind", "threshold", "cmp", "window_s",
            "for_s", "burn_fraction", "labels") if k in d})

    def matches(self, entry: dict) -> bool:
        if entry.get("name") != self.series:
            return False
        labels = entry.get("labels") or {}
        return all(labels.get(k) == v for k, v in self.labels.items())

    def signal(self, window: List[list]) -> Optional[float]:
        """Collapse the in-window points to the value the rule compares."""
        if not window:
            return None
        if self.kind == "threshold":
            return window[-1][_VALUE]
        if self.kind == "rate_of_change":
            span = window[-1][_TS] - window[0][_TS]
            if span <= 0 or len(window) < 2:
                return None
            return (window[-1][_VALUE] - window[0][_VALUE]) / span
        # burn_rate: fraction of the window violating the threshold —
        # error-budget burn, fires on sustained violation, not one spike
        bad = sum(1 for p in window if self._violates(p[_VALUE]))
        return bad / len(window)

    def _violates(self, value: float) -> bool:
        return value > self.threshold if self.cmp == "gt" \
            else value < self.threshold

    def breached(self, signal: float) -> bool:
        if self.kind == "burn_rate":
            return signal >= self.burn_fraction
        return self._violates(signal)


def _window_exemplar(window: List[list]) -> Optional[str]:
    for p in reversed(window):
        if len(p) > _EXEMPLAR and p[_EXEMPLAR]:
            return p[_EXEMPLAR]
    return None


class AlertEngine:
    """Rule registry + firing/resolved lifecycle.

    State machine per (rule, series): ok -> pending (breached, waiting
    out ``for_s``) -> firing -> ok.  Transitions into/out of firing emit
    ALERT_FIRING / ALERT_RESOLVED events and append to a bounded
    transition log (the dashboard's and CLI's history surface).
    """

    LOG_CAP = 512

    def __init__(self):
        self._rules: Dict[str, AlertRule] = {}
        # (rule_name, series_id) -> {"state", "since", "value", ...}
        self._states: Dict[tuple, dict] = {}
        self.log: List[dict] = []

    # -- rule registry -------------------------------------------------------

    def set_rule(self, rule: AlertRule) -> None:
        self._rules[rule.name] = rule

    def delete_rule(self, name: str) -> bool:
        self._states = {
            k: v for k, v in self._states.items() if k[0] != name
        }
        return self._rules.pop(name, None) is not None

    def rules(self) -> List[dict]:
        return [r.to_dict() for r in self._rules.values()]

    def get_rule(self, name: str) -> Optional[AlertRule]:
        return self._rules.get(name)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, entries: List[dict], now: Optional[float] = None,
                 emit: Optional[EmitFn] = None) -> None:
        if now is None:
            now = time.time()
        seen = set()
        for rule in list(self._rules.values()):
            for entry in entries:
                if not rule.matches(entry):
                    continue
                key = (rule.name, entry["id"])
                seen.add(key)
                window = [
                    p for p in entry.get("points", ())
                    if p[_TS] >= now - rule.window_s
                ]
                signal = rule.signal(window)
                self._step(rule, entry, key, signal, window, now, emit)
        # series that vanished (retention reaped them) resolve their alerts
        for key in [k for k in self._states if k not in seen]:
            st = self._states.pop(key)
            if st["state"] == "firing":
                self._transition(key, st, "resolved", now, emit,
                                 reason="series_gone")

    def _step(self, rule: AlertRule, entry: dict, key: tuple,
              signal: Optional[float], window: List[list], now: float,
              emit: Optional[EmitFn]) -> None:
        st = self._states.setdefault(key, {
            "state": "ok", "since": now, "rule": rule.name,
            "series_id": entry["id"], "series": entry.get("name"),
            "labels": entry.get("labels") or {},
            "worker_id": entry.get("worker_id", ""),
            "node_id": entry.get("node_id", ""),
        })
        breached = signal is not None and rule.breached(signal)
        st["value"] = signal
        st["threshold"] = rule.threshold
        st["exemplar"] = _window_exemplar(window) or st.get("exemplar")
        if breached:
            if st["state"] == "ok":
                st["state"], st["since"] = "pending", now
            if st["state"] == "pending" and now - st["since"] >= rule.for_s:
                self._transition(key, st, "firing", now, emit)
        else:
            if st["state"] == "firing":
                self._transition(key, st, "resolved", now, emit)
            st["state"], st["since"] = "ok", now

    def _transition(self, key: tuple, st: dict, to: str, now: float,
                    emit: Optional[EmitFn], **extra) -> None:
        st["state"] = "firing" if to == "firing" else "ok"
        st["since"] = now
        row = {
            "ts": now, "transition": to, "rule": st["rule"],
            "series_id": st["series_id"], "series": st.get("series"),
            "labels": st.get("labels"), "worker_id": st.get("worker_id"),
            "node_id": st.get("node_id"), "value": st.get("value"),
            "threshold": st.get("threshold"),
            "exemplar": st.get("exemplar"),
        }
        row.update(extra)
        self.log.append(row)
        del self.log[:-self.LOG_CAP]
        if emit is not None:
            name = (_events.ALERT_FIRING if to == "firing"
                    else _events.ALERT_RESOLVED)
            emit(name, **{k: v for k, v in row.items() if k != "ts"})

    # -- read surface --------------------------------------------------------

    def active(self) -> List[dict]:
        return [
            {
                "rule": st["rule"], "series_id": st["series_id"],
                "series": st.get("series"), "labels": st.get("labels"),
                "worker_id": st.get("worker_id"),
                "node_id": st.get("node_id"), "state": st["state"],
                "since": st["since"], "value": st.get("value"),
                "threshold": st.get("threshold"),
                "exemplar": st.get("exemplar"),
            }
            for st in self._states.values() if st["state"] == "firing"
        ]


class StragglerDetector:
    """MAD outlier detection of per-worker step time inside a group.

    For each training group (series labelled with ``group``), take each
    worker's median step time over the trailing window, then flag any
    worker whose median exceeds
    ``group_median + max(k * 1.4826 * MAD, rel_floor * group_median)``.
    1.4826 scales MAD to a stddev-consistent estimator; ``rel_floor``
    (default 25% over median) stops a perfectly uniform group — MAD
    zero — from alerting on scheduler jitter.  Needs >= 3 workers so a
    median and deviation are meaningful.
    """

    def __init__(self, k: float = 3.0, rel_floor: float = 0.25,
                 window_s: float = 120.0, min_points: int = 2,
                 min_workers: int = 3):
        self.k = k
        self.rel_floor = rel_floor
        self.window_s = window_s
        self.min_points = min_points
        self.min_workers = min_workers
        # (group, series_id) -> {"firing": bool, "since": ts}
        self._states: Dict[tuple, dict] = {}
        self._verdicts: List[dict] = []

    def evaluate(self, entries: List[dict], now: Optional[float] = None,
                 emit: Optional[EmitFn] = None) -> List[dict]:
        if now is None:
            now = time.time()
        groups: Dict[str, List[dict]] = {}
        for entry in entries:
            if entry.get("name") != "step_time_s":
                continue
            group = (entry.get("labels") or {}).get("group") or \
                (entry.get("labels") or {}).get("run") or "?"
            groups.setdefault(group, []).append(entry)

        verdicts: List[dict] = []
        for group, members in groups.items():
            rows = []
            for entry in members:
                window = [
                    p for p in entry.get("points", ())
                    if p[_TS] >= now - self.window_s
                ]
                if len(window) < self.min_points:
                    continue
                rows.append((entry, window,
                             statistics.median(p[_VALUE] for p in window)))
            if len(rows) < self.min_workers:
                continue
            medians = [m for _, _, m in rows]
            group_median = statistics.median(medians)
            mad = statistics.median(abs(m - group_median) for m in medians)
            cutoff = group_median + max(
                self.k * 1.4826 * mad, self.rel_floor * group_median
            )
            for entry, window, worker_median in rows:
                key = (group, entry["id"])
                st = self._states.setdefault(
                    key, {"firing": False, "since": now})
                firing = worker_median > cutoff
                labels = entry.get("labels") or {}
                verdict = {
                    "group": group,
                    "series_id": entry["id"],
                    "worker_id": entry.get("worker_id", ""),
                    "node_id": entry.get("node_id", ""),
                    "rank": labels.get("rank"),
                    "run": labels.get("run"),
                    "median_s": worker_median,
                    "group_median_s": group_median,
                    "mad_s": mad,
                    "cutoff_s": cutoff,
                    "deviation": (worker_median - group_median)
                    / group_median if group_median else 0.0,
                    "straggler": firing,
                    "since": st["since"] if firing == st["firing"] else now,
                }
                if firing and not st["firing"]:
                    st.update(firing=True, since=now)
                    if emit is not None:
                        emit(
                            _events.STRAGGLER_DETECTED,
                            group=group,
                            worker_id=verdict["worker_id"],
                            node_id=verdict["node_id"],
                            rank=verdict["rank"],
                            median_s=worker_median,
                            group_median_s=group_median,
                            cutoff_s=cutoff,
                            exemplar=_window_exemplar(window),
                            # the offending series tail travels with the
                            # event so the post-mortem needs no extra query
                            series_tail=[
                                [p[_TS], p[_VALUE]] for p in window[-16:]
                            ],
                        )
                elif st["firing"] and not firing:
                    st.update(firing=False, since=now)
                    if emit is not None:
                        emit(
                            _events.STRAGGLER_RESOLVED,
                            group=group,
                            worker_id=verdict["worker_id"],
                            node_id=verdict["node_id"],
                            rank=verdict["rank"],
                            median_s=worker_median,
                            group_median_s=group_median,
                        )
                verdicts.append(verdict)
        verdicts.sort(key=lambda v: v["deviation"], reverse=True)
        self._verdicts = verdicts
        return verdicts

    def verdicts(self) -> List[dict]:
        """Latest per-worker rows, sorted by step-time deviation (what
        ``ray_tpu top`` renders)."""
        return list(self._verdicts)
