"""Minimal Prometheus-shaped metrics registry (a copy of the reference's
``utils/metrics.py``): counters, gauges and histograms by name and
labels, with the same reads and the same text dump.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Tuple


def _lk(labels: Optional[Mapping[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class Metrics:
    def __init__(self):
        self._mu = threading.Lock()
        self.counters: Dict[Tuple[str, Tuple], float] = {}
        self.gauges: Dict[Tuple[str, Tuple], float] = {}
        self.histograms: Dict[Tuple[str, Tuple], List[float]] = {}

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Mapping[str, str]] = None) -> None:
        with self._mu:
            key = (name, _lk(labels))
            self.counters[key] = self.counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Mapping[str, str]] = None) -> None:
        with self._mu:
            self.gauges[(name, _lk(labels))] = value

    def observe(self, name: str, value: float,
                labels: Optional[Mapping[str, str]] = None) -> None:
        with self._mu:
            self.histograms.setdefault((name, _lk(labels)), []).append(value)

    def clear_series(self, name: str,
                     match: Optional[Mapping[str, str]] = None) -> None:
        """Drop labeled series of a gauge (full re-emit pattern: series
        for entities that vanished must not linger stale). With `match`,
        only series whose labels contain that subset are dropped."""
        with self._mu:
            want = set((match or {}).items())
            for key in [k for k in self.gauges
                        if k[0] == name and want <= set(k[1])]:
                del self.gauges[key]

    # -- reads -----------------------------------------------------------
    def counter(self, name: str, labels: Optional[Mapping[str, str]] = None) -> float:
        return self.counters.get((name, _lk(labels)), 0.0)

    def gauge(self, name: str, labels: Optional[Mapping[str, str]] = None) -> float:
        return self.gauges.get((name, _lk(labels)), 0.0)

    def percentile(self, name: str, q: float,
                   labels: Optional[Mapping[str, str]] = None) -> float:
        vals = sorted(self.histograms.get((name, _lk(labels)), []))
        if not vals:
            return 0.0
        return vals[min(len(vals) - 1, int(len(vals) * q))]

    def render(self) -> str:
        """Prometheus exposition-format-ish dump. Locked: the daemon's
        HTTP threads scrape concurrently with reconciling controllers."""
        with self._mu:
            counters = sorted(self.counters.items())
            gauges = sorted(self.gauges.items())
            histograms = [(k, (len(v), sum(v)))
                          for k, v in sorted(self.histograms.items())]
        lines = []
        for (name, labels), v in counters:
            lines.append(f"{name}{_fmt(labels)} {v}")
        for (name, labels), v in gauges:
            lines.append(f"{name}{_fmt(labels)} {v}")
        for (name, labels), (cnt, total) in histograms:
            lines.append(f"{name}_count{_fmt(labels)} {cnt}")
            lines.append(f"{name}_sum{_fmt(labels)} {total}")
        return "\n".join(lines) + "\n"


def _fmt(labels: Tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"
