"""Host-side metrics: the registry the serve plane reports into.

A host copy of the reference's ``nerrf_tpu/observability.py`` registry,
kept identical: ``MetricsRegistry`` (thread-safe counters, gauges and
fixed-bucket histograms with labels, rendered in the Prometheus text
exposition format) and ``DEFAULT_REGISTRY``.  The HTTP endpoint and the
profiler wrapper come with the port's CLI.
"""

from __future__ import annotations

import threading
import warnings
from typing import Dict, Iterable, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


def _escape_label_value(v: str) -> str:
    """Label-value escaping per the text exposition format: backslash,
    double-quote and newline must be escaped or one label value corrupts
    every series after it in the scrape."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _escape_help(text: str) -> str:
    """HELP text escaping (backslash and newline per the format spec)."""
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


class MetricsRegistry:
    """Counters, gauges, and fixed-bucket histograms with label sets."""

    def __init__(self, namespace: str = "nerrf") -> None:
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        self._hists: Dict[str, Dict[_LabelKey, list]] = {}
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}
        self._help: Dict[str, str] = {}

    def _name(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def counter_inc(self, name: str, value: float = 1.0,
                    labels: Optional[Dict[str, str]] = None,
                    help: str = "") -> None:
        with self._lock:
            d = self._counters.setdefault(name, {})
            k = _labelkey(labels)
            d[k] = d.get(k, 0.0) + value
            if help:
                self._help.setdefault(name, help)

    def gauge_set(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None,
                  help: str = "") -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[_labelkey(labels)] = value
            if help:
                self._help.setdefault(name, help)

    DEFAULT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 2.5, 10.0)

    def histogram_observe(self, name: str, value: float,
                          buckets: Optional[Iterable[float]] = None,
                          labels: Optional[Dict[str, str]] = None,
                          help: str = "") -> None:
        """Observe into a fixed-bucket histogram.

        The bucket ladder is fixed at the metric's FIRST observation
        (``buckets=None`` means "whatever is registered", falling back to
        ``DEFAULT_BUCKETS``); a later call passing a *different* ladder
        warns and keeps the registered one — re-bucketing mid-flight would
        corrupt the cumulative counts already recorded."""
        with self._lock:
            bk = self._hist_buckets.get(name)
            if bk is None:
                bk = tuple(buckets) if buckets is not None \
                    else self.DEFAULT_BUCKETS
                self._hist_buckets[name] = bk
            elif buckets is not None and tuple(buckets) != bk:
                warnings.warn(
                    f"histogram {name!r} already registered with buckets "
                    f"{bk}; ignoring differing buckets {tuple(buckets)}",
                    stacklevel=2)
            d = self._hists.setdefault(name, {})
            k = _labelkey(labels)
            if k not in d:
                d[k] = [0] * (len(bk) + 1) + [0.0, 0]  # cumcounts, sum, count
            cell = d[k]
            for i, b in enumerate(bk):
                if value <= b:
                    cell[i] += 1
            cell[len(bk)] += 1      # +Inf bucket
            cell[-2] += value       # sum
            cell[-1] += 1           # count
            if help:
                self._help.setdefault(name, help)

    def value(self, name: str, labels: Optional[Dict[str, str]] = None,
              stat: Optional[str] = None) -> float:
        """Read back one series.  Counters/gauges return their value;
        histograms return ``stat`` ∈ {"sum" (default), "count", "mean"}
        instead of silently reading 0.0 for a registered metric."""
        with self._lock:
            for table in (self._counters, self._gauges):
                if name in table:
                    return table[name].get(_labelkey(labels), 0.0)
            if name in self._hists:
                cell = self._hists[name].get(_labelkey(labels))
                if cell is None:
                    return 0.0
                if stat in (None, "sum"):
                    return float(cell[-2])
                if stat == "count":
                    return float(cell[-1])
                if stat == "mean":
                    return float(cell[-2]) / cell[-1] if cell[-1] else 0.0
                raise ValueError(
                    f"unknown histogram stat {stat!r}; "
                    "expected 'sum', 'count' or 'mean'")
        return 0.0

    def remove_series(self, name: str,
                      labels: Optional[Dict[str, str]] = None) -> bool:
        """Drop ONE labeled series of a metric (the metric itself, its
        type and its other series stay).  For per-entity series — e.g. the
        SLO plane's per-stream histograms — whose entity set is unbounded
        over a pod's lifetime: retiring a departed entity's series bounds
        label cardinality in memory and in the scrape.  Returns whether
        anything was removed."""
        k = _labelkey(labels)
        removed = False
        with self._lock:
            for table in (self._counters, self._gauges, self._hists):
                d = table.get(name)
                if d is not None and k in d:
                    del d[k]
                    removed = True
        return removed

    def snapshot(self) -> dict:
        """JSON-serializable copy of every live series — the telemetry
        archive's cadenced `metrics_snapshot` record (and any other
        offline consumer that wants values, not text exposition).  Same
        two-phase discipline as `render`: copy under the lock, shape the
        output outside it.  Label keys are rendered as the sorted
        ``k=v,k=v`` string ("" for the unlabeled series) so the snapshot
        roundtrips through JSON without tuple keys."""
        with self._lock:
            counters = {n: dict(s) for n, s in self._counters.items()}
            gauges = {n: dict(s) for n, s in self._gauges.items()}
            hists = {n: {k: list(cell) for k, cell in s.items()}
                     for n, s in self._hists.items()}
            hist_buckets = dict(self._hist_buckets)

        def key(k: _LabelKey) -> str:
            return ",".join(f"{a}={b}" for a, b in k)

        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for n, s in sorted(counters.items()):
            out["counters"][n] = {key(k): v for k, v in sorted(s.items())}
        for n, s in sorted(gauges.items()):
            out["gauges"][n] = {key(k): v for k, v in sorted(s.items())}
        for n, s in sorted(hists.items()):
            bk = hist_buckets.get(n, ())
            out["histograms"][n] = {
                "buckets": list(bk),
                "series": {key(k): {"cum": cell[:len(bk) + 1],
                                    "sum": cell[-2], "count": cell[-1]}
                           for k, cell in sorted(s.items())}}
        return out

    def render(self) -> str:
        """Prometheus text exposition format, one block per metric.

        Two-phase by design: SNAPSHOT the registry state under the lock
        (cheap copies — histogram cells are list-copied so a concurrent
        ``histogram_observe`` can never interleave its multi-field update
        mid-scrape and expose a cell whose bucket counts disagree with its
        ``_count``), then FORMAT outside the lock — string assembly is the
        expensive part of a scrape and must not stall the scoring plane's
        writers for its duration."""
        with self._lock:
            counters = {n: sorted(s.items())
                        for n, s in sorted(self._counters.items())}
            gauges = {n: sorted(s.items())
                      for n, s in sorted(self._gauges.items())}
            hists = {n: sorted((k, list(cell)) for k, cell in s.items())
                     for n, s in sorted(self._hists.items())}
            hist_buckets = dict(self._hist_buckets)
            help_text = dict(self._help)
        out = []
        for name, series in counters.items():
            full = self._name(name)
            if name in help_text:
                out.append(f"# HELP {full} {_escape_help(help_text[name])}")
            out.append(f"# TYPE {full} counter")
            for k, v in series:
                out.append(f"{full}{_fmt_labels(k)} {v:g}")
        for name, series in gauges.items():
            full = self._name(name)
            if name in help_text:
                out.append(f"# HELP {full} {_escape_help(help_text[name])}")
            out.append(f"# TYPE {full} gauge")
            for k, v in series:
                out.append(f"{full}{_fmt_labels(k)} {v:g}")
        for name, series in hists.items():
            full = self._name(name)
            bk = hist_buckets[name]
            if name in help_text:
                out.append(f"# HELP {full} {_escape_help(help_text[name])}")
            out.append(f"# TYPE {full} histogram")
            for k, cell in series:
                for i, b in enumerate(bk):
                    lk = _labelkey(dict(dict(k), le=f"{b:g}"))
                    out.append(f"{full}_bucket{_fmt_labels(lk)} {cell[i]}")
                lk = _labelkey(dict(dict(k), le="+Inf"))
                out.append(f"{full}_bucket{_fmt_labels(lk)} {cell[len(bk)]}")
                out.append(f"{full}_sum{_fmt_labels(k)} {cell[-2]:g}")
                out.append(f"{full}_count{_fmt_labels(k)} {cell[-1]}")
        return "\n".join(out) + "\n"


# The default registry the pipeline components report into.
DEFAULT_REGISTRY = MetricsRegistry()
