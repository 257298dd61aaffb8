"""Counters, gauges, fixed-bucket log-scale histograms + Prometheus text.

The serving path's latency distributions (TTFT, inter-token gap, queue
wait, step duration) are heavy-tailed over four-plus decades — from
sub-millisecond mock steps to multi-second cold prefills — so the
histograms use FIXED geometric bucket edges (``log_buckets``): every
process and every restart bins identically, which is what lets two
scraped ``/metrics`` series be compared without re-bucketing. Rendering follows the Prometheus text exposition
format (``*_bucket{le=...}`` cumulative counts + ``_sum``/``_count``;
counters end in ``_total``), so any Prometheus-compatible scraper ingests
``GET /metrics`` directly.

Pure stdlib, no numpy or torch: nothing in here can ever touch a device
value.

Thread-safety: every metric guards its state with its own ``_m_lock``; the registry guards its name map with ``_reg_lock``. Writers are the scheduler loop and HTTP
threads; scrapes take one lock per metric, never all at once.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Iterable

from ..lockcheck import make_lock


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple[float, ...]:
    """Geometric bucket edges from ``lo`` to at least ``hi`` with
    ``per_decade`` buckets per factor of 10 — the fixed log-scale grid
    every latency histogram bins on."""
    if lo <= 0 or hi <= lo:
        raise ValueError("need 0 < lo < hi")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    n = math.ceil(math.log10(hi / lo) * per_decade)
    # round to 6 significant digits so edges are stable, printable values
    return tuple(
        float(f"{lo * 10 ** (i / per_decade):.6g}") for i in range(n + 1)
    )


# THE latency grid (seconds): 100 µs .. 100 s, 4 buckets per decade.
# Shared by TTFT / inter-token / queue-wait / step-duration so their
# exposition lines line up column-for-column.
LATENCY_BUCKETS_S = log_buckets(1e-4, 100.0, per_decade=4)


def _fmt(v: float) -> str:
    """Prometheus sample value / le formatting: trim trailing float noise."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.10g}"


def _label_str(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter, optionally labelled (one value per label set)."""

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._m_lock = make_lock("Counter._m_lock")
        self._ctr_values: dict[tuple[tuple[str, str], ...], float] = {}

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._m_lock:
            self._ctr_values[key] = self._ctr_values.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._m_lock:
            return self._ctr_values.get(key, 0.0)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._m_lock:
            items = sorted(self._ctr_values.items())
        if not items:
            items = [((), 0.0)]
        for labels, v in items:
            out.append(f"{self.name}{_label_str(labels)} {_fmt(v)}")
        return out


class Gauge:
    """Last-write-wins value, optionally labelled."""

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._m_lock = make_lock("Gauge._m_lock")
        self._gauge_values: dict[tuple[tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._m_lock:
            self._gauge_values[key] = float(value)

    def value(self, **labels: str) -> float | None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._m_lock:
            return self._gauge_values.get(key)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._m_lock:
            items = sorted(self._gauge_values.items())
        if not items:
            items = [((), 0.0)]
        for labels, v in items:
            out.append(f"{self.name}{_label_str(labels)} {_fmt(v)}")
        return out


class Histogram:
    """Fixed-bucket histogram over pre-computed (log-scale) edges.

    ``observe(v)`` bins by ``v <= edge`` (Prometheus ``le`` semantics;
    values past the last edge land in the implicit +Inf bucket).
    ``quantile(q)`` interpolates linearly inside the winning bucket —
    a bucketed estimate, which is the point: every reader of ``/metrics``
    gets its percentiles from the SAME counts, so they cannot drift."""

    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.help = help_
        self.edges = tuple(float(b) for b in buckets)
        if not self.edges or any(
            b >= a for a, b in zip(self.edges[1:], self.edges)
        ):
            raise ValueError("bucket edges must be strictly increasing")
        self._m_lock = make_lock("Histogram._m_lock")
        self._hist_counts = [0] * (len(self.edges) + 1)  # last = +Inf
        self._hist_sum = 0.0
        self._hist_n = 0

    def observe(self, value: float) -> None:
        idx = bisect_left(self.edges, value)  # first edge >= value
        with self._m_lock:
            self._hist_counts[idx] += 1
            self._hist_sum += value
            self._hist_n += 1

    @property
    def count(self) -> int:
        with self._m_lock:
            return self._hist_n

    @property
    def sum(self) -> float:
        with self._m_lock:
            return self._hist_sum

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._m_lock:
            return list(self._hist_counts), self._hist_sum, self._hist_n

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated q-quantile (0 < q <= 1); None when empty.
        The +Inf bucket reports the last finite edge (a floor)."""
        if not 0.0 < q <= 1.0:
            raise ValueError("q must be in (0, 1]")
        counts, _, n = self.snapshot()
        if n == 0:
            return None
        target = q * n
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= target:
                if i >= len(self.edges):  # +Inf bucket: no upper edge
                    return self.edges[-1]
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i]
                return lo + (hi - lo) * (target - prev) / c
        return self.edges[-1]

    def render(self) -> list[str]:
        counts, total_sum, n = self.snapshot()
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        cum = 0
        for edge, c in zip(self.edges, counts):
            cum += c
            out.append(f'{self.name}_bucket{{le="{_fmt(edge)}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {n}')
        out.append(f"{self.name}_sum {_fmt(total_sum)}")
        out.append(f"{self.name}_count {n}")
        return out


class LabelledHistogram:
    """A histogram FAMILY over one shared edge grid: ``observe(v,
    **labels)`` bins into the per-label-set series, and ``render()``
    emits ONE metric whose ``_bucket``/``_sum``/``_count`` lines carry
    the labels alongside ``le`` — the shape a per-phase attribution
    series (``dllama_request_phase_seconds{phase="prefill_ms"}``)
    needs. Same fixed log-scale edges discipline as :class:`Histogram`:
    every label set bins identically, so series are comparable without
    re-bucketing."""


    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.help = help_
        self.edges = tuple(float(b) for b in buckets)
        if not self.edges or any(
            b >= a for a, b in zip(self.edges[1:], self.edges)
        ):
            raise ValueError("bucket edges must be strictly increasing")
        self._m_lock = make_lock("LabelledHistogram._m_lock")
        # label-set key -> [bucket counts (last = +Inf), sum, n]
        self._hist_series: dict[tuple[tuple[str, str], ...], list] = {}

    @staticmethod
    def _key(labels: dict) -> tuple[tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def observe(self, value: float, **labels: str) -> None:
        idx = bisect_left(self.edges, value)  # first edge >= value
        key = self._key(labels)
        with self._m_lock:
            s = self._hist_series.get(key)
            if s is None:
                s = self._hist_series[key] = [
                    [0] * (len(self.edges) + 1), 0.0, 0,
                ]
            s[0][idx] += 1
            s[1] += value
            s[2] += 1

    def snapshot(self, **labels: str) -> tuple[list[int], float, int] | None:
        """One label set's ``(bucket counts, sum, n)``; None if unseen."""
        with self._m_lock:
            s = self._hist_series.get(self._key(labels))
            return None if s is None else (list(s[0]), s[1], s[2])

    def quantile(self, q: float, **labels: str) -> float | None:
        """Bucket-interpolated q-quantile of one label set's series
        (same estimate contract as :meth:`Histogram.quantile`)."""
        if not 0.0 < q <= 1.0:
            raise ValueError("q must be in (0, 1]")
        snap = self.snapshot(**labels)
        if snap is None or snap[2] == 0:
            return None
        counts, _, n = snap
        target = q * n
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= target:
                if i >= len(self.edges):  # +Inf bucket: no upper edge
                    return self.edges[-1]
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i]
                return lo + (hi - lo) * (target - prev) / c
        return self.edges[-1]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._m_lock:
            items = sorted(
                (k, (list(s[0]), s[1], s[2]))
                for k, s in self._hist_series.items()
            )
        for labels, (counts, total_sum, n) in items:
            cum = 0
            for edge, c in zip(self.edges, counts):
                cum += c
                le = (("le", _fmt(edge)),)
                out.append(
                    f"{self.name}_bucket{_label_str(labels + le)} {cum}"
                )
            out.append(
                f'{self.name}_bucket{_label_str(labels + (("le", "+Inf"),))}'
                f" {n}"
            )
            out.append(f"{self.name}_sum{_label_str(labels)} {_fmt(total_sum)}")
            out.append(f"{self.name}_count{_label_str(labels)} {n}")
        return out


class MetricsRegistry:
    """Name -> metric map with idempotent constructors and one-call text
    exposition. Re-registering a name returns the existing instance."""

    def __init__(self):
        self._reg_lock = make_lock("MetricsRegistry._reg_lock")
        self._reg_metrics: dict[str, object] = {}

    def _get_or_make(self, name: str, factory, kind):
        with self._reg_lock:
            m = self._reg_metrics.get(name)
            if m is None:
                m = self._reg_metrics[name] = factory()
            elif not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_, buckets), Histogram
        )

    def get(self, name: str):
        with self._reg_lock:
            return self._reg_metrics.get(name)

    def labelled_histogram(
        self, name: str, help_: str = "",
        buckets: Iterable[float] = LATENCY_BUCKETS_S,
    ) -> LabelledHistogram:
        return self._get_or_make(
            name, lambda: LabelledHistogram(name, help_, buckets),
            LabelledHistogram,
        )

    def render(self) -> str:
        """Full Prometheus text exposition (trailing newline included,
        per the format spec)."""
        with self._reg_lock:
            metrics = [self._reg_metrics[k] for k in sorted(self._reg_metrics)]
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
