"""Metrics core: counters, gauges, histograms, and per-round timeseries.

Instruments are plain host-side accumulators — nothing here touches a
device. The federated engines feed them with values that were computed on
the device and copied to the host once a block (fused engine) or once a
round (legacy engine);
``MetricsRegistry.snapshot()`` renders everything as a deterministic,
JSON-ready dict (sorted names, plain python numbers) so the same sequence
of updates always serializes to the same bytes.
"""
from __future__ import annotations

import math
from typing import Dict, List


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("Counter.inc expects n >= 0")
        self.value += int(n)


class Gauge:
    """Last-value-wins scalar."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact-sample histogram (these runs observe at most a few thousand
    values, so keeping the samples and sorting at snapshot time beats
    maintaining bucket boundaries)."""

    __slots__ = ("_values",)

    def __init__(self) -> None:
        self._values: List[float] = []

    def observe(self, v: float, n: int = 1) -> None:
        """Record ``v`` ``n`` times (``n`` lets a block of identical rounds
        contribute one observation per round)."""
        self._values.extend([float(v)] * int(n))

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the observed samples."""
        if not self._values:
            return math.nan
        s = sorted(self._values)
        idx = max(0, math.ceil(p / 100.0 * len(s)) - 1)
        return s[idx]

    def snapshot(self) -> Dict[str, float]:
        if not self._values:
            return {"count": 0}
        s = sorted(self._values)
        return {
            "count": len(s),
            "min": s[0],
            "max": s[-1],
            "mean": sum(s) / len(s),
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class Timeseries:
    """(step, value) series — the per-round trajectories (target accuracy,
    link success rate, ...) that the report CLI plots as summary stats."""

    __slots__ = ("steps", "values")

    def __init__(self) -> None:
        self.steps: List[int] = []
        self.values: List[float] = []

    def append(self, step: int, value: float) -> None:
        self.steps.append(int(step))
        self.values.append(float(value))

    def snapshot(self) -> Dict[str, List[float]]:
        return {"steps": list(self.steps), "values": list(self.values)}


class MetricsRegistry:
    """Named instruments with get-or-create access.

    One registry lives per run (the recorder resets it in ``begin_run``);
    ``snapshot()`` is embedded in the run's summary event.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._timeseries: Dict[str, Timeseries] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def timeseries(self, name: str) -> Timeseries:
        return self._timeseries.setdefault(name, Timeseries())

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()
        self._timeseries.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """Deterministic JSON-ready view: names sorted, values plain."""
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: self._histograms[k].snapshot()
                           for k in sorted(self._histograms)},
            "timeseries": {k: self._timeseries[k].snapshot()
                           for k in sorted(self._timeseries)},
        }
