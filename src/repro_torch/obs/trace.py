"""Span tracing: host-side wall-clock phases as Chrome-trace-format JSON.

A :class:`Tracer` collects complete ("ph": "X") events for the phases the
simulator goes through — data staging, kernel builds, round-block
execution, eval/drain — plus compile events annotated with the analytic
FLOP/byte count of the block they precede
(:meth:`repro_torch.core.fedsim.FederatedSimulation.block_cost`).
``Tracer.export`` writes a file loadable by ``chrome://tracing`` or
https://ui.perfetto.dev.

Module-level ``span``/``traced`` operate on an ambient tracer (swap it with
``use_tracer``); the simulator's :class:`repro_torch.obs.record.RunRecorder`
owns its own tracer instance so concurrent simulations don't interleave.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional


class Span:
    """Handle yielded by ``span(...)``: attach late args, read the duration
    after the block exits."""

    __slots__ = ("name", "args", "duration_s")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self.duration_s: Optional[float] = None

    def set(self, **args: Any) -> None:
        """Add args discovered while the span is open."""
        self.args.update(args)


class Tracer:
    """Collects Chrome-trace events. ``clock`` is injectable so tests can
    produce deterministic timestamps."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self.events: List[Dict[str, Any]] = []

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "phase", **args: Any):
        """Context manager recording a complete event around the block."""
        t0 = self._now_us()
        sp = Span(name, dict(args))
        try:
            yield sp
        finally:
            dur = self._now_us() - t0
            sp.duration_s = dur / 1e6
            self.events.append({"name": name, "cat": cat, "ph": "X",
                                "ts": t0, "dur": dur, "pid": 0, "tid": 0,
                                "args": sp.args})

    def traced(self, name: Optional[str] = None, cat: str = "phase"):
        """Decorator form of :meth:`span`."""
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label, cat=cat):
                    return fn(*a, **kw)

            return wrapper

        return deco

    def instant(self, name: str, cat: str = "mark", **args: Any) -> None:
        self.events.append({"name": name, "cat": cat, "ph": "i",
                            "ts": self._now_us(), "s": "t", "pid": 0,
                            "tid": 0, "args": dict(args)})

    def add_compile_event(self, name: str,
                          cost: Optional[Dict[str, float]] = None,
                          seconds: float = 0.0) -> Dict[str, float]:
        """Record a compile (here: getting a block's kernels built or
        loaded) as a trace event annotated with FLOP/byte counts from
        ``cost`` (``"bytes accessed"`` or ``"bytes_accessed"``). Returns the
        normalized ``{"flops", "bytes_accessed"}`` dict."""
        cost = cost or {}
        info = {
            "flops": float(cost.get("flops", 0.0)),
            "bytes_accessed": float(cost.get("bytes accessed",
                                             cost.get("bytes_accessed",
                                                      0.0))),
        }
        ts = self._now_us()
        self.events.append({"name": f"compile:{name}", "cat": "compile",
                            "ph": "X", "ts": ts - seconds * 1e6,
                            "dur": seconds * 1e6, "pid": 0, "tid": 0,
                            "args": dict(info)})
        return info

    # ------------------------------------------------------------- export

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, sort_keys=True)
            f.write("\n")


# ------------------------------------------------------- ambient tracer

_AMBIENT = Tracer()


def get_tracer() -> Tracer:
    return _AMBIENT


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the ambient tracer; returns the previous one."""
    global _AMBIENT
    prev, _AMBIENT = _AMBIENT, tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, cat: str = "phase", **args: Any):
    """``obs.span(...)``: a span on the ambient tracer."""
    return get_tracer().span(name, cat=cat, **args)


def traced(name: Optional[str] = None, cat: str = "phase"):
    """``@obs.traced(...)``: decorator spanning each call on the ambient
    tracer (resolved at call time, so ``use_tracer`` blocks are honored)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with get_tracer().span(label, cat=cat):
                return fn(*a, **kw)

        return wrapper

    return deco
