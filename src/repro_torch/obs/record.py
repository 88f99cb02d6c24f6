"""RunRecord: the structured JSONL record of a federated simulation run.

One *run* (one ``FederatedSimulation.run(method)`` call) is a sequence of
events sharing a ``run_id``; a file may hold many runs (e.g. all six
methods of a benchmark sweep). Event types, one JSON object per line:

  meta     — run header: schema version, method, engine, free-form config
  round    — per-round device-tap scalars: per-client ``train_loss``,
             ``em_entropy``, ``link_success_rate``, ``effective_neighbors``
  eval     — eval-boundary accuracies (+ π for pfedwn)
  compile  — the first run of a (method, block length) on an instance:
             name, wall seconds spent building or loading its kernels,
             and the block's analytic matmul FLOP/byte count
  summary  — run footer: final/max accuracy + the metrics-registry snapshot
             (counters, gauges, histograms, timeseries)

Serialization is deterministic (sorted keys, compact separators, plain
python numbers), so identical update sequences produce byte-identical
JSONL — the property the obs test suite pins. Wall-clock only enters
through the injectable ``clock`` (meta) and measured latencies (summary
histograms); ``round``/``eval`` events carry none.

Sinks: :class:`JsonlSink` (write-through file) and :class:`MemorySink`
(deterministic in-memory list, used by tests and ``last_run_record``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

SCHEMA_VERSION = 1

_NUM = (int, float)


def _jsonable(v: Any) -> Any:
    """Fallback encoder for numpy scalars and arrays and host torch
    tensors. A 0-d array or tensor has ``__len__``, so it takes
    ``tolist()``, which gives a Python scalar all the same."""
    if hasattr(v, "item") and not hasattr(v, "__len__"):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    raise TypeError(f"not JSON-serializable: {type(v).__name__}")


def encode_event(event: Dict[str, Any]) -> str:
    """The canonical byte encoding of one event (sorted keys, compact)."""
    return json.dumps(event, sort_keys=True, separators=(",", ":"),
                      default=_jsonable)


class MemorySink:
    """Collects events in order; ``to_jsonl`` renders the canonical bytes."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def to_jsonl(self) -> str:
        return "".join(encode_event(e) + "\n" for e in self.events)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Write-through JSONL file sink (truncates on construction: one sink
    instance == one fresh record file)."""

    def __init__(self, path: str) -> None:
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "w")

    def emit(self, event: Dict[str, Any]) -> None:
        self._f.write(encode_event(event) + "\n")
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class RunRecorder:
    """The engine-facing recording facade: metrics registry + tracer +
    sinks, with one method per event type.

    Always keeps an in-memory copy (``events``); add a ``jsonl_path`` to
    persist, a ``trace_path`` to export the Chrome trace at ``end_run``.
    ``clock`` stamps only the meta event and is injectable for determinism.
    """

    def __init__(self, *, jsonl_path: Optional[str] = None,
                 trace_path: Optional[str] = None,
                 sinks: Sequence[Any] = (),
                 tracer: Optional[Tracer] = None,
                 clock: Optional[Any] = None) -> None:
        self._clock = clock or time.time
        self.memory = MemorySink()
        self.sinks: List[Any] = [self.memory] + list(sinks)
        if jsonl_path:
            self.sinks.append(JsonlSink(jsonl_path))
        self.jsonl_path = jsonl_path
        self.trace_path = trace_path
        self.tracer = tracer or Tracer()
        self.metrics = MetricsRegistry()
        self._run_seq = 0
        self.run_id: Optional[str] = None

    # ------------------------------------------------------------- plumbing

    @property
    def events(self) -> List[Dict[str, Any]]:
        return self.memory.events

    def span(self, name: str, cat: str = "phase", **args: Any):
        return self.tracer.span(name, cat=cat, **args)

    def _emit(self, event: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.emit(event)

    # ---------------------------------------------------------- run section

    def begin_run(self, *, method: str, engine: str,
                  meta: Optional[Dict[str, Any]] = None) -> str:
        self._run_seq += 1
        self.run_id = f"{method}/{engine}#{self._run_seq}"
        self.metrics.reset()
        self._emit({"type": "meta", "schema": SCHEMA_VERSION,
                    "run_id": self.run_id, "method": method,
                    "engine": engine, "time_unix": float(self._clock()),
                    "meta": dict(meta or {})})
        return self.run_id

    def record_round(self, rnd: int, *, train_loss: Iterable[float],
                     em_entropy: float, link_success_rate: float,
                     effective_neighbors: float) -> None:
        tl = [float(v) for v in train_loss]
        m = self.metrics
        m.counter("rounds_total").inc()
        m.timeseries("target_train_loss").append(rnd, tl[0] if tl else 0.0)
        m.timeseries("link_success_rate").append(rnd,
                                                 float(link_success_rate))
        m.timeseries("effective_neighbors").append(
            rnd, float(effective_neighbors))
        self._emit({"type": "round", "run_id": self.run_id,
                    "round": int(rnd), "train_loss": tl,
                    "em_entropy": float(em_entropy),
                    "link_success_rate": float(link_success_rate),
                    "effective_neighbors": float(effective_neighbors)})

    def record_eval(self, rnd: int, *, target_acc: float,
                    mean_participant_acc: float,
                    pi: Optional[Iterable[float]] = None) -> None:
        m = self.metrics
        m.counter("evals_total").inc()
        m.gauge("last_target_acc").set(float(target_acc))
        m.timeseries("target_acc").append(rnd, float(target_acc))
        self._emit({"type": "eval", "run_id": self.run_id,
                    "round": int(rnd), "target_acc": float(target_acc),
                    "mean_participant_acc": float(mean_participant_acc),
                    "pi": None if pi is None else [float(v) for v in pi]})

    def record_compile(self, name: str,
                       cost: Optional[Dict[str, float]] = None,
                       seconds: float = 0.0) -> Dict[str, float]:
        info = self.tracer.add_compile_event(name, cost=cost,
                                             seconds=seconds)
        self.metrics.counter("compile_events").inc()
        self._emit({"type": "compile", "run_id": self.run_id, "name": name,
                    "flops": info["flops"],
                    "bytes_accessed": info["bytes_accessed"],
                    "seconds": float(seconds)})
        return info

    def observe_round_latency(self, ms: float, n: int = 1) -> None:
        self.metrics.histogram("round_latency_ms").observe(ms, n)

    def end_run(self, *, method: str, engine: str, rounds: int,
                max_target_acc: float, final_target_acc: float,
                extra: Optional[Dict[str, Any]] = None) -> None:
        event = {"type": "summary", "run_id": self.run_id, "method": method,
                 "engine": engine, "rounds": int(rounds),
                 "max_target_acc": float(max_target_acc),
                 "final_target_acc": float(final_target_acc),
                 "metrics": self.metrics.snapshot()}
        if extra:
            event["extra"] = dict(extra)
        self._emit(event)
        for s in self.sinks:
            s.flush()
        if self.trace_path:
            self.tracer.export(self.trace_path)


# ------------------------------------------------------- schema validation

_REQUIRED: Dict[str, Dict[str, Any]] = {
    "meta": {"run_id": str, "method": str, "engine": str, "schema": int,
             "time_unix": _NUM, "meta": dict},
    "round": {"run_id": str, "round": int, "train_loss": list,
              "em_entropy": _NUM, "link_success_rate": _NUM,
              "effective_neighbors": _NUM},
    "eval": {"run_id": str, "round": int, "target_acc": _NUM,
             "mean_participant_acc": _NUM},
    "compile": {"run_id": str, "name": str, "flops": _NUM,
                "bytes_accessed": _NUM, "seconds": _NUM},
    "summary": {"run_id": str, "method": str, "engine": str, "rounds": int,
                "max_target_acc": _NUM, "final_target_acc": _NUM,
                "metrics": dict},
}

_ENGINES = ("fused", "legacy")


def validate_event(event: Any) -> List[str]:
    """Schema check for one decoded event; returns a list of violations
    (empty == valid)."""
    if not isinstance(event, dict):
        return ["event is not an object"]
    etype = event.get("type")
    if etype not in _REQUIRED:
        return [f"unknown event type {etype!r}"]
    errors: List[str] = []
    for key, want in _REQUIRED[etype].items():
        if key not in event:
            errors.append(f"{etype}: missing key {key!r}")
        elif not isinstance(event[key], want):
            errors.append(f"{etype}: key {key!r} has type "
                          f"{type(event[key]).__name__}")
    if etype == "meta" and event.get("schema") != SCHEMA_VERSION:
        errors.append(f"meta: schema {event.get('schema')!r} != "
                      f"{SCHEMA_VERSION}")
    if etype in ("meta", "summary") and \
            event.get("engine") not in _ENGINES:
        errors.append(f"{etype}: engine {event.get('engine')!r} not in "
                      f"{_ENGINES}")
    if etype == "round":
        tl = event.get("train_loss")
        if isinstance(tl, list) and \
                not all(isinstance(v, _NUM) for v in tl):
            errors.append("round: train_loss has non-numeric entries")
    if etype == "eval":
        pi = event.get("pi")
        if pi is not None and (not isinstance(pi, list) or
                               not all(isinstance(v, _NUM) for v in pi)):
            errors.append("eval: pi must be null or a list of numbers")
    return errors


def validate_jsonl_lines(lines: Iterable[str]) -> List[str]:
    """Validate raw JSONL lines; returns ``line N: <violation>`` strings."""
    errors: List[str] = []
    for i, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {i}: invalid JSON ({e.msg})")
            continue
        errors.extend(f"line {i}: {err}" for err in validate_event(event))
    return errors
