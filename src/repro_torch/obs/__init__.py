"""Telemetry subsystem: metrics core, span tracing, and RunRecords (the
port of ``repro.obs``; the same schema-v1 files, byte for byte).

Three layers (see ``docs/observability.md``):

  - :mod:`repro_torch.obs.metrics` — counters / gauges / histograms /
    per-round timeseries behind a :class:`MetricsRegistry`.
  - :mod:`repro_torch.obs.trace` — ``obs.span(...)`` / ``@obs.traced``
    host-side wall-clock spans, exported as Chrome-trace JSON
    (Perfetto-loadable), with compile events carrying FLOP/byte counts.
  - :mod:`repro_torch.obs.record` — the :class:`RunRecorder` facade
    writing the structured JSONL ``RunRecord`` consumed by ``python -m
    repro_torch.obs.report``.

The federated simulator owns a recorder per instance; the fused engine's
per-round taps stay on the device and reach the host in the block's one
copy, so recording adds no host sync to the round loop.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, Timeseries)
from repro_torch.obs.record import (SCHEMA_VERSION, JsonlSink, MemorySink,
                                    RunRecorder, encode_event,
                                    validate_event, validate_jsonl_lines)
from repro_torch.obs.trace import (Span, Tracer, get_tracer, set_tracer,
                                   span, traced, use_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Timeseries",
    "SCHEMA_VERSION", "JsonlSink", "MemorySink", "RunRecorder",
    "encode_event", "validate_event", "validate_jsonl_lines",
    "Span", "Tracer", "get_tracer", "set_tracer", "span", "traced",
    "use_tracer",
]
