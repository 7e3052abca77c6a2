"""Observability (``repro.obs``): tracing, live metrics, attribution and
drift reporting for the port's engine.

* :mod:`repro_torch.obs.trace`: a bounded ring-buffer
  :class:`TraceRecorder`.  The engine opens one span per request
  lifecycle (queued, prefill chunks, decode, the terminal status, with
  preemption, retry and chaos events attached) and one per step (the
  host's dispatch and the device's wait split out), plus per-step counter
  tracks; the export is Chrome trace-event JSON that Perfetto loads.
* :mod:`repro_torch.obs.metrics`: counter, gauge and histogram registry
  with Prometheus text exposition, the None-never-NaN
  :func:`percentile`, and :class:`WindowedSeries` behind
  ``Engine.live_metrics()``.
* :mod:`repro_torch.obs.promcheck`: a strict exposition conformance
  checker.
* :mod:`repro_torch.obs.attrib`: every N engine steps the step is re-run
  segment by segment (each a CUDA graph of its own on the card) on a copy
  of its pre-step state, attributing device time to each layer and bit
  pair.
* :mod:`repro_torch.obs.server`: ``/metrics``, ``/livez`` and ``/trace``
  over stdlib HTTP on a background thread; the engine never opens a
  socket.
* :mod:`repro_torch.obs.drift`: per-layer measured time against the
  plan's predicted cost, standalone and in situ
  (``python -m repro_torch.obs.drift``).

Tracing and attribution are opt-in; off, every hook of the engine is one
``is not None`` test and allocates nothing.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WindowedSeries,
    percentile,
)
from repro_torch.obs.server import TelemetryServer  # noqa: F401
from repro_torch.obs.trace import TraceRecorder  # noqa: F401

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TelemetryServer",
    "TraceRecorder",
    "WindowedSeries",
    "percentile",
]
