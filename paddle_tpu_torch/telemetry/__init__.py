"""Telemetry for the PyTorch port: the metrics registry, the JSONL sink,
causal request tracing, the goodput ledger and the /memz registry.

  telemetry.registry   process-wide counters/gauges/histograms with a
                       Prometheus text exposition (scrape or dump)
  telemetry.sink       per-record JSONL (PADDLE_METRICS_PATH)
  telemetry.tracing    causal spans (PADDLE_TRACING): bounded span
                       ring, flight recorder, per-request records
  telemetry.goodput    goodput/badput ledger (PADDLE_GOODPUT); the
                       generation engine charges serving badput here
  telemetry.memory     PADDLE_HBM_BUDGET_BYTES and the /memz sections
  telemetry.export     the metrics and span push exporters
                       (PADDLE_METRICS_PUSH_URL, PADDLE_TRACES_PUSH_URL)

All stdlib-only copies of the JAX package's modules of the same names
(memory.py keeps only its framework-neutral part).
"""
from __future__ import annotations

from . import export, goodput, memory, sink, tracing  # noqa: F401
from .registry import (  # noqa: F401
    BYTE_BUCKETS,
    DEFAULT_MS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from .sink import emit, enabled  # noqa: F401


def to_prometheus() -> str:
    """One-call text exposition of the process registry."""
    return get_registry().to_prometheus()


def snapshot() -> dict:
    """JSON-ready dump of the process registry."""
    return get_registry().snapshot()
