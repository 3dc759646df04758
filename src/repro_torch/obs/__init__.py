"""Unified observability for the CB engine: metrics, spans, exports.

The port of ``repro.obs``: the same names, metric names and snapshots.
Stdlib only. Three layers:

  * **metrics** — a process-wide :class:`MetricsRegistry` of typed,
    labeled instruments (counter / gauge / log2-bucket histogram) with
    deterministic snapshots (``obs.snapshot()``) and JSON export;
  * **spans** — ``obs.span(name, **attrs)`` context-manager tracing on
    the injectable monotonic clock, exported as Chrome ``trace_event``
    JSON (``obs.export_chrome_trace(path)``);
  * **mirrored counters** — :class:`MirroredCounter` keeps a private
    counter dict (``PlanCache.hits``) intact while forwarding its
    increments into the registry.

A fourth layer lives in the ``repro_torch.obs.locality`` submodule
(import it explicitly — it needs numpy, so it stays out of this
package's stdlib-only import): the vectorized reuse-distance engine and
the access-stream generators that model L1/L2 cache traffic of the
planned super-block/super-tile pipelines.

Everything is gated on ``obs.configure(enabled=...)`` (default ON;
disabled instruments are no-op-cheap) and timed by the injectable
``configure(clock=...)`` so tests are deterministic. Recording is a
host-side Python effect after a call is enqueued: it reads only shape
metadata, never synchronises with the device, and numeric results are
bit-identical with obs on or off.

Metric naming convention: ``repro.<subsystem>.<metric>``, the JAX
package's names — the catalog lives in ``src/repro/obs/README.md``.
"""
from __future__ import annotations

from .metrics import (  # noqa: F401
    BUCKET_EDGES,
    Batch,
    Counter,
    Gauge,
    Histogram,
    Instrument,
    MetricsRegistry,
    MirroredCounter,
    bucket_index,
    configure,
    is_enabled,
    now,
    registry,
)
from .spans import (  # noqa: F401
    Span,
    SpanRecord,
    Tracer,
    tracer,
)


def counter(name: str) -> Counter:
    """Shorthand for the default registry's counter."""
    return registry().counter(name)


def gauge(name: str) -> Gauge:
    return registry().gauge(name)


def histogram(name: str) -> Histogram:
    return registry().histogram(name)


_TRACER = tracer()


def span(name: str, **attrs):
    """Start a traced region on the default tracer (context manager)."""
    return _TRACER.span(name, **attrs)


def snapshot() -> dict:
    """Deterministic JSON-able view of every recorded metric."""
    return registry().snapshot()


def reset() -> None:
    """Clear the default registry AND the default tracer."""
    registry().reset()
    tracer().reset()


def chrome_trace() -> dict:
    return tracer().chrome_trace()


def export_chrome_trace(path) -> str:
    """Write the default tracer's spans as Chrome trace_event JSON."""
    return tracer().export(path)
