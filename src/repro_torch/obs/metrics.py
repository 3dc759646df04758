"""Process-wide metrics registry with typed, labeled instruments.

Stdlib only (no torch, no numpy): the registry is imported by hot host
paths (``kernels/ops``, ``autotune/plan``, ``solvers/krylov``), and
snapshot values are plain Python ints/floats so ``json.dumps`` always
works. The port of ``repro.obs.metrics``: same instruments, same metric
names, same snapshots.

Three instrument kinds, all supporting labeled series (one independent
value per label combination):

  * :class:`Counter`   — monotonically increasing sum (``inc``);
  * :class:`Gauge`     — last-written value (``set``);
  * :class:`Histogram` — fixed **log2 buckets** (upper edges at powers
    of two), so p50/p99 are deterministic functions of the observed
    multiset: a quantile is always reported as its bucket's upper edge,
    never interpolated from machine-dependent timings.

Naming convention: ``repro.<subsystem>.<metric>``, the JAX package's names
(its catalog is ``src/repro/obs/README.md``), so the two packages' snapshots
compare key for key. All recording is gated on :func:`is_enabled` —
``configure(enabled=False)`` turns every instrument into a cheap no-op —
and timestamps come from the injectable :func:`now` clock so tests can
drive deterministic time.

:class:`MirroredCounter` backs the ``PlanCache`` hit/miss/stale counts: a
real ``collections.Counter`` whose increments are *also* forwarded to a
registry counter. The local dict stays the source of
truth for the attribute API (correct even when obs is disabled); the
registry series is the telemetry view.
"""
from __future__ import annotations

import collections
import json
import math
import threading
import time

from repro_torch import errors


# ---------------------------------------------------------------------------
# Process-wide configuration: the enabled flag and the injectable clock.
# ---------------------------------------------------------------------------

class _Config:
    __slots__ = ("enabled", "clock")

    def __init__(self) -> None:
        self.enabled = True
        self.clock = time.monotonic


CONFIG = _Config()


def configure(*, enabled: bool | None = None, clock=None) -> None:
    """Set the process-wide obs switches (None leaves a switch untouched).

    ``enabled=False`` turns every instrument and span into a no-op-cheap
    guard check; ``clock`` replaces the monotonic clock used for span
    timing and latency histograms (inject a fake for deterministic
    tests).
    """
    if enabled is not None:
        CONFIG.enabled = bool(enabled)
    if clock is not None:
        CONFIG.clock = clock


def is_enabled() -> bool:
    return CONFIG.enabled


def now() -> float:
    """Current time from the configured (injectable) monotonic clock."""
    return CONFIG.clock()


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class Instrument:
    """Base: one named metric holding independent labeled series."""

    kind = "instrument"

    def __init__(self, name: str, registry: "MetricsRegistry") -> None:
        self.name = name
        self._registry = registry
        self._series: dict[tuple, object] = {}

    def reset(self) -> None:
        with self._registry._lock:
            self._series.clear()

    def labelsets(self) -> list[dict]:
        return [dict(key) for key in sorted(self._series)]

    def _snapshot_value(self, state):  # pragma: no cover - overridden
        raise NotImplementedError

    def snapshot(self) -> list[dict]:
        with self._registry._lock:
            return [
                {"labels": dict(key), **self._snapshot_value(state)}
                for key, state in sorted(self._series.items())
            ]


class Counter(Instrument):
    """Monotonic sum. ``inc`` rejects negative deltas by contract."""

    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if not CONFIG.enabled:
            return
        if value < 0:
            raise errors.InvalidArgError(
                f"counter {self.name!r}: negative increment {value!r}"
            )
        key = _label_key(labels)
        with self._registry._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)

    def total(self) -> float:
        """Sum across every labeled series."""
        with self._registry._lock:
            return sum(self._series.values())

    def _snapshot_value(self, state):
        return {"value": state}


class Gauge(Instrument):
    """Last-written value per labeled series."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not CONFIG.enabled:
            return
        with self._registry._lock:
            self._series[_label_key(labels)] = value

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)

    def _snapshot_value(self, state):
        return {"value": state}


# Fixed log2 bucket upper edges: 2^-30 (~1ns in seconds) .. 2^31. A value
# lands in the smallest bucket whose upper edge it does not exceed; the
# two sentinel buckets catch underflow (v <= 2^-30, including 0) and
# overflow (v > 2^31). Fixed edges make every percentile a deterministic
# function of the observed multiset, independent of arrival order.
_MIN_EXP = -30
_MAX_EXP = 31
BUCKET_EDGES: tuple[float, ...] = tuple(
    2.0 ** e for e in range(_MIN_EXP, _MAX_EXP + 1)
)


def bucket_index(value: float) -> int:
    """Index of the log2 bucket holding ``value`` (see BUCKET_EDGES)."""
    if not value > BUCKET_EDGES[0]:
        return 0
    if value > BUCKET_EDGES[-1]:
        return len(BUCKET_EDGES)
    m, e = math.frexp(value)          # value = m * 2^e, 0.5 <= m < 1
    exp = e - 1 if m == 0.5 else e    # ceil(log2(value))
    return exp - _MIN_EXP


class _HistState:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts = [0] * (len(BUCKET_EDGES) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(Instrument):
    """Fixed-log2-bucket histogram with deterministic percentiles."""

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        if not CONFIG.enabled:
            return
        value = float(value)
        key = _label_key(labels)
        with self._registry._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = _HistState()
            state.counts[bucket_index(value)] += 1
            state.count += 1
            state.sum += value
            state.min = min(state.min, value)
            state.max = max(state.max, value)

    def percentile(self, p: float, **labels) -> float:
        """Deterministic quantile: the upper edge of the bucket holding
        the ``ceil(p * count)``-th observation (the true max for the
        overflow bucket)."""
        state = self._series.get(_label_key(labels))
        if state is None or state.count == 0:
            return 0.0
        rank = max(1, math.ceil(p * state.count))
        seen = 0
        for i, c in enumerate(state.counts):
            seen += c
            if seen >= rank:
                return BUCKET_EDGES[i] if i < len(BUCKET_EDGES) else state.max
        return state.max  # pragma: no cover - rank <= count always hits

    def summary(self, **labels) -> dict:
        state = self._series.get(_label_key(labels))
        if state is None or state.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p99": 0.0}
        return {
            "count": state.count,
            "sum": state.sum,
            "min": state.min,
            "max": state.max,
            "p50": self.percentile(0.50, **labels),
            "p99": self.percentile(0.99, **labels),
        }

    def _snapshot_value(self, state: _HistState):
        # recompute the percentile walk inline: snapshot() holds the lock
        summary = {"count": state.count, "sum": state.sum,
                   "min": state.min, "max": state.max}
        for tag, p in (("p50", 0.50), ("p99", 0.99)):
            rank = max(1, math.ceil(p * state.count))
            seen, val = 0, state.max
            for i, c in enumerate(state.counts):
                seen += c
                if seen >= rank:
                    val = (BUCKET_EDGES[i] if i < len(BUCKET_EDGES)
                           else state.max)
                    break
            summary[tag] = val
        return {"summary": summary}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name -> instrument store with snapshot / reset / JSON export."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._instruments: dict[str, Instrument] = {}

    def _get(self, name: str, cls) -> Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, self)
            elif type(inst) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict:
        """JSON-able view: {name: {"type": kind, "series": [...]}}.

        Series with no recordings are omitted; ordering is sorted, so
        two identical recording sequences snapshot identically.
        """
        with self._lock:
            return {
                name: {"type": inst.kind, "series": inst.snapshot()}
                for name, inst in sorted(self._instruments.items())
                if inst._series
            }

    def reset(self) -> None:
        """Clear every series (instrument objects stay registered)."""
        with self._lock:
            for inst in self._instruments.values():
                inst.reset()

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


# The process-wide default registry: subsystem instrumentation all lands
# here so one ``snapshot()`` sees the whole engine.
_DEFAULT_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _DEFAULT_REGISTRY


class Batch:
    """A fixed set of counter increments and gauge writes, resolved once and
    recorded together.

    ``inc`` / ``set`` here look the instrument up and sort the labels when
    the batch is built; :meth:`record` then applies every update under one
    registry lock — exactly what the same ``Counter.inc`` / ``Gauge.set``
    calls would have done, at a fraction of their host cost. It is the hot
    path's form for a caller that records the same series on every call
    (``kernels.ops``'s launch accounting keeps one per stream). Like every
    instrument, a disabled registry records nothing.
    """

    def __init__(self, registry: "MetricsRegistry | None" = None) -> None:
        self._registry = registry or _DEFAULT_REGISTRY
        self._adds: list = []
        self._sets: list = []

    def inc(self, name: str, value: float = 1, **labels) -> "Batch":
        if value < 0:
            raise errors.InvalidArgError(
                f"counter {name!r}: negative increment {value!r}")
        self._adds.append(
            (self._registry.counter(name)._series, _label_key(labels), value))
        return self

    def set(self, name: str, value: float, **labels) -> "Batch":
        self._sets.append(
            (self._registry.gauge(name)._series, _label_key(labels), value))
        return self

    def record(self) -> None:
        if not CONFIG.enabled:
            return
        with self._registry._lock:
            for series, key, value in self._adds:
                series[key] = series.get(key, 0) + value
            for series, key, value in self._sets:
                series[key] = value


class MirroredCounter(collections.Counter):
    """``collections.Counter`` whose increments also feed the registry.

    Drop-in for a private counter dict: call sites keep the
    ``counts[key] += 1`` / ``dict(counts)`` idioms, while every positive
    delta is forwarded to the registry counter ``metric`` with the key as
    the ``label`` value. The local dict stays authoritative — it keeps
    counting even when obs is disabled or the registry is reset, so the
    attribute API never changes meaning.
    """

    def __init__(self, data=None, *, metric: str | None = None,
                 label: str = "key", registry: MetricsRegistry | None = None):
        self._metric = metric
        self._label = label
        self._registry = registry
        super().__init__()
        if data:
            for k, v in dict(data).items():   # seed without re-mirroring
                super().__setitem__(k, v)

    def __setitem__(self, key, value) -> None:
        if self._metric is not None:
            delta = value - self.get(key, 0)
            if delta > 0:
                reg = self._registry or _DEFAULT_REGISTRY
                reg.counter(self._metric).inc(delta, **{self._label: key})
        super().__setitem__(key, value)
