"""Lightweight span tracing with Chrome ``trace_event`` export.

A span is a context manager timing one host-side region on the
injectable monotonic clock (``metrics.now``):

    with obs.span("robust_solve", n=4096) as sp:
        ...
        sp.set(status="ok")

Spans nest per thread (a thread-local counter records each span's
depth), cost two clock reads plus one list append, and become no-ops
when obs is disabled. While a ``torch.profiler`` is recording, a span
also opens a ``torch.profiler.record_function`` of its name, so it shows
in the profiler's trace as a ``user_annotation`` on the thread that ran
it, on the clock of the device's kernels; with no profiler recording
that costs one "is a profiler on" check. torch is never imported here:
the check is looked up once torch is in ``sys.modules``.

Completed spans accumulate in a bounded
in-process buffer on the :class:`Tracer`; ``chrome_trace()`` renders
them as Chrome ``trace_event`` *complete* events (``ph: "X"``, µs
timestamps relative to the tracer epoch) — load the exported
``.trace.json`` in ``chrome://tracing`` / Perfetto. The port of
``repro.obs.spans``: the same records and the same trace JSON.

Determinism: timestamps come only from the configured clock and thread
ids are logical (0, 1, ... in first-seen order, not OS idents), so a
fake clock reproduces byte-identical traces.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import threading

from . import metrics


@dataclasses.dataclass(frozen=True, slots=True)
class SpanRecord:
    """One completed span (times in clock seconds since tracer epoch)."""

    name: str
    start: float
    duration: float
    depth: int
    tid: int
    attrs: dict


_FIELDS = len(SpanRecord.__slots__)


def _find_profiler_check() -> bool:
    """Whether a torch profiler is recording; False while torch is not imported.
    Once torch is, its C check takes this function's place in ``_profiling``."""
    global _profiling
    autograd = getattr(getattr(sys.modules.get("torch"), "_C", None), "_autograd", None)
    check = getattr(autograd, "_profiler_enabled", None)
    if check is None:
        return False
    _profiling = check
    return check()


_profiling = _find_profiler_check


class _NullSpan:
    """Returned while obs is disabled: absorbs the whole span API."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Span:
    """Context manager for one traced region; ``set()`` adds attrs."""

    __slots__ = ("name", "attrs", "_tracer", "_start", "_depth", "_tid", "_annot")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self._tracer = tracer

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        local = self._tracer._local
        try:
            depth = local.depth
        except AttributeError:
            depth = self._tracer._join_thread()
        self._depth, self._tid = depth, local.tid
        local.depth = depth + 1
        if _profiling():
            self._annot = sys.modules["torch"].profiler.record_function(self.name)
            self._annot.__enter__()
        else:
            self._annot = None
        self._start = metrics.CONFIG.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = metrics.CONFIG.clock()
        if self._annot is not None:
            self._annot.__exit__(exc_type, exc, tb)
        tracer = self._tracer
        tracer._local.depth = self._depth
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        record = (self.name, self._start - tracer._epoch, end - self._start, self._depth,
                  self._tid, dict(self.attrs) if self.attrs else None)
        with tracer._lock:
            if len(tracer._log) < _FIELDS * tracer.max_spans:
                tracer._log.extend(record)
            else:
                tracer.dropped += 1
        return False


class Tracer:
    """Bounded buffer of completed spans + Chrome trace rendering."""

    def __init__(self, max_spans: int = 100_000) -> None:
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._local = threading.local()
        # every completed span's SpanRecord fields, flat: a span adds no object
        # that outlives it for the garbage collector to scan; records() builds them
        self._log: list = []
        self._tids: dict[int, int] = {}
        self._epoch: float | None = None
        self.dropped = 0

    # -- recording ------------------------------------------------------
    def span(self, name: str, **attrs):
        if not metrics.CONFIG.enabled:
            return _NULL_SPAN
        if self._epoch is None:
            with self._lock:
                if self._epoch is None:
                    self._epoch = metrics.now()
        return Span(self, name, attrs)

    def _join_thread(self) -> int:
        """Give the calling thread its logical id; return its span depth (0)."""
        with self._lock:
            self._local.tid = self._tids.setdefault(threading.get_ident(), len(self._tids))
        self._local.depth = 0
        return 0

    # -- reading --------------------------------------------------------
    def records(self) -> tuple[SpanRecord, ...]:
        with self._lock:
            log = list(self._log)
        return tuple(SpanRecord(*log[i:i + _FIELDS - 1], log[i + _FIELDS - 1] or {})
                     for i in range(0, len(log), _FIELDS))

    def reset(self) -> None:
        with self._lock:
            self._log.clear()
            self._tids.clear()
            self._epoch = None
            self.dropped = 0
        self._local = threading.local()

    def summary(self) -> list[dict]:
        """Per-name aggregate rows (count, total/mean/max seconds),
        sorted by total descending — the obs_report table."""
        agg: dict[str, list] = {}
        for r in self.records():
            row = agg.setdefault(r.name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += r.duration
            row[2] = max(row[2], r.duration)
        return [
            {"name": name, "count": c, "total_s": tot,
             "mean_s": tot / c, "max_s": mx}
            for name, (c, tot, mx) in sorted(
                agg.items(), key=lambda kv: -kv[1][1])
        ]

    # -- export ---------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON object (complete events)."""
        events = [
            {
                "name": r.name,
                "cat": "repro",
                "ph": "X",
                "ts": r.start * 1e6,        # trace_event wants microseconds
                "dur": r.duration * 1e6,
                "pid": 1,
                "tid": r.tid,
                "args": dict(r.attrs, depth=r.depth),
            }
            for r in self.records()
        ]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1, sort_keys=True)
        return str(path)


_DEFAULT_TRACER = Tracer()


def tracer() -> Tracer:
    return _DEFAULT_TRACER
