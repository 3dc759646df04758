"""Lightweight span tracing with Chrome ``trace_event`` export.

A span is a context manager timing one host-side region on the
injectable monotonic clock (``metrics.now``):

    with obs.span("robust_solve", n=4096) as sp:
        ...
        sp.set(status="ok")

Spans nest per thread (a thread-local stack records each span's depth
and parent), cost two clock reads plus one list append, and become
no-ops when obs is disabled. Completed spans accumulate in a bounded
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
import threading

from . import metrics


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span (times in clock seconds since tracer epoch)."""

    name: str
    start: float
    duration: float
    depth: int
    tid: int
    attrs: dict


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

    __slots__ = ("name", "attrs", "_tracer", "_start", "_depth", "_tid")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self._tracer = tracer
        self._start = 0.0
        self._depth = 0
        self._tid = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tid, stack = self._tracer._thread_state()
        self._depth = len(stack)
        stack.append(self)
        self._start = metrics.now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = metrics.now()
        _, stack = self._tracer._thread_state()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._record(SpanRecord(
            name=self.name,
            start=self._start - self._tracer._epoch,
            duration=end - self._start,
            depth=self._depth,
            tid=self._tid,
            attrs=dict(self.attrs),
        ))
        return False


class Tracer:
    """Bounded buffer of completed spans + Chrome trace rendering."""

    def __init__(self, max_spans: int = 100_000) -> None:
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._local = threading.local()
        self._records: list[SpanRecord] = []
        self._tids: dict[int, int] = {}
        self._epoch: float | None = None
        self.dropped = 0

    # -- recording ------------------------------------------------------
    def span(self, name: str, **attrs):
        if not metrics.is_enabled():
            return _NULL_SPAN
        if self._epoch is None:
            with self._lock:
                if self._epoch is None:
                    self._epoch = metrics.now()
        return Span(self, name, attrs)

    def _thread_state(self) -> tuple[int, list]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            with self._lock:
                self._local.tid = self._tids.setdefault(
                    threading.get_ident(), len(self._tids))
        return self._local.tid, stack

    def _record(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._records) >= self.max_spans:
                self.dropped += 1
                return
            self._records.append(record)

    # -- reading --------------------------------------------------------
    def records(self) -> tuple[SpanRecord, ...]:
        with self._lock:
            return tuple(self._records)

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
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
