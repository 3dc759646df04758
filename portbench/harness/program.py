"""What the program records of itself (``repro_torch.obs``), for the metrics
whose source is ``program_span`` or ``program_counter``. A span or series the
program does not record reads None, never 0."""
from __future__ import annotations

from repro_torch import obs


def span_total_s(name: str):
    """Seconds summed over every completed span called ``name``; None without one."""
    durations = [r.duration for r in obs.tracer().records() if r.name == name]
    return sum(durations) if durations else None


def counter_series(name: str) -> dict:
    """A counter's series as {label set: value}, each label set a sorted tuple of pairs."""
    metric = obs.snapshot().get(name, {"series": []})
    return {tuple(sorted(s["labels"].items())): s["value"] for s in metric["series"]}
