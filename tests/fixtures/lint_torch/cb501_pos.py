"""CB501 positive: instrument names off the naming convention."""
from repro_torch import obs


def record(kind):
    obs.counter("fixture_calls").inc()
    obs.gauge("repro.depth").set(1)
    obs.histogram(f"{kind}.latency").observe(0.1)
    mirrored = obs.MirroredCounter(metric="lookups", label="outcome")
    return mirrored
