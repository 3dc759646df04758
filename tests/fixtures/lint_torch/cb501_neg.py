"""CB501 negative: repro.<subsystem>.<metric> names everywhere (the reference's)."""
from repro_torch import obs


def record(kind):
    obs.counter("repro.fixture.calls").inc()
    obs.gauge("repro.fixture.depth").set(1)
    obs.histogram(f"repro.fixture.{kind}_latency").observe(0.1)
    mirrored = obs.MirroredCounter(
        metric="repro.fixture.lookups", label="outcome")
    return mirrored
