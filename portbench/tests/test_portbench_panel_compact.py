"""``panel_compact_fill``: the panel non-zeros over the value slots the bitmap
panel kernel reads a call, None where that kernel did not run."""
import types

import pytest

import pb_common  # noqa: F401  (puts the harness and src on the path)
from harness import spec
from repro_torch import obs

read = spec.module("metrics", "panel_compact_fill").read
RUN = types.SimpleNamespace(trace=None)


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset()
    yield
    obs.reset()


def test_it_reads_the_gauge_over_the_slots_of_a_call():
    assert read(RUN) is None
    obs.gauge("repro.streams.nnz").set(90, format="panel")
    assert read(RUN) is None                                   # no call yet
    obs.counter("repro.ops.spmv.calls").inc(2, impl="cuda")
    assert read(RUN) is None                                   # a program without the counter
    obs.counter("repro.ops.spmv.compact_elems").inc(200, format="panel")
    assert read(RUN) == pytest.approx(90.0)


def test_it_reads_none_where_the_padded_kernel_ran():
    obs.gauge("repro.streams.nnz").set(90, format="panel")
    obs.counter("repro.ops.spmv.calls").inc(3, impl="cuda")
    obs.counter("repro.ops.spmv.compact_elems").inc(0, format="panel")
    assert read(RUN) is None
