"""panel_fill: the share of the panel stream's slots that hold a non-zero,
in %: the panel non-zeros the build packed (the gauge
``repro.streams.nnz{format=panel}``) over the slots one call runs
(``repro.ops.spmv.padded_elems{format=panel}`` over
``repro.ops.spmv.calls{impl=cuda}``). None where either series is missing
or no call was made, never 0."""
from harness import program

PANEL = (("format", "panel"),)


def read(run):
    nnz = program.counter_series("repro.streams.nnz").get(PANEL)
    padded = program.counter_series("repro.ops.spmv.padded_elems").get(PANEL)
    calls = program.counter_series("repro.ops.spmv.calls").get((("impl", "cuda"),), 0)
    if nnz is None or not padded or not calls:
        return None
    return 100.0 * nnz / (padded / calls)
