"""panel_compact_fill: the share of the value slots the bitmap panel kernel
reads that hold a non-zero, in %: the panel non-zeros the build packed (the
gauge ``repro.streams.nnz{format=panel}``) over the slots one call reads
(``repro.ops.spmv.compact_elems{format=panel}`` over
``repro.ops.spmv.calls{impl=cuda}``). None where either series is missing or
reads 0 (the padded kernel ran, or the program has no bitmap kernel), or no
call was made, never 0."""
from harness import program

PANEL = (("format", "panel"),)


def read(run):
    nnz = program.counter_series("repro.streams.nnz").get(PANEL)
    compact = program.counter_series("repro.ops.spmv.compact_elems").get(PANEL)
    calls = program.counter_series("repro.ops.spmv.calls").get((("impl", "cuda"),), 0)
    if nnz is None or not compact or not calls:
        return None
    return 100.0 * nnz / (compact / calls)
