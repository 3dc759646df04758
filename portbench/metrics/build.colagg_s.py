"""build.colagg_s: seconds of the host build's step that runs the column aggregation
(``column_agg.column_aggregate``, or the identity where it does not apply): the
program's own span ``cb.colagg``, summed over its records in ``repro_torch.obs``'s
tracer. The traced run builds once, so the records are that build's."""
from harness import program

SPAN = "cb.colagg"


def read(run):
    return program.span_total_s(SPAN)
