"""build.formats_s: seconds of the host build's step that runs the format selection and
intra-block aggregation (``formats.select_formats`` +
``aggregation.aggregate_partition``): the program's own span ``cb.formats``, summed over
its records in ``repro_torch.obs``'s tracer. The traced run builds once, so the records
are that build's."""
from harness import program

SPAN = "cb.formats"


def read(run):
    return program.span_total_s(SPAN)
