"""build.partition_s: seconds of the host build's step that runs the 2D blocking
(``blocking.partition_coo``; twice where column aggregation applies): the program's own
span ``cb.partition``, summed over its records in ``repro_torch.obs``'s tracer. The
traced run builds once, so the records are that build's."""
from harness import program

SPAN = "cb.partition"


def read(run):
    return program.span_total_s(SPAN)
