"""build.pack_s: seconds of the host build's step that runs the packing into super-block
streams (``build_super_streams``): the program's own span ``streams.build_super``,
summed over its records in ``repro_torch.obs``'s tracer. The traced run builds once, so
the records are that build's."""
from harness import program

SPAN = "streams.build_super"


def read(run):
    return program.span_total_s(SPAN)
