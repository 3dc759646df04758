"""build.to_device_s: seconds of the host build's step that runs the move of the streams to
the device (the streams' ``.to()``): the program's own span ``streams.to``, summed over
its records in ``repro_torch.obs``'s tracer. The traced run builds once, so the records
are that build's."""
from harness import program

SPAN = "streams.to"


def read(run):
    return program.span_total_s(SPAN)
