"""build.balance_s: seconds of the host build's step that runs the load balance
(``balance.tb_load_balance`` + ``apply_balance``): the program's own span
``cb.balance``, summed over its records in ``repro_torch.obs``'s tracer. The traced run
builds once, so the records are that build's."""
from harness import program

SPAN = "cb.balance"


def read(run):
    return program.span_total_s(SPAN)
