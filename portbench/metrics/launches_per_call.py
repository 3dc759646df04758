"""launches_per_call: every kernel a ``cb_spmv`` call launches, as the program
counts them: the total of ``repro.ops.spmv.launches`` (every ``format``
series: the format kernels, ``gather``, ``combine``, ``fill``) over
``repro.ops.spmv.calls{impl=cuda}``. None where the program does not count
its gathers (a ``launches`` with no ``format=gather`` series), or made no call."""
from harness import program


def read(run):
    launches = program.counter_series("repro.ops.spmv.launches")
    calls = program.counter_series("repro.ops.spmv.calls").get((("impl", "cuda"),), 0)
    if not calls or (("format", "gather"),) not in launches:
        return None
    return sum(launches.values()) / calls
