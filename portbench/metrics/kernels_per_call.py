"""kernels_per_call: CUDA kernels in the traced sub-window over the calls in it."""


def read(run):
    tr = run.trace
    if tr is None or tr.units == 0 or not tr.kernels():
        return None
    return len(tr.kernels()) / tr.units
