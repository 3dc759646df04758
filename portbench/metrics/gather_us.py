"""gather_us: device time of the x gather (ops._gather's index_select, a gather kernel),
from the profiler's CUDA activity in the traced sub-window, per call, in us. Kernel names: ``PATTERN``."""
from harness import readers

PATTERN = r"indexSelect|_scatter_gather_elementwise_kernel"


def read(run):
    return readers.kernel_us_per_unit(run, PATTERN)
