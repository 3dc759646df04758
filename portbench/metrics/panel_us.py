"""panel_us: device time of the panel kernel alone (column-aggregated CSR
blocks, ``csrc/cb_colagg.cu``), from the profiler's CUDA activity in the
traced sub-window, per call, in us. ``format_us`` sums it with the dense and
COO kernels. Kernel name: ``PATTERN``."""
from harness import readers

PATTERN = r"cb_panel_kernel"


def read(run):
    return readers.kernel_us_per_unit(run, PATTERN)
