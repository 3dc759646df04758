"""format_us: device time of the three format kernels (dense, panel, coo),
from the profiler's CUDA activity in the traced sub-window, per call, in us. Kernel names: ``PATTERN``."""
from harness import readers

PATTERN = r"cb_dense_kernel|cb_panel_kernel|cb_coo_kernel"


def read(run):
    return readers.kernel_us_per_unit(run, PATTERN)
