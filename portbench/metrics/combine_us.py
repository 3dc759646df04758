"""combine_us: device time of the combine (cb_segment_sum's kernel),
from the profiler's CUDA activity in the traced sub-window, per call, in us. Kernel names: ``PATTERN``."""
from harness import readers

PATTERN = r"cb_combine_kernel"


def read(run):
    return readers.kernel_us_per_unit(run, PATTERN)
