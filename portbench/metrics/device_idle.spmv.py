"""device_idle.spmv: the share of the traced sub-window in which no kernel,
copy or set ran on the device (torch.profiler's CUDA activity), in %."""
from harness import readers


def read(run):
    return readers.idle_pct(run)
