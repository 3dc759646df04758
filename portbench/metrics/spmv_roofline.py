"""spmv_roofline: the byte floor's time at the card's HBM rate over the
call's summed device time, in %.

The floor is counted from the benchmark's own matrix, never from the
port's layout: each stored value read once at 4 B, x read once and y
written once at 4 B. The rate is the data sheet's (peaks.json) for the
card the run is on; the call's time is every device op of the traced
sub-window over the calls in it."""
from harness import device


def floor_bytes(nnz: int, m: int, n: int) -> int:
    return 4 * nnz + 4 * n + 4 * m


def read(run):
    tr = run.trace
    peak = run.peaks.get(device.name(run.device), {}).get("hbm_bytes_per_s")
    if tr is None or tr.units == 0 or not tr.ops or not peak:
        return None
    m, n = run.matrix["shape"]
    call_us = sum(o[3] for o in tr.ops) / tr.units
    return 100.0 * (floor_bytes(run.nnz, m, n) / peak * 1e6) / call_us
