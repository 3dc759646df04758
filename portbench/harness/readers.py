"""Reductions that several metric readers share."""
from __future__ import annotations


def idle_pct(run):
    """Share of the traced sub-window with no device op, in %; None without kernels."""
    tr = run.trace
    if tr is None or tr.window_us <= 0 or not tr.kernels():
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)


def kernel_us_per_unit(run, pattern: str):
    """Device time of the sub-window's kernels matching ``pattern``, per unit, in us."""
    tr = run.trace
    if tr is None or tr.units == 0:
        return None
    ks = tr.kernels(pattern)
    if not ks:
        return None
    return sum(k[3] for k in ks) / tr.units
