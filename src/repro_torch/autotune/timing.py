"""Measurement helpers of the autotuner's timed search.

The port of ``repro.autotune.timing``: the same minimum of individually
timed calls, taken on the device the call ran on.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch


def time_min(fn, *args, reps=15):
    """Min of individually-timed calls (two warmups first), in seconds.

    A call whose result lives on a CUDA device is timed there: a pair of
    ``torch.cuda.Event``s around each call on that device's current
    stream, synchronised before the next call, so each figure is what one
    call costs its caller, the host's enqueue included where it is the
    longer. Any other call is timed by the host clock. The minimum is
    robust to a neighbour's noise on a shared machine.
    """
    fn(*args)
    out = fn(*args)
    if not (isinstance(out, torch.Tensor) and out.is_cuda):
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(out.device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = math.inf
        for _ in range(reps):
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    return best


def geomean(xs) -> float:
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-12)))))
