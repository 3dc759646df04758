"""host_self_us: the program's own host work per call inside the real loop, in us.

Each ``cb_spmv`` call is an ``obs`` span, which a recording profiler also
holds as a ``user_annotation`` on the launching thread (``run.trace.host``).
For every such annotation that starts in the traced sub-window: its
duration minus the time of the CUDA runtime and driver calls nested in it
(names matching ``RUNTIME``; their union, so a driver call inside a runtime
call counts once). With the launch queue full the host waits inside
``cudaLaunchKernel``; what is left is the program's self time. The mean over
those calls; None without one."""
import bisect
import re

from harness import trace

SPAN = "cb_spmv"
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def self_us(spans: list, runtime: list) -> list:
    """Per span (start, dur): dur minus the union of the runtime calls inside it."""
    runtime = sorted(runtime)
    starts = [r0 for r0, _ in runtime]
    out = []
    for s0, d in spans:
        near = runtime[bisect.bisect_left(starts, s0):bisect.bisect_right(starts, s0 + d)]
        out.append(d - trace.union_us([(r0, rd) for r0, rd in near if r0 + rd <= s0 + d]))
    return out


def read(run):
    tr = run.trace
    if tr is None:
        return None
    w1 = tr.start_us + tr.window_us
    spans = [(s, d) for name, s, d in tr.host if name == SPAN and tr.start_us <= s <= w1]
    if not spans:
        return None
    runtime = [(s, d) for name, s, d in tr.host if RUNTIME.match(name)]
    selfs = self_us(spans, runtime)
    return sum(selfs) / len(selfs)
