"""enqueue_us: host time to dispatch one call with the launch queue not
full: after a synchronise, the host clock over dispatching 32 calls, over
32; batches repeated until 0.3 s of dispatch is summed."""
import time

BATCH = 32
TOTAL_S = 0.3


def read(run):
    prog = run.program
    if prog is None or not hasattr(prog, "call"):
        return None
    spent, calls = 0.0, 0
    while spent < TOTAL_S:
        prog.sync()
        t0 = time.perf_counter()
        for i in range(BATCH):
            prog.call(i)
        spent += time.perf_counter() - t0
        calls += BATCH
    prog.sync()
    return spent / calls * 1e6
