"""spmv_gflops: 2 * nnz * calls completed over the whole window, in GFLOP/s.

nnz is the benchmark's own count of the matrix's stored entries; the
window runs from the first dispatch to the final synchronise."""


def read(run):
    if run.units == 0 or run.window_s <= 0:
        return None
    return 2.0 * run.nnz * run.units / run.window_s / 1e9
