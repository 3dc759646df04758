"""Reference (oracle) SpMV over the CB structure — pure numpy.

``spmv_ref`` unpacks the packed buffer through the virtual pointers, so it
exercises the *format*, not just the linear algebra; ``dense_oracle`` is
the straight COO product that never touches the CB machinery.
"""
from __future__ import annotations

import numpy as np

from .cb_matrix import CBMatrix


def _row_sums(rows: np.ndarray, prod: np.ndarray, m: int, dtype) -> np.ndarray:
    """Sum ``prod`` per row in element order (float64 inside, fast at 1e7+ nnz)."""
    return np.bincount(rows, weights=prod, minlength=m).astype(dtype)


def spmv_ref(cb: CBMatrix, x: np.ndarray) -> np.ndarray:
    """y = A @ x computed from the decoded CB structure."""
    m, n = cb.shape
    x = np.asarray(x)
    acc_dtype = np.result_type(cb.val_dtype, x.dtype, np.float32)
    r, c, v = cb.global_elements()
    return _row_sums(r, v.astype(acc_dtype) * x[c].astype(acc_dtype), m, acc_dtype)


def dense_oracle(rows, cols, vals, shape, x) -> np.ndarray:
    """Straight COO mat-vec, independent of the CB machinery."""
    m, n = shape
    acc_dtype = np.result_type(np.asarray(vals).dtype, np.asarray(x).dtype, np.float32)
    prod = np.asarray(vals, acc_dtype) * np.asarray(x, acc_dtype)[np.asarray(cols)]
    return _row_sums(np.asarray(rows), prod, m, acc_dtype)
