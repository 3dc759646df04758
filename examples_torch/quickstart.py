"""Quickstart: convert a sparse matrix to CB format and run CB-SpMV.

    PYTHONPATH=src python examples_torch/quickstart.py                 # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

The port of ``examples/quickstart.py``: the same matrix, pipeline and
printout, on the CUDA kernels (``--device cpu``: their plain versions).
``main`` returns what it printed as numbers, with the matrix, the
streams, ``x`` and ``y``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CBMatrix
from repro_torch.core.spmv_ref import dense_oracle
from repro_torch.core.streams import build_streams, resolve_device
from repro_torch.data import matrices
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a SuiteSparse-like matrix (power-law graph, the paper's hard case)
    m = n = 1024
    rows, cols, vals = matrices.power_law(m, n, seed=0)
    print(f"matrix: {m}x{n}, nnz={len(vals)}")

    # 2. the full CB conversion pipeline (Fig. 5): blocking -> th0 check ->
    #    column aggregation -> format selection -> VP packing -> TB balance
    cb = CBMatrix.from_coo(rows, cols, vals, (m, n), block_size=16,
                           val_dtype=np.float32)
    stats = cb.stats()
    print("CB structure:", {k: stats[k] for k in
          ("num_blocks", "fmt_coo", "fmt_csr", "fmt_dense",
           "column_aggregated", "super_sparse_fraction")})
    print(f"TB load imbalance after pq balance: "
          f"{stats['tb_load_imbalance']:.3f} (1.0 = perfect)")

    # 3. typed kernel streams + the CUDA kernels (their plain versions on the CPU)
    streams = build_streams(cb).to(device)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = ops.cb_spmv(streams, torch.from_numpy(x), device=device)

    # 4. validate against the dense oracle
    y_ref = dense_oracle(rows, cols, vals.astype(np.float32), (m, n), x)
    err = float(np.abs(y.cpu().numpy() - y_ref).max())
    print(f"CB-SpMV max abs error vs dense oracle: {err:.2e}")
    assert err < 1e-3
    print("OK")
    return {"m": m, "n": n, "nnz": len(vals), "stats": stats, "err_vs_oracle": err,
            "coo": (rows, cols, vals), "streams": streams, "x": x, "y": y}


if __name__ == "__main__":
    main()
