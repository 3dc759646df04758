"""Solve a 2-D Poisson problem with CG on the batched CB engine.

    PYTHONPATH=src python examples_torch/solve_poisson.py                # on the card
    PYTHONPATH=src python examples_torch/solve_poisson.py --device cpu

The port of ``examples/solve_poisson.py``: the 5-point-stencil Laplacian of
a g x g grid (SPD, n = g^2 unknowns) solved to 1e-6 relative residual by
preconditioned conjugate gradients. The matrix is preprocessed ONCE into
a ``CBLinearOperator`` (super-block streams + block-Jacobi inverse) on the
device; the solve keeps its state there and runs the batched super-block
engine's CUDA kernels (``impl="cuda"``, the port's default) in every
iteration, the regime where CB preprocessing amortizes to zero (paper
fig. 12 extended: cost / iteration-count curves below). Times are the
card's (``--device cpu``: the CPU's, through the kernels' plain versions).
``main`` returns what it printed as numbers, with ``x``, the operator,
the preconditioner and ``b``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import CBMatrix
from repro_torch.core.streams import resolve_device
from repro_torch.solvers import CBLinearOperator, block_jacobi, cg


def poisson_2d(g: int):
    """5-point stencil Laplacian on a g x g grid -> COO triplets."""
    n = g * g
    idx = np.arange(n).reshape(g, g)
    rows, cols, vals = [idx.reshape(-1)], [idx.reshape(-1)], [np.full(n, 4.0)]
    for _axis, sl_a, sl_b in (
        (0, (slice(1, None), slice(None)), (slice(None, -1), slice(None))),
        (1, (slice(None), slice(1, None)), (slice(None), slice(None, -1))),
    ):
        a, b = idx[sl_a].reshape(-1), idx[sl_b].reshape(-1)
        rows += [a, b]
        cols += [b, a]
        vals += [np.full(len(a), -1.0)] * 2
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(np.float32), (n, n))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = 40
    rows, cols, vals, shape = poisson_2d(g)
    n = shape[0]
    print(f"Poisson {g}x{g} grid: n={n}, nnz={len(vals)}")

    # -- plan time: full CB preprocessing, paid once --------------------
    t0 = time.perf_counter()
    cb = CBMatrix.from_coo(rows, cols, vals, shape, block_size=16,
                           val_dtype=np.float32)
    op = CBLinearOperator.from_cb(cb, device=device)
    M = block_jacobi(cb, device=device)
    _sync(device)
    t_pre = time.perf_counter() - t0
    print(f"preprocessing: {t_pre * 1e3:.1f} ms "
          f"(group_size={op.group_size}, {cb.stats()['num_blocks']} blocks)")

    # -- solve: the loop state on the device, the kernels every iteration --
    x_true = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    b = torch.from_numpy(cb.to_dense() @ x_true).to(device)
    impl = "cuda"  # the hand-written kernels; "reference" is the plain oracle
    res = cg(op, b, M, tol=1e-6, maxiter=500, impl=impl)
    _sync(device)

    t0 = time.perf_counter()
    res = cg(op, b, M, tol=1e-6, maxiter=500, impl=impl)
    _sync(device)
    t_solve = time.perf_counter() - t0

    iters = int(res.iterations)
    t_iter = t_solve / max(iters, 1)
    x = res.x.cpu().numpy()
    err = float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    print(f"CG+block-Jacobi: {iters} iters, converged={bool(res.converged)}, "
          f"relative error {err:.2e}")
    print(f"solve: {t_solve * 1e3:.1f} ms total, {t_iter * 1e6:.0f} us/iter")

    # -- the fig. 12 story, extended to solves --------------------------
    print("preprocessing amortization (overhead / total vs iterations):")
    amortization = {}
    for k in (1, 10, 100, iters):
        frac = t_pre / (t_pre + k * t_iter)
        amortization[k] = frac
        print(f"  {k:>4} iterations: preprocessing is {frac * 100:5.1f}% "
              f"of end-to-end time")
    hist = res.history.cpu().numpy()
    hist = hist[hist >= 0]
    print("residual history:", " ".join(f"{h:.1e}" for h in hist[:8]),
          "..." if len(hist) > 8 else "")
    assert bool(res.converged)
    print("OK")
    return {"g": g, "n": n, "nnz": len(vals), "group_size": op.group_size,
            "num_blocks": cb.stats()["num_blocks"], "preprocess_s": t_pre,
            "iterations": iters, "converged": bool(res.converged), "relative_error": err,
            "solve_s": t_solve, "iter_s": t_iter, "amortization": amortization,
            "history": hist.tolist(), "x": x, "operator": op, "preconditioner": M, "b": b}


if __name__ == "__main__":
    main()
