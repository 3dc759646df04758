"""Iterative solver subsystem on the batched CB-SpMV engine.

``CBLinearOperator`` amortizes all CB preprocessing (blocking, format
selection, column aggregation, balance, super-block packing, transposed
streams, SpMM tiles) into one plan-time build on the host; the Krylov and
spectral solvers then apply it on the device, with the loop state kept
there and read back every ``_loop.SYNC_EVERY`` iterations.
"""
from .operator import CBLinearOperator  # noqa: F401
from .krylov import (  # noqa: F401
    Attempt,
    RobustSolveResult,
    SolveResult,
    SolverStatus,
    bicgstab,
    cg,
    gmres,
    robust_solve,
)
from .precond import (  # noqa: F401
    BlockJacobiPreconditioner,
    DiagScatter,
    IdentityPreconditioner,
    JacobiPreconditioner,
    block_jacobi,
    diag_scatter,
    jacobi,
)
from .eigen import (  # noqa: F401
    EigenResult,
    EvolvingPageRank,
    chebyshev_subspace,
    evolving_pagerank,
    pagerank,
    pagerank_operator,
    power_iteration,
)
