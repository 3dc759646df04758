"""Spectral workloads on the CB engine — power iteration, Chebyshev
subspace iteration, and PageRank on the power-law corpus.

Same loop contract as ``krylov.py``: the state lives on the operator's
device, the while loops run through ``_loop.while_loop`` (the host reads
the stop predicate every ``SYNC_EVERY`` iterations), and the loops of a
fixed count (Chebyshev degrees and rounds) are plain Python loops.

The Chebyshev filter is the multi-vector showcase: it drives the block
``matmat`` path (CB-SpMM tile stream), applying a degree-``d`` polynomial
that damps the spectrum inside ``[lb, ub]`` so the subspace rotates
toward the eigenvalues *above* ``ub`` — the standard filtered subspace
iteration for large sparse spectra.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import errors
from repro_torch.core.cb_matrix import CBMatrix

from ._loop import while_loop
from .operator import CBLinearOperator


@dataclasses.dataclass
class EigenResult:
    eigenvalue: torch.Tensor   # () f32 Rayleigh quotient
    eigenvector: torch.Tensor  # (n,) unit norm
    iterations: torch.Tensor   # () int32
    converged: torch.Tensor    # () bool


def _scalar(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def power_iteration(
    A: CBLinearOperator,
    v0,
    *,
    tol: float = 1e-8,
    maxiter: int = 500,
    impl: str = "cuda",
) -> EigenResult:
    """Dominant eigenpair of square ``A`` by normalized power iteration."""
    v = torch.as_tensor(v0, device=A.device).to(torch.float32)
    v = v / torch.linalg.vector_norm(v)

    def cond(state):
        k, _v, _lam, delta = state
        return (k < maxiter) & (delta > tol)

    def body(state):
        k, v, _lam, _delta = state
        w = A.matvec(v, impl=impl)
        lam = torch.dot(v, w)
        wn = torch.linalg.vector_norm(w)
        v_new = w / torch.where(wn > 0, wn, 1.0)
        # sign-align before measuring the step so ±v oscillation (negative
        # dominant eigenvalue) still registers as converged
        v_new = torch.where(torch.dot(v_new, v) < 0, -v_new, v_new)
        delta = torch.linalg.vector_norm(v_new - v)
        return (k + 1, v_new, lam, delta)

    k0 = torch.zeros((), dtype=torch.int32, device=v.device)
    k, v, lam, delta = while_loop(
        "power_iteration", cond, body,
        (k0, v, _scalar(0.0, v.device), _scalar(math.inf, v.device)), maxiter)
    return EigenResult(eigenvalue=lam, eigenvector=v, iterations=k, converged=delta <= tol)


def chebyshev_subspace(
    A: CBLinearOperator,
    V0,
    *,
    lb: float,
    ub: float,
    degree: int = 8,
    iters: int = 5,
    impl: str = "cuda",
    group_size: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chebyshev-filtered subspace iteration for the top of the spectrum.

    ``V0``: (n, k) initial block. ``[lb, ub]`` is the *unwanted* spectral
    interval to damp (typically [lambda_min, a cut below the wanted
    eigenvalues]). Returns ``(ritz_values (k,), ritz_vectors (n, k))``
    with values ascending — the largest eigenpairs of SPD ``A`` land at
    the end. Every matrix application is a multi-RHS ``matmat`` through
    the batched CB-SpMM super-tile stream; ``group_size`` is asserted
    against the operator's plan-time packing, as in ``cb_spmv``.
    """
    mm = lambda X: A.matmat(X, impl=impl, group_size=group_size)  # noqa: E731
    e = (ub - lb) / 2.0
    c = (ub + lb) / 2.0

    def filt(X):
        # T_d(( A - cI ) / e) X via the three-term recurrence.
        T0, T1 = X, (mm(X) - c * X) / e
        for _ in range(degree - 1):
            T0, T1 = T1, (2.0 / e) * (mm(T1) - c * T1) - T0
        return T1

    Q, _ = torch.linalg.qr(torch.as_tensor(V0, device=A.device).to(torch.float32))
    for _ in range(iters):
        Q, _ = torch.linalg.qr(filt(Q))
    # Rayleigh-Ritz on the filtered subspace.
    S = Q.T @ mm(Q)
    vals, U = torch.linalg.eigh((S + S.T) / 2.0)
    return vals, Q @ U


# ---------------------------------------------------------------------------
# PageRank — the power-law-corpus spectral demo.
# ---------------------------------------------------------------------------

def _transitions(src, dst, n: int):
    """(unique sources, unique destinations, edge -> unique edge, out-degree)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    uk, edge_map = np.unique(src * n + dst, return_inverse=True)
    src_u, dst_u = uk // n, uk % n
    outdeg = np.bincount(src_u, minlength=n).astype(np.float64)
    return src_u, dst_u, edge_map.reshape(-1), outdeg


def _dangling(outdeg: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy((outdeg == 0).astype(np.float32)).to(device)


def pagerank_operator(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    *,
    block_size: int = 16,
    group_size: int | None = None,
    device=None,
) -> tuple[CBLinearOperator, torch.Tensor]:
    """Preprocess a directed edge list into the PageRank operator.

    Builds ``P^T`` (column-stochastic transition matrix, transposed so
    ``matvec`` pushes rank mass forward) through the full CB pipeline.
    Duplicate edges are collapsed. Returns the operator plus the dangling
    mask (out-degree-zero nodes, whose mass is spread uniformly), both on
    ``device`` (``None``: CUDA).
    """
    src_u, dst_u, _, outdeg = _transitions(src, dst, n)
    vals = 1.0 / outdeg[src_u]
    cb = CBMatrix.from_coo(dst_u, src_u, vals.astype(np.float32), (n, n),
                           block_size=block_size, val_dtype=np.float32)
    op = CBLinearOperator.from_cb(cb, group_size=group_size, device=device)
    return op, _dangling(outdeg, op.device)


# ---------------------------------------------------------------------------
# Time-evolving PageRank: fixed link structure, churning edge weights.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class EvolvingPageRank:
    """PageRank over a fixed edge set whose *weights* change per step.

    The dynamic-sparsity showcase: a web/interaction graph where links
    persist but their strengths drift (click counts, decayed activity).
    The transition structure — blocking, colagg, formats, Alg. 2 balance,
    stream packing — is preprocessed ONCE (``build``); each step only
    renormalizes the new weights into transition probabilities on the
    host and scatters them into the operator's streams on the device
    (``with_values``), so the per-step cost is a value scatter plus the
    damped power iteration, never a CB rebuild. Weights must stay
    positive: a zero weight is structure drift (a vanished edge) and
    needs a fresh ``build``.
    """

    op: CBLinearOperator      # updatable P^T operator (built once)
    dangling: torch.Tensor    # structural: nodes with no outgoing edges
    n: int
    edge_src: np.ndarray      # unique edge sources
    edge_dst: np.ndarray      # unique edge destinations
    edge_map: np.ndarray      # original edge index -> unique edge index
    canon_order: np.ndarray   # unique-edge order -> canonical value order

    @classmethod
    def build(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        n: int,
        *,
        block_size: int = 16,
        group_size: int | None = None,
        device=None,
    ) -> "EvolvingPageRank":
        """Preprocess the edge structure once (unit initial weights)."""
        src_u, dst_u, edge_map, outdeg = _transitions(src, dst, n)
        vals = (1.0 / outdeg[src_u]).astype(np.float32)
        cb = CBMatrix.from_coo(dst_u, src_u, vals, (n, n),
                               block_size=block_size, val_dtype=np.float32)
        op = CBLinearOperator.from_cb(cb, group_size=group_size, updatable=True,
                                      device=device)
        # canonical (to_coo) order of the (row=dst, col=src) matrix
        canon_order = np.lexsort((src_u, dst_u))
        return cls(
            op=op, dangling=_dangling(outdeg, op.device), n=n,
            edge_src=src_u, edge_dst=dst_u, edge_map=edge_map,
            canon_order=canon_order,
        )

    def canonical_values(self, weights: np.ndarray) -> np.ndarray:
        """Per-original-edge weights -> canonical transition values."""
        w = np.asarray(weights, np.float64)
        if w.shape != self.edge_map.shape:
            raise errors.InvalidArgError(
                f"expected one weight per original edge "
                f"({self.edge_map.shape[0]}), got shape {w.shape}"
            )
        if not np.all(w > 0):
            raise errors.InvalidArgError(
                "edge weights must stay positive — a zero weight removes "
                "the edge (structure drift); rebuild instead"
            )
        w_u = np.zeros(len(self.edge_src), np.float64)
        np.add.at(w_u, self.edge_map, w)
        outsum = np.zeros(self.n, np.float64)
        np.add.at(outsum, self.edge_src, w_u)
        vals = (w_u / outsum[self.edge_src]).astype(np.float32)
        return vals[self.canon_order]

    def step(self, weights: np.ndarray, **pagerank_kwargs) -> EigenResult:
        """Rank under fresh weights: value scatter + power iteration."""
        op = self.op.with_values(self.canonical_values(weights))
        return pagerank(op, self.dangling, **pagerank_kwargs)


def evolving_pagerank(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    weight_steps,
    *,
    block_size: int = 16,
    group_size: int | None = None,
    device=None,
    **pagerank_kwargs,
) -> list[EigenResult]:
    """Run PageRank over a sequence of weight snapshots (one build)."""
    ev = EvolvingPageRank.build(src, dst, n, block_size=block_size,
                                group_size=group_size, device=device)
    return [ev.step(w, **pagerank_kwargs) for w in weight_steps]


def pagerank(
    A: CBLinearOperator,
    dangling,
    *,
    damping: float = 0.85,
    tol: float = 1e-7,  # L1 step; f32 iteration floors out near 1e-8
    maxiter: int = 200,
    impl: str = "cuda",
) -> EigenResult:
    """Damped power iteration on the Google matrix (L1-normalized)."""
    n = A.shape[1]
    dangling = torch.as_tensor(dangling, device=A.device).to(torch.float32)
    p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=A.device)

    def cond(state):
        k, _p, delta = state
        return (k < maxiter) & (delta > tol)

    def body(state):
        k, p, _delta = state
        # fused accumulate-SpMV: the dangling-mass term seeds the
        # accumulator and A @ p lands on top of it (ops.cb_spmv_into)
        seed = (torch.dot(dangling, p) / n).expand(n).contiguous()
        pushed = A.matvec_into(seed, p, impl=impl)
        p_new = damping * pushed + (1.0 - damping) / n
        p_new = p_new / torch.sum(p_new)  # renormalize f32 drift
        delta = torch.sum(torch.abs(p_new - p))
        return (k + 1, p_new, delta)

    k0 = torch.zeros((), dtype=torch.int32, device=p.device)
    k, p, delta = while_loop("pagerank", cond, body,
                             (k0, p, _scalar(math.inf, p.device)), maxiter)
    return EigenResult(
        eigenvalue=_scalar(1.0, p.device), eigenvector=p,
        iterations=k, converged=delta <= tol,
    )
