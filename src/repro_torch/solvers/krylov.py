"""Krylov solvers over CBLinearOperator — loop state kept on the device.

Each solver is the JAX package's while loop (``repro.solvers.krylov``)
run by ``_loop.while_loop``: the state lives on the operator's device,
every update is masked by the device predicate ``active``, and the host
reads ``active`` once every ``_loop.SYNC_EVERY`` iterations (counted in
``_loop.HOST_SYNCS``). The residual history is a fixed ``(maxiter + 1,)``
buffer (-1.0 marks unreached iterations) on the device. Loops with a
fixed count (GMRES's Arnoldi steps) are plain Python loops with no read.

All solvers stop on ``||r||_2 <= tol * ||b||_2`` (relative residual, the
criterion the scipy references in the tests use, so iteration counts are
comparable) or on ``maxiter``.

Breakdown awareness (``repro_torch.errors``): the state also holds an
int32 ``flag`` plus best-iterate tracking. Every iteration checks, on the
device —

  * **breakdown**:   a Krylov scalar denominator collapsed (|rho| at the
    dtype's tiny scale; for CG also non-positive curvature p^T A p <= 0,
    i.e. the operator is not SPD);
  * **non-finite**:  NaN/Inf reached the residual (poisoned iterate,
    corrupted payload);
  * **divergence**:  ||r|| > divtol * ||b||;
  * **stagnation**:  no new best residual for ``stall_limit``
    consecutive iterations (cycles, for GMRES).

Any flag stops the loop; ``SolveResult.status`` reports the terminal
``errors.SolverStatus``, and ``SolveResult.x`` is always the *best*
iterate seen (the final iterate on convergence). ``robust_solve`` chains
CG -> BiCGStab -> GMRES(m) on top, restarting each attempt from the best
iterate so far.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import errors, obs
from repro_torch.errors import SolverStatus

from ._loop import while_loop
from .operator import CBLinearOperator

# GMRES reads its stop flag after every restart cycle: a cycle is ``restart``
# products, and its least-squares solve (``torch.linalg.svd``) waits for the
# device anyway, so a read costs nothing there while a masked cycle would.
GMRES_SYNC_EVERY = 1

_OK = int(SolverStatus.OK)
_MAXITER = int(SolverStatus.MAXITER)
_BREAKDOWN = int(SolverStatus.BREAKDOWN)
_NONFINITE = int(SolverStatus.NONFINITE)
_STAGNATION = int(SolverStatus.STAGNATION)
_DIVERGED = int(SolverStatus.DIVERGED)


@dataclasses.dataclass
class SolveResult:
    """Solution + convergence record (device tensors; shapes fixed by maxiter)."""

    x: torch.Tensor           # (n,) best iterate (== final iterate on success)
    iterations: torch.Tensor  # () int32 — iterations actually run
    residual: torch.Tensor    # () f32 — final ||r||_2
    converged: torch.Tensor   # () bool — hit tol before maxiter
    history: torch.Tensor     # (maxiter + 1,) f32 — ||r_k||, -1.0 = unreached
    status: torch.Tensor      # () int32 — errors.SolverStatus terminal code

    @property
    def reason(self) -> str:
        """Host-side reason code for ``status`` (``repro_torch.errors``)."""
        return errors.solver_reason(int(self.status))


def _on(A: CBLinearOperator, v) -> torch.Tensor:
    """``v`` (numpy or a tensor) on the operator's device."""
    return torch.as_tensor(v, device=A.device)


def _apply_M(M, r: torch.Tensor) -> torch.Tensor:
    return r if M is None else M.apply(r)


def _guard_tiny(dtype) -> float:
    """Smallest safe denominator magnitude for ``dtype``.

    Dtype-aware on purpose: ``float16``'s smallest normal is ~6e-5 — a
    float32-scale constant (1e-30) would wave through denominators whose
    reciprocal overflows half precision to Inf. ``bfloat16`` shares
    float32's exponent range, so its guard lands at the same scale.
    """
    if not dtype.is_floating_point:
        dtype = torch.float32
    return torch.finfo(dtype).tiny


def _safe_div(num, den):
    """num / den with a collapsed denominator mapped to 0.

    The post-convergence guard (once r == 0 every Krylov scalar
    degenerates to 0/0, and the masked iterations after the stop still
    compute) *and* the breakdown guard: a denominator at or below the
    dtype's tiny scale produces 0, leaving the iterate untouched while
    the flag logic reports BREAKDOWN."""
    den = torch.as_tensor(den)
    ok = den.abs() > _guard_tiny(den.dtype)
    return torch.where(ok, num, 0.0) / torch.where(ok, den, 1.0)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """||v||_2, accumulated in float32 for sub-f32 inputs.

    bf16/f16 squares lose almost all mantissa (and a long bf16 sum
    saturates once the partial sum outgrows the 8-bit mantissa's ulp),
    so low-precision iterates are upcast before the square-sum."""
    if v.dtype.is_floating_point and torch.finfo(v.dtype).bits < 32:
        v = v.to(torch.float32)
    return torch.sqrt(torch.sum(v * v))


def _classify(flag, *, nonfinite, breakdown, diverged, stagnated):
    """Priority-merge the in-loop failure predicates into the flag.

    An already-set flag wins (the loop stops on the iteration that set
    it)."""
    new = torch.where(stagnated, _STAGNATION, torch.zeros_like(flag))
    new = torch.where(diverged, _DIVERGED, new)
    new = torch.where(breakdown, _BREAKDOWN, new)
    new = torch.where(nonfinite, _NONFINITE, new)
    return torch.where(flag != _OK, flag, new)


def _result(x, k, rnorm, stop, hist, flag) -> SolveResult:
    converged = rnorm <= stop
    status = torch.where(
        ~torch.isfinite(rnorm), _NONFINITE,
        torch.where(converged, _OK, torch.where(flag != _OK, flag, _MAXITER)))
    return SolveResult(x=x, iterations=k, residual=rnorm, converged=converged,
                       history=hist, status=status)


def _track_best(x, rnorm, best_x, best, stall):
    """Best-iterate / stagnation bookkeeping shared by the loop bodies."""
    improved = rnorm < best
    best_x = torch.where(improved, x, best_x)
    best = torch.minimum(best, rnorm)
    stall = torch.where(improved, 0, stall + 1)
    return best_x, best, stall


def _history(rnorm0, maxiter: int) -> torch.Tensor:
    hist = torch.full((maxiter + 1,), -1.0, dtype=torch.float32, device=rnorm0.device)
    hist[0] = rnorm0
    return hist


def _record(hist, k, rnorm):
    """``hist`` with entry ``k + 1`` set to ``rnorm`` (a new tensor)."""
    return hist.index_put(((k + 1).long().view(1),), rnorm.view(1))


def _start(A, b, x0, mv):
    """(b, x, r) in float32 on the operator's device."""
    b = _on(A, b).to(torch.float32)
    x = torch.zeros_like(b) if x0 is None else _on(A, x0).to(torch.float32)
    r = b if x0 is None else b - mv(x)
    return b, x, r


def _zero_i32(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------

def cg(
    A: CBLinearOperator,
    b,
    M=None,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 200,
    impl: str = "cuda",
    divtol: float = 1e8,
    stall_limit: int = 50,
) -> SolveResult:
    """Preconditioned conjugate gradients for SPD ``A``.

    Breakdown flag: non-positive curvature ``p^T A p <= tiny`` (the
    operator is singular or not SPD) or a collapsed ``rho``. See the
    module docstring for the other failure flags."""
    mv = lambda v: A.matvec(v, impl=impl)  # noqa: E731
    b, x, r = _start(A, b, x0, mv)
    tiny = _guard_tiny(b.dtype)
    z = _apply_M(M, r)
    p = z
    rz = torch.dot(r, z)
    rnorm = _norm(r)
    bnorm = _norm(b)
    stop = tol * bnorm
    blowup = divtol * torch.clamp_min(bnorm, tiny)

    def cond(state):
        k, _x, _r, _p, _rz, rnorm, _h, flag, *_ = state
        return (k < maxiter) & (rnorm > stop) & (flag == _OK)

    def body(state):
        k, x, r, p, rz, _rnorm, hist, flag, best_x, best, stall = state
        q = mv(p)
        den = torch.dot(p, q)
        alpha = _safe_div(rz, den)
        x = x + alpha * p
        r = r - alpha * q
        z = _apply_M(M, r)
        rz_new = torch.dot(r, z)
        p = z + _safe_div(rz_new, rz) * p
        rnorm = _norm(r)
        hist = _record(hist, k, rnorm)
        best_x, best, stall = _track_best(x, rnorm, best_x, best, stall)
        flag = _classify(
            flag,
            nonfinite=~torch.isfinite(rnorm),
            breakdown=(den <= tiny) | (rz.abs() <= tiny),
            diverged=rnorm > blowup,
            stagnated=stall >= stall_limit,
        )
        return (k + 1, x, r, p, rz_new, rnorm, hist, flag, best_x, best, stall)

    k0 = _zero_i32(b.device)
    state = (k0, x, r, p, rz, rnorm, _history(rnorm, maxiter), k0 + _OK,
             x, rnorm, k0)
    state = while_loop("cg", cond, body, state, maxiter)
    k, _x, _r, _p, _rz, rnorm, hist, flag, best_x, _best, _stall = state
    return _result(best_x, k, rnorm, stop, hist, flag)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------

def bicgstab(
    A: CBLinearOperator,
    b,
    M=None,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 200,
    impl: str = "cuda",
    divtol: float = 1e8,
    stall_limit: int = 50,
) -> SolveResult:
    """Preconditioned BiCGStab for general (nonsymmetric) ``A``.

    Breakdown flag: the classic BiCGStab scalars collapsing — ``rho =
    <r0hat, r>`` or ``<r0hat, v>`` at the dtype's tiny scale."""
    mv = lambda v: A.matvec(v, impl=impl)  # noqa: E731
    b, x, r = _start(A, b, x0, mv)
    tiny = _guard_tiny(b.dtype)
    r0hat = r
    one = torch.ones((), dtype=torch.float32, device=b.device)
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    rnorm = _norm(r)
    bnorm = _norm(b)
    stop = tol * bnorm
    blowup = divtol * torch.clamp_min(bnorm, tiny)

    def cond(state):
        k, rnorm, flag = state[0], state[8], state[10]
        return (k < maxiter) & (rnorm > stop) & (flag == _OK)

    def body(state):
        (k, x, r, rho, alpha, omega, v, p, _rnorm, hist, flag,
         best_x, best, stall) = state
        rho_new = torch.dot(r0hat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        phat = _apply_M(M, p)
        v = mv(phat)
        r0v = torch.dot(r0hat, v)
        alpha = _safe_div(rho_new, r0v)
        s = r - alpha * v
        shat = _apply_M(M, s)
        t = mv(shat)
        omega = _safe_div(torch.dot(t, s), torch.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rnorm = _norm(r)
        hist = _record(hist, k, rnorm)
        best_x, best, stall = _track_best(x, rnorm, best_x, best, stall)
        flag = _classify(
            flag,
            nonfinite=~torch.isfinite(rnorm),
            breakdown=(rho_new.abs() <= tiny) | (r0v.abs() <= tiny),
            diverged=rnorm > blowup,
            stagnated=stall >= stall_limit,
        )
        return (k + 1, x, r, rho_new, alpha, omega, v, p, rnorm, hist,
                flag, best_x, best, stall)

    k0 = _zero_i32(b.device)
    state = (k0, x, r, one, one, one, v, p, rnorm, _history(rnorm, maxiter),
             k0 + _OK, x, rnorm, k0)
    state = while_loop("bicgstab", cond, body, state, maxiter)
    k = state[0]
    rnorm, hist, flag, best_x = state[8], state[9], state[10], state[11]
    return _result(best_x, k, rnorm, stop, hist, flag)


# ---------------------------------------------------------------------------
# GMRES(m)
# ---------------------------------------------------------------------------

def _lstsq(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares ``argmin ||H y - rhs||`` by SVD, on H's device.

    ``jnp.linalg.lstsq``'s algorithm and default cut-off: singular values
    below ``eps * max(M, N)`` times the largest count as zero, so the zero
    columns a lucky breakdown leaves in H get a zero coefficient
    (``torch.linalg.lstsq`` on CUDA has only the full-rank ``gels``
    routine). A non-finite H or rhs is solved as zeros and then poisons
    the result with NaN, as an SVD of NaNs would, so a non-finite
    Arnoldi step still ends the solve as NONFINITE.
    """
    finite = torch.isfinite(H).all() & torch.isfinite(rhs).all()
    U, s, Vh = torch.linalg.svd(torch.where(torch.isfinite(H), H, 0.0), full_matrices=False)
    rcond = torch.finfo(H.dtype).eps * max(H.shape)
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    y = Vh.T @ (s_inv * (U.T @ torch.where(torch.isfinite(rhs), rhs, 0.0)))
    return torch.where(finite, y, math.nan)


def gmres(
    A: CBLinearOperator,
    b,
    M=None,
    x0=None,
    *,
    tol: float = 1e-6,
    restart: int = 20,
    maxiter: int = 20,
    impl: str = "cuda",
    divtol: float = 1e8,
    stall_limit: int = 5,
) -> SolveResult:
    """Restarted GMRES(m) with left preconditioning.

    ``maxiter`` counts *restart cycles* (outer iterations); each cycle
    performs ``restart`` Arnoldi steps in fixed-shape buffers — ``V`` is
    ``(restart + 1, n)``, ``H`` is ``(restart + 1, restart)`` —
    orthogonalized by two-pass classical Gram-Schmidt (unset basis rows
    are zero, so the projection needs no masking). The residual history
    records the TRUE residual at each restart boundary.

    In-cycle Arnoldi breakdown (``h_{j+1,j} ~ 0``) is the *lucky* kind —
    the Krylov space closed — and is handled by zeroing the next basis
    vector, not flagged. The failure flags operate at restart
    granularity: non-finite / diverged true residual, or ``stall_limit``
    cycles without a new best (the classic GMRES(m) stall, e.g. a pure
    rotation at small ``m``)."""
    mv = lambda v: A.matvec(v, impl=impl)  # noqa: E731
    b, x, r = _start(A, b, x0, mv)
    n = b.shape[0]
    rnorm = _norm(r)
    bnorm = _norm(b)
    stop = tol * bnorm
    tiny = math.sqrt(_guard_tiny(b.dtype))
    blowup = divtol * torch.clamp_min(bnorm, tiny)

    def cycle(x, r):
        z = _apply_M(M, r)
        beta = _norm(z)
        V = torch.zeros((restart + 1, n), dtype=torch.float32, device=b.device)
        V[0] = z / torch.clamp_min(beta, tiny)
        H = torch.zeros((restart + 1, restart), dtype=torch.float32, device=b.device)
        for j in range(restart):
            w = _apply_M(M, mv(V[j]))
            # CGS2: rows > j of V are still zero, so V @ w projects onto
            # the built basis only — no index masking needed.
            h1 = V @ w
            w = w - V.T @ h1
            h2 = V @ w
            w = w - V.T @ h2
            hn = _norm(w)
            V[j + 1] = torch.where(hn > tiny, 1.0, 0.0) * w / torch.clamp_min(hn, tiny)
            H[:, j] = h1 + h2
            H[j + 1, j] = hn
        e1 = torch.zeros(restart + 1, dtype=torch.float32, device=b.device)
        e1[0] = beta
        return x + V[:restart].T @ _lstsq(H, e1)

    def cond(state):
        k, _x, _r, rnorm, _h, flag, *_ = state
        return (k < maxiter) & (rnorm > stop) & (flag == _OK)

    def body(state):
        k, x, r, _rnorm, hist, flag, best_x, best, stall = state
        x = cycle(x, r)
        # the TRUE residual, computed once and carried: it both feeds the
        # history/stopping test and seeds the next cycle's Krylov space
        r = b - mv(x)
        rnorm = _norm(r)
        hist = _record(hist, k, rnorm)
        best_x, best, stall = _track_best(x, rnorm, best_x, best, stall)
        flag = _classify(
            flag,
            nonfinite=~torch.isfinite(rnorm),
            breakdown=torch.zeros((), dtype=torch.bool, device=b.device),
            diverged=rnorm > blowup,
            stagnated=stall >= stall_limit,
        )
        return (k + 1, x, r, rnorm, hist, flag, best_x, best, stall)

    k0 = _zero_i32(b.device)
    state = (k0, x, r, rnorm, _history(rnorm, maxiter), k0 + _OK, x, rnorm, k0)
    state = while_loop("gmres", cond, body, state, maxiter, GMRES_SYNC_EVERY)
    k, _x, _r, rnorm, hist, flag, best_x, _best, _stall = state
    return _result(best_x, k, rnorm, stop, hist, flag)


# ---------------------------------------------------------------------------
# robust_solve — the breakdown-aware fallback chain.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Attempt:
    """Host-side record of one solver attempt inside ``robust_solve``."""

    solver: str
    preconditioned: bool
    status: int                  # errors.SolverStatus value
    reason: str                  # errors.solver_reason(status)
    converged: bool
    iterations: int
    residual: float


@dataclasses.dataclass(frozen=True)
class RobustSolveResult:
    """Outcome of the fallback chain: the winning (or best) attempt."""

    x: torch.Tensor
    converged: bool
    status: int                  # errors.SolverStatus of the final verdict
    reason: str
    solver: str                  # solver that produced ``x``
    residual: float
    attempts: tuple[Attempt, ...]
    result: SolveResult          # full record of the decisive attempt
    sanitized_x0: bool = False   # a non-finite warm start was dropped


_CHAIN_SOLVERS = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}


def robust_solve(
    A: CBLinearOperator,
    b,
    M=None,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 200,
    restart: int = 20,
    methods: tuple[str, ...] = ("cg", "bicgstab", "gmres"),
    fallback_preconditioner=None,
    max_attempts: int | None = None,
    impl: str = "cuda",
    divtol: float = 1e8,
    stall_limit: int = 50,
) -> RobustSolveResult:
    """Breakdown-aware supervisor: CG -> BiCGStab -> GMRES(m) with bounded retry.

    A host-level supervisor over the solvers; only the attempt
    accounting runs on the host, and each attempt is an ``obs`` span
    (``solve:<name>`` inside ``robust_solve``) and a bump of the
    ``repro.solvers.robust.*`` counters. Policy per attempt:

      * every attempt warm-starts from the **best iterate seen so far**
        (restart-from-best), falling back to ``x0`` / zero;
      * a converged attempt short-circuits the chain;
      * after the base ladder, ``fallback_preconditioner`` (if given)
        re-runs the ladder once with the escalated preconditioner;
      * ``max_attempts`` bounds the total number of solver invocations
        (default: the full ladder, once per preconditioner level).

    Detection contract (``repro_torch.errors``): a non-finite right-hand
    side is unsolvable and raises ``NonFiniteError`` immediately; a
    non-finite ``x0`` is *tolerated* by sanitizing to a cold start
    (recorded in ``sanitized_x0``). A chain that exhausts its attempts
    returns ``converged=False`` with the best attempt's iterate and the
    final attempt's typed status — never an untyped failure.
    """
    b = _on(A, b)
    if not bool(torch.isfinite(b).all()):
        raise errors.NonFiniteError(
            "robust_solve: right-hand side contains non-finite entries"
        )
    sanitized = False
    if x0 is not None and not bool(torch.isfinite(_on(A, x0)).all()):
        x0, sanitized = None, True   # poisoned warm start -> cold start

    unknown = [m for m in methods if m not in _CHAIN_SOLVERS]
    if unknown:
        raise errors.InvalidArgError(
            f"unknown methods {unknown}; choose from "
            f"{sorted(_CHAIN_SOLVERS)}"
        )

    ladder = [(name, M, False) for name in methods]
    if fallback_preconditioner is not None:
        ladder += [(name, fallback_preconditioner, True) for name in methods]
    if max_attempts is not None:
        ladder = ladder[:max_attempts]
    if not ladder:
        raise errors.InvalidArgError("robust_solve: empty fallback ladder")

    gmres_cycles = max(1, math.ceil(maxiter / restart))
    common = dict(tol=tol, impl=impl, divtol=divtol)

    # Attempt-ladder telemetry (repro.solvers.robust.*): each attempt is
    # one span + one labeled counter bump, so a fleet can alarm on
    # fallback rates without scraping Attempt tuples.
    reg = obs.registry()
    reg.counter("repro.solvers.robust.calls").inc()
    if sanitized:
        reg.counter("repro.solvers.robust.sanitized_x0").inc()

    attempts: list[Attempt] = []
    best_x, best_rnorm = x0, float("inf")
    best_attempt: tuple[str, SolveResult] | None = None
    res = None
    name = methods[0]
    with obs.span("robust_solve", n=int(b.shape[0]),
                  methods=",".join(methods)) as root:
        for name, Mi, escalated in ladder:
            solver = _CHAIN_SOLVERS[name]
            with obs.span(f"solve:{name}", solver=name,
                          preconditioned=Mi is not None,
                          escalated=escalated) as sp:
                if name == "gmres":
                    res = solver(A, b, Mi, x0=best_x, maxiter=gmres_cycles,
                                 restart=restart, **common)
                else:
                    res = solver(A, b, Mi, x0=best_x, maxiter=maxiter,
                                 stall_limit=stall_limit, **common)
                status = int(res.status)
                rnorm = float(res.residual)
                sp.set(status=errors.solver_reason(status),
                       iterations=int(res.iterations))
            attempts.append(Attempt(
                solver=name, preconditioned=Mi is not None, status=status,
                reason=errors.solver_reason(status),
                converged=bool(res.converged),
                iterations=int(res.iterations), residual=rnorm,
            ))
            reg.counter("repro.solvers.robust.attempts").inc(
                solver=name, reason=errors.solver_reason(status))
            reg.counter("repro.solvers.robust.iterations").inc(
                int(res.iterations), solver=name)
            if math.isfinite(rnorm) and rnorm < best_rnorm:
                best_rnorm, best_x = rnorm, res.x
                best_attempt = (name, res)
            if status == SolverStatus.OK:
                root.set(outcome="converged", solver=name,
                         attempts=len(attempts))
                reg.counter("repro.solvers.robust.outcome").inc(
                    outcome="converged", solver=name)
                return RobustSolveResult(
                    x=res.x, converged=True, status=SolverStatus.OK,
                    reason=errors.solver_reason(SolverStatus.OK), solver=name,
                    residual=rnorm, attempts=tuple(attempts), result=res,
                    sanitized_x0=sanitized,
                )

        # chain exhausted: surface the best iterate with a typed verdict
        final_name, final_res = best_attempt if best_attempt else (name, res)
        status = int(attempts[-1].status)
        root.set(outcome="exhausted", solver=final_name,
                 attempts=len(attempts))
        reg.counter("repro.solvers.robust.outcome").inc(
            outcome="exhausted", solver=final_name)
        return RobustSolveResult(
            x=final_res.x, converged=False, status=status,
            reason=errors.solver_reason(status), solver=final_name,
            residual=float(final_res.residual), attempts=tuple(attempts),
            result=final_res, sanitized_x0=sanitized,
        )
