"""Shared error taxonomy — one reason-code vocabulary for every layer.

The hardened failure model (fault-injection axis, ``runtime/faults.py``)
requires that every fault is either *detected with a structured reason*
or *tolerated with a correct result*. "Structured" means machine-
matchable: a short stable reason code attached to the exception (or
status value), never just prose. This module is the single home of
those codes so the layers agree:

  * artifact integrity  — ``CBMatrix.save/load`` checksums, plan-cache
    corruption (``autotune/plan.py``), checkpoint manifests;
  * ingestion           — MatrixMarket parsing (``data/matrices.py``);
  * payload policy      — non-finite values at ``from_coo`` /
    ``update_values`` time, structure drift in the updaters;
  * solver statuses     — the in-loop breakdown/divergence/non-finite
    flags carried by the Krylov solvers (``SolverStatus`` is an
    ``IntEnum`` because the flag lives in device-side loop state);
  * serving degradation — queue backpressure, deadlines, tick retry
    exhaustion (``serving/engine.py``);
  * runtime supervision — heartbeat loss and restart-budget exhaustion
    (``runtime/fault_tolerance.py``);
  * device placement    — an entry point asked for a CUDA device that
    is not present (``core/streams.py``, ``kernels/ops.py``), or a
    kernel that failed to build or launch (``kernels/_build.py``).

Exceptions subclass the builtin the call site historically raised
(``ValueError``/``RuntimeError``) so pre-taxonomy callers and tests
keep working; new code should match on the class or ``.code``.

This module is imported by host-side plumbing everywhere, so it must
stay dependency-free (stdlib only: no torch, no numpy).
"""
from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Reason codes (stable strings — logged, asserted on, and persisted).
# ---------------------------------------------------------------------------

# artifact integrity
ARTIFACT_CORRUPT = "artifact-corrupt"          # checksum / byte-level damage
ARTIFACT_SCHEMA = "artifact-schema"            # unknown or wrong schema tag
PLAN_STALE = "plan-stale"                      # plan fails check_valid

# API misuse
INVALID_ARGUMENT = "invalid-argument"          # caller-supplied value rejected

# payloads + structure
NONFINITE_PAYLOAD = "nonfinite-payload"        # NaN/Inf in matrix values
STRUCTURE_DRIFT = "structure-drift"            # update pattern != structure
INGEST_INVALID = "ingest-invalid"              # malformed external input

# serving degradation
QUEUE_FULL = "queue-full"                      # backpressure rejection
DEADLINE_EXCEEDED = "deadline-exceeded"        # per-request deadline passed
TICK_FAILED = "tick-failed"                    # decode step retries exhausted
ACCEPTED = "accepted"                          # the non-error submit status

# runtime supervision
HEARTBEAT_LOST = "heartbeat-lost"              # host missed its timeout
RESTART_BUDGET_EXHAUSTED = "restart-budget-exhausted"
INJECTED = "injected-fault"                    # deterministic test fault

# device placement + kernels
DEVICE_UNAVAILABLE = "device-unavailable"      # CUDA requested, none present
KERNEL_FAILED = "kernel-failed"                # build or launch error


def reason(code: str, message: str) -> str:
    """Format a reason string carrying its code: ``"<code>: <message>"``.

    Used where the API contract is a *string*, not an exception — e.g.
    ``Plan.check_valid`` returns these and ``PlanCache.get`` counts them
    as stale misses. ``reason_code`` recovers the code half.
    """
    return f"{code}: {message}"


def reason_code(text: str | None) -> str | None:
    """Extract the leading code from a :func:`reason`-formatted string."""
    if not text:
        return None
    head = text.split(":", 1)[0].strip()
    return head if " " not in head else None


# ---------------------------------------------------------------------------
# Exception hierarchy.
# ---------------------------------------------------------------------------

class ReproError(Exception):
    """Base of the taxonomy; every instance carries a ``.code``."""

    code: str = "error"

    def __init__(self, message: str = "", *, code: str | None = None):
        if code is not None:
            self.code = code
        super().__init__(message)


class ArtifactError(ReproError, ValueError):
    """A persisted artifact (npz/JSON/checkpoint) failed integrity checks."""

    code = ARTIFACT_CORRUPT


class SchemaError(ArtifactError):
    """An artifact carries an unknown or incompatible schema tag."""

    code = ARTIFACT_SCHEMA


class InvalidArgError(ReproError, ValueError):
    """A caller-supplied argument failed validation (API misuse).

    The taxonomy home for the historical bare ``raise ValueError`` at
    library entry points — enforced by cblint rule CB401 — so even
    plain validation failures carry a stable ``.code``.
    """

    code = INVALID_ARGUMENT


class PlanStaleError(ReproError, ValueError):
    """A plan failed ``check_valid`` against the matrix it was applied to."""

    code = PLAN_STALE


class NonFiniteError(ReproError, ValueError):
    """NaN/Inf payload rejected by the non-finite policy."""

    code = NONFINITE_PAYLOAD


class StructureDriftError(ReproError, ValueError):
    """A value update's coordinate set differs from the built structure."""

    code = STRUCTURE_DRIFT


class IngestError(ReproError, ValueError):
    """External input (e.g. a MatrixMarket file) is malformed."""

    code = INGEST_INVALID


class BackpressureError(ReproError, RuntimeError):
    """The serving queue is full (typed rejection, not unbounded growth)."""

    code = QUEUE_FULL


class TickError(ReproError, RuntimeError):
    """A serving tick kept failing after bounded retry-with-backoff."""

    code = TICK_FAILED


class RestartBudgetError(ReproError, RuntimeError):
    """The supervisor's bounded restart budget is exhausted."""

    code = RESTART_BUDGET_EXHAUSTED


class InjectedFault(ReproError, RuntimeError):
    """A deterministic fault raised by ``runtime/faults.py`` injectors."""

    code = INJECTED


class DeviceUnavailableError(ReproError, RuntimeError):
    """A CUDA device was requested (the default) and none is present.

    The port never carries on quietly on the CPU: callers that want the
    CPU say ``device="cpu"``.
    """

    code = DEVICE_UNAVAILABLE


class KernelError(ReproError, RuntimeError):
    """A hand-written kernel failed to build or to launch."""

    code = KERNEL_FAILED


# ---------------------------------------------------------------------------
# Solver statuses (small int flags carried in solver loop state).
# ---------------------------------------------------------------------------

class SolverStatus(enum.IntEnum):
    """Terminal status of a Krylov solve (``SolveResult.status``).

    The value is carried through the solver loop as an int32, so the
    members are small ints; ``solver_reason`` maps them to
    the taxonomy's string codes for logs and bench rows.
    """

    OK = 0           # converged to tol
    MAXITER = 1      # ran out of iterations without a detected pathology
    BREAKDOWN = 2    # Krylov scalar collapsed (rho ~ 0, non-positive pAp)
    NONFINITE = 3    # NaN/Inf in the iterate or residual
    STAGNATION = 4   # no new best residual for `stall_limit` iterations
    DIVERGED = 5     # residual blew past divtol * ||b||


_SOLVER_REASONS = {
    SolverStatus.OK: "solver-ok",
    SolverStatus.MAXITER: "solver-maxiter",
    SolverStatus.BREAKDOWN: "solver-breakdown",
    SolverStatus.NONFINITE: "solver-nonfinite",
    SolverStatus.STAGNATION: "solver-stagnation",
    SolverStatus.DIVERGED: "solver-diverged",
}


def solver_reason(status: int) -> str:
    """Stable reason code for a ``SolverStatus`` value (host side)."""
    try:
        return _SOLVER_REASONS[SolverStatus(int(status))]
    except ValueError:
        return f"solver-unknown-{int(status)}"
