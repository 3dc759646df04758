"""Empirical refinement: build (and optionally time) the top-k candidates.

``plan_search`` is the subsystem's front door (``CBMatrix.plan_for``
delegates here):

  1. hash the matrix; a ``PlanCache`` hit returns the stored plan with
     zero work (the cross-process amortization path);
  2. extract features, rank the candidate grid with the analytical cost
     model (``cost.rank``) — no kernels run;
  3. **refine**: the top-k candidates plus the default-constants
     configuration are actually *built* (``CBMatrix.from_coo`` +
     ``build_super_streams``), giving exact padded-work and step counts
     instead of estimates. Candidates sharing a structural config
     (block size / thresholds / colagg) share one CBMatrix build — only
     the stream packing differs per group size;
  4. select: in **timed** mode the shortlist is moved to the CUDA device
     and timed through ``ops.cb_spmv(impl="cuda")`` (``timing.time_min``:
     CUDA events around each call), and the fastest wins. In
     **heuristic** mode selection minimizes
     ``padded + STEP_OVERHEAD_ELEMS * steps`` over the *measured*
     builds, restricted to candidates whose padded work does not exceed
     the default configuration's (so a tuned plan never regresses padded
     work; ``allow_padded_regression=True`` lifts the restriction).
     Heuristic mode touches no device and consumes no wall clock, so the
     same matrix always yields the same plan bit-for-bit — the JAX
     package's plan, field for field.

The port of ``repro.autotune.search``. Where the JAX package's
``resolve_mode`` asks JAX whether it runs on a TPU, the port asks the
caller: ``device=None`` means the CUDA device (``"auto"`` then times on
it), ``device="cpu"`` means the CPU (``"auto"`` then stays heuristic, and
``"timed"`` is refused — the plain versions' wall time says nothing about
the card a plan will serve).

The returned ``Plan`` records the winning configuration with its
*resolved* colagg decision plus the model's prediction and the measured
values, and is stored in the cache when one was given.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import errors
from repro_torch.core.cb_matrix import CBMatrix
from repro_torch.core.streams import build_super_streams, resolve_device
from repro_torch.kernels import ops

from . import timing
from .cost import (
    DEFAULT_CONFIG, STEP_OVERHEAD_ELEMS, CandidateConfig, default_candidates,
    estimate, rank,
)
from .features import extract_features
from .plan import Plan, PlanCache, legacy_content_hash, matrix_hashes


@dataclasses.dataclass(frozen=True)
class SearchSettings:
    """Knobs of the refinement pass (not of the candidate space)."""

    top_k: int = 3
    mode: str = "auto"              # "heuristic" | "timed" | "auto"
    timing_reps: int = 5
    allow_padded_regression: bool = False
    candidates: tuple[CandidateConfig, ...] | None = None


DEFAULT_SETTINGS = SearchSettings()


def resolve_mode(mode: str, device=None) -> str:
    """'auto' -> timed on a CUDA device, heuristic when the caller asks
    for the CPU.

    ``device`` as for every entry point: ``None`` is the CUDA device
    (``errors.DeviceUnavailableError`` where there is none). ``"timed"``
    on the CPU raises ``errors.InvalidArgError``: the CPU runs the
    kernels' plain versions, whose wall time would tune for the wrong
    target.
    """
    if mode not in ("heuristic", "timed", "auto"):
        raise errors.InvalidArgError(f"unknown search mode {mode!r}")
    if mode == "heuristic":
        return mode
    on_card = resolve_device(device).type == "cuda"
    if mode == "timed" and not on_card:
        raise errors.InvalidArgError(
            "mode='timed' times the CUDA kernels and needs a CUDA device; "
            f"got device={device!r} (use mode='heuristic' on the CPU)")
    return "timed" if on_card else "heuristic"


@dataclasses.dataclass
class _Refined:
    """One shortlisted candidate after the build-and-measure pass."""

    config: CandidateConfig
    cb: CBMatrix
    streams: object
    padded_elems: int
    steps: int
    t_spmv: float | None = None

    @property
    def heuristic_score(self) -> float:
        return self.padded_elems + STEP_OVERHEAD_ELEMS * self.steps


def _build_candidate(rows, cols, vals, shape, val_dtype, config,
                     cb_by_structure: dict) -> _Refined:
    """Build one candidate's CB structure and streams.

    Candidates that share (block size, thresholds, colagg) share one
    ``CBMatrix``. A build under ``colagg="auto"`` is also filed under the
    bool it resolved to, so the shortlist's usual pair of twins (``"auto"``
    and the explicit bool it resolves to) costs one ``from_coo``, not two:
    ``from_coo`` with that bool builds the very same structure.
    """
    skey = (config.block_size, config.thresholds, config.colagg)
    cb = cb_by_structure.get(skey)
    if cb is None:
        cb = cb_by_structure[skey] = CBMatrix.from_coo(
            rows, cols, vals, shape,
            block_size=config.block_size,
            val_dtype=val_dtype,
            thresholds=config.thresholds,
            use_column_aggregation=config.colagg,
        )
        cb_by_structure.setdefault(skey[:2] + (bool(cb.colagg.applied),), cb)
    streams = build_super_streams(cb, group_size=config.resolved_group_size())
    return _Refined(
        config=config, cb=cb, streams=streams,
        padded_elems=int(sum(streams.padded_work().values())),
        steps=int(streams.num_dense_groups + streams.num_panel_groups
                  + streams.num_coo_groups),
    )


def _time_candidate(refined: _Refined, shape, reps: int, dev: torch.device) -> float:
    """Seconds of one ``cb_spmv(impl="cuda")`` on ``dev`` (``timing.time_min``);
    the candidate's streams live on the card only while they are timed."""
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(shape[1]).astype(np.float32)).to(dev)
    streams = refined.streams.to(dev)
    return timing.time_min(
        lambda: ops.cb_spmv(streams, x, impl="cuda", device=dev), reps=reps)


def plan_search(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    *,
    val_dtype=np.float32,
    cache: PlanCache | None = None,
    settings: SearchSettings | None = None,
    device=None,
) -> Plan:
    """Pick a per-matrix CB configuration (see module docstring).

    ``device`` is where a timed search runs (``None``: the CUDA device);
    a heuristic search touches no device whatever it says.
    """
    settings = DEFAULT_SETTINGS if settings is None else settings
    val_dtype = np.dtype(val_dtype)
    hashes = matrix_hashes(rows, cols, vals, shape, val_dtype)
    if cache is not None:
        # Structure-keyed lookup: value churn reuses the plan. The v1
        # content hash rides along so pre-split plan files still hit
        # (and migrate) instead of forcing one last re-plan.
        hit = cache.get(
            hashes.structure,
            legacy_hash=legacy_content_hash(rows, cols, vals, shape,
                                            val_dtype),
            shape=shape,
            nnz=hashes.nnz,
        )
        if hit is not None:
            return hit

    mode = resolve_mode(settings.mode, device)
    features = extract_features(rows, cols, vals, shape)
    candidates = (default_candidates() if settings.candidates is None
                  else settings.candidates)
    ranked = rank(features, candidates)

    # shortlist: top-k by model score, default config always present
    shortlist = [c for c, _ in ranked[: max(1, settings.top_k)]]
    if DEFAULT_CONFIG not in shortlist:
        shortlist.append(DEFAULT_CONFIG)

    cb_by_structure: dict = {}
    refined = [
        _build_candidate(rows, cols, vals, shape, val_dtype, c,
                         cb_by_structure)
        for c in shortlist
    ]
    default_refined = next(r for r in refined if r.config == DEFAULT_CONFIG)

    if mode == "timed":
        dev = resolve_device(device)
        for r in refined:
            r.t_spmv = _time_candidate(r, shape, settings.timing_reps, dev)
        best = min(refined, key=lambda r: (r.t_spmv, r.padded_elems))
    else:
        pool = refined
        if not settings.allow_padded_regression:
            pool = [r for r in refined
                    if r.padded_elems <= default_refined.padded_elems]
        # min() is stable: ties keep shortlist (= model-rank) order
        best = min(pool, key=lambda r: r.heuristic_score)

    predicted = estimate(features, best.config)
    plan = Plan(
        structure_hash=hashes.structure,
        value_hash=hashes.value,
        shape=tuple(int(v) for v in shape),
        nnz=hashes.nnz,
        val_dtype=val_dtype.name,
        block_size=best.config.block_size,
        th0=best.config.thresholds.th0,
        th1=best.config.thresholds.th1,
        th2=best.config.thresholds.th2,
        colagg=bool(best.cb.colagg.applied),
        group_size=best.config.resolved_group_size(),
        mode=mode,
        predicted_padded_elems=predicted.padded_elems,
        predicted_steps=predicted.steps,
        measured_padded_elems=best.padded_elems,
        measured_steps=best.steps,
        t_spmv=best.t_spmv,
    )
    if cache is not None:
        cache.put(plan)
    return plan
