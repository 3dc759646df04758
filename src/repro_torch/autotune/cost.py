"""Analytical cost model over the stream builders — ranks plans unrun.

The model prices a candidate configuration (block size B, th1/th2
format thresholds, column-aggregation mode, group size G) by mirroring
the *arithmetic* of ``core/streams.build_super_streams`` on the block
profile from ``features.py``, without building anything:

  * **padded work** — elements the kernels would stream per SpMV pass:
    dense blocks cost ``B*B`` each (evened groups via ``even_group``,
    exactly as the packer evens slots); CSR blocks cost ``B *
    bucket(width)`` where ``width`` is the block's distinct-column
    count and ``bucket`` rounds to the SUBLANE like ``pad_width``;
    COO blocks cost ``bucket(nnz)``. Group widths assume the Alg. 2
    balancer achieves its target (max group ~= mean group), which it
    does to within a bucket on every corpus family.
  * **grid steps** — groups per format, ``ceil(count / G)``: the
    per-step dispatch overhead the batched engines amortize.
  * **scatter rows** — per-slot partial rows the fused combine adds:
    ``G`` per dense group plus ``W / SUBLANE`` per packed group.

Column aggregation is the one *estimated* quantity: a compacted panel
with ``C`` distinct nonzero columns spans ``ceil(C / B)`` blocks with
its nnz concentrated into them (paper §3.3.1). The model redistributes
each panel's nnz over that many synthetic blocks; format selection then
runs on the synthetic profile. The estimate is deliberately optimistic
about balance and pessimistic about nothing — which is fine, because
``search.py`` *builds* the top-k candidates and measures the real
streams before committing; the model only has to rank.

The score folds the three quantities into element-equivalents:
``padded + STEP_OVERHEAD_ELEMS * steps + SCATTER_ROW_ELEMS * rows``.

The port of ``repro.autotune.cost``, estimate for estimate: the constants
are the JAX package's, fitted there; whether they rank configurations on
the H100 as timing does is what ``search.py``'s timed mode measures.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import DEFAULT_THRESHOLDS, FormatThresholds
from repro_torch.core.streams import (
    MAX_GROUP_SIZE, SUBLANE, even_group, group_size_for, pad_width,
)

from .features import CANDIDATE_BLOCK_SIZES, MatrixFeatures

# Fixed cost of one grid step (one group) in payload-element equivalents.
# The JAX package's value, fitted to its Pallas interpreter's step-count
# sensitivity and kept here so heuristic plans match the reference's; it
# is not fitted to the H100. Order of magnitude is what matters for
# ranking (G=1 must lose to G=16 on a 10k-block matrix, a 3-block matrix
# must not chase giant groups).
STEP_OVERHEAD_ELEMS = 512

# Cost of one per-slot partial row in the fused scatter-add combine.
SCATTER_ROW_ELEMS = 16


@dataclasses.dataclass(frozen=True)
class CandidateConfig:
    """One point in the planner's configuration space."""

    block_size: int = 16
    thresholds: FormatThresholds = DEFAULT_THRESHOLDS
    colagg: object = "auto"          # "auto" | True | False
    group_size: int | None = None    # None -> group_size_for(block_size)

    def resolved_group_size(self) -> int:
        if self.group_size is None:
            return group_size_for(self.block_size)
        return int(self.group_size)


DEFAULT_CONFIG = CandidateConfig()


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """The model's prediction for one candidate on one matrix."""

    padded_elems: int
    steps: int
    scatter_rows: int
    colagg_applied: bool
    score: float


def _colagg_profile(prof, B: int):
    """Synthetic (nnz, width) per block after panel compaction.

    Each panel's ``C`` distinct columns compact into ``ceil(C / B)``
    blocks; its nnz spreads evenly over them and the last block keeps
    the ragged ``C mod B`` width.
    """
    blocks_per_panel = np.maximum(1, -(-prof.panel_cols // B))
    total = int(blocks_per_panel.sum())
    nnz_est = np.repeat(prof.panel_nnz // blocks_per_panel, blocks_per_panel)
    # spread the remainder one element per leading block of each panel
    rem = np.repeat(prof.panel_nnz % blocks_per_panel, blocks_per_panel)
    first = np.repeat(
        np.cumsum(blocks_per_panel) - blocks_per_panel, blocks_per_panel
    )
    nnz_est += (np.arange(total) - first) < rem
    width_est = np.full(total, B, np.int64)
    last = np.cumsum(blocks_per_panel) - 1
    ragged = prof.panel_cols - (blocks_per_panel - 1) * B
    width_est[last] = ragged
    return nnz_est, np.minimum(width_est, np.maximum(nnz_est, 1))


def estimate(features: MatrixFeatures, config: CandidateConfig) -> CostEstimate:
    """Price one candidate configuration on one matrix's features."""
    B = config.block_size
    prof = features.profile(B)
    th1, th2 = config.thresholds.resolve(B)
    G = config.resolved_group_size()

    if config.colagg == "auto":
        applied = prof.super_sparse_fraction >= config.thresholds.th0
    else:
        applied = bool(config.colagg)

    if applied and prof.num_blocks:
        nnz_blk, width_blk = _colagg_profile(prof, B)
    else:
        nnz_blk, width_blk = prof.nnz_per_block, prof.cols_per_block

    is_coo = nnz_blk < th1
    is_dense = nnz_blk > th2
    is_csr = ~(is_coo | is_dense)

    padded = steps = rows = 0

    nd = int(is_dense.sum())
    if nd:
        gd, Gd = even_group(nd, G)
        padded += gd * Gd * B * B
        steps += gd
        rows += gd * Gd

    def _packed_cost(widths: np.ndarray) -> tuple[int, int, int]:
        """(padded_elems_per_row, groups, slot_rows) for lane packing."""
        count = len(widths)
        g, _ = even_group(count, G)
        bucketed = (-(-widths // SUBLANE)) * SUBLANE
        w = max(pad_width(int(np.ceil(bucketed.sum() / g))),
                int(bucketed.max()))
        return w, g, g * (w // SUBLANE)

    np_ = int(is_csr.sum())
    if np_:
        w, g, r = _packed_cost(width_blk[is_csr])
        padded += g * B * w
        steps += g
        rows += r

    nc = int(is_coo.sum())
    if nc:
        w, g, r = _packed_cost(nnz_blk[is_coo])
        padded += g * w
        steps += g
        rows += r

    score = (padded + STEP_OVERHEAD_ELEMS * steps
             + SCATTER_ROW_ELEMS * rows)
    return CostEstimate(
        padded_elems=int(padded), steps=int(steps), scatter_rows=int(rows),
        colagg_applied=bool(applied), score=float(score),
    )


def rank(
    features: MatrixFeatures,
    candidates: tuple[CandidateConfig, ...],
) -> list[tuple[CandidateConfig, CostEstimate]]:
    """Candidates sorted by model score (stable: ties keep input order)."""
    scored = [(c, estimate(features, c)) for c in candidates]
    return sorted(scored, key=lambda ce: ce[1].score)


def default_candidates(
    block_sizes: tuple[int, ...] = CANDIDATE_BLOCK_SIZES,
) -> tuple[CandidateConfig, ...]:
    """The stock configuration grid the planner searches.

    Per block size: the paper thresholds plus a denser-leaning and a
    sparser-leaning variant (shifting the COO/CSR/Dense boundaries by
    2x either way), colagg forced on/off/auto, and group sizes at the
    occupancy heuristic and half/double it. The default constants
    configuration is always element [0] so searches can special-case it.
    """
    out = [DEFAULT_CONFIG]
    for B in block_sizes:
        area = B * B
        ths = (
            DEFAULT_THRESHOLDS,
            FormatThresholds(th1=max(1, area // 16), th2=max(1, area // 4)),
            FormatThresholds(th1=max(1, area // 4),
                             th2=min(area, (3 * area) // 4)),
        )
        gs = group_size_for(B)
        sizes = sorted({gs, max(1, gs // 2), min(MAX_GROUP_SIZE, gs * 2)})
        for th in ths:
            for colagg in ("auto", True, False):
                for g in sizes:
                    cand = CandidateConfig(
                        block_size=B, thresholds=th, colagg=colagg,
                        group_size=g,
                    )
                    if cand != DEFAULT_CONFIG:
                        out.append(cand)
    return tuple(out)
