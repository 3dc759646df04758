"""Block-aware column aggregation (paper §3.3.1, Fig. 6(b)).

Within each block-row *panel* (B consecutive matrix rows), columns that are
entirely zero in that panel are removed and the remaining columns shifted
left. Two maps are kept:

  * ``restore_cols`` — concatenated original (global) column index of each
    surviving panel column,
  * ``cols_offset``  — per-panel start offset into ``restore_cols``.

After aggregation every non-zero B-wide block in compacted coordinates has
at least one non-zero per column, so a full-width block carries >= B
non-zeros — the paper's ">=16 non-zeros per block ⇒ >=50% warp utilization"
guarantee: every surviving lane of a compacted panel does useful work.

The transform is applied matrix-wide iff the super-sparse block fraction
exceeds th0 (see formats.should_column_aggregate).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ColumnAggregation:
    """Panel-compacted coordinates plus the restore maps."""

    applied: bool
    # Element columns re-expressed in panel-compacted coordinate space.
    # (Only meaningful when applied=True; otherwise identical to input.)
    new_cols: np.ndarray          # (nnz,) int64 compacted column coordinate
    restore_cols: np.ndarray      # (sum_p K_p,) int32 original global column
    cols_offset: np.ndarray       # (num_panels + 1,) int64 prefix offsets
    panel_width: np.ndarray       # (num_panels,) int32  K_p
    num_panels: int

    def original_col(self, panel: int, compact_col: int) -> int:
        """Map a compacted column index back to the original global column."""
        return int(self.restore_cols[self.cols_offset[panel] + compact_col])


def identity_aggregation(cols: np.ndarray, shape: tuple[int, int], block_size: int) -> ColumnAggregation:
    m, n = shape
    num_panels = -(-m // block_size)
    return ColumnAggregation(
        applied=False,
        new_cols=np.asarray(cols, dtype=np.int64),
        restore_cols=np.zeros(0, dtype=np.int32),
        cols_offset=np.zeros(num_panels + 1, dtype=np.int64),
        panel_width=np.full(num_panels, n, dtype=np.int32),
        num_panels=num_panels,
    )


def column_aggregate(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: tuple[int, int],
    block_size: int,
) -> ColumnAggregation:
    """Compute panel-level column compaction for COO coordinates."""
    m, n = shape
    B = int(block_size)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    num_panels = -(-m // B)

    panel = rows // B
    # Unique (panel, col) pairs, sorted: gives each panel's surviving
    # columns in ascending original order.
    pc = panel * n + cols
    uniq = np.unique(pc)
    u_panel = uniq // n
    u_col = (uniq % n).astype(np.int32)

    panel_width = np.zeros(num_panels, dtype=np.int32)
    np.add.at(panel_width, u_panel.astype(np.int64), 1)
    cols_offset = np.zeros(num_panels + 1, dtype=np.int64)
    np.cumsum(panel_width, out=cols_offset[1:])

    # Rank of each element's (panel, col) among its panel's unique columns.
    idx = np.searchsorted(uniq, pc)
    new_cols = idx - cols_offset[panel]

    return ColumnAggregation(
        applied=True,
        new_cols=new_cols.astype(np.int64),
        restore_cols=u_col,
        cols_offset=cols_offset,
        panel_width=panel_width,
        num_panels=num_panels,
    )


def restore_for_block(
    agg: ColumnAggregation, panel, blk_col, block_size: int, n: int
) -> np.ndarray:
    """Global x-indices for the B columns of block (panel, blk_col).

    ``panel`` / ``blk_col`` are one block's indices (result ``(B,)``) or
    parallel arrays over many blocks (result ``(nblocks, B)``). Columns
    past the panel's compacted width map to index 0 — callers must pair
    them with zero values (the dense-tile padding convention).
    """
    B = block_size
    panel = np.asarray(panel, np.int64)[..., None]
    blk_col = np.asarray(blk_col, np.int64)[..., None]
    lane = np.arange(B, dtype=np.int64)
    if not agg.applied:
        return np.minimum(blk_col * B + lane, n - 1)  # safe-pad boundary blocks
    first = agg.cols_offset[panel]
    local = blk_col * B + lane
    valid = local < agg.panel_width[panel]
    idx = np.where(valid, first + local, first)
    out = agg.restore_cols[np.minimum(idx, len(agg.restore_cols) - 1)].astype(np.int64)
    return np.where(valid, out, 0)
