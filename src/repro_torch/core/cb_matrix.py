"""CBMatrix — the end-to-end CB-SpMV data structure (paper Fig. 5 / Fig. 6).

Conversion pipeline (COO input -> CB structure), exactly the paper's flow:

  1. load block-based COO           (blocking.partition_coo)
  2. matrix characteristics check   (formats.should_column_aggregate, th0)
  3. block-aware column aggregation (column_agg.column_aggregate)
  4. 2D structure + format select   (formats.select_formats, th1/th2)
  5. intra-block data aggregation   (aggregation.aggregate_partition -> VP)
  6. inter-TB load balance          (balance.tb_load_balance, Alg. 2)

The resulting object holds the high-level block-COO metadata in *balanced
slot order* plus the single packed byte buffer — the faithful portable
format. Kernel-facing typed streams are derived by core/streams.py.

``from_coo`` runs under the ``obs`` span ``cb.from_coo``, each step under a
child span: ``cb.partition`` (steps 1-2; twice where column aggregation
applies), ``cb.colagg`` (3), ``cb.formats`` (4-5) and ``cb.balance`` (6).
"""
from __future__ import annotations

import dataclasses
import hashlib
import zipfile
import zlib

import numpy as np

from repro_torch import errors, obs

from . import aggregation, balance, blocking, column_agg, formats


def _nonfinite_policy(vals: np.ndarray, policy: str, where: str) -> np.ndarray:
    """Apply the non-finite payload policy (``repro_torch.errors`` taxonomy).

    ``"raise"`` (the hardened default) rejects NaN/Inf with a typed
    ``NonFiniteError``; ``"sanitize"`` maps them to 0.0; ``"allow"``
    keeps them (the caller owns downstream NaN propagation — the solver
    loops flag it as ``SolverStatus.NONFINITE``).
    """
    if policy == "allow" or not np.issubdtype(vals.dtype, np.inexact):
        return vals
    finite = np.isfinite(vals)
    if finite.all():
        return vals
    if policy == "raise":
        bad = int((~finite).sum())
        raise errors.NonFiniteError(
            f"{where}: {bad} non-finite value(s) in payload "
            f"(pass nonfinite='sanitize' to zero them or 'allow' to keep)"
        )
    if policy == "sanitize":
        return np.where(finite, vals, vals.dtype.type(0))
    raise errors.InvalidArgError(
        f"unknown nonfinite policy {policy!r}; "
        "expected 'raise', 'sanitize' or 'allow'"
    )


def _npz_checksum(entries: dict) -> str:
    """Deterministic sha256 over named arrays (key + dtype + shape + bytes)."""
    h = hashlib.sha256()
    for key in sorted(entries):
        arr = np.asarray(entries[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(np.asarray(arr.shape, np.int64).tobytes())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class ValueLayout:
    """The once-per-structure value-scatter index (``value_layout``).

    ``byte_pos[i]`` is the first byte of canonical element ``i``'s value
    inside ``CBMatrix.packed``; ``keys[i]`` is its ``row * n + col`` key
    in canonical ascending order.
    """

    count: int
    byte_pos: np.ndarray   # (count,) int64
    keys: np.ndarray       # (count,) int64


@dataclasses.dataclass
class CBMatrix:
    shape: tuple[int, int]
    block_size: int
    val_dtype: np.dtype
    thresholds: formats.FormatThresholds

    # High-level block-COO metadata, in balanced slot order (padded with
    # empty slots so every group holds exactly `group_size` blocks).
    blk_row_idx: np.ndarray    # (nslots,) int32 — block-row (panel) index
    blk_col_idx: np.ndarray    # (nslots,) int32 — block-col in (compacted) space
    nnz_per_blk: np.ndarray    # (nslots,) int32 — 0 for pad slots
    type_per_blk: np.ndarray   # (nslots,) uint8
    vp_per_blk: np.ndarray     # (nslots,) int64 byte offsets (0 for pads)

    packed: np.ndarray         # (total_bytes,) uint8 — ``mtx_data``
    colagg: column_agg.ColumnAggregation
    balance_result: balance.BalanceResult
    nnz: int

    # ------------------------------------------------------------------
    @classmethod
    def from_coo(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: tuple[int, int],
        block_size: int = 16,
        val_dtype=np.float32,
        thresholds: formats.FormatThresholds = formats.DEFAULT_THRESHOLDS,
        use_column_aggregation: bool | str = "auto",
        warps_per_tb: int = 8,
        nonfinite: str = "raise",
    ) -> "CBMatrix":
        val_dtype = np.dtype(val_dtype)
        thresholds = formats.coerce_thresholds(thresholds)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=val_dtype)
        with obs.span("cb.from_coo", nnz=int(vals.size)) as sp:
            vals = _nonfinite_policy(vals, nonfinite, "CBMatrix.from_coo")

            # (1)+(2): probe partition to decide column aggregation (th0 gate).
            with obs.span("cb.partition", nnz=int(vals.size)):
                probe = blocking.partition_coo(rows, cols, vals, shape, block_size)
            if use_column_aggregation == "auto":
                apply_agg = formats.should_column_aggregate(
                    probe.nnz_per_blk, block_size, thresholds
                )
            else:
                apply_agg = bool(use_column_aggregation)

            # (3): panel-level column compaction.
            with obs.span("cb.colagg", colagg=bool(apply_agg)):
                if apply_agg:
                    agg = column_agg.column_aggregate(rows, cols, shape, block_size)
                else:
                    agg = column_agg.identity_aggregation(cols, shape, block_size)
            if apply_agg:
                with obs.span("cb.partition", nnz=int(vals.size)):
                    part = blocking.partition_coo(rows, agg.new_cols, vals, shape, block_size)
            else:
                part = probe

            # (4): per-block format selection.
            # (5): intra-block aggregation into the flat buffer + VPs.
            with obs.span("cb.formats", blocks=part.num_blocks):
                fmts = formats.select_formats(part.nnz_per_blk, block_size, thresholds)
                packed = aggregation.aggregate_partition(fmts, part, val_dtype)

            # (6): inter-TB load balance (Alg. 2) and metadata permutation.
            with obs.span("cb.balance", blocks=part.num_blocks):
                bal = balance.tb_load_balance(part.nnz_per_blk, warps_per_tb)
                brow, bcol, nnzb, typb, vps = balance.apply_balance(
                    bal,
                    part.blk_row_idx,
                    part.blk_col_idx,
                    part.nnz_per_blk,
                    fmts,
                    packed.vp_per_blk,
                    pad_values=(0, 0, 0, formats.FMT_COO, 0),
                )
            sp.set(blocks=part.num_blocks, colagg=bool(apply_agg))

        return cls(
            shape=tuple(shape),
            block_size=block_size,
            val_dtype=val_dtype,
            thresholds=thresholds,
            blk_row_idx=brow,
            blk_col_idx=bcol,
            nnz_per_blk=nnzb,
            type_per_blk=typb,
            vp_per_blk=vps,
            packed=packed.packed,
            colagg=agg,
            balance_result=bal,
            nnz=part.nnz,
        )

    # ------------------------------------------------------------------
    # Planning — the autotune subsystem's entry points, surfaced here so
    # ``from_coo``'s callers find them next to the constructor they tune.
    # ------------------------------------------------------------------

    @classmethod
    def plan_for(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: tuple[int, int],
        *,
        val_dtype=np.float32,
        cache=None,
        settings=None,
        device=None,
    ):
        """``from_coo``'s companion: pick a per-matrix configuration.

        Runs the autotune search (features -> cost model -> empirical
        refinement; see ``repro_torch.autotune``) and returns a ``Plan``
        whose (block size, thresholds, colagg, group size) can be applied
        via :meth:`from_plan`. ``cache`` is an optional
        ``autotune.PlanCache`` — a structure-hash hit skips the search
        entirely. ``device`` is where a timed search times the kernels
        (``None``: the CUDA device; with ``"cpu"`` the default mode is
        heuristic).
        """
        from repro_torch.autotune.search import plan_search

        return plan_search(rows, cols, vals, shape, val_dtype=val_dtype,
                           cache=cache, settings=settings, device=device)

    @classmethod
    def from_plan(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: tuple[int, int],
        plan,
    ) -> "CBMatrix":
        """Build the CB structure with a ``Plan``'s chosen configuration.

        The plan's colagg decision was *resolved* at planning time, so it
        is passed as an explicit bool — rebuilding from a cached plan is
        bit-identical to the freshly-planned build even if the th0 gate
        would flip on a re-probe.

        The plan is validated before any work runs: shape against the
        matrix, plus internal consistency (thresholds must resolve at
        the plan's block size) — a stale or hand-edited plan fails here
        with ``errors.PlanStaleError`` instead of mis-building silently.
        The cache path (``autotune.PlanCache.get``) performs the same
        validation and treats failures as a counted miss.
        """
        checker = getattr(plan, "check_valid", None)
        if checker is not None:
            reason = checker(shape=shape)
        else:
            reason = (None if tuple(shape) == tuple(plan.shape) else
                      f"plan was made for shape {plan.shape}, "
                      f"got {tuple(shape)}")
        if reason is not None:
            raise errors.PlanStaleError(reason)
        return cls.from_coo(
            rows, cols, vals, shape,
            block_size=plan.block_size,
            val_dtype=np.dtype(plan.val_dtype),
            thresholds=plan.thresholds,
            use_column_aggregation=plan.colagg,
        )

    # ------------------------------------------------------------------
    # Persistence — amortize preprocessing across *processes* (a solver
    # restart or benchmark rerun loads the structure instead of rebuilding
    # it). The file format (schema tag, entries, sha256) is the one the JAX
    # package ``repro`` writes, so either package loads the other's files.
    # ------------------------------------------------------------------

    SAVE_SCHEMA = "cb-matrix/v1"

    def save(self, path) -> None:
        """Serialize the full CB structure to a single ``.npz`` file.

        The payload is integrity-checked: a sha256 over every named
        array (key, dtype, shape, bytes — deterministic order) rides
        along as ``checksum`` and is re-verified by :meth:`load`, so a
        truncated or byte-flipped artifact fails with a typed
        ``errors.ArtifactError`` instead of mis-building silently.
        """
        th = self.thresholds
        entries = dict(
            schema=np.asarray(self.SAVE_SCHEMA),
            shape=np.asarray(self.shape, np.int64),
            block_size=np.int64(self.block_size),
            val_dtype=np.asarray(np.dtype(self.val_dtype).name),
            # None thresholds (the "derive from B" default) ride as -1.
            thresholds=np.asarray(
                [th.th0,
                 -1 if th.th1 is None else th.th1,
                 -1 if th.th2 is None else th.th2], np.float64
            ),
            blk_row_idx=self.blk_row_idx,
            blk_col_idx=self.blk_col_idx,
            nnz_per_blk=self.nnz_per_blk,
            type_per_blk=self.type_per_blk,
            vp_per_blk=self.vp_per_blk,
            packed=self.packed,
            colagg_applied=np.bool_(self.colagg.applied),
            colagg_new_cols=self.colagg.new_cols,
            colagg_restore_cols=self.colagg.restore_cols,
            colagg_cols_offset=self.colagg.cols_offset,
            colagg_panel_width=self.colagg.panel_width,
            bal_slots=self.balance_result.slots,
            bal_group_loads=self.balance_result.group_loads,
            bal_geom=np.asarray(
                [self.balance_result.num_groups,
                 self.balance_result.group_size], np.int64
            ),
            nnz=np.int64(self.nnz),
        )
        entries["checksum"] = np.asarray(_npz_checksum(entries))
        np.savez(path, **entries)

    @classmethod
    def load(cls, path, *, validate: bool = True) -> "CBMatrix":
        """Inverse of :meth:`save`; rejects unknown schemas and corruption.

        Every failure mode is typed (``repro_torch.errors``): an unreadable or
        byte-damaged file (zip/zlib/truncation errors, checksum
        mismatch) raises ``ArtifactError``; a wrong schema tag raises
        ``SchemaError``; a payload that decodes but violates the CB
        structural invariants fails :meth:`validate` (skippable via
        ``validate=False`` for forensics on damaged artifacts).
        Pre-checksum ``cb-matrix/v1`` files (no ``checksum`` entry)
        still load.
        """
        try:
            with np.load(path, allow_pickle=False) as z:
                entries = {k: np.asarray(z[k]) for k in z.files}
        except (OSError, zipfile.BadZipFile, zlib.error, EOFError,
                KeyError, ValueError, NotImplementedError) as e:
            # NotImplementedError: zipfile raises it when a byte flip lands
            # in the archive's version-needed field.
            raise errors.ArtifactError(
                f"{path}: unreadable cb-matrix artifact: {e}"
            ) from e
        schema = str(entries.get("schema"))
        if schema != cls.SAVE_SCHEMA:
            raise errors.SchemaError(
                f"{path}: schema {schema!r} != {cls.SAVE_SCHEMA!r}"
            )
        stored = entries.pop("checksum", None)
        if stored is not None:
            digest = _npz_checksum(entries)
            if str(stored) != digest:
                raise errors.ArtifactError(
                    f"{path}: checksum mismatch — artifact bytes are "
                    f"corrupted (stored {str(stored)[:12]}..., "
                    f"recomputed {digest[:12]}...)"
                )
        try:
            th0, th1, th2 = entries["thresholds"]
            cb = cls(
                shape=tuple(int(v) for v in entries["shape"]),
                block_size=int(entries["block_size"]),
                val_dtype=np.dtype(str(entries["val_dtype"])),
                thresholds=formats.FormatThresholds(
                    th0=float(th0),
                    th1=None if th1 < 0 else int(th1),
                    th2=None if th2 < 0 else int(th2),
                ),
                blk_row_idx=entries["blk_row_idx"],
                blk_col_idx=entries["blk_col_idx"],
                nnz_per_blk=entries["nnz_per_blk"],
                type_per_blk=entries["type_per_blk"],
                vp_per_blk=entries["vp_per_blk"],
                packed=entries["packed"],
                colagg=column_agg.ColumnAggregation(
                    applied=bool(entries["colagg_applied"]),
                    new_cols=entries["colagg_new_cols"],
                    restore_cols=entries["colagg_restore_cols"],
                    cols_offset=entries["colagg_cols_offset"],
                    panel_width=entries["colagg_panel_width"],
                    num_panels=len(entries["colagg_panel_width"]),
                ),
                balance_result=balance.BalanceResult(
                    slots=entries["bal_slots"],
                    group_loads=entries["bal_group_loads"],
                    num_groups=int(entries["bal_geom"][0]),
                    group_size=int(entries["bal_geom"][1]),
                ),
                nnz=int(entries["nnz"]),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise errors.ArtifactError(
                f"{path}: cb-matrix payload is incomplete or malformed: {e}"
            ) from e
        return cb.validate() if validate else cb

    # ------------------------------------------------------------------
    def validate(self, *, check_finite: bool = False) -> "CBMatrix":
        """Assert the CB structural invariants; raise ``ArtifactError``.

        Vectorized checks over the balanced-slot metadata and the packed
        buffer: consistent stream shapes, in-bounds block indices
        (colagg-aware), legal format codes, per-format payload byte
        spans inside ``packed``, pad-slot conventions, and the nnz
        ledger. ``check_finite=True`` additionally decodes every stored
        value and applies the non-finite detection — opt-in because it
        reads the whole payload.

        Returns ``self`` so call sites can chain
        (``CBMatrix.load(p).validate()`` is load's default behavior).
        """
        def bad(msg: str) -> errors.ArtifactError:
            return errors.ArtifactError(f"CBMatrix.validate: {msg}")

        m, n = (int(v) for v in self.shape)
        B = int(self.block_size)
        if m < 1 or n < 1 or B < 1:
            raise bad(f"nonsense geometry shape={self.shape} B={B}")
        meta = (self.blk_row_idx, self.blk_col_idx, self.nnz_per_blk,
                self.type_per_blk, self.vp_per_blk)
        nslots = len(self.blk_row_idx)
        if any(a.ndim != 1 or len(a) != nslots for a in meta):
            raise bad(
                "metadata stream shapes disagree: "
                f"{[a.shape for a in meta]}"
            )
        bal = self.balance_result
        if bal.num_groups * bal.group_size != nslots:
            raise bad(
                f"balance geometry {bal.num_groups}x{bal.group_size} "
                f"!= {nslots} slots"
            )
        nnzb = self.nnz_per_blk.astype(np.int64)
        if (nnzb < 0).any() or (nnzb > B * B).any():
            raise bad(f"per-block nnz outside [0, {B * B}]")
        if int(nnzb.sum()) != int(self.nnz):
            raise bad(
                f"nnz ledger mismatch: blocks sum to {int(nnzb.sum())}, "
                f"matrix claims {self.nnz}"
            )
        real = nnzb > 0
        if (self.vp_per_blk[~real] != 0).any():
            raise bad("pad slot with a nonzero value pointer")
        if real.any():
            brow = self.blk_row_idx[real].astype(np.int64)
            bcol = self.blk_col_idx[real].astype(np.int64)
            fmt = self.type_per_blk[real].astype(np.int64)
            vp = self.vp_per_blk[real].astype(np.int64)
            cnt = nnzb[real]
            if (brow < 0).any() or (brow * B >= m).any():
                raise bad(f"block-row index outside [0, {-(-m // B)})")
            if self.colagg.applied:
                width = self.colagg.panel_width[brow]
            else:
                width = np.full(len(brow), n, np.int64)
            if (bcol < 0).any() or (bcol * B >= width).any():
                raise bad("block-col index outside its panel's width")
            known = np.isin(
                fmt, [formats.FMT_COO, formats.FMT_CSR, formats.FMT_DENSE]
            )
            if not known.all():
                raise bad(
                    f"unknown format code(s) {np.unique(fmt[~known])}"
                )
            vsize = self.val_dtype.itemsize
            cdt_size = aggregation.coord_dtype(B).itemsize
            rp_size = (B + 1) * aggregation._csr_rowptr_dtype(B).itemsize
            head = np.where(
                fmt == formats.FMT_DENSE, 0,
                np.where(fmt == formats.FMT_COO, cnt * cdt_size,
                         rp_size + cnt * cdt_size))
            body = np.where(fmt == formats.FMT_DENSE, B * B * vsize,
                            cnt * vsize)
            need = head + (-head) % vsize + body
            if (vp < 0).any() or (vp + need > len(self.packed)).any():
                raise bad(
                    "value pointer + payload span exceeds the packed "
                    f"buffer ({len(self.packed)} bytes)"
                )
        if check_finite:
            for fmt in (formats.FMT_COO, formats.FMT_CSR, formats.FMT_DENSE):
                vals = self.format_elements(fmt)[4]
                if not np.isfinite(vals).all():
                    raise errors.NonFiniteError(
                        "CBMatrix.validate: packed payload contains "
                        f"{int((~np.isfinite(vals)).sum())} non-finite "
                        "value(s)"
                    )
        return self

    # ------------------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return int(np.sum(self.nnz_per_blk > 0))

    @property
    def num_slots(self) -> int:
        return len(self.blk_row_idx)

    def iter_blocks(self):
        """Yield (brow, bcol, fmt, local_r, local_c, vals) for real blocks."""
        for i in range(self.num_slots):
            nnz = int(self.nnz_per_blk[i])
            if nnz == 0:
                continue
            fmt = int(self.type_per_blk[i])
            r, c, v = aggregation.unpack_block(
                self.packed, int(self.vp_per_blk[i]), fmt, nnz,
                self.block_size, self.val_dtype,
            )
            yield int(self.blk_row_idx[i]), int(self.blk_col_idx[i]), fmt, r, c, v

    def format_elements(self, fmt: int):
        """Every element of every ``fmt`` block, decoded at once.

        Returns ``(slots, blk, local_r, local_c, vals)``: ``slots`` are
        the balanced-slot indices of the real blocks stored as ``fmt``
        (ascending), and the other four are parallel per-element arrays
        with ``blk`` indexing into ``slots`` — the array form of
        ``iter_blocks`` for one format (same block order, same element
        order), with no Python loop over blocks.
        """
        slots = np.flatnonzero((self.nnz_per_blk > 0) & (self.type_per_blk == fmt))
        blk, r, c, v = aggregation.unpack_format(
            self.packed, self.vp_per_blk[slots], self.nnz_per_blk[slots],
            fmt, self.block_size, self.val_dtype,
        )
        return slots, blk, r, c, v

    def global_elements(self):
        """(global rows, global cols, vals) of every element, format-major."""
        B = self.block_size
        rs, cs, vs = [], [], []
        for fmt in (formats.FMT_COO, formats.FMT_CSR, formats.FMT_DENSE):
            slots, blk, r, c, v = self.format_elements(fmt)
            brow = self.blk_row_idx[slots].astype(np.int64)[blk]
            bcol = self.blk_col_idx[slots].astype(np.int64)[blk]
            rs.append(brow * B + r)
            cs.append(self.global_x_index(brow, bcol, c))
            vs.append(v)
        return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Recover the original-coordinate triplets, row-major sorted.

        Column aggregation is folded back through ``global_x_index``, so
        the triplets are position-faithful to the input of ``from_coo``.
        The canonical (row, col) sort makes the output independent of the
        balanced slot order — two CBMatrix builds of the same matrix
        yield bit-identical triplets.

        Caveat: *explicitly stored zeros* do not survive. A 0.0 value
        inside a dense-format block is indistinguishable from structural
        padding in the packed tile (inherent to the CB byte format, same
        as ``to_dense``), so such entries are dropped.
        """
        r_all, c_all, v_all = self.global_elements()
        order = np.lexsort((c_all, r_all))
        return r_all[order], c_all[order], v_all[order]

    # ------------------------------------------------------------------
    # Dynamic-sparsity fast path: rewrite values without re-planning.
    #
    # Every structural decision (blocking, colagg, format select, Alg. 2
    # balance, byte layout) depends only on the sparsity pattern, so a
    # matrix whose values churn can keep its entire CB structure and
    # scatter fresh values straight into the packed buffer. The scatter
    # index — one byte offset per canonical element — is recorded once
    # per structure and reused for every update.
    # ------------------------------------------------------------------

    def value_layout(self) -> ValueLayout:
        """The value-scatter index: canonical order -> packed byte offsets.

        Decodes every format at once (``format_elements``), recording for
        every *recoverable* element its global (row, col) key and the byte
        offset of its value inside ``packed`` (the ``aggregation`` intra-block
        layouts: a dense element sits at its tile cell, a COO/CSR element
        at its index past the aligned head), then sorts by key into the
        canonical (row, col) order ``to_coo`` emits. Keys are unique, so
        the result is the JAX package's slot-by-slot walk, bit for bit.
        Cached on the instance; ``update_values`` propagates the cache to
        the copies it returns, so a churn loop pays the decode once.
        """
        layout = getattr(self, "_value_layout_cache", None)
        if layout is not None:
            return layout
        B = self.block_size
        vsize = self.val_dtype.itemsize
        n = self.shape[1]
        pos_l, key_l = [], []
        for fmt in (formats.FMT_COO, formats.FMT_CSR, formats.FMT_DENSE):
            slots, blk, r, c, _v = self.format_elements(fmt)
            vp = self.vp_per_blk[slots].astype(np.int64)
            r = r.astype(np.int64)
            if fmt == formats.FMT_DENSE:
                pos = vp[blk] + (r * B + c) * vsize
            else:
                nnz = self.nnz_per_blk[slots].astype(np.int64)
                head, _ = aggregation._section_sizes(np.full(len(slots), fmt), nnz, B, vsize)
                k = np.arange(len(blk), dtype=np.int64) - (np.cumsum(nnz) - nnz)[blk]
                pos = vp[blk] + head[blk] + k * vsize
            brow = self.blk_row_idx[slots].astype(np.int64)[blk]
            bcol = self.blk_col_idx[slots].astype(np.int64)[blk]
            pos_l.append(pos)
            key_l.append((brow * B + r) * n + self.global_x_index(brow, bcol, c))
        pos = np.concatenate(pos_l).astype(np.int64)
        keys = np.concatenate(key_l).astype(np.int64)
        order = np.argsort(keys, kind="stable")
        layout = ValueLayout(count=len(pos), byte_pos=pos[order], keys=keys[order])
        self._value_layout_cache = layout
        return layout

    def update_values(self, new_vals: np.ndarray, *,
                      nonfinite: str = "raise") -> "CBMatrix":
        """Rewrite the packed values in place of a full rebuild.

        ``new_vals`` is one value per element in **canonical order** —
        the (row, col)-sorted order ``to_coo`` returns (use
        :meth:`update_from_coo` for arbitrary triplet order). Returns a
        new ``CBMatrix`` sharing every metadata array (same blocking,
        colagg, formats, balance, byte layout) with only the packed
        buffer replaced — no re-planning, re-balancing, or re-selection
        runs.

        Writing an exact 0.0 into a dense-format slot makes that element
        unrecoverable on the next ``to_coo`` (the format cannot
        distinguish it from padding); keep update values nonzero when
        round-trip fidelity matters.
        """
        layout = self.value_layout()
        vals = np.ascontiguousarray(new_vals, self.val_dtype)
        vals = _nonfinite_policy(vals, nonfinite, "CBMatrix.update_values")
        if vals.shape != (layout.count,):
            raise errors.InvalidArgError(
                f"update_values expects {layout.count} canonical values "
                f"(see to_coo), got array of shape {vals.shape}"
            )
        vsize = self.val_dtype.itemsize
        packed = self.packed.copy()
        idx = layout.byte_pos[:, None] + np.arange(vsize, dtype=np.int64)
        packed[idx] = vals.view(np.uint8).reshape(-1, vsize)
        new = dataclasses.replace(self, packed=packed)
        # The scatter index is pattern-derived; hand it to the copy so
        # chained updates never decode the blocks again.
        new._value_layout_cache = layout
        return new

    def update_from_coo(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        *,
        nonfinite: str = "raise",
    ) -> "CBMatrix":
        """``update_values`` for triplets in arbitrary order.

        Duplicates are merged by summation (matching ``from_coo``); the
        resulting coordinate set must equal this matrix's structure
        exactly — structure drift (new or missing coordinates) raises,
        because only a full ``from_coo`` rebuild can re-plan the
        blocking for a changed pattern.
        """
        layout = self.value_layout()
        n = self.shape[1]
        rows = np.ascontiguousarray(rows, np.int64)
        cols = np.ascontiguousarray(cols, np.int64)
        vals = np.ascontiguousarray(vals, self.val_dtype)
        key = rows * n + cols
        uniq, inv = np.unique(key, return_inverse=True)
        summed = np.zeros(len(uniq), self.val_dtype)
        np.add.at(summed, inv, vals)
        if len(uniq) != layout.count or not np.array_equal(uniq, layout.keys):
            raise errors.StructureDriftError(errors.reason(
                errors.STRUCTURE_DRIFT,
                "sparsity pattern differs from this CBMatrix's structure; "
                "update_from_coo only rewrites values — rebuild with "
                "from_coo (and re-plan) for structure drift",
            ))
        return self.update_values(summed, nonfinite=nonfinite)

    def global_x_index(self, brow, bcol, local_c: np.ndarray) -> np.ndarray:
        """Map (block, local col) -> original global column of x.

        ``brow`` / ``bcol`` are one block's indices, or per-element arrays
        parallel to ``local_c``.
        """
        B = self.block_size
        if not self.colagg.applied:
            return bcol * B + local_c.astype(np.int64)
        base = self.colagg.cols_offset[brow] + bcol * B
        return self.colagg.restore_cols[base + local_c.astype(np.int64)].astype(np.int64)

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.val_dtype)
        r, c, v = self.global_elements()
        np.add.at(out, (r, c), v)
        return out

    # -- storage accounting (paper §4.4.1) ------------------------------
    def nbytes_structure(self) -> dict:
        meta = (
            self.blk_row_idx.nbytes
            + self.blk_col_idx.nbytes
            + self.nnz_per_blk.nbytes
            + self.type_per_blk.nbytes
            + self.vp_per_blk.nbytes
        )
        agg = self.colagg.restore_cols.nbytes + self.colagg.cols_offset.nbytes
        return {
            "high_level_metadata": int(meta),
            "column_agg_maps": int(agg) if self.colagg.applied else 0,
            "packed_data": int(self.packed.nbytes),
            "total": int(meta + self.packed.nbytes + (agg if self.colagg.applied else 0)),
        }

    def stats(self) -> dict:
        real = self.nnz_per_blk[self.nnz_per_blk > 0]
        fmt = self.type_per_blk[self.nnz_per_blk > 0]
        return {
            "nnz": self.nnz,
            "num_blocks": int(len(real)),
            "block_size": self.block_size,
            "column_aggregated": bool(self.colagg.applied),
            "fmt_coo": int(np.sum(fmt == formats.FMT_COO)),
            "fmt_csr": int(np.sum(fmt == formats.FMT_CSR)),
            "fmt_dense": int(np.sum(fmt == formats.FMT_DENSE)),
            "super_sparse_fraction": formats.super_sparse_fraction(real, self.block_size),
            "tb_load_std": self.balance_result.load_std,
            "tb_load_imbalance": self.balance_result.load_imbalance,
        }
