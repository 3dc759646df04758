"""Plan — the autotuner's persistent, schema-versioned decision record.

A ``Plan`` pins every knob the planner decided for one matrix: block
size, format thresholds (th0/th1/th2), the *resolved* column-aggregation
bool, and the batched engines' group size — plus the predictions and
measurements that justified the choice. It is a frozen (hashable)
dataclass, passed as ``ops.cb_spmv(..., plan=p)``.

Persistence mirrors ``CBMatrix.save``/``load`` (schema string checked on
load, version ``cb-plan/v2``; ``cb-plan/v1`` files remain readable) but
uses JSON — a plan is a dozen scalars, and a human should be able to
read why the planner chose what it chose.

Matrix identity is split in two:

  * ``structure_hash`` — sha256 over the *canonical* sparsity pattern:
    duplicate triplets merged, explicit zeros dropped, (row, col)-sorted
    coordinates, plus the shape. Independent of triplet order, value
    dtype, and the values themselves.
  * ``value_hash``     — sha256 over the canonical-order values in the
    plan's value dtype (dtype name included).

``PlanCache`` keys plans on ``structure_hash`` alone: every CB planning
decision (blocking, colagg, format select, Alg. 2 balance) depends only
on the pattern, so a matrix whose *values* churn every step — the
dynamic-sparsity regime — reuses its plan indefinitely. This fixes the
v1 defect where any value change re-planned from scratch, and the
explicit-zeros aliasing hazard ``CBMatrix.to_coo`` documents: the
canonicalization inside the hash makes original triplets (with explicit
zeros) and round-tripped triplets land on the same cache entry.
Cross-process amortization is the regime where per-matrix planning
cost divides by thousands of reuses.

The port of ``repro.autotune.plan``: the files, the hashes and the
checksums are the JAX package's bit for bit, so a plan written by either
package is a hit in the other's cache.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import NamedTuple

import numpy as np

from repro_torch import errors, obs
from repro_torch.core import aggregation
from repro_torch.core.formats import FormatThresholds

PLAN_SCHEMA = "cb-plan/v2"
PLAN_SCHEMA_V1 = "cb-plan/v1"


def canonical_triplets(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    val_dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical form of a COO matrix: dedup, drop zeros, (row, col)-sort.

    Duplicate coordinates are merged by summation (matching
    ``blocking.partition_coo``) and entries whose merged value is exactly
    zero are dropped — an explicitly-stored 0.0 does not survive a CB
    round trip (``CBMatrix.to_coo``), so it must not contribute to the
    matrix identity either. The result is sorted by (row, col), the same
    order ``to_coo`` emits.
    """
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.dtype(val_dtype))
    n = int(shape[1])
    key = rows * n + cols
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.zeros(len(uniq), vals.dtype)
    np.add.at(summed, inv, vals)
    keep = summed != 0
    uniq, summed = uniq[keep], summed[keep]
    return uniq // n, uniq % n, summed


class MatrixHashes(NamedTuple):
    """Both halves of a matrix's identity plus its canonical nnz."""

    structure: str
    value: str
    nnz: int


def matrix_hashes(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    val_dtype=np.float32,
) -> MatrixHashes:
    """Compute (structure_hash, value_hash, canonical nnz) in one pass."""
    r, c, v = canonical_triplets(rows, cols, vals, shape, val_dtype)
    hs = hashlib.sha256()
    hs.update(b"cb-structure/v2")
    hs.update(np.asarray([shape[0], shape[1], len(r)], np.int64).tobytes())
    hs.update(r.tobytes())
    hs.update(c.tobytes())
    hv = hashlib.sha256()
    hv.update(b"cb-values/v2")
    hv.update(np.dtype(val_dtype).name.encode())
    hv.update(v.tobytes())
    return MatrixHashes(hs.hexdigest(), hv.hexdigest(), len(r))


def structure_hash(rows, cols, vals, shape, val_dtype=np.float32) -> str:
    """sha256 of the canonical sparsity *pattern* (see module docstring)."""
    return matrix_hashes(rows, cols, vals, shape, val_dtype).structure


def value_hash(rows, cols, vals, shape, val_dtype=np.float32) -> str:
    """sha256 of the canonical-order *values* in ``val_dtype``."""
    return matrix_hashes(rows, cols, vals, shape, val_dtype).value


def matrix_content_hash(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    val_dtype=np.float32,
) -> str:
    """sha256 of the full matrix *content* (structure + values).

    The combined identity: changes with the pattern, the values, or the
    value dtype, but not with triplet order, duplicate splitting, or
    explicit zeros (the canonicalization of ``canonical_triplets`` is
    applied first). Use ``structure_hash`` when only the pattern matters
    — the plan cache does.
    """
    h = matrix_hashes(rows, cols, vals, shape, val_dtype)
    return hashlib.sha256(f"{h.structure}:{h.value}".encode()).hexdigest()


def legacy_content_hash(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    val_dtype=np.float32,
) -> str:
    """The exact ``cb-plan/v1`` content hash (no canonicalization).

    Kept bit-compatible with the v1 algorithm so a v2 lookup can probe
    for plan files written by v1 processes and migrate them.
    """
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.dtype(val_dtype))
    order = np.lexsort((cols, rows))
    h = hashlib.sha256()
    h.update(np.asarray([shape[0], shape[1], len(rows)], np.int64).tobytes())
    h.update(np.dtype(val_dtype).name.encode())
    h.update(rows[order].tobytes())
    h.update(cols[order].tobytes())
    h.update(vals[order].tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Plan:
    """One matrix's tuned CB configuration (see module docstring)."""

    structure_hash: str
    shape: tuple[int, int]
    nnz: int                        # canonical nnz (dedup, zero-dropped)
    val_dtype: str                  # numpy dtype name the plan was tuned in
    block_size: int
    th0: float
    th1: int | None                 # None = derive from B (formats.resolve)
    th2: int | None
    colagg: bool                    # resolved decision, not the "auto" mode
    group_size: int
    mode: str                       # "heuristic" | "timed"
    predicted_padded_elems: int
    predicted_steps: int
    measured_padded_elems: int
    measured_steps: int
    t_spmv: float | None = None     # refinement timing (None in heuristic mode)
    value_hash: str | None = None   # values the measurements ran with (info)
    # sha256 over the canonical JSON payload, written by ``to_json`` and
    # verified by ``check_valid`` (None = pre-checksum file, not checked).
    # compare=False so a loaded plan still ``==`` the freshly-planned one.
    payload_checksum: str | None = dataclasses.field(
        default=None, compare=False)

    @property
    def thresholds(self) -> FormatThresholds:
        return FormatThresholds(th0=self.th0, th1=self.th1, th2=self.th2)

    # ------------------------------------------------------------------
    def check_valid(self, shape=None, nnz=None) -> str | None:
        """Validate the plan, optionally against a matrix.

        Returns a human-readable reason string when the plan is
        internally inconsistent (thresholds that do not resolve at its
        block size, nonsense block/group sizes) or does not match the
        matrix it is about to be applied to — ``None`` when it is usable.
        ``PlanCache.get`` treats a non-None reason as a stale miss;
        ``CBMatrix.from_plan`` raises it.
        """
        if (self.payload_checksum is not None
                and self.payload_checksum != self._payload_digest()):
            return errors.reason(
                errors.ARTIFACT_CORRUPT,
                "plan payload checksum mismatch — the persisted fields "
                "were altered after save",
            )
        if len(self.shape) != 2 or min(self.shape) < 1:
            return f"plan shape {self.shape!r} is not a positive 2-D shape"
        if self.block_size < 1:
            return f"plan block_size {self.block_size} < 1"
        if self.group_size < 1:
            return f"plan group_size {self.group_size} < 1"
        try:
            aggregation.coord_dtype(self.block_size)
            self.thresholds.resolve(self.block_size)
        except (ValueError, TypeError) as e:
            return f"plan thresholds/block size invalid: {e}"
        if shape is not None and tuple(int(v) for v in shape) != tuple(self.shape):
            return f"plan was made for shape {self.shape}, got {tuple(shape)}"
        if nnz is not None and int(nnz) != int(self.nnz):
            return f"plan was made for nnz {self.nnz}, got {int(nnz)}"
        return None

    # ------------------------------------------------------------------
    def _payload_digest(self) -> str:
        """sha256 over the canonical JSON form of every persisted field.

        Canonical = compact separators, sorted keys, shape as a list,
        ``payload_checksum`` itself excluded — so the digest a fresh
        ``to_json`` stamps and the one a loaded plan recomputes agree
        bit-for-bit (JSON round-trips Python ints/floats exactly).
        """
        d = dataclasses.asdict(self)
        d.pop("payload_checksum", None)
        d["shape"] = list(self.shape)
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        d["schema"] = PLAN_SCHEMA
        d["payload_checksum"] = self._payload_digest()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Plan":
        schema = d.get("schema")
        if schema == PLAN_SCHEMA_V1:
            # v1 read-compat: the single content hash becomes the
            # structure key (PlanCache re-keys migrated entries on the
            # true structure hash; see PlanCache.get).
            d = dict(d)
            d["structure_hash"] = d.pop("matrix_hash")
            d.setdefault("value_hash", None)
            d.setdefault("payload_checksum", None)
        elif schema != PLAN_SCHEMA:
            raise errors.InvalidArgError(
                f"plan schema {schema!r} is neither {PLAN_SCHEMA!r} nor "
                f"{PLAN_SCHEMA_V1!r}"
            )
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["shape"] = tuple(int(v) for v in kw["shape"])
        return cls(**kw)

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path) -> "Plan":
        with open(path) as f:
            return cls.from_json(json.load(f))


class PlanCache:
    """Directory-backed plan store keyed by **structure hash**.

    ``get`` probes the structure-keyed ``cb-plan/v2`` file first and
    falls back to a caller-supplied legacy ``cb-plan/v1`` content-hash
    key; a legacy hit is re-keyed on the structure hash and persisted
    under the v2 schema, so the old file serves exactly one migration.
    Either way a logical lookup counts **exactly one** hit or miss —
    never once per probe level.

    An unreadable or schema-mismatched file is a miss (a newer schema
    simply re-plans rather than erroring a fleet). A file that loads but
    fails ``Plan.check_valid`` against the requested matrix — wrong
    shape, wrong nnz, thresholds that no longer resolve — is a *stale*
    miss, counted separately in ``stale`` so fleets can alarm on cache
    poisoning instead of silently re-planning forever.

    Counters live on the obs registry (the process-wide counter
    ``repro.autotune.plan_cache.lookups`` labeled by outcome); the
    per-instance ``hits`` / ``misses`` / ``stale`` attributes
    are thin read-only views over a :class:`repro_torch.obs.MirroredCounter`,
    so existing callers and tests see identical semantics.
    """

    def __init__(self, directory):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._counts = obs.MirroredCounter(
            metric="repro.autotune.plan_cache.lookups", label="outcome")

    @property
    def hits(self) -> int:
        return self._counts["hit"]

    @property
    def misses(self) -> int:
        return self._counts["miss"]

    @property
    def stale(self) -> int:
        return self._counts["stale"]

    def path_for(self, structure_hash: str) -> str:
        return os.path.join(self.directory, f"{structure_hash}.plan.json")

    def _load(self, key: str) -> Plan | None:
        """Load without touching counters; None on any read failure."""
        try:
            return Plan.load(self.path_for(key))
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            return None

    def get(
        self,
        structure_hash: str,
        *,
        legacy_hash: str | None = None,
        shape: tuple[int, int] | None = None,
        nnz: int | None = None,
    ) -> Plan | None:
        migrated = False
        plan = self._load(structure_hash)
        if plan is not None and plan.structure_hash != structure_hash:
            plan = None  # alien payload under this file name
        if plan is None and legacy_hash and legacy_hash != structure_hash:
            legacy = self._load(legacy_hash)
            if legacy is not None:
                # Re-keying changes the payload, so the stored digest (if
                # any) no longer applies; ``put`` stamps a fresh one.
                plan = dataclasses.replace(
                    legacy, structure_hash=structure_hash,
                    payload_checksum=None,
                )
                migrated = True
        if plan is None:
            self._counts["miss"] += 1
            return None
        if plan.check_valid(shape=shape, nnz=nnz) is not None:
            self._counts["stale"] += 1
            self._counts["miss"] += 1
            return None
        if migrated:
            self.put(plan)
        self._counts["hit"] += 1
        return plan

    def put(self, plan: Plan) -> str:
        path = self.path_for(plan.structure_hash)
        plan.save(path)
        return path

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
