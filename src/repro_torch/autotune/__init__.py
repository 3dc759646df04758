"""Adaptive autotuning + persistent plan cache for the CB engines (the port
of ``repro.autotune``, same names).

Converts the repo's hardcoded performance constants (th1/th2 format
thresholds, the th0 colagg gate, TARGET_STEP_ELEMS / MAX_GROUP_SIZE
group sizing) into per-matrix decisions: cheap feature extraction
(``features``), an analytical cost model over the stream builders
(``cost``), empirical refinement of the top-k candidates (``search``),
and a schema-versioned plan cache keyed on the canonical *structure*
hash (``plan``) so the planning cost amortizes across processes and
across value updates. ``search.plan_search(mode="timed")`` times the
shortlist through the CUDA kernels on the card it will serve (the
JAX package's ``src/repro/autotune/README.md`` describes the rest).
"""
from .cost import (  # noqa: F401
    CandidateConfig,
    CostEstimate,
    DEFAULT_CONFIG,
    default_candidates,
    estimate,
    rank,
)
from .features import (  # noqa: F401
    CANDIDATE_BLOCK_SIZES,
    BlockProfile,
    MatrixFeatures,
    extract_features,
    feature_vector,
    features_from_cb,
)
from .plan import (  # noqa: F401
    PLAN_SCHEMA,
    PLAN_SCHEMA_V1,
    MatrixHashes,
    Plan,
    PlanCache,
    canonical_triplets,
    legacy_content_hash,
    matrix_content_hash,
    matrix_hashes,
    structure_hash,
    value_hash,
)
from .search import (  # noqa: F401
    DEFAULT_SETTINGS,
    SearchSettings,
    plan_search,
    resolve_mode,
)
