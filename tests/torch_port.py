"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Every test builds its inputs with numpy from a seed and hands the same
arrays to the JAX package ``repro`` and to the port ``repro_torch``; this
module holds the scenario cut and the converters between the two.
"""
import numpy as np
import torch

from conformance.scenarios import GROUP_SIZES, Scenario, spmv_scenarios
from repro_torch.core import CBMatrix as TorchCBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.core.formats import FormatThresholds as TorchThresholds

STREAM_FIELDS = tstreams._STREAM_FIELDS
META_FIELDS = ("block_size", "m", "n", "mb", "colagg_applied")

# What one package's obs records and the other's does not; the parity tests
# strip exactly these and compare everything the two share.
PORT_ONLY_SPANS = frozenset({
    "cb.from_coo", "cb.partition", "cb.colagg", "cb.formats", "cb.balance",  # the host build
    "streams.build_super", "streams.to",
    "cb_spmv", "cb_spmv_into",                                                # one per call
})
PORT_ONLY_LAUNCHES = frozenset({"gather", "combine", "fill"})   # repro.ops.*.launches{format}
PORT_ONLY_GAUGES = frozenset({"repro.streams.nnz"})             # set per build_super_streams
PORT_ONLY_COUNTERS = frozenset({"compact_elems"})                # repro.ops.*.compact_elems{format}
REFERENCE_ONLY_GAUGE = "group_size"                             # repro.ops.{entry}.group_size


def shared_spans(names) -> list:
    """Span names in order, the port-only ones left out."""
    return [n for n in names if n not in PORT_ONLY_SPANS]


def shared_snapshot(snap: dict) -> dict:
    """An obs snapshot without the port-only ``launches`` series,
    ``compact_elems`` counters and ``repro.streams.nnz`` gauge, and the
    reference-only ``group_size`` gauges (either package's snapshot)."""
    out = {}
    for name, metric in snap.items():
        if name in PORT_ONLY_GAUGES:
            continue
        parts = name.split(".")
        if parts[:2] == ["repro", "ops"] and parts[-1] in (REFERENCE_ONLY_GAUGE,
                                                            *PORT_ONLY_COUNTERS):
            continue
        if parts[:2] == ["repro", "ops"] and parts[-1] == "launches":
            metric = dict(metric, series=[
                s for s in metric["series"]
                if s["labels"].get("format") not in PORT_ONLY_LAUNCHES])
        out[name] = metric
    return out


def scenario_cut(step: int = 1) -> list[Scenario]:
    """Every ``step``-th scenario of the conformance grid (structures x B
    {8,16,24} x colagg {auto,True,False}, forced formats, float64) — a cut
    that still reaches each axis."""
    return spmv_scenarios()[::step]


def ids(scenarios) -> list[str]:
    return [s.name for s in scenarios]


def torch_cb(scn: Scenario) -> TorchCBMatrix:
    """The port's CBMatrix for a scenario, from the same triplets."""
    rows, cols, vals, shape = scn.build_coo()
    th = scn.thresholds()
    return TorchCBMatrix.from_coo(
        rows, cols, vals, shape, block_size=scn.block_size,
        val_dtype=np.dtype(scn.dtype),
        thresholds=TorchThresholds(th0=th.th0, th1=th.th1, th2=th.th2),
        use_column_aggregation=scn.colagg,
    )


def to_torch_streams(jax_streams):
    """The port's stream object holding a JAX-package stream's exact bytes."""
    kind = "super" if hasattr(jax_streams, "group_size") else "flat"
    meta = {k: getattr(jax_streams, k) for k in META_FIELDS}
    if kind == "super":
        meta["group_size"] = jax_streams.group_size
    fields = {f: np.asarray(getattr(jax_streams, f)) for f in STREAM_FIELDS}
    return tstreams.streams_from_numpy(kind, fields, meta)


TILE_FIELDS = ("tiles", "brow", "bcol")
TILE_META = ("block_size", "m", "n", "mb", "nb")


def to_torch_tiles(jax_tiles):
    """The port's tile stream holding a JAX-package tile stream's exact bytes."""
    kind = "super_tile" if hasattr(jax_tiles, "group_size") else "tile"
    meta = {k: getattr(jax_tiles, k) for k in TILE_META}
    if kind == "super_tile":
        meta["group_size"] = jax_tiles.group_size
    fields = {f: np.asarray(getattr(jax_tiles, f)) for f in TILE_FIELDS}
    return tstreams.streams_from_numpy(kind, fields, meta)


def assert_tiles_equal(jax_tiles, torch_tiles, tag=""):
    """Every tile-stream array (values, dtype, shape) and every static field."""
    for f in TILE_FIELDS:
        want = np.asarray(getattr(jax_tiles, f))
        got = getattr(torch_tiles, f)
        got = got.view(torch.int16).numpy().view(want.dtype) if got.dtype == torch.bfloat16 \
            else got.numpy()
        assert got.dtype == want.dtype, (tag, f, got.dtype, want.dtype)
        assert got.shape == want.shape, (tag, f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag} {f}")
    for f in TILE_META + (("group_size",) if hasattr(jax_tiles, "group_size") else ()):
        assert getattr(jax_tiles, f) == getattr(torch_tiles, f), (tag, f)


def assert_streams_equal(jax_streams, torch_streams, tag=""):
    """Every array (values, dtype, shape) and every static field."""
    for f in STREAM_FIELDS:
        want = np.asarray(getattr(jax_streams, f))
        got = getattr(torch_streams, f).numpy()
        assert got.dtype == want.dtype, (tag, f, got.dtype, want.dtype)
        assert got.shape == want.shape, (tag, f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag} {f}")
    for f in META_FIELDS:
        assert getattr(jax_streams, f) == getattr(torch_streams, f), (tag, f)


def to_torch_operator(jax_op):
    """The port's CBLinearOperator over a JAX-package operator's exact stream
    bytes (forward, transposed and tile streams, where the JAX operator has
    them), on the CPU."""
    from repro_torch.solvers import CBLinearOperator as TorchOperator

    return TorchOperator.from_streams(
        jax_op.shape, jax_op.block_size, jax_op.nnz, to_torch_streams(jax_op.streams),
        streams_T=None if jax_op.streams_T is None else to_torch_streams(jax_op.streams_T),
        tiles=None if jax_op.tiles is None else to_torch_tiles(jax_op.tiles))


def to_torch_preconditioner(jax_M):
    """The port's preconditioner holding a JAX-package preconditioner's
    arrays (identity, Jacobi or block-Jacobi), on the CPU."""
    from repro_torch import solvers as tsolvers

    kind = type(jax_M).__name__
    if kind == "IdentityPreconditioner":
        return tsolvers.IdentityPreconditioner()
    if kind == "JacobiPreconditioner":
        return tsolvers.JacobiPreconditioner.from_numpy(np.asarray(jax_M.inv_diag),
                                                        device="cpu")
    if kind == "BlockJacobiPreconditioner":
        return tsolvers.BlockJacobiPreconditioner.from_numpy(
            jax_M.m, jax_M.block_size, np.asarray(jax_M.inv_blocks), device="cpu")
    raise TypeError(f"no converter for {kind}")


__all__ = ["GROUP_SIZES", "Scenario", "scenario_cut", "ids", "torch_cb",
           "to_torch_streams", "assert_streams_equal", "STREAM_FIELDS",
           "to_torch_tiles", "assert_tiles_equal", "TILE_FIELDS",
           "to_torch_operator", "to_torch_preconditioner"]
