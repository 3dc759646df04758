"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Every test builds its inputs with numpy from a seed and hands the same
arrays to the JAX package ``repro`` and to the port ``repro_torch``; this
module holds the scenario cut and the converters between the two.
"""
import numpy as np

from conformance.scenarios import GROUP_SIZES, Scenario, spmv_scenarios
from repro_torch.core import CBMatrix as TorchCBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.core.formats import FormatThresholds as TorchThresholds

STREAM_FIELDS = tstreams._STREAM_FIELDS
META_FIELDS = ("block_size", "m", "n", "mb", "colagg_applied")


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


__all__ = ["GROUP_SIZES", "Scenario", "scenario_cut", "ids", "torch_cb",
           "to_torch_streams", "assert_streams_equal", "STREAM_FIELDS"]
