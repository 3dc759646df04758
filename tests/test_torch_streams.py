"""Port parity, stream packing: every array of ``SpMVStreams`` and
``SuperBlockStreams`` built by ``repro_torch.core.streams`` is bit-equal
(values, dtype, shape) to the JAX package's, over the conformance grid and
the group-size axis. The port's packers are whole-matrix array code; the
JAX package's walk block by block — equality here is what licenses that.
"""
import numpy as np
import pytest
import torch

from repro.core import streams as jstreams
from repro_torch import errors as terrors
from repro_torch.core import streams as tstreams

import torch_port as tp

SCENARIOS = tp.scenario_cut()
GROUPED = [(s, G) for s in tp.scenario_cut(3) for G in (*tp.GROUP_SIZES, 7, None)]


@pytest.mark.parametrize("scn", SCENARIOS, ids=tp.ids(SCENARIOS))
def test_flat_streams_bit_equal(scn):
    want = jstreams.build_streams(scn.build())
    got = tstreams.build_streams(tp.torch_cb(scn))
    tp.assert_streams_equal(want, got, scn.name)
    assert got.padded_work() == want.padded_work()
    assert (got.num_dense, got.num_panel, got.num_coo) == \
           (want.num_dense, want.num_panel, want.num_coo)


@pytest.mark.parametrize("scn,G", GROUPED, ids=[f"{s.name}-G{g}" for s, g in GROUPED])
def test_super_streams_bit_equal(scn, G):
    want = jstreams.build_super_streams(scn.build(), group_size=G)
    got = tstreams.build_super_streams(tp.torch_cb(scn), group_size=G)
    tp.assert_streams_equal(want, got, f"{scn.name} G={G}")
    assert got.group_size == want.group_size
    assert got.padded_work() == want.padded_work()
    assert got.region_nbytes() == want.region_nbytes()
    assert (got.num_dense_groups, got.num_panel_groups, got.num_coo_groups) == \
           (want.num_dense_groups, want.num_panel_groups, want.num_coo_groups)


@pytest.mark.parametrize("B", [8, 16, 24, 32, 128])
def test_group_geometry_rules_match(B):
    assert tstreams.group_size_for(B) == jstreams.group_size_for(B)
    assert tstreams.group_size_for(B, 1 << 16, 64) == jstreams.group_size_for(B, 1 << 16, 64)
    for count in (0, 1, 15, 16, 17, 40, 1000):
        assert tstreams.even_group(count, B) == jstreams.even_group(count, B)
    for w in (0, 1, 7, 8, 9, 250):
        assert tstreams.pad_width(w) == jstreams.pad_width(w)
    assert (tstreams.SUBLANE, tstreams.TARGET_STEP_ELEMS, tstreams.MAX_GROUP_SIZE) == \
           (jstreams.SUBLANE, jstreams.TARGET_STEP_ELEMS, jstreams.MAX_GROUP_SIZE)


@pytest.mark.parametrize("kind", ["flat", "super"])
def test_streams_from_numpy_round_trip(kind):
    """The JAX package's packed bytes enter the port unchanged."""
    cb = tp.Scenario("block_clustered", 16).build()
    js = (jstreams.build_streams(cb) if kind == "flat"
          else jstreams.build_super_streams(cb, group_size=4))
    ts = tp.to_torch_streams(js)
    assert type(ts).__name__ == type(js).__name__
    tp.assert_streams_equal(js, ts, kind)
    for f in tp.STREAM_FIELDS:
        assert getattr(ts, f).device.type == "cpu"
    assert ts.dense_brow.dtype == torch.int32 and ts.coo_codes.dtype == torch.int32


def test_streams_from_numpy_rejects_bad_input():
    with pytest.raises(terrors.InvalidArgError):
        tstreams.streams_from_numpy("tile", {}, {})
    with pytest.raises(terrors.InvalidArgError):
        tstreams.streams_from_numpy("flat", {"dense_tiles": np.zeros((0, 8, 8))}, {})


def test_streams_from_numpy_takes_bfloat16():
    import ml_dtypes

    s = tstreams.build_streams(tp.torch_cb(tp.Scenario("uniform", 8)))
    fields = {f: getattr(s, f).numpy() for f in tp.STREAM_FIELDS}
    for f in ("dense_tiles", "panel_vals", "coo_vals"):
        fields[f] = fields[f].astype(ml_dtypes.bfloat16)
    meta = {k: getattr(s, k) for k in tp.META_FIELDS}
    got = tstreams.streams_from_numpy("flat", fields, meta)
    assert got.coo_vals.dtype == torch.bfloat16
    assert torch.equal(got.coo_vals, s.coo_vals.to(torch.bfloat16))
    assert torch.equal(got.panel_vals, s.panel_vals.to(torch.bfloat16))


def test_to_moves_and_retypes_without_touching_indices():
    s = tstreams.build_super_streams(tp.torch_cb(tp.Scenario("banded", 16)))
    b = s.to("cpu", payload_dtype=torch.bfloat16)
    assert b is not s and b.group_size == s.group_size
    assert b.panel_vals.dtype == torch.bfloat16 and b.val_itemsize == 2
    assert b.panel_xidx.dtype == torch.int32 and torch.equal(b.panel_xidx, s.panel_xidx)
    assert b.region_nbytes()["panel_vals"] * 2 == s.region_nbytes()["panel_vals"]
    assert s.device.type == "cpu"


def test_empty_formats_allocate_nothing():
    """Absent formats are genuinely empty arrays (no phantom (0, B, 8) buffers)."""
    m = n = 32
    rr, cc = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    v = np.ones(m * n, np.float32)
    from repro.core import CBMatrix as JaxCBMatrix
    from repro_torch.core import CBMatrix as TorchCBMatrix
    jcb = JaxCBMatrix.from_coo(rr.ravel(), cc.ravel(), v, (m, n), block_size=16)
    tcb = TorchCBMatrix.from_coo(rr.ravel(), cc.ravel(), v, (m, n), block_size=16)
    flat = tstreams.build_streams(tcb)
    assert flat.num_dense == 4 and tuple(flat.panel_vals.shape) == (0, 16, 0)
    assert tuple(flat.coo_codes.shape) == (0, 0)
    tp.assert_streams_equal(jstreams.build_streams(jcb), flat)
    tp.assert_streams_equal(jstreams.build_super_streams(jcb),
                            tstreams.build_super_streams(tcb))
    with pytest.raises(terrors.InvalidArgError):
        tstreams.build_super_streams(tcb, group_size=0)
