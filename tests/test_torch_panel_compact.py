"""The panels' bitmap encoding (``cb_colagg.compact_panels``) and the product
on it, on the CPU: the encoding rebuilds the padded panels exactly, the
plain version of the bitmap kernel equals the padded one's, a value updater
hands each stream its own encoding, and ``compact_elems`` is counted as a
port-only series.

The CUDA kernel ``cb_panel_kernel_bitmap`` is held bit for bit against the
padded kernel on the card by ``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import CBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.data import matrices
from repro_torch.kernels import cb_colagg as t_panel
from repro_torch.kernels import ops

import torch_port as tp

DTYPES = [torch.float32, torch.float64, torch.bfloat16]
PANEL_SCENARIOS = tp.scenario_cut()


def _panel_streams(scn, G=None):
    return tstreams.build_super_streams(tp.torch_cb(scn), group_size=G)


def _stencil_streams(n=16):
    rows, cols, vals = matrices.stencil_27(n)
    cb = CBMatrix.from_coo(rows, cols, vals.astype(np.float32), (n ** 3, n ** 3),
                           block_size=16, val_dtype=np.float32)
    return tstreams.build_super_streams(cb)


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset()
    yield
    obs.reset()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("G", [None, 4], ids=["G_default", "G4"])
def test_the_encoding_rebuilds_the_panels_exactly(dtype, G):
    """Over the conformance cut at B 8, 16 and 24: ``mask`` and ``cvals``
    decode to the very panels, every row's values sit in lane order from
    place 0, and a row of ``cvals`` is a multiple of 16 bytes."""
    seen = set()
    for scn in PANEL_SCENARIOS:
        panels = _panel_streams(scn, G).panel_vals.to(dtype)
        enc = t_panel.compact_panels(panels, chunk_elems=200)     # several chunks a stream
        gp, B, W = panels.shape
        assert enc.mask.shape == (gp, B, W // 8) and enc.mask.dtype == torch.uint8
        assert enc.cvals.dtype == dtype and enc.cvals.shape[:2] == (gp, B)
        assert (enc.cvals.shape[2] * panels.element_size()) % 16 == 0
        assert torch.equal(t_panel.panel_decode(enc.cvals, enc.mask), panels), scn.name
        counts = (panels != 0).sum(2)
        most = counts.max().item() if gp else 0
        assert 0 <= enc.cvals.shape[2] - most < 16 // panels.element_size()
        assert torch.equal((enc.cvals != 0).sum(2), counts)
        lanes = enc.mask.unsqueeze(-1).bitwise_and(
            torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)).ne(0)
        assert torch.equal(lanes.reshape(gp, B, W), panels != 0)
        if gp:
            seen.add(scn.block_size)
    assert seen == {8, 16, 24}


def _integer_panels(panels, seed=0):
    rng = np.random.default_rng(seed)
    a = panels.double().numpy()
    return torch.from_numpy(np.where(a != 0, rng.integers(-7, 8, a.shape) | 1, 0)) \
        .to(panels.dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("scn", [s for s in PANEL_SCENARIOS
                                 if s.name in ("bucket_widths-B8-colagg_auto",
                                               "banded-B24-colagg_auto",
                                               "spd-B16-colagg_off",
                                               "uniform-B8-colagg_off-force_csr")],
                         ids=lambda s: s.name)
def test_the_bitmap_plain_version_equals_the_padded_one(scn, dtype):
    """Integer-valued payloads and x, so every sum is exact: the plain version
    of the bitmap kernel, and its wrapper on the CPU, equal ``panel_spmv_plain``
    bit for bit."""
    s = _panel_streams(scn, 4)
    panels = _integer_panels(s.panel_vals).to(dtype)
    xg = torch.from_numpy(np.random.default_rng(4).integers(-4, 5, s.n).astype(np.float32))[
        s.panel_xidx.long()]
    enc = t_panel.compact_panels(panels)
    want = t_panel.panel_spmv_plain(panels, xg)
    assert torch.equal(t_panel.panel_spmv_bitmap_plain(enc.cvals, enc.mask, xg), want)
    out = torch.full_like(want, float("nan"))
    assert t_panel.panel_spmv_bitmap(enc.cvals, enc.mask, xg, out=out) is out
    assert torch.equal(out, want)


def test_the_bitmap_wrapper_checks_its_arguments():
    enc = t_panel.compact_panels(torch.eye(8).repeat(2, 1, 2))      # (2, 8, 16)
    xg = torch.ones((2, 16))
    with pytest.raises(Exception, match="mask"):
        t_panel.panel_spmv_bitmap(enc.cvals, enc.mask.to(torch.int32), xg)
    with pytest.raises(Exception, match="cvals"):
        t_panel.panel_spmv_bitmap(enc.cvals[:1], enc.mask, xg)
    with pytest.raises(Exception, match="xg"):
        t_panel.panel_spmv_bitmap(enc.cvals, enc.mask, torch.ones((2, 8)))
    with pytest.raises(Exception, match="16 bytes"):
        t_panel.panel_spmv_bitmap(torch.zeros((2, 8, 3)), enc.mask, xg)
    with pytest.raises(Exception, match="not a multiple"):
        t_panel.compact_panels(torch.zeros((1, 8, 12)))
    empty = t_panel.compact_panels(torch.zeros((0, 16, 0)))
    assert t_panel.panel_spmv_bitmap(empty.cvals, empty.mask, torch.zeros((0, 0))).shape == \
        (0, 0, 16)
    assert t_panel.panel_spmv_bitmap.launches == 0              # nothing runs on the CPU


def test_the_stencil_encoding_is_a_quarter_of_the_padded_bytes():
    """The 16^3 stencil's rows hold at most 48 of their group's 256 lanes:
    E = 48, and a row of the encoding is 48 values and 32 mask bytes."""
    s = _stencil_streams(16)
    enc = t_panel.compact_panels(s.panel_vals)
    gp, B, W = s.panel_vals.shape
    assert gp and W == 256 and enc.cvals.shape[2] == 48
    assert enc.nbytes == gp * B * (48 * 4 + W // 8)
    assert enc.nbytes < 0.25 * s.panel_vals.numel() * s.panel_vals.element_size()


def test_every_conformance_panel_stream_picks_the_bitmap_layout():
    """CUDA runs every panel stream on its bitmap encoding: over the
    conformance cut, that encoding is fewer bytes than the padded panels."""
    picked = [(enc.nbytes < p.numel() * p.element_size())
              for p in (_panel_streams(scn).panel_vals for scn in PANEL_SCENARIOS)
              if p.shape[0] for enc in [t_panel.compact_panels(p)]]
    assert picked and all(picked)


def _updater(transposed=False, n=12):
    rows, cols, vals = matrices.stencil_27(n)
    cb = CBMatrix.from_coo(rows, cols, vals.astype(np.float32), (n ** 3, n ** 3),
                           block_size=16, val_dtype=np.float32)
    make = (tstreams.transposed_super_stream_updater if transposed
            else tstreams.super_stream_updater)
    return cb, make(cb)


@pytest.mark.parametrize("transposed", [False, True], ids=["forward", "transposed"])
def test_the_updater_hands_each_stream_its_own_encoding(transposed):
    """``apply(v)`` scatters v into the encoding as into the payloads: the
    new stream's prepared state holds, for its own payload, the very encoding
    ``compact_panels`` derives from it, so its first CUDA call derives none;
    each stream has its own, and the template's state gains none."""
    cb, upd = _updater(transposed)
    assert upd.panel_mask.shape == upd.template.panel_vals.shape[:2] + (
        upd.template.panel_vals.shape[2] // 8,)
    rng = np.random.default_rng(7)
    streams = [upd.apply(rng.uniform(0.5, 2.0, cb.nnz).astype(np.float32)) for _ in range(2)]
    for new in streams:
        vals, version, enc = ops._prepare(new, None).panel
        assert vals is new.panel_vals and version == vals._version
        want = t_panel.compact_panels(new.panel_vals)
        assert torch.equal(enc.cvals, want.cvals) and torch.equal(enc.mask, want.mask)
        assert ops._compact_elems(ops._prepare(new, None)) == 0      # read on CUDA only
    assert not torch.equal(ops._prepare(streams[0], None).panel[2].cvals,
                           ops._prepare(streams[1], None).panel[2].cvals)
    assert ops._prepare(upd.template, None).panel is None
    moved = upd.to("cpu")
    assert torch.equal(moved.panel_cvals, upd.panel_cvals) and moved.cvals_pos.dtype == torch.int64
    assert upd.cvals_pos.shape == upd.panel_pos.shape


def test_an_updated_zero_keeps_its_lane_and_its_product():
    """A value updated to exactly 0.0 stays in the updater's mask (the
    structure fixes it), holding 0: the encoding still decodes to the
    stream's panels, and the product on it equals the padded one."""
    cb, upd = _updater()
    v = np.random.default_rng(8).uniform(0.5, 2.0, cb.nnz).astype(np.float32)
    v[::5] = 0.0
    new = upd.apply(v)
    enc = ops._prepare(new, None).panel[2]
    assert torch.equal(enc.mask, upd.panel_mask)
    assert not torch.equal(t_panel.compact_panels(new.panel_vals).mask, enc.mask)   # values drop them
    assert torch.equal(t_panel.panel_decode(enc.cvals, enc.mask), new.panel_vals)
    xg = torch.from_numpy(np.random.default_rng(9).integers(-4, 5, new.n).astype(np.float32))[
        new.panel_xidx.long()]
    assert torch.equal(t_panel.panel_spmv_bitmap(enc.cvals, enc.mask, xg),
                       t_panel.panel_spmv_plain(new.panel_vals, xg))


def test_a_cpu_call_runs_the_padded_path_and_counts_compact_elems_at_zero():
    """On CPU tensors ``_accumulate`` derives no encoding, and each call records
    ``compact_elems{format=panel}`` at 0, a series the parity tests strip as
    port-only."""
    s = _stencil_streams(16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(s.n).astype(np.float32))
    y = ops.cb_spmv(s, x, device="cpu")
    ops.cb_spmv_into(torch.zeros(s.m), s, x, device="cpu")
    ops.cb_spmv(s, x, device="cpu", impl="reference")
    assert ops._prepare(s, None).panel is None
    snap = obs.snapshot()
    for entry in ("spmv", "spmv_into"):
        assert snap[f"repro.ops.{entry}.compact_elems"]["series"] == [
            {"labels": {"format": "panel"}, "value": 0}]
    assert "compact_elems" in tp.PORT_ONLY_COUNTERS
    assert not [n for n in tp.shared_snapshot(snap) if n.endswith("compact_elems")]
    assert torch.equal(y, ops.cb_spmv(s, x, device="cpu"))
    cb, upd = _updater()
    new = upd.apply(np.ones(cb.nnz, np.float32))
    obs.reset()
    ops.cb_spmv(new, torch.ones(new.n), device="cpu")
    assert ops._prepare(new, None).panel is not None            # handed over, read on CUDA only
    assert obs.counter("repro.ops.spmv.compact_elems").value(format="panel") == 0


def test_the_call_batch_counts_compact_elems_per_call():
    """The CUDA path's accounting: a batch carries the elements it is given,
    and a cached batch is kept per count, so a stream that shares another's
    prepared state (and its cache of batches) counts its own."""
    s = _stencil_streams(16)
    prep = ops._prepare(s, None)
    cache = {}
    for compact in (5, 7, 7, 0):
        ops._record_call("spmv", prep.stats, "cuda", None, cache, prep.engine["spmv"], compact)
    assert obs.counter("repro.ops.spmv.compact_elems").value(format="panel") == 19
    assert obs.counter("repro.ops.spmv.launches").value(format="panel") == 4
    assert len(cache) == 3
