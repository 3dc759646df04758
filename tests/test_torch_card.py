"""The port's tests that need a CUDA device, in a file that imports neither
``jax`` nor ``repro``, so that a GPU machine without JAX collects them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py tests/test_torch_combine.py

Each case is the one of the parity file named beside it, its check
unchanged; only the inputs are built here with the port alone
(``repro_torch.data.matrices`` and the port's host pipeline, which the CPU
parity tests hold bit-equal to the JAX package's), and the float64 oracle is
the port's ``core.spmv_ref.dense_oracle``. Without a card every case skips.
"""
import collections
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch import solvers as tsolvers
from repro_torch.core import CBMatrix, dense_oracle
from repro_torch.core import streams as tstreams
from repro_torch.data import matrices
from repro_torch.kernels import cb_block_dense as t_dense
from repro_torch.kernels import cb_colagg as t_panel
from repro_torch.kernels import cb_combine as t_combine
from repro_torch.kernels import cb_coo as t_coo
from repro_torch.kernels import cb_spmm as t_spmm
from repro_torch.kernels import ops as tops
from repro_torch.sparse import linear as TL

NO_CARD = ("needs a CUDA device: the kernels have no CPU mode "
           "(run `python3 chip_smoke.py` on the GPU machine)")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)


# -- the conformance structures these cases use (tests/conformance/scenarios.py) --

def _empty_rows_cols(seed):
    rng = np.random.default_rng(seed)
    m, n = 160, 144
    live_rows = np.r_[np.arange(0, 24), np.arange(96, 120)]
    live_cols = np.r_[np.arange(8, 40), np.arange(120, 136)]
    rows, cols = rng.choice(live_rows, 220), rng.choice(live_cols, 220)
    _, idx = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[idx], cols[idx]
    return rows.astype(np.int64), cols.astype(np.int64), rng.standard_normal(len(rows)), (m, n)


def _bucket_widths(seed):
    rng = np.random.default_rng(seed)
    m, n = 136, 128
    rows_l, cols_l = [], []
    for i, k in enumerate((1, 7, 8, 9, 15, 16, 17)):
        csel = (np.arange(k) * 5 + i * 11) % n
        for rr in np.arange(i * 18, min(i * 18 + 12, m))[::2]:
            rows_l.append(np.full(len(csel), rr))
            cols_l.append(csel)
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    _, idx = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[idx], cols[idx]
    return rows.astype(np.int64), cols.astype(np.int64), rng.standard_normal(len(rows)), (m, n)


STRUCTURES = {
    "power_law": lambda seed: (*matrices.power_law(144, 144, seed=seed), (144, 144)),
    "banded": lambda seed: (*matrices.banded(160, 128, seed=seed), (160, 128)),
    "block_clustered": lambda seed: (*matrices.block_clustered(144, 120, seed=seed), (144, 120)),
    "empty_rows_cols": _empty_rows_cols,
    "bucket_widths": _bucket_widths,
}


def _scenario(structure, B, colagg="auto", seed=11):
    """(triplets, shape, CBMatrix) of a conformance scenario, float32."""
    rows, cols, vals, shape = STRUCTURES[structure](seed)
    vals = vals.astype(np.float32)
    cb = CBMatrix.from_coo(rows, cols, vals, shape, block_size=B, val_dtype=np.float32,
                           use_column_aggregation=colagg)
    return (rows, cols, vals), shape, cb


# -- tests/test_torch_kernels.py: the three SpMV kernels ----------------------------

def _integer_streams(cb, G):
    """Packed streams with small integer payloads (every sum exact in float32)
    and an integer x, drawn as the parity file draws them."""
    s = tstreams.build_super_streams(cb, group_size=G)
    rng = np.random.default_rng(0)

    def ints(t):
        a = t.numpy()
        return torch.from_numpy(np.where(a != 0, rng.integers(1, 8, a.shape), 0).astype(a.dtype))
    s = dataclasses.replace(s, dense_tiles=ints(s.dense_tiles), panel_vals=ints(s.panel_vals),
                            coo_vals=ints(s.coo_vals))
    x = np.random.default_rng(4).integers(-4, 5, s.n).astype(np.float32)
    return s, x


KERNEL_CASES = [(("block_clustered", 16), 4), (("block_clustered", 24), 7),
                (("bucket_widths", 8, True), 4), (("banded", 24), 7),
                (("power_law", 24), 4), (("empty_rows_cols", 16), 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("scn,G", KERNEL_CASES,
                         ids=[f"{s[0]}-B{s[1]}-G{g}" for s, g in KERNEL_CASES])
def test_cuda_kernels_vs_plain_on_the_card(scn, G):
    """The CUDA kernels against their plain versions (test_torch_kernels.py)."""
    _need_card()
    _, _, cb = _scenario(*scn)
    ts, x = _integer_streams(cb, G)
    s, x = ts.to("cuda"), torch.from_numpy(x).cuda()
    B = s.block_size
    if s.num_dense_groups:
        xg = x[s.dense_xidx.long()]
        assert torch.equal(t_dense.block_dense_spmv_batched(s.dense_tiles, xg),
                           t_dense.block_dense_spmv_plain(s.dense_tiles, xg))
    if s.num_panel_groups:
        xg = x[s.panel_xidx.long()]
        assert torch.equal(t_panel.panel_spmv_batched(s.panel_vals, xg),
                           t_panel.panel_spmv_plain(s.panel_vals, xg))
    if s.num_coo_groups:
        assert torch.equal(
            t_coo.coo_spmv_batched(s.coo_codes, s.coo_vals, s.coo_xidx, x, block_size=B),
            t_coo.coo_spmv_plain(s.coo_codes, s.coo_vals, s.coo_xidx, x, block_size=B))


def _coo_stream(case, dtype, rng):
    """(codes, vals, xidx, x) on the card, integer-valued (every sum exact):
    ``padding``, a random stream whose zero lanes carry xidx 0; ``hub``, the
    COO blocks of a hub row over every block column; ``big_x``, indices over
    an x of 16 M entries (64 MB, more than L2 holds)."""
    B = 16
    if case == "hub":
        rows, cols, vals, shape = _hub_with_a_dense_block()
        cb = CBMatrix.from_coo(rows, cols, vals, shape, block_size=B)
        s = tstreams.build_super_streams(cb)
        codes, xidx = s.coo_codes, s.coo_xidx
        vals = torch.from_numpy(rng.integers(1, 8, codes.shape)) * (s.coo_vals != 0)
        n = shape[1]
    else:
        gc, W, n = (37, 8 * 129, 4096) if case == "padding" else (256, 4096, 1 << 24)
        rows = torch.from_numpy(rng.integers(0, B, (gc, W)))
        cols = torch.from_numpy(rng.integers(0, 1 << 14, (gc, W)))
        codes = ((cols << t_coo.row_mask(B).bit_length()) | rows).to(torch.int32)
        vals = torch.from_numpy(rng.integers(-7, 8, (gc, W)))
        vals[:, W // 2:] *= torch.from_numpy(rng.random((gc, W - W // 2)) < 0.5)
        xidx = torch.from_numpy(rng.integers(0, n, (gc, W))).masked_fill(vals == 0, 0)
    x = torch.from_numpy(rng.integers(-4, 5, n).astype(np.float32))
    return (codes.to(torch.int32).cuda(), vals.to(dtype).cuda(), xidx.to(torch.int32).cuda(),
            x.cuda(), B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64],
                         ids=["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("case", ["padding", "hub", "big_x"])
def test_coo_kernel_reads_x_by_index_on_the_card(case, dtype):
    """The COO kernel, which reads ``x[xidx]`` itself, equals its plain
    version bit for bit, and counts its launch."""
    _need_card()
    codes, vals, xidx, x, B = _coo_stream(case, dtype, np.random.default_rng(7))
    before = t_coo.coo_spmv_batched.launches
    got = t_coo.coo_spmv_batched(codes, vals, xidx, x, block_size=B)
    assert t_coo.coo_spmv_batched.launches == before + 1
    want = t_coo.coo_spmv_plain(codes, vals, xidx, x, block_size=B)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.abs().sum() > 0


# -- tests/test_torch_panel_compact.py: the bitmap panel kernel -----------------------

def _stencil_cb(n):
    rows, cols, vals = matrices.stencil_27(n)
    return CBMatrix.from_coo(rows, cols, vals.astype(np.float32), (n ** 3, n ** 3),
                             block_size=16, val_dtype=np.float32)


def _synthetic_panels(B, W, density, groups=5, seed=3):
    """Random panels at a given share of filled lanes: rows that cross several
    32-slot stretches, passes and 32-value pieces of ``cvals``."""
    g = torch.Generator().manual_seed(seed)
    vals = torch.randn((groups, B, W), generator=g)
    return vals * (torch.rand((groups, B, W), generator=g) < density)


BITMAP_CASES = [("stencil", 32), ("banded", 24), ("bucket_widths", 8, True),
                ("block_clustered", 16), ("power_law", 24), ("empty_rows_cols", 16),
                ("synthetic", 16, 8 * 600, 0.3), ("synthetic", 24, 264, 1.0),
                ("synthetic", 8, 8 * 129, 0.05)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", BITMAP_CASES, ids=["-".join(map(str, c)) for c in BITMAP_CASES])
def test_bitmap_panel_kernel_bit_equal_to_the_padded_on_the_card(case, dtype):
    """On random (not integer) payloads and x: the encoding derived on the card
    rebuilds the panels, and the bitmap kernel's partials are
    ``torch.equal`` to the padded kernel's."""
    _need_card()
    if case[0] == "synthetic":
        panels = _synthetic_panels(*case[1:]).to(dtype).cuda()
        xg = torch.randn(panels.shape[0], panels.shape[2], device="cuda")
    else:
        cb = _stencil_cb(case[1]) if case[0] == "stencil" else _scenario(*case)[2]
        s = tstreams.build_super_streams(cb, group_size=None if case[0] == "stencil" else 4)
        s = s.to("cuda")
        assert s.num_panel_groups
        panels = s.panel_vals.to(dtype)
        xg = torch.randn(s.n, device="cuda")[s.panel_xidx.long()]
    enc = t_panel.compact_panels(panels)
    assert torch.equal(t_panel.panel_decode(enc.cvals, enc.mask), panels)
    before = t_panel.panel_spmv_bitmap.launches
    got = t_panel.panel_spmv_bitmap(enc.cvals, enc.mask, xg)
    assert t_panel.panel_spmv_bitmap.launches == before + 1
    want = t_panel.panel_spmv_batched(panels, xg)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _padded_call(s, x):
    """y = A x as ``_accumulate`` made it before the bitmap layout: the padded
    panel kernel, the other formats' kernels, the same combine."""
    prep = tops._prepare(s, None)
    B = s.block_size
    parts = torch.empty((prep.brow.numel(), B), dtype=torch.float32, device=x.device)
    nd, npn = s.dense_brow.numel(), s.panel_brow.numel()
    if s.num_dense_groups:
        t_dense.block_dense_spmv_batched(s.dense_tiles, tops._gather(x, s.dense_xidx),
                                         out=parts[:nd].view(s.dense_xidx.shape))
    t_panel.panel_spmv_batched(s.panel_vals, tops._gather(x, s.panel_xidx),
                               out=parts[nd:nd + npn].view(*s.panel_brow.shape, B))
    if s.num_coo_groups:
        t_coo.coo_spmv_batched(s.coo_codes, s.coo_vals, s.coo_xidx, x, block_size=B,
                               out=parts[nd + npn:].view(*s.coo_brow.shape, B))
    return t_combine.segment_combine(torch.zeros(s.m, dtype=torch.float32, device=x.device),
                                     parts, prep.brow, B, prep.combine)


@pytest.mark.cuda
@pytest.mark.parametrize("structure", ["stencil", "banded"])
def test_cb_spmv_on_bitmap_panels_is_bit_equal_to_the_padded_path_on_the_card(structure):
    """``cb_spmv`` runs the bitmap kernel, and its y is bit-equal to a y
    assembled from the padded partials through the same ``segment_combine``."""
    _need_card()
    cb = _stencil_cb(32) if structure == "stencil" else _scenario("banded", 16)[2]
    s = tstreams.build_super_streams(cb).to("cuda")
    x = torch.randn(s.n, device="cuda")
    before = t_panel.panel_spmv_bitmap.launches
    y = tops.cb_spmv(s, x)
    assert t_panel.panel_spmv_bitmap.launches == before + 1
    assert tops._panel_encoding(tops._prepare(s, None)) is not None
    assert torch.equal(y, _padded_call(s, x))
    y_acc = torch.ones(s.m, device="cuda")
    assert torch.equal(tops.cb_spmv_into(y_acc, s, x), torch.ones(s.m, device="cuda") + y)


@pytest.mark.cuda
def test_an_updated_stream_reads_its_own_bitmap_encoding_on_the_card(monkeypatch):
    """The updater's template (zero payload) runs first and derives its own
    encoding; ``apply(v)`` hands the new stream the template's prepared state
    and its own encoding, scattered from v (it derives none), and its product
    is bit-equal to a fresh build's: it never reads the template's encoding."""
    _need_card()
    cb = _stencil_cb(16)
    upd = tstreams.super_stream_updater(cb).to("cuda")
    x = torch.randn(cb.shape[1], device="cuda")
    assert not tops.cb_spmv(upd.template, x).any()
    v = np.random.default_rng(5).uniform(0.5, 2.0, cb.nnz).astype(np.float32)
    new = upd.apply(v)
    with monkeypatch.context() as m:
        m.setattr(t_panel, "compact_panels", None)          # a derivation would fail here
        y_new = tops.cb_spmv(new, x)
    fresh = tstreams.build_super_streams(cb.update_values(v)).to("cuda")
    y_fresh = tops.cb_spmv(fresh, x)
    assert y_new.any() and torch.equal(y_new, y_fresh)
    enc_new = tops._panel_encoding(tops._prepare(new, None))
    enc_fresh = tops._panel_encoding(tops._prepare(fresh, None))
    assert torch.equal(enc_new.cvals, enc_fresh.cvals) and torch.equal(enc_new.mask, enc_fresh.mask)


@pytest.mark.cuda
def test_the_bitmap_wrapper_refuses_misaligned_storage_on_the_card():
    """``mask`` and ``cvals`` one byte (one value) past an aligned base: the
    wrapper refuses both before the kernel's 16-byte copies could fault."""
    _need_card()
    enc = t_panel.compact_panels(_synthetic_panels(16, 64, 0.3).cuda())
    xg = torch.randn(enc.mask.shape[0], 64, device="cuda")
    buf = torch.empty(enc.mask.numel() + 1, dtype=torch.uint8, device="cuda")
    mask = buf[1:].view(enc.mask.shape)
    mask.copy_(enc.mask)
    assert mask.is_contiguous() and mask.data_ptr() % 16 == 1
    with pytest.raises(Exception, match="mask: storage must be 16-byte aligned"):
        t_panel.panel_spmv_bitmap(enc.cvals, mask, xg)
    cbuf = torch.empty(enc.cvals.numel() + 1, device="cuda")
    cvals = cbuf[1:].view(enc.cvals.shape)
    cvals.copy_(enc.cvals)
    with pytest.raises(Exception, match="cvals: storage must be 16-byte aligned"):
        t_panel.panel_spmv_bitmap(cvals, enc.mask, xg)
    torch.cuda.synchronize()


TRAP_RUN = """
import torch
from repro_torch.kernels import cb_colagg
enc = cb_colagg.compact_panels(torch.eye(16).repeat(3, 1, {w} // 16).cuda())
mask = enc.mask.clone()
if {bad}:
    mask[1, 5] = 255                 # eight lanes a slot: more than the row's E values
out = cb_colagg.panel_spmv_bitmap(enc.cvals, mask, torch.ones(3, {w}, device="cuda"))
torch.cuda.synchronize()
print("no trap")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 8 * 600], ids=["staged", "in_place"])
def test_the_bitmap_kernel_stops_on_a_mask_past_its_row_on_the_card(width):
    """A mask that holds more lanes than a row of ``cvals`` has values stops
    the kernel (``__trap``) in both of its forms, rather than read past the
    row; the fault poisons the context, so it runs in a process of its own."""
    _need_card()
    import subprocess
    import sys

    def run(bad):
        return subprocess.run([sys.executable, "-c", TRAP_RUN.format(w=width, bad=bad)],
                              capture_output=True, text=True, timeout=300)

    ok, proc = run(False), run(True)
    assert ok.returncode == 0 and "no trap" in ok.stdout, ok.stdout + ok.stderr
    assert proc.returncode != 0 and "no trap" not in proc.stdout, proc.stdout + proc.stderr
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr, proc.stderr


@pytest.mark.cuda
def test_an_inf_at_a_padding_lane_stays_out_of_the_bitmap_partials_on_the_card():
    """Pins how the layouts differ on non-finite x: an inf in x at a lane a
    row's group holds but the row does not makes the padded partial NaN
    (0 * inf) and leaves the bitmap one finite, so ``cb_spmv``'s y on the card
    is finite there where the CPU path's is NaN; elsewhere they agree."""
    _need_card()
    s = tstreams.build_super_streams(_stencil_cb(8))
    x = torch.randn(s.n, generator=torch.Generator().manual_seed(2))
    held = (s.panel_vals != 0).any(1, keepdim=True) & (s.panel_xidx != 0).unsqueeze(1)
    g, r, lane = ((s.panel_vals == 0) & held).nonzero()[0].tolist()   # another row's lane
    col = int(s.panel_xidx[g, lane])
    x[col] = float("inf")
    sc, xc = s.to("cuda"), x.cuda()
    enc = tops._panel_encoding(tops._prepare(sc, None))
    xg = xc[sc.panel_xidx.long()]
    padded = t_panel.panel_spmv_batched(sc.panel_vals, xg)
    bitmap = t_panel.panel_spmv_bitmap(enc.cvals, enc.mask, xg)
    assert padded[g, lane // 8, r].isnan() and bitmap[g, lane // 8, r].isfinite()
    y_card, y_cpu = tops.cb_spmv(sc, xc).cpu(), tops.cb_spmv(s, x, device="cpu")
    differ = y_card.isfinite() & y_cpu.isnan()
    assert differ.any()
    keep = ~differ
    assert torch.equal(y_card[keep].isnan(), y_cpu[keep].isnan())
    assert torch.equal(y_card[keep].isinf(), y_cpu[keep].isinf()) and y_cpu.isinf().any()
    assert torch.allclose(y_card[keep & y_cpu.isfinite()], y_cpu[keep & y_cpu.isfinite()],
                          rtol=1e-5, atol=1e-5)


# -- tests/test_torch_tracing.py: every kernel a call launches, in the registry -------

def _hub_with_a_dense_block(seed=0):
    """A hub row over every block column (its block row is longer than one
    combine chunk, so the combine takes its second pass), the diagonal in
    COO blocks and one dense 16 x 16 block."""
    m, n = 256, 1024
    bi, bj = np.meshgrid(np.arange(128, 144), np.arange(512, 528), indexing="ij")
    rows = np.concatenate([np.zeros(n // 4, np.int64), np.arange(m), bi.ravel()])
    cols = np.concatenate([np.arange(0, n, 4), np.arange(m), bj.ravel()])
    keys = np.unique(rows * n + cols)
    rows, cols = keys // n, keys % n
    vals = np.random.default_rng(seed).standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals, (m, n)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["spmv", "spmv_into"])
def test_registry_launches_equal_the_profilers_kernels_on_the_card(entry, tmp_path):
    """``repro.ops.{entry}.launches`` per call, every series summed, is the
    number of kernels the profiler sees a call run; each call is one
    ``user_annotation`` of its span's name."""
    _need_card()
    rows, cols, vals, shape = _hub_with_a_dense_block()
    cb = CBMatrix.from_coo(rows, cols, vals, shape, block_size=16)
    s = tstreams.build_super_streams(cb).to("cuda")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape[1])
                         .astype(np.float32)).cuda()
    y = torch.zeros(shape[0], device="cuda")

    def call():
        if entry == "spmv":
            return tops.cb_spmv(s, x)
        return tops.cb_spmv_into(y, s, x)

    call()
    assert len(tops._prepare(s, None).combine.passes) == 2
    assert tops.spmv_launch_stats(s)["launches"] == {"dense": 1, "panel": 0, "coo": 1}
    torch.cuda.synchronize()
    obs.reset()
    calls = 8
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    path = tmp_path / "calls.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == f"cb_{entry}"]
    launches = obs.counter(f"repro.ops.{entry}.launches").total()
    assert obs.counter(f"repro.ops.{entry}.calls").value(impl="cuda") == calls
    assert len(spans) == calls
    # dense's gather, the dense and COO kernels, two combine passes (and y's fill):
    # the COO kernel reads x itself, so no gather is counted or run for it
    assert obs.counter(f"repro.ops.{entry}.launches").value(format="gather") == calls
    assert launches / calls == len(kernels) / calls == (6 if entry == "spmv" else 5)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["spmv", "spmv_into"])
def test_registry_launches_equal_the_profilers_kernels_on_a_panel_stream(entry, tmp_path):
    """On the 32^3 stencil (panels and COO): the registry's launches per call are
    the kernels the profiler sees, one of them the bitmap panel kernel, and
    ``compact_elems{format=panel}`` counts its value slots every call."""
    _need_card()
    s = tstreams.build_super_streams(_stencil_cb(32)).to("cuda")
    x = torch.randn(s.n, device="cuda")
    y = torch.zeros(s.m, device="cuda")

    def call():
        if entry == "spmv":
            return tops.cb_spmv(s, x)
        return tops.cb_spmv_into(y, s, x)

    call()
    enc = tops._panel_encoding(tops._prepare(s, None))
    torch.cuda.synchronize()
    obs.reset()
    calls = 8
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    path = tmp_path / "calls.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    launches = obs.counter(f"repro.ops.{entry}.launches")
    assert launches.value(format="panel") == calls
    assert obs.counter(f"repro.ops.{entry}.compact_elems").value(format="panel") == \
        calls * enc.elems > 0
    seen = collections.Counter(k.split("(")[0] for k in kernels)
    assert sum("cb_panel_kernel_bitmap" in k for k in kernels) == calls, seen
    assert sum("cb_panel_kernel" in k for k in kernels) == calls, seen  # the padded one ran not
    assert launches.total() == len(kernels), seen


# -- tests/test_torch_spmv.py: cb_spmv end to end -------------------------------------

@pytest.mark.cuda
def test_cuda_path_bit_equal_runs_on_the_card():
    """impl='cuda' on the card: right, and the same bits twice."""
    _need_card()
    (rows, cols, vals), shape, cb = _scenario("block_clustered", 16)
    s = tstreams.build_super_streams(cb).to()
    x = np.random.default_rng(3).standard_normal(shape[1]).astype(np.float32)
    y = tops.cb_spmv(s, x)
    assert y.is_cuda and torch.equal(y, tops.cb_spmv(s, x))
    np.testing.assert_allclose(y.cpu().numpy(), dense_oracle(rows, cols, vals, shape, x),
                               rtol=3e-4, atol=3e-4)


# -- tests/test_torch_spmm.py: the SpMM kernel ------------------------------------------

# (B, Gt, groups, nb, N, tile dtype, X dtype, X offset): the plain cases, then
# the tensor-core kernel at B not a multiple of 16 or of 8, N past its
# 2048-column block, X a view one element past an aligned base (4-byte
# copies), and the solver's multi-RHS shape (one warp per slot, many groups)
SPMM_CASES = [
    (8, 4, 3, 5, 20, "float32", "float32", 0),
    (16, 1, 5, 4, 1, "float32", "float32", 0),
    (24, 16, 2, 3, 100, "bfloat16", "float32", 0),
    (16, 4, 2, 6, 129, "float64", "bfloat16", 0),
    (128, 1, 1, 2, 129, "float32", "float32", 0),
    (128, 2, 1, 2, 20, "bfloat16", "bfloat16", 0),
    (64, 2, 3, 4, 129, "float32", "float32", 0),
    (100, 2, 3, 4, 20, "bfloat16", "float32", 0),
    (128, 1, 2, 3, 1025, "float32", "float32", 0),
    (128, 1, 2, 3, 2049, "float64", "bfloat16", 0),
    (128, 2, 2, 3, 20, "float32", "float32", 1),
    (16, 1, 3, 4, 20, "float32", "float32", 1),
    (16, 16, 200, 300, 16, "float32", "float32", 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPMM_CASES, ids=[f"B{c[0]}-G{c[1]}-N{c[4]}"
                                                  + (f"-offset{c[7]}" if c[7] else "")
                                                  for c in SPMM_CASES])
def test_cuda_kernel_vs_plain_on_the_card(case):
    """The CUDA kernel against its plain version (test_torch_spmm.py): integer
    data bit for bit, normal data within 1e-4 of the largest value
    (``chip_smoke.py``'s ``KERNEL_TOL``)."""
    _need_card()
    B, Gt, gt, nb, N, tdt, xdt, off = case
    g = torch.Generator().manual_seed(B)
    for integer in (True, False):
        def draw(shape):
            return (torch.randint(-4, 5, shape, generator=g).float() if integer
                    else torch.randn(shape, generator=g))
        tiles = draw((gt, Gt * B, B)).to(getattr(torch, tdt)).cuda()
        bcol = torch.randint(0, nb, (gt, Gt), generator=g).to(torch.int32).cuda()
        Xb = draw((nb * B * N + off,)).to(getattr(torch, xdt)).cuda()[off:].view(nb, B, N)
        got = t_spmm.super_tile_spmm(tiles, bcol, Xb)
        want = t_spmm.super_tile_spmm_plain(tiles, bcol, Xb)
        if integer:
            assert torch.equal(got, want)
        else:
            err = float((got - want).abs().max())
            assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


# -- tests/test_torch_sparse_linear.py: the sparse layer ----------------------------------

@pytest.mark.cuda
def test_layer_on_the_card_matches_reference():
    """Forward and both gradients through the CUDA kernel against the plain
    reference layer, and the same bits twice (test_torch_sparse_linear.py)."""
    _need_card()
    spec = TL.cb_spec_random(512, 384, block_size=128, keep_fraction=0.25, seed=3)
    g = torch.Generator(device="cuda").manual_seed(0)
    tiles = TL.cb_tiles_init(g, spec)["tiles"]
    x = torch.randn(64, 512, device="cuda", generator=g)
    outs = []
    for impl in ("cuda", "cuda", "reference"):
        t, xx = tiles.clone().requires_grad_(True), x.clone().requires_grad_(True)
        y = TL.cb_linear_apply({"tiles": t}, spec, xx, impl=impl)
        y.square().sum().backward()
        outs.append((y.detach(), xx.grad, t.grad))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0], outs[2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# -- tests/test_torch_solvers.py: a solver on the kernels ---------------------------------

@pytest.mark.cuda
def test_solvers_on_the_card_match_the_reference():
    """CG with the CUDA kernels: the reference's iterations, and the same
    bits twice (test_torch_solvers.py)."""
    _need_card()
    rows, cols, vals = matrices.spd_banded(96, bandwidth=7, seed=3)
    tcb = CBMatrix.from_coo(rows, cols, vals.astype(np.float32), (96, 96), block_size=16,
                            val_dtype=np.float32)
    op = tsolvers.CBLinearOperator.from_cb(tcb)
    M = tsolvers.block_jacobi(tcb)
    b = np.random.default_rng(0).standard_normal(96).astype(np.float32)
    res = tsolvers.cg(op, b, M, tol=1e-6, maxiter=500)
    ref = tsolvers.cg(op, b, M, tol=1e-6, maxiter=500, impl="reference")
    assert res.x.is_cuda and bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    assert torch.equal(res.x, tsolvers.cg(op, b, M, tol=1e-6, maxiter=500).x)


# -- plans on the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_timed_plan_search_runs_the_kernels_on_the_card():
    """``mode="timed"`` times ``cb_spmv(impl="cuda")`` on the card: the wrappers'
    counters move, the plan records its time, and the planned call agrees
    with the float64 oracle and repeats bit for bit."""
    _need_card()
    from repro_torch.autotune import SearchSettings

    (rows, cols, vals), shape, _ = _scenario("power_law", 16)
    def format_launches():
        return (t_coo.coo_spmv_batched.launches + t_panel.panel_spmv_batched.launches
                + t_panel.panel_spmv_bitmap.launches)

    before = format_launches()
    plan = CBMatrix.plan_for(rows, cols, vals, shape,
                             settings=SearchSettings(mode="timed", timing_reps=3))
    assert plan.mode == "timed" and plan.t_spmv > 0
    assert format_launches() > before
    cb = CBMatrix.from_plan(rows, cols, vals, shape, plan)
    s = tstreams.build_super_streams(cb, group_size=plan.group_size).to()
    x = np.random.default_rng(3).standard_normal(shape[1]).astype(np.float32)
    y = tops.cb_spmv(s, x, plan=plan)
    assert torch.equal(y, tops.cb_spmv(s, x, plan=plan))
    np.testing.assert_allclose(y.cpu().numpy(), dense_oracle(rows, cols, vals, shape, x),
                               rtol=3e-4, atol=3e-4)


# -- serving on the card (tests/test_torch_models.py, tests/test_torch_serving.py) -----

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2.0**-5)])
def test_cb_paper_decode_on_the_card_matches_the_cpu(dtype, tol):
    """Teacher-forced decode of smoke-width cb-paper on the card (the sparse
    MLP on ``csrc/cb_spmm.cu`` and the combine) against the same weights on
    the CPU plain path; the tolerances of ``tests/test_torch_models.py``."""
    _need_card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model

    cfg = get_smoke_config("cb-paper").scaled(dtype=dtype)
    cpu, card = Model(cfg, "cpu"), Model(cfg, "cuda")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_card = card.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(p_card.parameters(), p_cpu.parameters()))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 6)))
    st_cpu, st_card = cpu.init_decode_state(3, 8), card.init_decode_state(3, 8)
    before = t_spmm.super_tile_spmm.launches
    for t in range(toks.shape[1]):
        pos = torch.full((3,), t, dtype=torch.int32)
        want, st_cpu = cpu.decode_step(p_cpu, st_cpu, toks[:, t:t + 1], pos)
        got, st_card = card.decode_step(p_card, st_card, toks[:, t:t + 1].cuda(), pos.cuda())
        assert got.is_cuda and got.dtype == cfg.activation_dtype
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float().cpu() - want.float()).abs().max().item() <= tol * scale
    assert t_spmm.super_tile_spmm.launches - before == 3 * cfg.num_layers * toks.shape[1]


@pytest.mark.cuda
def test_engine_tokens_bit_equal_over_two_runs_on_the_card():
    _need_card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine

    model = Model(get_smoke_config("cb-paper"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, rng.integers(2, 12)).astype(np.int32)
               for _ in range(6)]
    runs = []
    for _ in range(2):
        eng = ServingEngine(model, params, slots=4, max_len=64)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=8))
        runs.append({r.uid: r.generated for r in eng.run_until_done()})
    assert sorted(runs[0]) == list(range(6)) and all(len(g) == 8 for g in runs[0].values())
    assert runs[0] == runs[1]


# -- training on the card (tests/test_torch_training.py) -------------------------------

def _train_on(device, cfg, steps, seed=0, mesh=None):
    """``run_training`` of a smoke-width model on ``device`` (on ``mesh`` when
    given) from the weights of a CPU generator seeded ``seed``; returns
    (state, history, spmm launches)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
    from repro_torch.models import Model
    from repro_torch.training import OPTIMIZERS, TrainLoopConfig, TrainState, run_training

    model = Model(cfg, device, mesh=mesh)
    state = TrainState.create(model.init(torch.Generator().manual_seed(seed)),
                              OPTIMIZERS["adamw"]())
    stream = SyntheticTokenStream(DataConfig(cfg.vocab_size, seq_len=32, global_batch=4))
    before = t_spmm.super_tile_spmm.launches
    state, hist = run_training(model, stream, TrainLoopConfig(
        total_steps=steps, log_every=1, warmup_steps=1), initial_state=state)
    return state, hist, t_spmm.super_tile_spmm.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2.0**-5)])
def test_cb_paper_training_on_the_card_matches_the_cpu(dtype, tol):
    """Three steps of smoke-width cb-paper under full remat on the card (the
    sparse MLP's forward, recompute and dX on ``csrc/cb_spmm.cu`` and the
    combine) against the same run on the CPU plain path: the losses within
    the forward's tolerance (``tests/test_torch_models.py``), every parameter
    within the most three Adam steps at the schedule's lr can move it apart
    (2 lr a step), a second run on the card bit-equal, and 9 spmm launches a
    layer a step."""
    _need_card()
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("cb-paper").scaled(dtype=dtype, remat="full")
    card, hist, launches = _train_on("cuda", cfg, 3)
    cpu, want, _ = _train_on("cpu", cfg, 3)
    assert launches == 3 * 9 * cfg.num_layers
    for a, b in zip(hist, want):
        assert abs(a["loss"] - b["loss"]) <= tol * max(1.0, abs(b["loss"]))
    lr_sum = sum(h["lr"] for h in want)
    for p, q in zip(card.params.parameters(), cpu.params.parameters()):
        assert p.is_cuda and (p.cpu() - q).abs().max().item() <= 2 * lr_sum + 1e-6
    again, hist2, _ = _train_on("cuda", cfg, 3)
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist]
    assert all(torch.equal(p, q) for p, q in zip(card.params.parameters(),
                                                 again.params.parameters()))


# -- tests/test_torch_distributed.py: distributed_spmv on one NCCL rank ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["psum_scatter", "psum"])
def test_distributed_spmv_on_one_nccl_rank(tmp_path, combine):
    """``distributed_spmv`` at D = 1 over a real NCCL group on the card: the
    kernels on the rank's shard, then the collective; y against single-device
    ``cb_spmv`` (another order of the same float32 sums) and the float64
    oracle, the same bits twice, and ``Shard(0)`` under ``psum_scatter``."""
    _need_card()
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core import distributed as tdist
    from repro_torch.launch.mesh import make_mesh

    m = n = 4096
    rows, cols, vals = matrices.power_law(m, n, seed=7)
    vals = vals.astype(np.float32)
    cb = CBMatrix.from_coo(rows, cols, vals, (m, n), block_size=16, val_dtype=np.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32)).cuda()
    single = tops.cb_spmv(tstreams.build_super_streams(cb).to(), x)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1,), ("model",))
        sh = tdist.shard_streams(cb, 1)
        y = tdist.distributed_spmv(sh, x, mesh, combine=combine)
        again = tdist.distributed_spmv(sh, x, mesh, combine=combine)
        if combine == "psum_scatter":
            assert isinstance(y, DTensor) and y.placements == (Shard(0),)
            y, again = y.full_tensor(), again.full_tensor()
        assert y.is_cuda and torch.equal(y, again)
        assert (y - single).abs().max().item() <= 1e-4 * max(1.0, single.abs().max().item())
        np.testing.assert_allclose(y.cpu().numpy(), dense_oracle(rows, cols, vals, (m, n),
                                                                 x.cpu().numpy()),
                                   rtol=3e-4, atol=3e-4)
    finally:
        dist.destroy_process_group()


# -- tests/test_torch_mesh.py: training on a one-rank NCCL mesh --------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["cb-paper", "mixtral-8x7b"])
def test_training_on_a_one_rank_nccl_mesh_is_bit_equal(tmp_path, arch):
    """Three steps of smoke-width training on a (data 1, model 1) NCCL mesh
    (``Model(cfg, mesh=)``, DTensor parameters, the batch placed over
    ``batch``) against the same steps without a mesh: the losses and every
    parameter bit-equal (a one-rank collective runs nothing), and the same
    spmm launches (9 a layer a step for cb-paper)."""
    _need_card()
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh

    cfg = get_smoke_config(arch).scaled(remat="full")
    local, hist, launches = _train_on("cuda", cfg, 3)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        on_mesh, mhist, mlaunches = _train_on("cuda", cfg, 3, mesh=mesh)
        assert all(isinstance(p, DTensor) for p in on_mesh.params.parameters())
        assert [h["loss"] for h in mhist] == [h["loss"] for h in hist]
        assert mlaunches == launches
        assert all(torch.equal(p.to_local(), q) for p, q in zip(on_mesh.params.parameters(),
                                                                local.params.parameters()))
    finally:
        dist.destroy_process_group()


# -- the MoE, SSM, hybrid and encoder-decoder families (tests/test_torch_moe.py, -----
# -- test_torch_ssm.py, test_torch_hybrid_encdec.py) -------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch, expert_shard", [
    ("mixtral-8x7b", None), ("llama4-maverick-400b-a17b", None),
    ("llama4-maverick-400b-a17b", (1, 2)), ("mamba2-130m", None), ("zamba2-2.7b", None),
    ("whisper-small", None)])
def test_family_decode_on_the_card_matches_the_cpu(arch, expert_shard):
    """Teacher-forced ``decode_step`` of the smoke config (bfloat16) on the card
    against the same weights on the CPU, within 2^-5 of the logits' scale
    (the bfloat16 bound of the parity tests), and two card runs bit-equal.
    Whisper decodes over ``precompute_cross`` of seeded frames; llama4 also
    with its MoE layers holding half of the experts."""
    _need_card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model, encdec

    cfg = get_smoke_config(arch)
    cpu = Model(cfg, "cpu", expert_shard=expert_shard)
    card = Model(cfg, "cuda", expert_shard=expert_shard)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_card = card.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((3, max(cfg.num_frames, 1), cfg.d_model))
                              .astype(np.float32)).to(cfg.activation_dtype)

    def run(model, params, dev):
        st = model.init_decode_state(3, 8)
        if cfg.family == "encdec":
            st["cross"] = encdec.precompute_cross(params, cfg, frames.to(dev))
        out = []
        for t in range(toks.shape[1]):
            pos = torch.full((3,), t, dtype=torch.int32, device=dev)
            lg, st = model.decode_step(params, st, toks[:, t:t + 1].to(dev), pos)
            out.append(lg)
        return torch.stack(out, 1)

    want = run(cpu, p_cpu, "cpu")
    got = run(card, p_card, "cuda")
    assert got.is_cuda and got.dtype == cfg.activation_dtype and torch.isfinite(got).all()
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float().cpu() - want.float()).abs().max().item() <= 2.0**-5 * scale
    assert torch.equal(got, run(card, p_card, "cuda"))
