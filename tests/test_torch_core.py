"""Port parity, host pipeline: ``repro_torch.core`` / ``.data`` / ``.errors``
against the JAX package's modules of the same names.

The same numpy triplets go through ``repro`` and ``repro_torch``; every host
artefact must come out bit-equal (formats, packed bytes, balance slots,
saved files and their sha256), because stream parity and artefact exchange
between the two packages rest on it.
"""
import ast
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro import errors as jerrors
from repro.core import CBMatrix as JaxCBMatrix
from repro.core import aggregation as jagg
from repro.core import balance as jbalance
from repro.core import blocking as jblocking
from repro.core import column_agg as jcolagg
from repro.core import formats as jformats
from repro.core.spmv_ref import dense_oracle as j_dense_oracle
from repro.core.spmv_ref import spmv_ref as j_spmv_ref
from repro.data import matrices as jmatrices
from repro_torch import errors as terrors
from repro_torch.core import CBMatrix as TorchCBMatrix
from repro_torch.core import aggregation as tagg
from repro_torch.core import balance as tbalance
from repro_torch.core import blocking as tblocking
from repro_torch.core import column_agg as tcolagg
from repro_torch.core import formats as tformats
from repro_torch.core.spmv_ref import dense_oracle as t_dense_oracle
from repro_torch.core.spmv_ref import spmv_ref as t_spmv_ref
from repro_torch.core import streams as tstreams
from repro_torch.data import matrices as tmatrices
from repro_torch.kernels import ops as tops

import torch_port as tp

SCENARIOS = tp.scenario_cut()
REPO = pathlib.Path(__file__).resolve().parent.parent

CB_ARRAYS = ("blk_row_idx", "blk_col_idx", "nnz_per_blk", "type_per_blk",
             "vp_per_blk", "packed")


def _same(a, b, tag=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (tag, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=str(tag))


# ---------------------------------------------------------------------------
# the CB structure over the scenario grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scn", SCENARIOS, ids=tp.ids(SCENARIOS))
def test_cb_matrix_bit_equal(scn):
    """Formats, packed bytes, VPs, colagg maps and balance slots."""
    jcb, tcb = scn.build(), tp.torch_cb(scn)
    for f in CB_ARRAYS:
        _same(getattr(tcb, f), getattr(jcb, f), f)
    for f in ("new_cols", "restore_cols", "cols_offset", "panel_width"):
        _same(getattr(tcb.colagg, f), getattr(jcb.colagg, f), f)
    assert tcb.colagg.applied == jcb.colagg.applied
    _same(tcb.balance_result.slots, jcb.balance_result.slots, "slots")
    _same(tcb.balance_result.group_loads, jcb.balance_result.group_loads, "loads")
    assert (tcb.nnz, tcb.shape, tcb.val_dtype) == (jcb.nnz, jcb.shape, jcb.val_dtype)
    assert tcb.stats() == jcb.stats()
    assert tcb.nbytes_structure() == jcb.nbytes_structure()
    tcb.validate(check_finite=True)


@pytest.mark.parametrize("scn", SCENARIOS[::3], ids=tp.ids(SCENARIOS[::3]))
def test_decoders_match(scn):
    """to_coo / to_dense / spmv_ref / iter_blocks against the JAX package's,
    and the whole-matrix decoder against the per-block walk."""
    jcb, tcb = scn.build(), tp.torch_cb(scn)
    for got, want in zip(tcb.to_coo(), jcb.to_coo()):
        _same(got, want, "to_coo")
    _same(tcb.to_dense(), jcb.to_dense(), "to_dense")
    x = np.random.default_rng(5).standard_normal(tcb.shape[1]).astype(np.float32)
    np.testing.assert_allclose(t_spmv_ref(tcb, x), j_spmv_ref(jcb, x),
                               rtol=1e-5, atol=1e-5)
    blocks_t, blocks_j = list(tcb.iter_blocks()), list(jcb.iter_blocks())
    assert len(blocks_t) == len(blocks_j)
    for bt, bj in zip(blocks_t, blocks_j):
        assert bt[:3] == bj[:3]
        for got, want in zip(bt[3:], bj[3:]):
            _same(got, want, "iter_blocks")
    for fmt in (tformats.FMT_COO, tformats.FMT_CSR, tformats.FMT_DENSE):
        walk = [b for b in blocks_t if b[2] == fmt]
        slots, blk, r, c, v = tcb.format_elements(fmt)
        assert len(slots) == len(walk)
        if walk:
            _same(r, np.concatenate([b[3] for b in walk]), "rows")
            _same(c, np.concatenate([b[4] for b in walk]), "cols")
            _same(v, np.concatenate([b[5] for b in walk]), "vals")
            _same(np.bincount(blk, minlength=len(walk)),
                  np.asarray([len(b[5]) for b in walk]), "per-block counts")


@pytest.mark.parametrize("scn", SCENARIOS[::4], ids=tp.ids(SCENARIOS[::4]))
def test_npz_cross_load_same_sha256(scn, tmp_path):
    """A file saved by either package loads and validates in the other,
    and both write the same checksum."""
    jcb, tcb = scn.build(), tp.torch_cb(scn)
    jcb.save(tmp_path / "j.npz")
    tcb.save(tmp_path / "t.npz")
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert str(zj["checksum"]) == str(zt["checksum"])
    from_j = TorchCBMatrix.load(tmp_path / "j.npz")
    from_t = JaxCBMatrix.load(tmp_path / "t.npz")
    for f in CB_ARRAYS:
        _same(getattr(from_j, f), getattr(tcb, f), f)
        _same(getattr(from_t, f), getattr(jcb, f), f)
    assert from_j.thresholds == tcb.thresholds and from_j.val_dtype == tcb.val_dtype


def test_load_rejects_corruption(tmp_path):
    scn = tp.Scenario("power_law", 16)
    tcb = tp.torch_cb(scn)
    tcb.save(tmp_path / "ok.npz")
    with np.load(tmp_path / "ok.npz") as z:
        entries = {k: z[k] for k in z.files}
    entries["packed"] = entries["packed"].copy()
    entries["packed"][3] ^= 0xFF
    np.savez(tmp_path / "bad.npz", **entries)
    with pytest.raises(terrors.ArtifactError) as ei:
        TorchCBMatrix.load(tmp_path / "bad.npz")
    assert ei.value.code == terrors.ARTIFACT_CORRUPT
    entries["schema"] = np.asarray("cb-matrix/v9")
    np.savez(tmp_path / "schema.npz", **entries)
    with pytest.raises(terrors.SchemaError):
        TorchCBMatrix.load(tmp_path / "schema.npz")
    (tmp_path / "trunc.npz").write_bytes((tmp_path / "ok.npz").read_bytes()[:100])
    with pytest.raises(terrors.ArtifactError):
        TorchCBMatrix.load(tmp_path / "trunc.npz")


@pytest.mark.parametrize("policy,raises", [("raise", True), ("sanitize", False),
                                            ("allow", False)])
def test_nonfinite_policy(policy, raises):
    r, c = np.array([0, 1, 2]), np.array([0, 1, 2])
    v = np.array([1.0, np.nan, np.inf])
    if raises:
        with pytest.raises(terrors.NonFiniteError):
            TorchCBMatrix.from_coo(r, c, v, (4, 4), nonfinite=policy)
        return
    tcb = TorchCBMatrix.from_coo(r, c, v, (4, 4), nonfinite=policy)
    jcb = JaxCBMatrix.from_coo(r, c, v, (4, 4), nonfinite=policy)
    _same(tcb.packed, jcb.packed)
    if policy == "allow":
        with pytest.raises(terrors.NonFiniteError):
            tcb.validate(check_finite=True)


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [8, 16, 24, 128])
def test_formats_match(B):
    nnz = np.arange(0, B * B + 1)
    _same(tformats.select_formats(nnz, B), jformats.select_formats(nnz, B))
    assert tformats.FormatThresholds().resolve(B) == jformats.FormatThresholds().resolve(B)
    th_t = tformats.FormatThresholds(th1=3, th2=B)
    th_j = jformats.FormatThresholds(th1=3, th2=B)
    _same(tformats.select_formats(nnz, B, th_t), jformats.select_formats(nnz, B, th_j))
    assert (tformats.should_column_aggregate(nnz[1:], B)
            == jformats.should_column_aggregate(nnz[1:], B))
    with pytest.raises(terrors.InvalidArgError):
        tformats.FormatThresholds(th1=9, th2=3).resolve(B)


@pytest.mark.parametrize("B", [8, 16, 24])
def test_blocking_and_column_agg_match(B):
    rng = np.random.default_rng(B)
    m, n = 150, 133
    rows, cols = rng.integers(0, m, 700), rng.integers(0, n, 700)   # with duplicates
    vals = rng.standard_normal(700).astype(np.float32)
    pt = tblocking.partition_coo(rows, cols, vals, (m, n), B)
    pj = jblocking.partition_coo(rows, cols, vals, (m, n), B)
    for f in ("blk_row_idx", "blk_col_idx", "nnz_per_blk", "blk_ptr", "local_rows",
              "local_cols", "values"):
        _same(getattr(pt, f), getattr(pj, f), f)
    at = tcolagg.column_aggregate(rows, cols, (m, n), B)
    aj = jcolagg.column_aggregate(rows, cols, (m, n), B)
    it = tcolagg.identity_aggregation(cols, (m, n), B)
    ij = jcolagg.identity_aggregation(cols, (m, n), B)
    for a, b in ((at, aj), (it, ij)):
        for f in ("new_cols", "restore_cols", "cols_offset", "panel_width"):
            _same(getattr(a, f), getattr(b, f), f)
        for panel, bcol in ((0, 0), (3, 1), (a.num_panels - 1, 0)):
            _same(tcolagg.restore_for_block(a, panel, bcol, B, n),
                  jcolagg.restore_for_block(b, panel, bcol, B, n), "restore")
        # the array form is the per-block form, stacked
        panels = np.array([0, 3, a.num_panels - 1])
        bcols = np.array([0, 1, 0])
        stacked = tcolagg.restore_for_block(a, panels, bcols, B, n)
        for k in range(3):
            _same(stacked[k], jcolagg.restore_for_block(b, panels[k], bcols[k], B, n))
    with pytest.raises(terrors.InvalidArgError):
        tblocking.partition_coo([m], [0], [1.0], (m, n), B)


@pytest.mark.parametrize("B", [8, 16, 24])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_aggregation_matches_block_by_block(B, dtype):
    """pack/unpack per block equal the JAX package's; the whole-matrix packer
    writes the same bytes as packing block after block."""
    rng = np.random.default_rng(B + np.dtype(dtype).itemsize)
    m = n = 6 * B
    rows, cols = rng.integers(0, m, 900), rng.integers(0, n, 900)
    vals = rng.standard_normal(900).astype(dtype)
    part = tblocking.partition_coo(rows, cols, vals, (m, n), B)
    fmts = rng.integers(0, 3, part.num_blocks).astype(np.uint8)
    assert tagg.coord_bits(B) == jagg.coord_bits(B)
    elems = [part.block_elems(i) for i in range(part.num_blocks)]
    for i in (0, part.num_blocks // 2, part.num_blocks - 1):
        r, c, v = elems[i]
        for fmt in (0, 1, 2):
            blob = tagg.pack_block(fmt, r, c, v, B)
            _same(blob, jagg.pack_block(fmt, r, c, v, B), "pack_block")
            for got, want in zip(tagg.unpack_block(blob, 0, fmt, len(v), B, dtype),
                                 jagg.unpack_block(blob, 0, fmt, len(v), B, dtype)):
                _same(got, want, "unpack_block")
        codes = tagg.encode_coords(r, c, B)
        _same(codes, jagg.encode_coords(r, c, B))
        for got, want in zip(tagg.decode_coords(codes, B), (r, c)):
            np.testing.assert_array_equal(got, want)
    loop_t = tagg.aggregate_blocks(fmts, elems, B, dtype)
    loop_j = jagg.aggregate_blocks(fmts, elems, B, dtype)
    whole = tagg.aggregate_partition(fmts, part, dtype)
    for f in ("packed", "vp_per_blk", "nbytes_per_blk"):
        _same(getattr(loop_t, f), getattr(loop_j, f), f)
        _same(getattr(whole, f), getattr(loop_j, f), f)
    nnz = np.diff(part.blk_ptr)
    for fmt in (0, 1):     # dense tiles drop zeros; covered by test_decoders_match
        sel = np.flatnonzero(fmts == fmt)
        blk, r, c, v = tagg.unpack_format(whole.packed, whole.vp_per_blk[sel], nnz[sel],
                                          fmt, B, dtype)
        _same(r, np.concatenate([elems[i][0] for i in sel]), "rows")
        _same(c, np.concatenate([elems[i][1] for i in sel]), "cols")
        _same(v, np.concatenate([elems[i][2] for i in sel]), "vals")


@pytest.mark.parametrize("nblk,group", [(1, 8), (37, 8), (200, 16), (64, 1), (5, 7)])
def test_balance_matches(nblk, group):
    load = np.random.default_rng(nblk).integers(1, 200, nblk)
    load[::5] = 50     # ties: the heap's order must still agree
    for fn in ("tb_load_balance", "grid_group_balance"):
        rt, rj = getattr(tbalance, fn)(load, group), getattr(jbalance, fn)(load, group)
        _same(rt.slots, rj.slots, fn)
        _same(rt.group_loads, rj.group_loads, fn)
        assert (rt.num_groups, rt.group_size) == (rj.num_groups, rj.group_size)
        assert rt.load_std == rj.load_std and rt.load_imbalance == rj.load_imbalance
        meta = np.arange(nblk, dtype=np.int32)
        _same(tbalance.apply_balance(rt, meta, pad_values=(-7,))[0],
              jbalance.apply_balance(rj, meta, pad_values=(-7,))[0])


@pytest.mark.parametrize("family,args", [
    ("uniform_random", (200, 160, 0.02)), ("power_law", (200, 160)),
    ("banded", (200, 160)), ("block_clustered", (200, 160)),
    ("diagonal_dominant", (200, 160)), ("pruned_weight", (200, 160)),
])
def test_generators_match(family, args):
    for got, want in zip(getattr(tmatrices, family)(*args, seed=9),
                         getattr(jmatrices, family)(*args, seed=9)):
        _same(got, want, family)


def test_corpus_and_oracle_match():
    ct, cj = tmatrices.corpus("small", seed=2), jmatrices.corpus("small", seed=2)
    assert [s.name for s, *_ in ct] == [s.name for s, *_ in cj]
    for (_, *a), (_, *b) in zip(ct[:6], cj[:6]):
        for got, want in zip(a[:3], b[:3]):
            _same(got, want)
        assert a[3] == b[3]
    with pytest.raises(terrors.InvalidArgError):
        tmatrices.corpus("huge")
    _, r, c, v, shape = ct[1]
    x = np.random.default_rng(0).standard_normal(shape[1])
    np.testing.assert_allclose(t_dense_oracle(r, c, v, shape, x),
                               j_dense_oracle(r, c, v, shape, x), rtol=1e-12)


@pytest.mark.parametrize("header,body,ok", [
    ("%%MatrixMarket matrix coordinate real general", "3 3 2\n1 1 2.5\n3 2 -1\n", True),
    ("%%MatrixMarket matrix coordinate pattern symmetric", "3 3 2\n2 1\n3 3\n", True),
    ("%%MatrixMarket matrix coordinate real skew-symmetric", "3 3 1\n3 1 4\n", True),
    ("%%MatrixMarket matrix array real general", "2 2\n1\n2\n3\n4\n", False),
    ("%%MatrixMarket matrix coordinate real general", "3 3 2\n1 1 2.5\n", False),
])
def test_matrix_market_matches(tmp_path, header, body, ok):
    path = tmp_path / "a.mtx"
    path.write_text(header + "\n% comment\n" + body)
    if not ok:
        with pytest.raises(terrors.IngestError) as ei:
            tmatrices.load_matrix_market(path)
        assert ei.value.code == terrors.INGEST_INVALID
        with pytest.raises(jerrors.IngestError):
            jmatrices.load_matrix_market(path)
        return
    got, want = tmatrices.load_matrix_market(path), jmatrices.load_matrix_market(path)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)
    assert got[3] == want[3]


def test_errors_mirror_the_jax_package():
    """Same reason codes, same classes, same builtin bases (plus the port's own)."""
    for name in dir(jerrors):
        want = getattr(jerrors, name)
        if name.isupper() and isinstance(want, str):
            assert getattr(terrors, name) == want, name
        elif isinstance(want, type) and issubclass(want, Exception):
            got = getattr(terrors, name)
            assert got.code == want.code, name
            assert [b.__name__ for b in got.__mro__] == [b.__name__ for b in want.__mro__]
    assert [(s.name, s.value) for s in terrors.SolverStatus] == \
           [(s.name, s.value) for s in jerrors.SolverStatus]
    assert terrors.solver_reason(2) == jerrors.solver_reason(2)
    assert terrors.reason_code(terrors.reason("x-y", "msg")) == "x-y"
    assert issubclass(terrors.DeviceUnavailableError, RuntimeError)
    assert issubclass(terrors.KernelError, RuntimeError)


# ---------------------------------------------------------------------------
# the port stands alone, and does not carry on quietly without a card
# ---------------------------------------------------------------------------

def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


PACKAGE_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
if str(REPO) not in sys.path:            # examples_torch: the port's entry points
    sys.path.insert(0, str(REPO))
from examples_torch import ENTRY_POINTS  # noqa: E402
PORT_FILES = PACKAGE_FILES + [REPO / "chip_smoke.py"] + sorted(
    (REPO / "examples_torch").glob("*.py")) + [REPO / "scripts" / "explain_torch.py",
                                               REPO / "scripts" / "obs_report_torch.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    banned = {"jax", "jaxlib", "repro", "flax", "optax", "benchmarks"} & _imported_roots(path)
    assert not banned, f"{path} imports {sorted(banned)}"


def test_card_tests_import_neither_jax_nor_repro():
    """A GPU machine without JAX collects every ``cuda`` test of the port:
    the file that holds them reaches neither package, not even through the
    parity helpers."""
    banned = {"jax", "jaxlib", "repro", "torch_port", "conformance"}
    assert not banned & _imported_roots(REPO / "tests" / "test_torch_card.py")


def test_port_has_every_module_of_the_slice():
    have = {str(p.relative_to(REPO / "src" / "repro_torch")) for p in PACKAGE_FILES}
    for mod in ("errors.py", "core/formats.py", "core/blocking.py", "core/column_agg.py",
                "core/aggregation.py", "core/balance.py", "core/cb_matrix.py",
                "core/spmv_ref.py", "core/streams.py", "data/matrices.py",
                "kernels/ref.py", "kernels/ops.py", "kernels/_build.py",
                "kernels/cb_block_dense.py", "kernels/cb_colagg.py", "kernels/cb_coo.py",
                "kernels/cb_combine.py", "obs/__init__.py", "obs/metrics.py", "obs/spans.py",
                "obs/locality.py", "autotune/__init__.py", "autotune/features.py",
                "autotune/cost.py", "autotune/plan.py", "autotune/search.py",
                "autotune/timing.py", "configs/__init__.py", "configs/base.py",
                "configs/granite_8b.py", "models/__init__.py", "models/layers.py",
                "models/transformer.py", "models/model.py", "serving/__init__.py",
                "serving/decode.py", "serving/engine.py", "launch/__init__.py",
                "launch/serve.py", "data/synthetic.py", "training/__init__.py",
                "training/schedule.py", "training/optimizer.py", "training/train_state.py",
                "training/grad_compression.py", "training/train_loop.py",
                "checkpoint/__init__.py", "checkpoint/checkpointer.py", "runtime/__init__.py",
                "runtime/elastic.py", "runtime/fault_tolerance.py", "runtime/faults.py",
                "launch/train.py", "core/distributed.py", "launch/mesh.py",
                "models/sharding.py", "runtime/pipeline.py", "models/moe.py",
                "models/ssm.py", "models/hybrid.py", "models/encdec.py",
                "launch/dryrun.py", "launch/roofline.py", "analysis/__init__.py",
                "analysis/__main__.py", "analysis/engine.py", "analysis/registry.py"):
        assert mod in have, mod
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    for src in ("cb_block_dense.cu", "cb_colagg.cu", "cb_coo.cu", "cb_combine.cu",
                "cb_common.cuh"):
        assert (csrc / src).is_file(), src
    assert {p.name for p in (REPO / "examples").glob("*.py")} == \
        {pathlib.Path(f).name for f in ENTRY_POINTS.values() if f.startswith("examples_torch")}
    for path in ENTRY_POINTS.values():
        assert (REPO / path).is_file(), path


def test_cuda_request_without_a_card_raises():
    """The default device is CUDA; with none present every entry point says
    so with a typed error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    streams = tstreams.build_super_streams(tp.torch_cb(tp.Scenario("uniform", 16)))
    x = torch.zeros(streams.n)
    for call in (lambda: streams.to(), lambda: streams.to("cuda"),
                 lambda: tops.cb_spmv(streams, x),
                 lambda: tops.cb_spmv(streams, x, impl="reference"),
                 lambda: tops.cb_spmv_into(torch.zeros(streams.m), streams, x),
                 lambda: tstreams.resolve_device(None)):
        with pytest.raises(terrors.DeviceUnavailableError) as ei:
            call()
        assert ei.value.code == terrors.DEVICE_UNAVAILABLE
    assert tstreams.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_each_example_and_tool_raises_without_a_card(name, tmp_path, monkeypatch):
    """Every example and tool runs on CUDA by default: with no card and no
    ``--device cpu`` it raises the typed error before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    monkeypatch.chdir(tmp_path)                 # train_lm's checkpoints, obs_report's trace
    path = REPO / ENTRY_POINTS[name]
    spec = importlib.util.spec_from_file_location(f"_entry_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(terrors.DeviceUnavailableError) as ei:
        mod.main([])
    assert ei.value.code == terrors.DEVICE_UNAVAILABLE
    assert not list(tmp_path.iterdir())


def test_a_call_runs_on_the_very_device_its_streams_live_on(monkeypatch):
    """Streams on ``cuda:1`` are refused for a ``cuda:0`` call (and the other
    way round), where comparing device types alone let them through; a
    default ``"cuda"`` call reads the current device's index. The card is
    faked: ``resolve_device`` and ``current_device`` are monkeypatched and
    the streams are a stand-in carrying only ``.device``."""
    import types

    monkeypatch.setattr(tops, "resolve_device", lambda d=None: torch.device(
        "cuda" if d is None else d))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    on = {i: types.SimpleNamespace(device=torch.device("cuda", i)) for i in (0, 1)}
    for streams, device in ((on[1], "cuda:0"), (on[0], "cuda:1"), (on[1], None),
                            (on[1], "cuda")):
        with pytest.raises(terrors.InvalidArgError, match="move them first"):
            tops._check_impl_device(streams, "cuda", device)
    for streams, device in ((on[0], "cuda:0"), (on[0], None), (on[0], "cuda"),
                            (on[1], "cuda:1")):
        tops._check_impl_device(streams, "cuda", device)
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    tops._check_impl_device(cpu, "reference", "cpu")
    with pytest.raises(terrors.InvalidArgError):
        tops._check_impl_device(cpu, "cuda", "cuda:0")
