"""Parity of the port's solver subsystem (``repro_torch.solvers``) with the
JAX package's (``repro.solvers``).

The same numpy inputs go through ``repro`` (``impl="reference"``) and
through the port on the CPU (``device="cpu"``, both ``impl``s: ``"cuda"``
takes the kernels' plain versions on CPU tensors). Host artefacts are held
bit for bit (``spd_banded``, transposed streams, value layout, updaters,
block diagonals); solver runs by status, iteration count (within 2 of
``repro``'s and of scipy's) and solution (1e-4 relative to ``repro``'s);
spectral runs by eigenvalue (1e-5), Ritz values (1e-4) and subspace,
PageRank by L1 distance (1e-6).
"""
import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from repro import solvers as jsolvers
from repro.autotune import SearchSettings as JaxSettings
from repro.core import streams as jstreams
from repro.core.cb_matrix import CBMatrix as JaxCBMatrix
from repro.data import matrices as jmatrices
from repro.runtime import corrupt_packed_values, poison_vector
from repro.solvers import krylov as jkrylov
from repro_torch import errors
from repro_torch import solvers as tsolvers
from repro_torch.core import CBMatrix as TorchCBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.data import matrices as tmatrices
from repro_torch.solvers import _loop, krylov as tkrylov
from torch_port import (
    assert_streams_equal, assert_tiles_equal, ids, scenario_cut, to_torch_operator,
    to_torch_preconditioner, torch_cb,
)

TOL = 1e-6
IMPLS = ["cuda", "reference"]
SCENARIOS = scenario_cut(5)


# ---------------------------------------------------------------------------
# cases: the shapes of tests/test_solvers.py and tests/test_faults.py
# ---------------------------------------------------------------------------

def _pair(rows, cols, vals, shape, block_size=16):
    """The same triplets through both packages' ``from_coo``."""
    kw = dict(block_size=block_size, val_dtype=np.float32)
    return (JaxCBMatrix.from_coo(rows, cols, vals, shape, **kw),
            TorchCBMatrix.from_coo(rows, cols, vals, shape, **kw))


def _dense_of(rows, cols, vals, shape):
    A = np.zeros(shape, np.float32)
    np.add.at(A, (rows, cols), vals)
    return A


@functools.lru_cache(maxsize=None)
def _spd_case(d=96, seed=3, group_size=None):
    rows, cols, vals = jmatrices.spd_banded(d, bandwidth=7, seed=seed)
    vals = vals.astype(np.float32)
    jcb, tcb = _pair(rows, cols, vals, (d, d))
    kw = dict(group_size=group_size, with_rmatvec=True, with_matmat=True)
    return (jcb, tcb, jsolvers.CBLinearOperator.from_cb(jcb, **kw),
            tsolvers.CBLinearOperator.from_cb(tcb, device="cpu", **kw),
            _dense_of(rows, cols, vals, (d, d)))


@functools.lru_cache(maxsize=None)
def _nonsym_case(d=96, seed=5):
    rows, cols, vals = jmatrices.banded(d, d, bandwidth=7, fill=0.8, seed=seed)
    diag = np.arange(d)
    rows = np.concatenate([rows, diag])
    cols = np.concatenate([cols, diag])
    vals = np.concatenate([vals, np.full(d, 8.0)]).astype(np.float32)
    jcb, tcb = _pair(rows, cols, vals, (d, d))
    return (jcb, tcb, jsolvers.CBLinearOperator.from_cb(jcb),
            tsolvers.CBLinearOperator.from_cb(tcb, device="cpu"),
            _dense_of(rows, cols, vals, (d, d)))


@functools.lru_cache(maxsize=None)
def _indefinite(d=64, seed=1):
    """SPD matrix with one diagonal entry negated — CG breaks down."""
    r, c, v = jmatrices.spd_banded(d, bandwidth=7, seed=seed)
    dense = np.zeros((d, d), np.float32)
    np.add.at(dense, (r, c), v)
    rr, cc = np.nonzero(dense)
    vv = dense[rr, cc].copy()
    vv[(rr == d - 1) & (cc == d - 1)] = -50.0
    jcb, tcb = _pair(rr, cc, vv, (d, d))
    return (jcb, tcb, jsolvers.CBLinearOperator.from_cb(jcb),
            tsolvers.CBLinearOperator.from_cb(tcb, device="cpu"))


def _updatable_case(seed=0, m=70, n=70, group_size=4):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, m, 500), np.arange(m)])
    cols = np.concatenate([rng.integers(0, n, 500), np.arange(m)])
    vals = np.concatenate([rng.standard_normal(500), np.full(m, 3.0)]).astype(np.float32)
    jcb, tcb = _pair(rows, cols, vals, (m, n))
    kw = dict(group_size=group_size, with_rmatvec=True, with_matmat=True, updatable=True)
    return (jcb, tcb, jsolvers.CBLinearOperator.from_cb(jcb, **kw),
            tsolvers.CBLinearOperator.from_cb(tcb, device="cpu", **kw), rng)


def _nonzero_values(count, rng):
    v = rng.standard_normal(count).astype(np.float32)
    v[v == 0] = 1.0
    return v


def _rhs(d, seed=0):
    return np.random.default_rng(seed).standard_normal(d).astype(np.float32)


def _jax_cb(scn):
    rows, cols, vals, shape = scn.build_coo()
    return JaxCBMatrix.from_coo(rows, cols, vals, shape, block_size=scn.block_size,
                                val_dtype=np.dtype(scn.dtype), thresholds=scn.thresholds(),
                                use_column_aggregation=scn.colagg)


def _scipy_iters(kind, A, b, tol=TOL, maxiter=500, M=None):
    """Iteration count of the scipy CSR reference, same stopping rule."""
    count = [0]
    fn = {"cg": spla.cg, "bicgstab": spla.bicgstab}[kind]
    _, info = fn(sp.csr_matrix(A), b, rtol=tol, atol=0.0, maxiter=maxiter, M=M,
                 callback=lambda *_: count.__setitem__(0, count[0] + 1))
    assert info == 0
    return count[0]


def _np(t):
    return t.detach().cpu().numpy()


def _same_bits(want, got, tag=""):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, (tag, want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=tag)


def _same_status(jres, tres):
    assert int(tres.status) == int(jres.status), (tres.reason, jres.reason)
    assert tres.reason == jres.reason
    assert bool(tres.converged) == bool(jres.converged)


def _close_x(jres, tres, rel=1e-4):
    want = np.asarray(jres.x, np.float64)
    assert np.linalg.norm(_np(tres.x) - want) <= rel * max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------------------
# host artefacts, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,bandwidth,seed", [(96, 7, 3), (90, 7, 8), (64, 5, 1), (4097, 9, 0)])
def test_spd_banded_triplets_bit_equal(d, bandwidth, seed):
    for want, got in zip(jmatrices.spd_banded(d, bandwidth=bandwidth, seed=seed),
                         tmatrices.spd_banded(d, bandwidth=bandwidth, seed=seed)):
        _same_bits(want, got)


def test_spd_corpus_bit_equal():
    jc, tc = jmatrices.spd_corpus("small", seed=2), tmatrices.spd_corpus("small", seed=2)
    assert len(jc) == len(tc)
    for (js, *ja), (ts, *ta) in zip(jc, tc):
        assert (js.name, js.family, js.m, js.n) == (ts.name, ts.family, ts.m, ts.n)
        for want, got in zip(ja[:3], ta[:3]):
            _same_bits(want, got)
        assert ja[3] == ta[3]
    with pytest.raises(errors.InvalidArgError):
        tmatrices.spd_corpus("huge")


@pytest.mark.parametrize("scn", SCENARIOS, ids=ids(SCENARIOS))
def test_transposed_streams_bit_equal(scn):
    jcb, tcb = _jax_cb(scn), torch_cb(scn)
    jt, tt = jstreams.transpose_cb(jcb), tstreams.transpose_cb(tcb)
    for f in ("blk_row_idx", "blk_col_idx", "nnz_per_blk", "type_per_blk", "vp_per_blk",
              "packed"):
        _same_bits(getattr(jt, f), getattr(tt, f), f"{scn.name} {f}")
    assert jt.shape == tt.shape and jt.nnz == tt.nnz
    for G in (None, 4):
        assert_streams_equal(jstreams.build_transposed_super_streams(jcb, G),
                             tstreams.build_transposed_super_streams(tcb, G), scn.name)


@pytest.mark.parametrize("scn", SCENARIOS, ids=ids(SCENARIOS))
def test_value_layout_and_index_shadow_bit_equal(scn):
    jcb, tcb = _jax_cb(scn), torch_cb(scn)
    jl, tl = jcb.value_layout(), tcb.value_layout()
    assert jl.count == tl.count
    _same_bits(jl.byte_pos, tl.byte_pos, "byte_pos")
    _same_bits(jl.keys, tl.keys, "keys")
    assert tcb.value_layout() is tl                     # cached on the instance
    js, ts = jstreams._index_cb(jcb), tstreams._index_cb(tcb)
    assert np.dtype(ts.val_dtype) == np.dtype(js.val_dtype) == np.int64
    for f in ("packed", "vp_per_blk", "nnz_per_blk"):
        _same_bits(getattr(js, f), getattr(ts, f), f)


@pytest.mark.parametrize("scn", SCENARIOS[::2], ids=ids(SCENARIOS[::2]))
def test_update_values_bytes_bit_equal(scn):
    jcb, tcb = _jax_cb(scn), torch_cb(scn)
    count = tcb.value_layout().count
    v = _nonzero_values(count, np.random.default_rng(1)).astype(tcb.val_dtype)
    ju, tu = jcb.update_values(v), tcb.update_values(v)
    _same_bits(ju.packed, tu.packed, "packed")
    assert tu.value_layout() is tcb.value_layout()       # the cache is handed on
    rows, cols, vals = tu.to_coo()
    _same_bits(v, vals)
    # arbitrary order with a duplicate split in two: update_from_coo merges it
    perm = np.random.default_rng(2).permutation(count)
    r, c, w = rows[perm], cols[perm], v[perm]
    r, c = np.concatenate([r, r[:1]]), np.concatenate([c, c[:1]])
    w = np.concatenate([w[:1] * 0.5, w[1:], w[:1] * 0.5]).astype(v.dtype)
    _same_bits(jcb.update_from_coo(r, c, w).packed, tcb.update_from_coo(r, c, w).packed)


def test_update_from_coo_rejects_structure_drift_and_bad_counts():
    _, tcb, *_ = _updatable_case(seed=3)
    rows, cols, vals = tcb.to_coo()
    with pytest.raises(errors.StructureDriftError, match="structure"):
        tcb.update_from_coo(rows[1:], cols[1:], vals[1:])
    with pytest.raises(errors.InvalidArgError, match="canonical values"):
        tcb.update_values(vals[1:])
    with pytest.raises(errors.NonFiniteError):
        tcb.update_values(np.where(np.arange(len(vals)) == 0, np.nan, vals))


@pytest.mark.parametrize("scn", SCENARIOS[::2], ids=ids(SCENARIOS[::2]))
def test_updaters_index_and_apply_bit_equal(scn):
    jcb, tcb = _jax_cb(scn), torch_cb(scn)
    v = _nonzero_values(tcb.value_layout().count, np.random.default_rng(4)).astype(tcb.val_dtype)
    for G in (None, 4):
        for make in ("super_stream_updater", "transposed_super_stream_updater"):
            ju, tu = getattr(jstreams, make)(jcb, G), getattr(tstreams, make)(tcb, G)
            for f in ("dense", "panel", "coo"):
                _same_bits(getattr(ju, f + "_pos"), _np(getattr(tu, f + "_pos")), f"{make} pos")
                _same_bits(getattr(ju, f + "_src"), _np(getattr(tu, f + "_src")), f"{make} src")
            assert_streams_equal(ju.apply(v), tu.apply(v), f"{scn.name} {make}")
            assert_streams_equal(ju.apply(v), tu.apply(torch.from_numpy(v)), "tensor values")
        ju, tu = jstreams.super_tile_updater(jcb, G), tstreams.super_tile_updater(tcb, G)
        _same_bits(ju.pos, _np(tu.pos), "tile pos")
        _same_bits(ju.src, _np(tu.src), "tile src")
        assert_tiles_equal(ju.apply(v), tu.apply(v), scn.name)


def test_updated_stream_shares_the_templates_combine_route():
    _, tcb, _, top, rng = _updatable_case(seed=5)
    new = top.with_values(_nonzero_values(tcb.value_layout().count, rng))
    for upd, s in ((top.updater, new.streams), (top.updater_T, new.streams_T)):
        prep, tprep = s.__dict__["_prepared"][None], upd.template.__dict__["_prepared"][None]
        assert prep.sup is s and prep.brow is tprep.brow and prep.combine is tprep.combine
    sup, route = new.tiles.__dict__["_prepared"][None]
    assert sup is new.tiles and route is top.tile_updater.template.__dict__["_prepared"][None][1]
    assert new.updater is top.updater and new.tile_updater is top.tile_updater


def _diag_cases():
    out = [("spd", *_spd_case(d=90, seed=8)[:2]), ("updatable", *_updatable_case(seed=10)[:2])]
    out += [(s.name, _jax_cb(s), torch_cb(s)) for s in SCENARIOS[::4]]
    return out


def test_diagonal_blocks_and_preconditioners_bit_equal():
    from repro.solvers import precond as jprecond
    from repro_torch.solvers import precond as tprecond

    for tag, jcb, tcb in _diag_cases():
        _same_bits(jprecond._diag_blocks(jcb), tprecond._diag_blocks(tcb), tag)
        _same_bits(np.asarray(jsolvers.jacobi(jcb).inv_diag),
                   _np(tsolvers.jacobi(tcb, device="cpu").inv_diag), tag)
        jb, tb = jsolvers.block_jacobi(jcb), tsolvers.block_jacobi(tcb, device="cpu")
        _same_bits(np.asarray(jb.inv_blocks), _np(tb.inv_blocks), tag)
        assert (jb.m, jb.block_size) == (tb.m, tb.block_size)
        jd, td = jsolvers.diag_scatter(jcb), tsolvers.diag_scatter(tcb)
        _same_bits(jd.flat_idx, td.flat_idx, tag)
        _same_bits(jd.src, td.src, tag)
        v = _nonzero_values(tcb.value_layout().count, np.random.default_rng(6))
        v = v.astype(tcb.val_dtype)
        _same_bits(np.asarray(jd.block_jacobi(v).inv_blocks),
                   _np(td.block_jacobi(v, device="cpu").inv_blocks), tag)
        _same_bits(np.asarray(jd.jacobi(v).inv_diag), _np(td.jacobi(v, device="cpu").inv_diag))
        # the scatter equals a rebuild from the updated matrix
        _same_bits(_np(td.block_jacobi(v, device="cpu").inv_blocks),
                   _np(tsolvers.block_jacobi(tcb.update_values(v), device="cpu").inv_blocks))


def test_preconditioner_apply_matches_jax():
    jcb, tcb, _, _, A = _spd_case(d=90, seed=8)              # ragged last block
    r = _rhs(90, 5)
    for jm, tm in ((jsolvers.jacobi(jcb), tsolvers.jacobi(tcb, device="cpu")),
                   (jsolvers.block_jacobi(jcb), tsolvers.block_jacobi(tcb, device="cpu")),
                   (jsolvers.IdentityPreconditioner(), tsolvers.IdentityPreconditioner())):
        want = np.asarray(jm.apply(jnp.asarray(r)))
        np.testing.assert_allclose(_np(tm.apply(torch.from_numpy(r))), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(to_torch_preconditioner(jm).apply(torch.from_numpy(r))),
                                   want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

def test_from_cb_defaults_to_cuda():
    _, tcb, *_ = _spd_case()
    if torch.cuda.is_available():
        assert tsolvers.CBLinearOperator.from_cb(tcb).device.type == "cuda"
    else:
        with pytest.raises(errors.DeviceUnavailableError):
            tsolvers.CBLinearOperator.from_cb(tcb)
        with pytest.raises(errors.DeviceUnavailableError):
            tsolvers.block_jacobi(tcb)


def test_plan_waits_for_the_autotune_slice():
    """The autotune slice is in: ``plan="auto"`` plans on the operator's
    device (heuristic on the CPU) and builds the reference's planned streams."""
    jcb, tcb, *_ = _spd_case()
    top = tsolvers.CBLinearOperator.from_cb(tcb, plan="auto", device="cpu")
    jop = jsolvers.CBLinearOperator.from_cb(jcb, plan="auto", plan_settings=JaxSettings(mode="heuristic"))
    assert top.plan.mode == "heuristic" and top.plan.to_json() == jop.plan.to_json()
    assert_streams_equal(jop.streams, top.streams)
    with pytest.raises(errors.InvalidArgError, match="not both"):
        tsolvers.CBLinearOperator.from_cb(tcb, plan="auto", group_size=4, device="cpu")


def test_operator_from_jax_streams_matches_from_cb():
    """``from_streams`` on the JAX operator's bytes is the port's own build."""
    jcb, _, jop, top, A = _spd_case(seed=19, group_size=4)
    cop = to_torch_operator(jop)
    assert cop.group_size == top.group_size == jop.group_size == 4
    assert_streams_equal(jop.streams, cop.streams)
    assert_streams_equal(jop.streams_T, top.streams_T)
    assert_tiles_equal(jop.tiles, top.tiles)
    rng = np.random.default_rng(8)
    x = rng.standard_normal(96).astype(np.float32)
    X = rng.standard_normal((96, 5)).astype(np.float32)
    for impl in IMPLS:
        assert torch.equal(cop.matvec(x, impl=impl), top.matvec(x, impl=impl))
        assert torch.equal(cop.rmatvec(x, impl=impl), top.rmatvec(x, impl=impl))
        assert torch.equal(cop.matmat(X, impl=impl), top.matmat(X, impl=impl))
        np.testing.assert_allclose(_np(top.matvec(x, impl=impl)), A @ x, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(top.rmatvec(x, impl=impl)), A.T @ x, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(top.matmat(X, impl=impl)), A @ X, rtol=1e-4, atol=1e-4)
        y0 = rng.standard_normal(96).astype(np.float32)
        out = top.matvec_into(torch.from_numpy(y0.copy()), x, impl=impl)
        np.testing.assert_allclose(_np(out), y0 + A @ x, rtol=1e-4, atol=1e-4)
    assert top.dtype == torch.float32 and top.device.type == "cpu"
    with pytest.raises(errors.InvalidArgError, match="group_size"):
        top.matmat(X, group_size=8)


def test_rmatvec_bit_equal_to_the_dense_transposes_build():
    jcb, tcb, _, top, A = _spd_case(d=90, seed=17, group_size=4)
    At = A.T
    rt, ct = np.nonzero(At)
    cbT = TorchCBMatrix.from_coo(rt, ct, At[rt, ct], At.shape, block_size=16,
                                 val_dtype=np.float32, thresholds=tcb.thresholds)
    sT = tstreams.build_super_streams(cbT, group_size=4)
    y = _rhs(90, 7)
    for impl in IMPLS:
        from repro_torch.kernels import ops as tops
        assert torch.equal(top.rmatvec(y, impl=impl), tops.cb_spmv(sT, y, impl=impl, device="cpu"))


def test_capability_gating():
    _, tcb, *_ = _spd_case(seed=23)
    op = tsolvers.CBLinearOperator.from_cb(tcb, device="cpu")
    with pytest.raises(errors.InvalidArgError, match="with_rmatvec"):
        op.rmatvec(torch.zeros(96))
    with pytest.raises(errors.InvalidArgError, match="with_matmat"):
        op.matmat(torch.zeros((96, 2)))
    with pytest.raises(errors.InvalidArgError, match="updatable=True"):
        op.with_values(np.ones(tcb.value_layout().count, np.float32))


def test_with_values_bit_identical_to_rebuild():
    jcb, tcb, jop, top, rng = _updatable_case(seed=7)
    v = _nonzero_values(tcb.value_layout().count, rng)
    new = top.with_values(v)
    ref = tsolvers.CBLinearOperator.from_cb(tcb.update_values(v), group_size=4, with_rmatvec=True,
                                            with_matmat=True, device="cpu")
    jnew = jop.with_values(v)
    for got, fresh, jax_s in ((new.streams, ref.streams, jnew.streams),
                              (new.streams_T, ref.streams_T, jnew.streams_T)):
        for f in tstreams._STREAM_FIELDS:
            assert torch.equal(getattr(got, f), getattr(fresh, f)), f
        assert_streams_equal(jax_s, got)
    assert torch.equal(new.tiles.tiles, ref.tiles.tiles)
    assert_tiles_equal(jnew.tiles, new.tiles)
    x = rng.standard_normal(70).astype(np.float32)
    X = rng.standard_normal((70, 3)).astype(np.float32)
    for impl in IMPLS:
        assert torch.equal(new.matvec(x, impl=impl), ref.matvec(x, impl=impl))
        assert torch.equal(new.rmatvec(x, impl=impl), ref.rmatvec(x, impl=impl))
        assert torch.equal(new.matmat(X, impl=impl), ref.matmat(X, impl=impl))


# ---------------------------------------------------------------------------
# solver parity
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_solve(case, solver, seed, precond=None, **kw):
    jcb, _, jop, *_ = case()
    M = None if precond is None else getattr(jsolvers, precond)(jcb)
    return getattr(jsolvers, solver)(jop, jnp.asarray(_rhs(jop.shape[0], seed)), M,
                                     impl="reference", **kw)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("precond", [None, "jacobi", "block_jacobi"])
def test_cg_matches_repro_and_scipy(impl, precond):
    jcb, tcb, _, top, A = _spd_case()
    jres = _jax_solve(_spd_case, "cg", 0, precond, tol=TOL, maxiter=500)
    M = None if precond is None else getattr(tsolvers, precond)(tcb, device="cpu")
    b = _rhs(96, 0)
    tres = tsolvers.cg(top, b, M, tol=TOL, maxiter=500, impl=impl)
    _same_status(jres, tres)
    assert bool(tres.converged) and float(tres.residual) <= TOL * np.linalg.norm(b)
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 2
    Ms = None
    if precond is not None:
        tm = getattr(tsolvers, precond)(tcb, device="cpu")
        Ms = spla.LinearOperator(A.shape, matvec=lambda r: _np(tm.apply(
            torch.as_tensor(np.asarray(r, np.float32).reshape(-1)))).astype(np.float64))
    assert abs(int(tres.iterations) - _scipy_iters("cg", A.astype(np.float64), b, M=Ms)) <= 2
    _close_x(jres, tres)


@pytest.mark.parametrize("impl", IMPLS)
def test_bicgstab_matches_repro_and_scipy(impl):
    *_, top, A = _nonsym_case()
    jres = _jax_solve(_nonsym_case, "bicgstab", 1, tol=TOL, maxiter=500)
    b = _rhs(96, 1)
    tres = tsolvers.bicgstab(top, b, tol=TOL, maxiter=500, impl=impl)
    _same_status(jres, tres)
    assert bool(tres.converged)
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 2
    assert abs(int(tres.iterations) - _scipy_iters("bicgstab", A.astype(np.float64), b)) <= 2
    _close_x(jres, tres)


@pytest.mark.parametrize("impl", IMPLS)
def test_gmres_matches_repro(impl):
    case = functools.partial(_nonsym_case, seed=9)
    *_, top, A = case()
    jres = _jax_solve(case, "gmres", 2, tol=TOL, restart=15, maxiter=30)
    b = _rhs(96, 2)
    tres = tsolvers.gmres(top, b, tol=TOL, restart=15, maxiter=30, impl=impl)
    _same_status(jres, tres)
    assert bool(tres.converged)
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 2
    _close_x(jres, tres)
    x64 = np.linalg.solve(A.astype(np.float64), b)
    assert np.linalg.norm(_np(tres.x) - x64) <= 1e-4 * np.linalg.norm(x64)


def _exact_case(n, rows, cols, vals, block_size):
    jcb, tcb = _pair(np.asarray(rows), np.asarray(cols), np.asarray(vals, np.float32), (n, n),
                     block_size=block_size)
    return jsolvers.CBLinearOperator.from_cb(jcb), tsolvers.CBLinearOperator.from_cb(
        tcb, device="cpu")


@pytest.mark.parametrize("kind", ["scaled_identity", "cyclic_shift"])
def test_gmres_lucky_breakdown_least_squares(kind):
    """The Krylov space closes before ``restart`` steps: H has exact zero
    columns, which the SVD solve's cut-off gives zero coefficients."""
    n = 4
    if kind == "scaled_identity":
        jop, top = _exact_case(n, range(n), range(n), [2.0] * n, 2)
    else:                                   # e_i -> e_{i+1 mod n}: closes after n steps
        jop, top = _exact_case(n, [(i + 1) % n for i in range(n)], range(n), [1.0] * n, 2)
    b = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    jres = jsolvers.gmres(jop, jnp.asarray(b), tol=1e-6, restart=6, maxiter=3, impl="reference")
    for impl in IMPLS:
        tres = tsolvers.gmres(top, b, tol=1e-6, restart=6, maxiter=3, impl=impl)
        _same_status(jres, tres)
        assert int(tres.iterations) == int(jres.iterations) == 1
        np.testing.assert_allclose(_np(tres.x), np.asarray(jres.x), atol=1e-6)
    H = torch.zeros((7, 6))
    H[0, 0] = 2.0
    y = tkrylov._lstsq(H, torch.tensor([3.0, 0, 0, 0, 0, 0, 0]))
    np.testing.assert_allclose(_np(y), [1.5, 0, 0, 0, 0, 0], atol=0)
    assert torch.isnan(tkrylov._lstsq(H, torch.full((7,), math.nan))).all()


def test_residual_history_buffer_semantics():
    *_, top, A = _spd_case(seed=11)
    b = _rhs(96, 3)
    jres = _jax_solve(functools.partial(_spd_case, seed=11), "cg", 3, tol=TOL, maxiter=64)
    for impl in IMPLS:
        res = tsolvers.cg(top, b, tol=TOL, maxiter=64, impl=impl)
        hist, k = _np(res.history), int(res.iterations)
        assert hist.shape == (65,) and res.history.dtype == torch.float32
        assert np.all(hist[: k + 1] >= 0)
        assert np.all(hist[k + 1:] == -1.0)
        assert hist[0] == pytest.approx(np.linalg.norm(b), rel=1e-5)
        assert hist[k] == pytest.approx(float(res.residual), rel=1e-5)
        jh = np.asarray(jres.history)
        np.testing.assert_array_equal(hist < 0, jh < 0)
        np.testing.assert_allclose(hist[hist >= 0], jh[jh >= 0], rtol=1e-3)
        assert res.iterations.dtype == torch.int32 and res.status.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indefinite_breakdown_and_robust_ladder_match_repro(seed):
    _, _, jop, top = _indefinite(seed=seed)
    b = _rhs(64, seed)
    jres = jsolvers.cg(jop, jnp.asarray(b), tol=1e-6, maxiter=300, impl="reference")
    jrob = jsolvers.robust_solve(jop, jnp.asarray(b), tol=1e-6, maxiter=300, impl="reference")
    for impl in IMPLS:
        tres = tsolvers.cg(top, b, tol=1e-6, maxiter=300, impl=impl)
        _same_status(jres, tres)
        assert int(tres.status) == errors.SolverStatus.BREAKDOWN
        assert int(tres.iterations) == int(jres.iterations)
        trob = tsolvers.robust_solve(top, b, tol=1e-6, maxiter=300, impl=impl)
        assert [(a.solver, a.status) for a in trob.attempts] == \
            [(a.solver, a.status) for a in jrob.attempts]
        for ta, ja in zip(trob.attempts, jrob.attempts):
            assert ta.reason == ja.reason and ta.converged == ja.converged
            assert abs(ta.iterations - ja.iterations) <= 2
        assert trob.converged and trob.solver == jrob.solver and trob.status == jrob.status
        np.testing.assert_allclose(_np(trob.x), np.asarray(jrob.x), rtol=1e-3, atol=1e-4)


def test_nonfinite_rhs_and_corrupt_payload_match_repro():
    rr, cc, vv = jmatrices.spd_banded(64, bandwidth=7, seed=1)
    jcb, tcb = _pair(rr, cc, vv.astype(np.float32), (64, 64))
    jop = jsolvers.CBLinearOperator.from_cb(jcb)
    top = tsolvers.CBLinearOperator.from_cb(tcb, device="cpu")
    nan_b = np.full(64, np.nan, np.float32)
    jres = jsolvers.cg(jop, jnp.asarray(nan_b), tol=1e-8, maxiter=50, impl="reference")
    jbad, tbad = corrupt_packed_values(jcb, n=3, seed=0), corrupt_packed_values(tcb, n=3, seed=0)
    _same_bits(jbad.packed, tbad.packed)
    jbop = jsolvers.CBLinearOperator.from_cb(jbad)
    tbop = tsolvers.CBLinearOperator.from_cb(tbad, device="cpu")
    for impl in IMPLS:
        tres = tsolvers.cg(top, nan_b, tol=1e-8, maxiter=50, impl=impl)
        _same_status(jres, tres)
        assert int(tres.status) == errors.SolverStatus.NONFINITE and int(tres.iterations) == 0
        for name in ("cg", "bicgstab", "gmres"):
            jr = getattr(jsolvers, name)(jbop, jnp.asarray(_rhs(64)), tol=1e-8, maxiter=50,
                                         impl="reference")
            tr = getattr(tsolvers, name)(tbop, _rhs(64), tol=1e-8, maxiter=50, impl=impl)
            _same_status(jr, tr)
            assert int(tr.status) == errors.SolverStatus.NONFINITE
            assert int(tr.iterations) == int(jr.iterations)


def test_divergence_matches_repro():
    _, tcb, jop, top, _ = _spd_case(d=64, seed=1)
    jres = jsolvers.cg(jop, jnp.asarray(_rhs(64)), tol=1e-12, maxiter=50, impl="reference",
                       divtol=1e-6)
    for impl in IMPLS:
        tres = tsolvers.cg(top, _rhs(64), tol=1e-12, maxiter=50, impl=impl, divtol=1e-6)
        _same_status(jres, tres)
        assert int(tres.status) == errors.SolverStatus.DIVERGED


def test_gmres_rotation_stall_matches_repro():
    """GMRES(1) on a rotation matrix makes no progress: STAGNATION."""
    jop, top = _exact_case(2, [0, 1], [1, 0], [1.0, -1.0], 2)
    b = np.array([1.0, 0.0], np.float32)
    jres = jsolvers.gmres(jop, jnp.asarray(b), tol=1e-8, restart=1, maxiter=40, impl="reference")
    for impl in IMPLS:
        tres = tsolvers.gmres(top, b, tol=1e-8, restart=1, maxiter=40, impl=impl)
        _same_status(jres, tres)
        assert int(tres.status) == errors.SolverStatus.STAGNATION
        assert int(tres.iterations) == int(jres.iterations)
        _same_bits(np.asarray(jres.history), _np(tres.history))


def test_best_iterate_on_failure():
    _, _, jop, top = _indefinite()
    b = _rhs(64)
    for impl in IMPLS:
        res = tsolvers.cg(top, b, tol=1e-10, maxiter=200, impl=impl)
        hist = _np(res.history)
        r = b - _np(top.matvec(res.x, impl="reference"))
        np.testing.assert_allclose(np.linalg.norm(r), hist[hist >= 0].min(), rtol=1e-3, atol=1e-5)
        _close_x(jsolvers.cg(jop, jnp.asarray(b), tol=1e-10, maxiter=200, impl="reference"), res)


def test_robust_solve_rejects_nonfinite_rhs_tolerates_bad_x0():
    _, _, jop, top, _ = _spd_case(d=64, seed=1)
    with pytest.raises(errors.NonFiniteError):
        tsolvers.robust_solve(top, np.full(64, np.inf, np.float32))
    x0 = poison_vector(np.zeros(64, np.float32), n=2, seed=0)
    jres = jsolvers.robust_solve(jop, jnp.asarray(_rhs(64)), x0=jnp.asarray(x0), tol=1e-6,
                                 maxiter=300, impl="reference")
    res = tsolvers.robust_solve(top, _rhs(64), x0=x0, tol=1e-6, maxiter=300)
    assert res.converged and res.sanitized_x0 and jres.sanitized_x0
    assert [(a.solver, a.status) for a in res.attempts] == \
        [(a.solver, a.status) for a in jres.attempts]
    with pytest.raises(errors.InvalidArgError, match="unknown methods"):
        tsolvers.robust_solve(top, _rhs(64), methods=("lsqr",))
    with pytest.raises(errors.InvalidArgError, match="empty"):
        tsolvers.robust_solve(top, _rhs(64), max_attempts=0)


def test_robust_solve_escalates_preconditioner_like_repro():
    jcb, tcb, jop, top = _indefinite(seed=0)
    b = _rhs(64)
    kw = dict(tol=1e-6, maxiter=300, methods=("cg",))
    jres = jsolvers.robust_solve(jop, jnp.asarray(b), impl="reference",
                                 fallback_preconditioner=jsolvers.block_jacobi(jcb), **kw)
    tres = tsolvers.robust_solve(top, b, fallback_preconditioner=tsolvers.block_jacobi(
        tcb, device="cpu"), **kw)
    assert [(a.solver, a.preconditioned, a.status) for a in tres.attempts] == \
        [(a.solver, a.preconditioned, a.status) for a in jres.attempts]
    assert (tres.converged, tres.status, tres.reason) == (jres.converged, jres.status, jres.reason)


def test_dtype_aware_guards():
    half = torch.float16
    assert float(tkrylov._safe_div(torch.tensor(1.0, dtype=half),
                                   torch.tensor(1e-6, dtype=half))) == 0.0
    assert float(tkrylov._safe_div(torch.tensor(1.0, dtype=half),
                                   torch.tensor(0.5, dtype=half))) == 2.0
    for dt in (torch.bfloat16, torch.float16):
        assert float(tkrylov._norm(torch.ones(1024, dtype=dt))) == pytest.approx(32.0, rel=1e-2)
    assert tkrylov._guard_tiny(torch.float32) == float(jkrylov._guard_tiny(jnp.float32))
    assert tkrylov._guard_tiny(torch.int32) == tkrylov._guard_tiny(torch.float32)


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "gmres"])
def test_host_reads_active_every_sync_every_iterations(solver):
    """A solve of k iterations reads ``active`` at most ceil(k / K) + 1 times."""
    *_, top, _ = _spd_case()
    kw = dict(restart=2, maxiter=60) if solver == "gmres" else dict(maxiter=500)
    _loop.HOST_SYNCS.clear()
    res = getattr(tsolvers, solver)(top, _rhs(96, 4), tol=1e-6, **kw)
    k = int(res.iterations)
    K = tkrylov.GMRES_SYNC_EVERY if solver == "gmres" else _loop.SYNC_EVERY
    assert bool(res.converged) and k > K
    assert 1 <= _loop.HOST_SYNCS[solver] <= math.ceil(k / K) + 1


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "power_iteration", "pagerank"])
def test_masked_iterations_change_nothing(solver):
    """Iterations run after the stop (up to K - 1 of them) leave the state as
    the while loop left it: the same solve read every step, every 2 and every
    16 steps agrees bit for bit."""
    *_, top, _ = _spd_case()
    if solver == "pagerank":
        top, dangling = tsolvers.pagerank_operator(*jmatrices.power_law(200, 200, seed=5)[:2],
                                                   200, device="cpu")
        run = lambda: tsolvers.pagerank(top, dangling, maxiter=300)  # noqa: E731
    elif solver == "power_iteration":
        run = lambda: tsolvers.power_iteration(top, _rhs(96, 1), tol=1e-6)  # noqa: E731
    else:
        run = lambda: getattr(tsolvers, solver)(top, _rhs(96, 0), tol=TOL, maxiter=500)  # noqa
    K = _loop.SYNC_EVERY
    results = []
    try:
        for every in (1, K, 16):
            _loop.SYNC_EVERY = every
            results.append(run())
    finally:
        _loop.SYNC_EVERY = K
    for res in results[1:]:
        for f in dataclasses.fields(res):
            assert torch.equal(getattr(res, f.name), getattr(results[0], f.name)), f.name


# ---------------------------------------------------------------------------
# spectral solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_power_iteration_matches_repro(impl):
    *_, jop, top, A = _spd_case(seed=3)
    v0 = np.random.default_rng(11).standard_normal(96).astype(np.float32)
    jres = jsolvers.power_iteration(jop, jnp.asarray(v0), tol=1e-6, maxiter=1000,
                                    impl="reference")
    tres = tsolvers.power_iteration(top, v0, tol=1e-6, maxiter=1000, impl=impl)
    assert bool(tres.converged) == bool(jres.converged) is True
    assert float(tres.eigenvalue) == pytest.approx(float(jres.eigenvalue), rel=1e-5)
    assert float(tres.eigenvalue) == pytest.approx(np.linalg.eigvalsh(A.astype(np.float64))[-1],
                                                   rel=1e-4)
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 2
    assert abs(float(np.dot(_np(tres.eigenvector), np.asarray(jres.eigenvector)))) == \
        pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_chebyshev_subspace_matches_repro(impl):
    *_, jop, top, A = _spd_case(seed=41)
    ev = np.linalg.eigvalsh(A.astype(np.float64))
    V0 = np.random.default_rng(12).standard_normal((96, 6)).astype(np.float32)
    kw = dict(lb=float(ev[0]), ub=float(ev[-8]), degree=8, iters=6)
    jv, jQ = jsolvers.chebyshev_subspace(jop, jnp.asarray(V0), impl="reference", **kw)
    tv, tQ = tsolvers.chebyshev_subspace(top, V0, impl=impl, **kw)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-4)
    np.testing.assert_allclose(_np(tv)[-4:], ev[-4:], rtol=1e-3)
    # the same subspace: the singular values of |Q_jax^T Q_port| are all ~1
    sv = np.linalg.svd(np.asarray(jQ, np.float64).T @ _np(tQ).astype(np.float64),
                       compute_uv=False)
    np.testing.assert_allclose(sv, 1.0, atol=1e-4)
    q, lam = _np(tQ)[:, -1], float(tv[-1])
    assert np.linalg.norm(A @ q - lam * q) <= 1e-2 * abs(lam)


def _pagerank_fresh(src, dst, n, w):
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    uk, inv = np.unique(key, return_inverse=True)
    s_u, d_u = uk // n, uk % n
    w_u = np.zeros(len(uk))
    np.add.at(w_u, inv, w)
    outsum = np.zeros(n)
    np.add.at(outsum, s_u, w_u)
    cb = TorchCBMatrix.from_coo(d_u, s_u, (w_u / outsum[s_u]).astype(np.float32), (n, n),
                                block_size=16)
    dangling = torch.from_numpy((np.bincount(s_u, minlength=n) == 0).astype(np.float32))
    return tsolvers.CBLinearOperator.from_cb(cb, device="cpu"), dangling


@pytest.mark.parametrize("impl", IMPLS)
def test_pagerank_matches_repro(impl):
    n = 200
    src, dst, _ = jmatrices.power_law(n, n, seed=5)
    jop, jd = jsolvers.pagerank_operator(src, dst, n, group_size=4)
    top, td = tsolvers.pagerank_operator(src, dst, n, group_size=4, device="cpu")
    assert_streams_equal(jop.streams, top.streams)
    _same_bits(np.asarray(jd), _np(td))
    jres = jsolvers.pagerank(jop, jd, maxiter=300, impl="reference")
    tres = tsolvers.pagerank(top, td, maxiter=300, impl=impl)
    p = _np(tres.eigenvector)
    assert np.abs(p - np.asarray(jres.eigenvector)).sum() <= 1e-6
    assert p.sum() == pytest.approx(1.0, abs=1e-5) and np.all(p > 0)
    assert bool(tres.converged) and abs(int(tres.iterations) - int(jres.iterations)) <= 2


def test_evolving_pagerank_matches_fresh_builds_and_repro():
    n = 64
    rng = np.random.default_rng(21)
    src, dst = rng.integers(0, n, 400), rng.integers(0, n, 400)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    jev = jsolvers.EvolvingPageRank.build(src, dst, n, block_size=16)
    tev = tsolvers.EvolvingPageRank.build(src, dst, n, block_size=16, device="cpu")
    _same_bits(jev.canon_order, tev.canon_order)
    steps = [rng.uniform(0.1, 2.0, len(src)) for _ in range(3)]
    tres_all = tsolvers.evolving_pagerank(src, dst, n, steps, block_size=16, device="cpu",
                                          maxiter=150)
    for w, tres_ev in zip(steps, tres_all):
        vals = tev.canonical_values(w)
        _same_bits(jev.canonical_values(w), vals)
        op = tev.op.with_values(vals)
        fresh, dangling = _pagerank_fresh(src, dst, n, w)
        for f in tstreams._STREAM_FIELDS:
            assert torch.equal(getattr(op.streams, f), getattr(fresh.streams, f)), f
        tres = tev.step(w, maxiter=150)
        assert torch.equal(tres.eigenvector, tsolvers.pagerank(fresh, dangling,
                                                               maxiter=150).eigenvector)
        assert torch.equal(tres.eigenvector, tres_ev.eigenvector)
        jres = jev.step(w, impl="reference", maxiter=150)
        assert np.abs(_np(tres.eigenvector) - np.asarray(jres.eigenvector)).sum() <= 1e-6


def test_evolving_pagerank_rejects_structure_drift():
    ev = tsolvers.EvolvingPageRank.build(np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0]), 32,
                                         block_size=16, device="cpu")
    with pytest.raises(errors.InvalidArgError, match="structure drift"):
        ev.canonical_values(np.array([1.0, 0.0, 1.0, 1.0]))
    with pytest.raises(errors.InvalidArgError, match="one weight per"):
        ev.canonical_values(np.ones(3))


def test_public_names_match_repro():
    import repro.solvers as jpkg

    jnames = {k for k in vars(jpkg) if not k.startswith("_")} - {
        "operator", "krylov", "precond", "eigen"}
    tnames = {k for k in vars(tsolvers) if not k.startswith("_")} - {
        "operator", "krylov", "precond", "eigen"}
    assert jnames == tnames
