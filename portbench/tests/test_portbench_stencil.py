"""The ``hpcg-160`` configuration on the CPU at a tiny grid: HPCG's stencil
generator, the stencil reference against the COO reference, the program
against both, and the ``hpcg160-spmv`` cell's check, control and faults."""
import types

import numpy as np
import pytest
import torch

import pb_common
from pb_common import SEED
from harness import runner, spec
from reference import stencil
from repro_torch import obs
from reference.sparse import of_matrix
from test_portbench_harness import FAULTS

CELL = "hpcg160-spmv"
GRID = {"nx": 24, "ny": 16, "nz": 8}
TINY = {"params": GRID}
BENCH = pb_common.bench()
hpcg = spec.module("matrices", "hpcg_stencil")


def _nnz(nx, ny, nz):
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


@pytest.mark.parametrize("grid", [GRID, {"nx": 5, "ny": 5, "nz": 5}, {"nx": 1, "ny": 3, "nz": 2}],
                         ids=["24x16x8", "5^3", "1x3x2"])
def test_stencil_sizes_values_and_order(grid):
    m = hpcg.generate(grid, SEED)
    r, c, v = m["rows"], m["cols"], m["vals"]
    n = grid["nx"] * grid["ny"] * grid["nz"]
    assert m["shape"] == (n, n) and r.size == _nnz(**grid)
    assert v.dtype == np.float32 and r.min() >= 0 and c.min() >= 0 and c.max() < n
    key = r * n + c
    assert np.all(np.diff(key) > 0)                               # sorted by (row, col), unique
    assert np.array_equal(np.sort(c * n + r), key)                # symmetric pattern
    assert np.all(v[r == c] == 26) and np.all(v[r != c] == -1)    # so symmetric values too
    assert np.array_equal(np.bincount(r[r == c], minlength=n), np.ones(n))


def test_stencil_rows_follow_hpcgs_grid():
    """An interior point has its 26 box neighbours, a corner 7."""
    nx, ny, nz = 5, 4, 3
    m = hpcg.generate({"nx": nx, "ny": ny, "nz": nz}, SEED)
    r, c = m["rows"], m["cols"]
    row = 1 * nx * ny + 2 * nx + 3                                # (ix, iy, iz) = (3, 2, 1)
    want = sorted(row + dz * nx * ny + dy * nx + dx
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    assert c[r == row].tolist() == want
    assert c[r == 0].tolist() == [0, 1, nx, nx + 1, nx * ny, nx * ny + 1, nx * ny + nx,
                                  nx * ny + nx + 1]


def test_the_seed_does_not_change_the_matrix():
    a, b = hpcg.generate(GRID, SEED), hpcg.generate(GRID, SEED + 1)
    assert all(np.array_equal(a[k], b[k]) for k in ("rows", "cols", "vals"))


@pytest.mark.parametrize("grid", [{"nx": 9, "ny": 9, "nz": 9}, GRID], ids=["cube", "non-cube"])
def test_coo_reference_equals_the_stencil_reference(grid):
    m = hpcg.generate(grid, SEED)
    A = of_matrix(m, "cpu")
    g = torch.Generator().manual_seed(SEED)
    for _ in range(3):
        x = torch.rand(m["shape"][1], generator=g, dtype=torch.float32) * 2 - 1
        y = stencil.matvec(x, grid["nx"], grid["ny"], grid["nz"])
        assert y.dtype == torch.float64
        torch.testing.assert_close(A.matvec(x), y, rtol=1e-12, atol=1e-12)


def test_program_matches_the_references_within_the_cells_limit():
    cell = spec.Cell(BENCH, CELL, TINY)
    m = cell.matrix_gen.generate(cell.config["params"], SEED)
    dev = torch.device("cpu")
    inputs = cell.entry.make_inputs(m, cell.config, cell.traffic, SEED, dev)
    prog = cell.entry.Program(m, cell.config, cell.traffic, inputs, SEED, dev)
    outputs = [(i, prog.call(i)) for i in range(4)]
    y_err = cell.entry.check(m, inputs, outputs, cell.traffic, dev)["y_err"]
    assert y_err <= float(cell.limits["y_err"]["limit"])
    x = inputs["X"][1]
    ref = stencil.matvec(x, **GRID)
    assert float((outputs[1][1].double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert prog.streams.panel_vals.shape[0] > 0          # the panel path runs


def test_traced_cpu_run_is_correct_and_reports_panel_fill():
    line = runner.run_cell(CELL, SEED, 1.5, True, device="cpu", config_override=TINY,
                           bench=BENCH)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    fill = metrics["panel_fill"]
    assert 5.0 < fill <= 100.0 and "build_s" in metrics
    assert set(metrics) <= {m["name"] for m in spec.Cell(BENCH, CELL).per_layer()}
    # the CPU has no device trace: the kernel metrics are left out, never 0
    assert not {"panel_us", "gather_us", "spmv_roofline"} & set(metrics)


def test_untraced_cpu_run_reports_the_end_to_end_metrics():
    line = runner.run_cell(CELL, SEED, 0.6, False, device="cpu", config_override=TINY,
                           bench=BENCH)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "spmv_gflops"}


def test_control_fails_the_limit():
    import control
    nums = control.control_numbers(CELL, SEED, "cpu", TINY, bench=BENCH)
    limit = float(spec.Cell(BENCH, CELL).limits["y_err"]["limit"])
    assert nums["y_err"] > limit, nums


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    line = runner.run_cell(CELL, SEED, 0.4, False, device="cpu", config_override=TINY,
                           bench=BENCH)
    assert line["correct"] is False, line["checks"]


def test_panel_fill_reads_the_gauge_over_the_slots_of_a_call():
    read = spec.module("metrics", "panel_fill").read
    run = types.SimpleNamespace(trace=None)
    obs.reset()
    try:
        assert read(run) is None
        obs.gauge("repro.streams.nnz").set(30, format="panel")
        assert read(run) is None                             # no call yet
        obs.counter("repro.ops.spmv.calls").inc(2, impl="cuda")
        obs.counter("repro.ops.spmv.padded_elems").inc(400, format="panel")
        assert read(run) == pytest.approx(15.0)
    finally:
        obs.reset()
