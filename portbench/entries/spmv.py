"""Back-to-back ``cb_spmv`` calls over a pool of x vectors.

Set-up: ``CBMatrix.from_coo`` -> ``build_super_streams`` -> ``.to(device)``
at the port's defaults. Window: one caller dispatches ``ops.cb_spmv`` round
robin over the pool with no synchronise until the window's end. The y of a
sample of calls, drawn from the seed, is kept and checked afterwards
against the float64 reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.cb_matrix import CBMatrix
from repro_torch.core.streams import build_super_streams
from repro_torch.kernels import ops
from reference.sparse import of_matrix, round_tf32

UNIT = "call"
BLOCKING = False


def make_inputs(matrix: dict, config: dict, traffic: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    n = matrix["shape"][1]
    lo, hi = float(traffic["x_low"]), float(traffic["x_high"])
    X = torch.rand((int(traffic["pool"]), n), generator=g, device=device,
                   dtype=torch.float32) * (hi - lo) + lo
    return {"X": X}


class Program:
    def __init__(self, matrix: dict, config: dict, traffic: dict, inputs: dict, seed: int,
                 device: torch.device):
        self.device = device
        self.X = inputs["X"]
        self.traffic = traffic
        self.rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        cb = CBMatrix.from_coo(matrix["rows"], matrix["cols"], matrix["vals"], matrix["shape"],
                               block_size=int(config["block_size"]),
                               val_dtype=np.dtype(config["value_dtype"]))
        self.streams = build_super_streams(cb).to(device)
        del cb
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_s = time.perf_counter() - t0
        self.stride, self.offset, self.cap = 1, 0, 4 * int(traffic["kept_outputs"])
        self.kept: list = []
        self.last = None

    def call(self, i: int) -> torch.Tensor:
        return ops.cb_spmv(self.streams, self.X[i % self.X.shape[0]], device=self.device)

    def warm_up(self) -> float:
        """Warm every shape; return seconds per call, synchronised."""
        for i in range(int(self.traffic["warmup_calls"])):
            self.call(i)
        self.sync()
        t0 = time.perf_counter()
        for i in range(16):
            self.call(i)
        self.sync()
        return (time.perf_counter() - t0) / 16

    def plan_keep(self, expected_units: int) -> None:
        """Keep every stride-th call's y from a seeded offset: about
        ``kept_outputs`` of the window's calls, never more than four times that."""
        self.stride = max(1, expected_units // int(self.traffic["kept_outputs"]))
        self.offset = int(self.rng.integers(self.stride))

    def kept_bytes(self, expected_units: int) -> int:
        """Device memory the kept y's will hold at most."""
        return self.cap * self.streams.m * 4

    def step(self, i: int) -> None:
        y = self.call(i)
        if i % self.stride == self.offset and len(self.kept) < self.cap:
            self.kept.append((i % self.X.shape[0], y))
        self.last = (i % self.X.shape[0], y)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def results(self) -> dict:
        return {"failed": 0}

    def outputs(self) -> list:
        return self.kept + ([self.last] if self.last is not None else [])

    def free(self) -> None:
        self.streams = None


def check(matrix: dict, inputs: dict, outputs: list, traffic: dict, device) -> dict:
    """y_err: the largest row error of a kept y, |y - A x|_i over (|A| |x|)_i
    (both float64, from the benchmark's own triplets and x). Each row is held
    to its own scale, so an error in an ordinary row is not divided away by a
    hub row's; an empty row has to read exactly 0."""
    A = of_matrix(matrix, device)
    tiny = torch.finfo(torch.float64).tiny
    err, refs = 0.0, {}
    for xi, y in outputs:
        if xi not in refs:
            x = inputs["X"][xi]
            refs[xi] = (A.matvec(x), A.matvec(x, absolute=True).clamp_min_(tiny))
        yref, scale = refs[xi]
        err = max(err, float(((y.to(torch.float64) - yref).abs() / scale).max()))
    return {"y_err": err}


def control(matrix: dict, inputs: dict, traffic: dict, device) -> list:
    """The reference in the program's place in TF32: values and x rounded to
    a 10-bit mantissa, products summed in float32."""
    A = of_matrix(matrix, device, dtype=torch.float32, round_fn=round_tf32)
    return [(i, A.matvec(inputs["X"][i])) for i in range(inputs["X"].shape[0])]


def extra(run) -> dict | None:
    """The fig9 yardstick, printed by traced runs and never a metric:
    ``torch.sparse`` CSR ``A @ x`` on the same matrix (CUDA events over 50
    back-to-back products), beside cb_spmv's summed device time per call
    from the sub-window."""
    if run.device.type != "cuda" or run.program is None:
        return None
    m = run.matrix
    idx = torch.stack([torch.as_tensor(m["rows"], dtype=torch.int64),
                       torch.as_tensor(m["cols"], dtype=torch.int64)]).to(run.device)
    A = torch.sparse_coo_tensor(idx, torch.as_tensor(m["vals"]).to(run.device),
                                m["shape"]).coalesce().to_sparse_csr()
    del idx
    x = run.program.X[0]
    for _ in range(3):
        A @ x
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        A @ x
    end.record()
    end.synchronize()
    tr = run.trace
    cb_ms = (sum(o[3] for o in tr.ops) / tr.units / 1e3) if tr and tr.units else None
    return {"yardstick": "torch.sparse CSR A @ x", "csr_ms": start.elapsed_time(end) / 50,
            "cb_spmv_device_ms": cb_ms}
