"""Rank-parallel CB-SpMV: the paper's pq balancer scaled to a mesh axis.

    PYTHONPATH=src python examples_torch/distributed_spmv.py                # on the card
    PYTHONPATH=src python examples_torch/distributed_spmv.py --device cpu

The port of ``examples/distributed_spmv.py``, which forces 8 host devices.
Here 8 processes are started, each a rank of a gloo process group on the
``model`` axis of a ``DeviceMesh``, joined through a file store in a
temporary directory (no port). On the card the 8 ranks share ``cuda:0``
(NCCL refuses two ranks on one card), each launching the CUDA kernels on
its shard; ``--device cpu`` runs them on the CPU through the kernels' plain
versions. The ranks are forked from a ``forkserver`` that has imported
``PRELOAD`` (and with it torch) once, where ``spawn`` would import them again
in each. Each rank must end within ``TIMEOUT_S`` seconds. ``main`` returns
what it printed as numbers, with the gathered ``y`` and the kernel launches
of every rank.
"""
import argparse
import atexit
import multiprocessing
import multiprocessing.forkserver
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core import CBMatrix
from repro_torch.core import distributed as dist
from repro_torch.core.spmv_ref import dense_oracle
from repro_torch.core.streams import resolve_device
from repro_torch.data import matrices
from repro_torch.kernels import cb_block_dense, cb_colagg, cb_combine, cb_coo
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import full_tensor

RANKS = 8
TIMEOUT_S = 120.0      # seconds the ranks may take, start-up included
# the modules a rank needs, imported once by the server the ranks are forked from
PRELOAD = ["repro_torch.core.distributed", "repro_torch.launch.mesh",
           "repro_torch.models.sharding"]
# on the way out, stop that server and wait for it: left to itself it outlives
# this process while its imports unwind
atexit.register(multiprocessing.forkserver._forkserver._stop)
KERNELS = {"dense": cb_block_dense.block_dense_spmv_batched,
           "panel": cb_colagg.panel_spmv_batched,
           "panel_bitmap": cb_colagg.panel_spmv_bitmap,
           "coo": cb_coo.coo_spmv_batched,
           "combine": cb_combine.segment_combine}


def build_matrix():
    m = n = 2048
    rows, cols, vals = matrices.power_law(m, n, seed=4)
    cb = CBMatrix.from_coo(rows, cols, vals, (m, n), block_size=16,
                           val_dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    return (rows, cols, vals), cb, x


def _rank(rank: int, job: dict) -> None:
    """One rank (a process of its own): join the group, run its shard, save y."""
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    tdist.init_process_group("gloo", init_method=f"file://{job['store']}", rank=rank,
                             world_size=job["ranks"])
    try:
        _, cb, x = build_matrix()
        sharded = dist.shard_streams(cb, job["ranks"])
        mesh = make_mesh((job["ranks"],), ("model",), device_type=device.type)
        for w in KERNELS.values():
            w.launches = 0
        y = full_tensor(dist.distributed_spmv(sharded, torch.from_numpy(x), mesh,
                                              device=device))
        out = {"y": y.cpu(), "launches": {k: w.launches for k, w in KERNELS.items()}}
    finally:
        tdist.destroy_process_group()
    torch.save(out, pathlib.Path(job["out"]) / f"rank{rank}.pt")


def run_ranks(device: torch.device, ranks: int, timeout: float) -> list[dict]:
    """Start ``ranks`` processes of ``_rank``; each must exit 0 within ``timeout``."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    with tempfile.TemporaryDirectory() as tmp:
        job = dict(device=device.type, ranks=ranks, store=f"{tmp}/store", out=tmp)
        procs = [ctx.Process(target=_rank, args=(r, job)) for r in range(ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if alive:
            raise TimeoutError(f"ranks {alive} still running after {timeout} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [torch.load(pathlib.Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(ranks)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    (rows, cols, vals), cb, x = build_matrix()
    m, n = cb.shape
    print(f"matrix {m}x{n} nnz={cb.nnz}, blocks={cb.num_blocks}")

    n_dev = RANKS
    sharded = dist.shard_streams(cb, n_dev)
    print(f"pq-balanced over {n_dev} ranks: nnz per rank = "
          f"{sharded.device_nnz.tolist()} "
          f"(imbalance {sharded.load_imbalance:.3f})")

    res = run_ranks(device, n_dev, TIMEOUT_S)
    y = res[0]["y"].numpy()
    y_ref = dense_oracle(rows, cols, vals.astype(np.float32), (m, n), x)
    err = float(np.abs(y - y_ref).max())
    print(f"distributed CB-SpMV max abs error: {err:.2e}")
    assert err < 1e-3
    print("OK")
    return {"m": m, "n": n, "nnz": int(cb.nnz), "blocks": int(cb.num_blocks), "ranks": n_dev,
            "one_card": device.type == "cuda", "backend": "gloo",
            "device_nnz": sharded.device_nnz.tolist(),
            "load_imbalance": sharded.load_imbalance, "err_vs_oracle": err, "y": y,
            "ranks_agree": all(np.array_equal(r["y"].numpy(), y) for r in res),
            "rank_launches": {k: sum(r["launches"][k] for r in res) for k in KERNELS}}


if __name__ == "__main__":
    main()
