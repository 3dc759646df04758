#!/usr/bin/env python3
"""Where a group of ranks spends its seconds, by start method.

    python3 scripts/rank_startup_probe.py          # about three minutes on an H100

Starts the ``distributed_spmv`` example's 8 gloo ranks on ``cuda:0`` (the
``examples`` phase of ``chip_smoke.py``), and one rank, under ``spawn``,
under ``forkserver`` as Python 3.12 runs it by default, and under
``forkserver`` with a named preload, as ``chip_smoke.py`` and the example
run them. This script imports ``chip_smoke`` (as ``chip_smoke.py``'s ranks
re-import it) before it starts any rank. Each rank stamps the wall clock at
its entry and after each stage; a line per group gives, in seconds, the time
to the last rank's entry and each stage's slowest rank. Prints one JSON
object a line and the card's name and power limit; exits non-zero without a
GPU.
"""
from __future__ import annotations

import json
import multiprocessing
import multiprocessing.forkserver
import pathlib
import sys
import tempfile
import time

import torch
import torch.distributed as tdist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from examples_torch import distributed_spmv as ex  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.sharding import full_tensor  # noqa: E402


def rank(r: int, job: dict) -> None:
    t = {"entry": time.time()}
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t["cuda_init"] = time.time()
    tdist.init_process_group("gloo", init_method=f"file://{job['store']}", rank=r,
                             world_size=job["ranks"])
    t["group_init"] = time.time()
    _, cb, x = ex.build_matrix()
    sh = dist.shard_streams(cb, job["ranks"])
    mesh = make_mesh((job["ranks"],), ("model",), device_type="cuda")
    t["shard"] = time.time()
    for stage in ("first_spmv", "second_spmv"):
        full_tensor(dist.distributed_spmv(sh, torch.from_numpy(x), mesh,
                                          device=torch.device("cuda", 0)))
        torch.cuda.synchronize()
        t[stage] = time.time()
    tdist.destroy_process_group()
    t["group_destroy"] = time.time()
    pathlib.Path(job["out"], f"t{r}.json").write_text(json.dumps(t))


def group(method: str, ranks: int) -> dict:
    ctx = multiprocessing.get_context(method.split()[0])
    with tempfile.TemporaryDirectory() as tmp:
        job = dict(ranks=ranks, store=f"{tmp}/store", out=tmp)
        t0 = time.time()
        procs = [ctx.Process(target=rank, args=(r, job)) for r in range(ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        t_end = time.time()
        if any(p.exitcode != 0 for p in procs):
            cs.fail(f"{method}: ranks exited with {[p.exitcode for p in procs]}")
        ts = [json.loads(pathlib.Path(tmp, f"t{r}.json").read_text()) for r in range(ranks)]
    out = dict(method=method, ranks=ranks, total_s=t_end - t0,
               to_last_entry_s=max(t["entry"] for t in ts) - t0)
    stages = list(ts[0])
    for prev, k in zip(stages, stages[1:]):
        out[f"{k}_s"] = max(t[k] - t[prev] for t in ts)
    out["exit_s"] = t_end - max(t[stages[-1]] for t in ts)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_startup_probe: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi(), flush=True)
    torch.zeros(1, device="cuda")          # the parent holds a context, as chip_smoke.py does
    fs = multiprocessing.get_context("forkserver")
    for method, preload in (("spawn", None), ("forkserver (Python's default)", ["__main__"]),
                            ("forkserver (preload)", ["chip_smoke"])):
        if preload:
            multiprocessing.forkserver._forkserver._stop()   # a new server, this preload
            fs.set_forkserver_preload(preload)
        for ranks in (8, 8, 1):
            cs.emit("rank_group", **group(method, ranks))
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
