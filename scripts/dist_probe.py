#!/usr/bin/env python3
"""Probe the collectives a one-card ``dist`` run can use, then run that phase alone.

    python3 scripts/dist_probe.py          # about three minutes on an H100

1. ``collectives``: two ranks spawned on ``cuda:0`` under gloo (NCCL refuses
   two ranks on one card) and one rank under NCCL try each collective
   ``distributed_spmv`` and its ``DTensor`` result need on CUDA tensors —
   ``all_reduce``, ``reduce_scatter_tensor``, ``all_gather_into_tensor`` —
   and print which ran and agreed with the sum they should give.
2. the ``dist`` phase of ``chip_smoke.py`` (``chip_smoke.run_dist``): the
   ``spmv`` lines of its banded and power-law matrices (real size, the same
   seeds), then ``distributed_spmv`` on 1 NCCL rank and on 2 and 4 gloo ranks
   sharing the card, with the combines step 1 found working, each line
   checked as ``chip_smoke.py`` checks it.

Prints one JSON object a line, the card's name and power limit as
``nvidia-smi`` gives them, and exits non-zero without a GPU or on any
failed check.
"""
from __future__ import annotations

import json
import multiprocessing
import pathlib
import sys
import tempfile

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OPS = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")
TIMEOUT = 120


def probe_rank(rank: int, world: int, backend: str, store: str, out: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    res = {}
    try:
        for op in OPS:
            n = 1024 * world
            a = torch.full((n,), float(rank + 1), device="cuda")
            want = float(sum(range(1, world + 1)))
            try:
                if op == "all_reduce":
                    dist.all_reduce(a)
                    ok = bool((a == want).all())
                elif op == "reduce_scatter_tensor":
                    b = torch.empty(n // world, device="cuda")
                    dist.reduce_scatter_tensor(b, a)
                    ok = bool((b == want).all())
                else:
                    b = torch.empty(n * world, device="cuda")
                    dist.all_gather_into_tensor(b, a)
                    ok = bool((b.view(world, n)[:, 0].cpu() ==
                               torch.arange(1, world + 1, dtype=torch.float32)).all())
                torch.cuda.synchronize()
                res[op] = "ok" if ok else "wrong result"
            except Exception as e:             # the probe's question: does it run at all
                res[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    finally:
        dist.destroy_process_group()
    pathlib.Path(out, f"probe-{backend}-{world}-{rank}.json").write_text(json.dumps(res))


def probe(world: int, backend: str, tmp: str) -> dict:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=probe_rank,
                         args=(r, world, backend, f"{tmp}/store-{backend}-{world}", tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        return {"exitcodes": codes}
    return json.loads(pathlib.Path(tmp, f"probe-{backend}-{world}-0.json").read_text())


def main() -> None:
    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    cs.emit("device", nvidia_smi=cs.smi(), torch=torch.__version__, cuda=torch.version.cuda)
    cs.emit("build", **{k: v for k, v in cs._build.build_info().items() if k == "seconds"})
    with tempfile.TemporaryDirectory() as tmp:
        found = {"nccl 1": probe(1, "nccl", tmp), "gloo 2": probe(2, "gloo", tmp)}
    cs.emit("collectives", **found)
    ran = {op for op, r in found["gloo 2"].items() if r == "ok"}
    gloo_combines = tuple(c for c, need in (
        ("psum_scatter", {"reduce_scatter_tensor", "all_gather_into_tensor"}),
        ("psum", {"all_reduce"})) if need <= ran)
    if not gloo_combines:
        cs.fail(f"gloo on CUDA tensors runs neither combine: {found['gloo 2']}")
    runs = (cs.DIST_RUNS[0],) + tuple((D, b, gloo_combines) for D, b, _ in cs.DIST_RUNS[1:])

    per_kernel = {k: [] for k in cs.WRAPPERS}
    launches = {k: 0 for k in cs.WRAPPERS}
    inputs = {}
    for name, heavy, call, make, shape in cs.make_matrices(0):
        if name in cs.DIST_MATRICES:
            cb, coo, y, spmv_ms = cs.run_matrix(name, heavy, call, make, shape, 0, per_kernel,
                                                launches)
            inputs[name] = (cb, coo, y, spmv_ms, call)
            torch.cuda.empty_cache()
    dist_launches = {}
    cs.run_dist(inputs, 0, launches, dist_launches, runs=runs)
    cs.emit("dist_launches", **dist_launches)
    print(cs.smi(), flush=True)


if __name__ == "__main__":
    main()
