#!/usr/bin/env python3
"""Probe the collectives the mesh's training uses on one card, then run that phase alone.

    python3 scripts/mesh_probe.py          # about four minutes on an H100

1. ``collectives``: two ranks spawned on ``cuda:0`` under gloo (NCCL refuses
   two ranks on one card) and one rank under NCCL run each collective
   ``repro_torch.models.sharding`` uses on CUDA tensors, through its own
   functions (gloo stages CUDA tensors through the host) and straight through
   c10d: all-reduce (sum, max), all-gather and reduce-scatter along a
   non-leading dim, ``full_tensor`` of a ``DTensor``, the differentiable
   ``gather_over`` / ``reduce_over`` / ``sum_grad`` with their backward,
   and ``constrain`` of a ``DTensor`` at its own layout; each is held to the
   sum it should give.
2. ``full_tensor``: ``DTensor.full_tensor()`` on a CUDA tensor under two gloo
   ranks, in processes of their own, and their exit codes (it crashed in
   torch 2.11: ROADMAP C.11).
3. the ``mesh`` phase of ``chip_smoke.py`` (``chip_smoke.run_mesh``): the
   ``train`` line's two-step run at full width (its reference), then the
   ``mesh_train`` 1x1 (one NCCL rank), ``mesh_train`` 2x2 (cb-paper, 2 layers)
   and ``mesh_moe`` 1x2 (mixtral, 2 layers) lines, each checked as
   ``chip_smoke.py`` checks it.

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
import time

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import axis_rules, constrain  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402

TIMEOUT = 120


def _checks(rank: int, world: int) -> dict:
    mesh = make_mesh((1, world), ("data", "model"))
    group = mesh.get_group("model")
    dev = torch.device("cuda", 0)
    want = float(sum(range(1, world + 1)))
    res = {}

    def run(name, fn):
        try:
            res[name] = bool(fn())
        except Exception as e:            # noqa: BLE001 -- the probe reports each op's fault
            res[name] = f"{type(e).__name__}: {e}"[:300]

    a = torch.full((3, 4 * world), float(rank + 1), device=dev)
    run("sharding.all_reduce sum", lambda: (S.all_reduce(a, mesh, "model") == want).all())
    run("sharding.all_reduce max", lambda: (S.all_reduce(
        a, mesh, "model", op=dist.ReduceOp.MAX) == world).all())
    g = S.all_gather(a, mesh, "model", 1)
    run("sharding.all_gather dim 1", lambda: g.shape == (3, 4 * world * world) and all(
        (g[:, 4 * world * r:4 * world * (r + 1)] == r + 1).all() for r in range(world)))
    run("sharding.reduce_scatter dim 1", lambda: torch.equal(
        S.reduce_scatter(a, mesh, "model", 1), torch.full((3, 4), want, device=dev)))
    d = S.distribute_local(torch.arange(8.0 * world, device=dev).reshape(2, 4 * world), mesh,
                           S.placements_for(mesh, None, "heads"))
    run("sharding.full_tensor", lambda: torch.equal(
        S.full_tensor(d), torch.arange(8.0 * world, device=dev).reshape(2, 4 * world)))
    x = torch.full((2, 4), float(rank + 1), device=dev, requires_grad=True)
    y = S.gather_over(x, mesh, "model", 1)
    y.backward(torch.ones_like(y))
    run("gather_over backward (reduce-scatter)", lambda: (x.grad == world).all())
    x.grad = None
    y = S.gather_over(x, mesh, "model", 1, grad="slice")
    y.backward(torch.ones_like(y))
    run("gather_over backward (slice)", lambda: (x.grad == 1).all())
    x.grad = None
    y = S.reduce_over(x, mesh, ("model",))
    y.backward(torch.ones_like(y))
    run("reduce_over", lambda: (y == want).all() and (x.grad == 1).all())
    x.grad = None
    y = S.sum_grad(x, mesh)
    y.backward(torch.ones_like(y))
    run("sum_grad", lambda: torch.equal(y, x) and (x.grad == world).all())
    with axis_rules(mesh):
        run("constrain at its own layout", lambda: torch.equal(
            constrain(d, None, "heads").to_local(), d.to_local()))
    # c10d on CUDA tensors, not staged
    b = a.clone()
    run("c10d all_reduce (CUDA)", lambda: (dist.all_reduce(b, group=group), (b == want).all())[1])
    out = torch.empty((3 * world, 4 * world), device=dev)
    run("c10d all_gather_into_tensor (CUDA)", lambda: (
        dist.all_gather_into_tensor(out, a, group=group), out.shape[0] == 3 * world)[1])
    rs = torch.empty((3, 4), device=dev)
    src = torch.full((3 * world, 4), float(rank + 1), device=dev)
    run("c10d reduce_scatter_tensor (CUDA)", lambda: (
        dist.reduce_scatter_tensor(rs, src, group=group), (rs == want).all())[1])
    return res


def probe_rank(rank: int, world: int, backend: str, store: str, out: str, task: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        if task == "checks":
            res = _checks(rank, world)
        else:                               # DTensor's own gather, which may crash the process
            mesh = make_mesh((world,), ("model",))
            d = S.distribute_local(torch.arange(4.0 * world, device="cuda"), mesh,
                                   S.placements_for(mesh, "heads"))
            res = {"full_tensor": bool(torch.equal(d.full_tensor().cpu(),
                                                   torch.arange(4.0 * world)))}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(res, pathlib.Path(out) / f"{backend}-{task}-{world}-{rank}.pt")


def spawn(world: int, backend: str, task: str, tmp: pathlib.Path) -> dict:
    ctx = multiprocessing.get_context("spawn")
    store = tmp / f"store-{backend}-{task}-{world}"
    procs = [ctx.Process(target=probe_rank, args=(r, world, backend, str(store), str(tmp), task))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    results = [torch.load(tmp / f"{backend}-{task}-{world}-{r}.pt") if c == 0 else None
               for r, c in enumerate(codes)]
    return dict(exit_codes=codes, results=results)


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi(), flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for world, backend in ((2, "gloo"), (1, "nccl")):
            r = spawn(world, backend, "checks", tmp)
            good = all(c == 0 for c in r["exit_codes"]) and all(
                v is True for res in r["results"] for v in res.values())
            ok &= good
            cs.emit("collectives", backend=backend, ranks=world, ok=good, **r)
        r = spawn(2, "gloo", "full_tensor", tmp)
        cs.emit("full_tensor", backend="gloo", ranks=2, torch=torch.__version__, **r)

    # the mesh phase alone, after the train line's two-step reference run
    torch.backends.cuda.matmul.allow_tf32 = False      # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.get_config(cs.TRAIN["arch"])
    model = cs.Model(cfg)
    st, hist = cs.run_training(model, cs.train_stream(cfg), cs.train_loop_config(2),
                               initial_state=cs.fresh_state(model, 0))
    two_step = ([h["loss"] for h in hist], [p.detach().cpu() for p in st.params.parameters()])
    del st, model
    torch.cuda.empty_cache()
    launches = {k: 0 for k in cs.WRAPPERS}
    per_kernel = {k: [] for k in cs.WRAPPERS}
    mesh_launches = {}
    cs.run_mesh(0, dict(two_step=two_step, step_ms=None, peak_mem_gb=None), per_kernel,
                launches, mesh_launches)
    cs.emit("mesh_launches", launches=launches, per_run=mesh_launches,
            worst_err=dict(cs.worst_err), kernel_rows=per_kernel)
    print(cs.smi(), flush=True)
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
