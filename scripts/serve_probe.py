#!/usr/bin/env python3
"""Profile one serving tick of the cb-paper model on one NVIDIA GPU.

    python3 scripts/serve_probe.py         # about a minute on an H100

Builds ``chip_smoke.py``'s ``serve`` model (``repro_torch.models.Model`` of
``get_config("cb-paper")``: granite-8b at full width, all 36 layers,
CB-sparse SwiGLU at B = 128, bfloat16 activations, float32 weights from a
CUDA generator seeded 0), fills a 4-slot, 256-deep decode state with 8
prompt tokens, then runs ``torch.profiler`` over ``REPS`` synchronised
``decode_step`` calls from that state. Prints one JSON line:

- ``wall_ms`` / ``device_busy_ms`` / ``idle_share`` per step: the summed
  kernel time against the host clock under the profiler, and
  ``wall_ms_unprofiled`` / ``idle_share_unprofiled`` against the same steps
  run before it without the profiler's host cost;
- ``device_ms_by_kernel``: device time per step of the costliest kernels,
  and ``device_ms_by_group``: the same summed into the spmm kernel, the
  combine, cuBLAS's GEMMs and GEMVs, the elementwise copies (the float32 ->
  bfloat16 weight casts among them) and the rest;
- ``host_ms_by_op``: the host's self time per step of the costliest aten
  ops, and ``ops_per_step``: aten ops dispatched.

Exits non-zero without a GPU.
"""
from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

SLOTS, MAX_LEN, PREFILL, REPS = 4, 256, 8, 5
DEV = torch.device("cuda")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def group(name: str) -> str:
    n = name.lower()
    if "cb_spmm" in n or "super_tile" in n:
        return "spmm kernel"
    if "segment" in n or "combine" in n:
        return "combine"
    if any(k in n for k in ("gemm", "gemv", "nvjet", "cutlass", "sm90")):   # cuBLAS / cuBLASLt
        return "gemm"
    if "copy" in n or "convert" in n:
        return "casts and copies"
    return "other"


def main() -> None:
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    cfg = get_config("cb-paper")
    model = Model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    state = model.init_decode_state(SLOTS, MAX_LEN)
    rng = np.random.default_rng(41)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, PREFILL)).astype(np.int32))
    toks = toks.to(DEV)
    for t in range(PREFILL):
        _, state = model.decode_step(params, state, toks[:, t:t + 1],
                                     torch.full((SLOTS,), t, dtype=torch.int32, device=DEV))
    pos = torch.full((SLOTS,), PREFILL, dtype=torch.int32, device=DEV)

    def step():
        model.decode_step(params, state, toks[:, -1:], pos)
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    for _ in range(REPS):
        step()
    wall_off = (time.perf_counter() - t0) * 1e3 / REPS
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            step()
        wall = (time.perf_counter() - t0) * 1e3 / REPS
    by_kernel, host, n_ops = collections.Counter(), collections.Counter(), 0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] += dev / 1e3 / REPS
        if e.key.startswith("aten::"):
            host[e.key] += e.self_cpu_time_total / 1e3 / REPS
            n_ops += e.count
    by_group = collections.Counter()
    for k, ms in by_kernel.items():
        by_group[group(k)] += ms
    busy = sum(by_kernel.values())
    print(json.dumps({"serve_probe": dict(
        config=cfg.name, layers=cfg.num_layers, slots=SLOTS, max_len=MAX_LEN, reps=REPS,
        wall_ms=wall, device_busy_ms=busy, idle_share=max(0.0, 1.0 - busy / wall),
        wall_ms_unprofiled=wall_off, idle_share_unprofiled=max(0.0, 1.0 - busy / wall_off),
        device_ms_by_group=dict(by_group.most_common()),
        device_ms_by_kernel=dict(by_kernel.most_common(15)),
        host_ms_by_op=dict(host.most_common(15)), ops_per_step=n_ops / REPS,
        nvidia_smi=smi())}), flush=True)


if __name__ == "__main__":
    main()
