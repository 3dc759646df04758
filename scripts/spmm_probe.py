#!/usr/bin/env python3
"""Check and time the port's SpMM kernel alone, on one NVIDIA GPU.

    python3 scripts/spmm_probe.py               # checks + times, about a minute
    python3 scripts/spmm_probe.py --variants    # also times source variants

A quicker loop than ``chip_smoke.py`` for work on ``csrc/cb_spmm.cu``. It
builds the kernel library, holds ``super_tile_spmm`` against its plain
version over B in {1, 8, 16, 24, 32, 33, 64, 100, 128} x N in {1, 16, 17,
20, 33, 127, 128, 129, 1025, 2049}, every (tile, X) dtype pair in turn, X aligned
and one element past an aligned base, normal data within 1e-4 of the largest
value and integer data bit for bit, and all-empty slots as exact zeros. Then
it times the kernel (CUDA events, 20 warm calls, median of 3 batches) at the
cb-paper MLP's shape (896 tiles of 128 x 128, N = 4096) and at the solver's
``matmat`` shape (24,576 groups of 16 tiles of 16 x 16, N = 16), beside
``torch.bmm`` on pre-gathered X blocks (float32, TF32 off).

``--variants`` compiles copies of ``cb_spmm.cu`` with one change each (the
TF32 rounding by integer ops in place of ``cvt.rna``; only the hi*hi product;
no split at all; the guarded stage on full tiles too; the full stage unrolled
by 2 or 4 across k-steps) into separate libraries and times
their wide kernel at the MLP shape, to show where its time goes. The copies'
results are not all right (that is the point of two of them) and are never
used but here. Prints one JSON line; exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, cb_spmm  # noqa: E402

DEV = torch.device("cuda")
TOL = 1e-4


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    batches = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        batches.append(a.elapsed_time(b) / reps)
    return statistics.median(batches)


def check_grid(gen) -> tuple[int, float]:
    """Kernel vs plain over the grid; returns (failures, worst relative error)."""
    dtypes = [(t, x) for t in (torch.float32, torch.bfloat16, torch.float64)
              for x in (torch.float32, torch.bfloat16)]
    fails, worst, i = 0, 0.0, 0
    for B in (1, 8, 16, 24, 32, 33, 64, 100, 128):
        for N in (1, 16, 17, 20, 33, 127, 128, 129, 1025, 2049):
            tdt, xdt = dtypes[i % len(dtypes)]
            i += 1
            for integer in (False, True):
                for off in (0, 1):
                    def draw(shape):
                        return (torch.randint(-4, 5, shape, generator=gen).float() if integer
                                else torch.randn(shape, generator=gen))
                    tiles = draw((5, 2 * B, B)).to(tdt).to(DEV)
                    bcol = torch.randint(0, 7, (5, 2), generator=gen).to(torch.int32).to(DEV)
                    Xb = draw((7 * B * N + off,)).to(xdt).to(DEV)[off:].view(7, B, N)
                    got = cb_spmm.super_tile_spmm(tiles, bcol, Xb)
                    want = cb_spmm.super_tile_spmm_plain(tiles, bcol, Xb)
                    scale = max(1.0, want.abs().max().item())
                    err = (got - want).abs().max().item() / scale
                    ok = torch.equal(got, want) if integer else err <= TOL
                    worst = max(worst, err)
                    if not ok:
                        fails += 1
                        print(f"FAIL B={B} N={N} {tdt}/{xdt} integer={integer} offset={off} "
                              f"err={err:.3e}", flush=True)
    for B in (16, 128):
        z = cb_spmm.super_tile_spmm(torch.zeros(2, 4 * B, B, device=DEV),
                                    torch.zeros(2, 4, dtype=torch.int32, device=DEV),
                                    torch.randn(3, B, 20, device=DEV))
        if z.any():
            fails += 1
            print(f"FAIL empty slots at B={B} are not exact zeros", flush=True)
    return fails, worst


def mlp_shape():
    tiles = torch.randn(896, 128, 128, device=DEV)
    bcol = torch.randint(0, 32, (896, 1), device=DEV, dtype=torch.int32)
    return tiles, bcol, torch.randn(32, 128, 4096, device=DEV)


def matmat_shape():
    tiles = torch.randn(24576, 16 * 16, 16, device=DEV)
    bcol = torch.randint(0, 131072, (24576, 16), device=DEV, dtype=torch.int32)
    return tiles, bcol, torch.randn(131072, 16, 16, device=DEV)


def timed(tiles, bcol, Xb) -> dict:
    B = Xb.shape[1]
    got = cb_spmm.super_tile_spmm(tiles, bcol, Xb)
    want = cb_spmm.super_tile_spmm_plain(tiles, bcol, Xb)
    err = ((got - want).abs().max() / want.abs().max()).item()
    del got, want
    xg = Xb[bcol.view(-1).long()]
    t3 = tiles.view(-1, B, B)
    return {"ms": time_ms(lambda: cb_spmm.super_tile_spmm(tiles, bcol, Xb)),
            "bmm_ms": time_ms(lambda: torch.bmm(t3, xg)), "err_rel": err}


def variants() -> dict:
    """Time copies of cb_spmm.cu, one change each, at the MLP shape."""
    src = (_build.CSRC / "cb_spmm.cu").read_text()
    cvt = re.search(r"__device__ __forceinline__ uint32_t tf32_rna\(float x\) \{.*?\n\}", src,
                    re.S).group(0)
    split = re.search(r"template <bool LO>\n__device__ __forceinline__ void tf32_split.*?\n\}",
                      src, re.S).group(0)
    int_rna = ("__device__ __forceinline__ uint32_t tf32_rna(float x) {\n"
               "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n}")
    no_split = ("template <bool LO>\n__device__ __forceinline__ void tf32_split(float x, "
                "uint32_t& hi, uint32_t& lo) {\n  hi = __float_as_uint(x);\n  lo = LO ? hi : 0u;\n}")
    hi_only = (("if (A_LO) mma_tf32(acc[mi][ni], al, bh[ni]);", ""),
               ("if (X_LO) mma_tf32(acc[mi][ni], ah, bl[ni]);", ""))
    edits = {
        "as_is": (),
        "int_rna": ((cvt, int_rna),),
        "hi_only": hi_only,
        "no_split": ((split, no_split),),
        "guarded": (("if (mlive == 4 && nlive == 4 && ksteps == WIDE_KC / 8)", "if (false)"),),
        "full_unroll_2": (("#pragma unroll 1\n    for (int ks", "#pragma unroll 2\n    for (int ks"),),
        "full_unroll_4": (("#pragma unroll 1\n    for (int ks", "#pragma unroll\n    for (int ks"),),
    }
    nvcc = _build._find_nvcc()
    work = _build.BUILD_DIR / "variants"          # beside the built library, ignored by git
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in edits.items():
        text = src.replace('#include "cb_common.cuh"', f'#include "{_build.CSRC}/cb_common.cuh"')
        for old, new in subs:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        cu, so = work / f"{name}.cu", work / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    tiles, bcol, Xb = mlp_shape()
    want = cb_spmm.super_tile_spmm_plain(tiles, bcol, Xb)
    out, res = torch.empty_like(want), {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"spmm_probe: nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).cb_spmm
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes, fn.restype = [P, P, P, P, L, I, I, I, I, P], I

        def call():
            code = fn(tiles.data_ptr(), bcol.data_ptr(), Xb.data_ptr(), out.data_ptr(),
                      896, 128, 4096, 0, 0, torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"spmm_probe: variant {name} returned CUDA error {code}")
        call()
        torch.cuda.synchronize()
        res[name] = {"ms": time_ms(call),
                     "err_rel": ((out - want).abs().max() / want.abs().max()).item(),
                     "ptxas": {k: v for k, v in ptxas_report(log).items()
                               if k.startswith("_Z12cb_spmm_wideIffLb1E")}}
    return res


def ptxas_report(log: str) -> dict:
    """Registers, shared memory and spills of each SpMM kernel, from ``-Xptxas -v``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            name = m.group(1)
        elif name and "cb_spmm" in name and ("spill" in ln or "Used" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: " | ".join(v) for k, v in out.items()}


def sass_histogram() -> dict:
    """SASS opcode counts of the wide kernel (float32 tiles and X, 16-byte copies)."""
    lib = next(_build.BUILD_DIR.glob("libcb_spmv_*.so"))
    cuobjdump = pathlib.Path(_build._find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    for body in sass.split("Function : ")[1:]:
        if body.startswith("_Z12cb_spmm_wideIffLb1E"):
            ops = collections.Counter(
                m.group(1).split(".")[0] for m in
                re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
            return dict(ops.most_common(20))
    return {}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("spmm_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    info = _build.build_info()
    fails, worst = check_grid(torch.Generator().manual_seed(args.seed))
    res = {"card": card, "build_s": info["seconds"], "check_failures": fails,
           "check_worst_rel": worst, "mlp": timed(*mlp_shape()), "matmat": timed(*matmat_shape()),
           "ptxas": ptxas_report(info["log"]),
           "sass_wide": sass_histogram()}
    torch.cuda.empty_cache()
    if args.variants:
        res["variants_mlp"] = variants()
    print(json.dumps(res), flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
