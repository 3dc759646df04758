"""Build and load the CUDA kernels of this package.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
(Hopper) into one shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a cold build takes seconds. The build
happens at the first kernel launch of a process, never at import: this
module touches ``nvcc`` and ``ctypes`` only inside ``library()``. Each
source is compiled by its own ``nvcc`` process, all started together, and
the objects are linked into ``build/libcb_spmv_<hash>.so`` next to this
file (a directory ``.gitignore`` lists); the hash covers the sources and
the flags, so an edited kernel is rebuilt and an unchanged one reused.

Nothing here falls back: a missing compiler, a failed build or a failed
launch raises ``errors.KernelError``.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

from repro_torch import errors

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
SOURCES = ("cb_block_dense.cu", "cb_colagg.cu", "cb_coo.cu", "cb_combine.cu")
HEADERS = ("cb_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# payload dtype codes, shared with csrc/cb_common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

_lock = threading.Lock()
_state: dict = {}   # "lib", "seconds", "log" once built


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise errors.KernelError(
        "nvcc not found (looked on PATH and under $CUDA_HOME, /usr/local/cuda): "
        "the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(commands: list[list[str]]) -> str:
    """Start every command at once, wait for all, return their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in commands]
    log, failed = [], []
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(cmd[-1])
    if failed:
        raise errors.KernelError(
            f"nvcc failed for {failed}:\n" + "\n".join(log))
    return "\n".join(log)


def _build(lib_path: pathlib.Path) -> str:
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{pathlib.Path(src).stem}.o" for src in SOURCES]
    tmp_lib = BUILD_DIR / f"{tag}.so"
    try:
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            for src, obj in zip(SOURCES, objects)
        ])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp_lib), *map(str, objects)]])
        os.replace(tmp_lib, lib_path)   # atomic: readers see all or nothing
    finally:
        for f in (*objects, tmp_lib):
            f.unlink(missing_ok=True)
    return log


def _declare(lib) -> None:
    import ctypes

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cb_dense_spmv.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.cb_panel_spmv.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, ptr]
    lib.cb_coo_spmv.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr]
    lib.cb_segment_sum.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i64, ptr]
    for fn in (lib.cb_dense_spmv, lib.cb_panel_spmv, lib.cb_coo_spmv, lib.cb_segment_sum):
        fn.restype = i32
    lib.cb_error_string.argtypes = [i32]
    lib.cb_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library, built first if this process has not yet."""
    with _lock:
        if "lib" not in _state:
            import ctypes

            lib_path = BUILD_DIR / f"libcb_spmv_{_source_hash()}.so"
            t0 = time.perf_counter()
            log = "" if lib_path.exists() else _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            _declare(lib)
            _state.update(lib=lib, seconds=time.perf_counter() - t0, log=log)
        return _state["lib"]


def build_info() -> dict:
    """Seconds the build-and-load took in this process and nvcc's output
    (empty when the library was already on disk)."""
    library()
    return {"seconds": _state["seconds"], "log": _state["log"]}


def check(code: int, what: str) -> None:
    """Raise ``KernelError`` unless a kernel entry point returned 0."""
    if code != 0:
        msg = library().cb_error_string(code).decode()
        raise errors.KernelError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr() -> int:
    """PyTorch's current CUDA stream, as the integer the C interface takes."""
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, *, dtype=None, shape=None, device=None,
            align: int = 1) -> None:
    """The checks every kernel wrapper makes on a tensor before launching."""
    if dtype is not None and t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise errors.InvalidArgError(f"{name}: dtype {t.dtype} not supported, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise errors.InvalidArgError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if device is not None and t.device != device:
        raise errors.InvalidArgError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise errors.InvalidArgError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % align:
        raise errors.InvalidArgError(f"{name}: storage must be {align}-byte aligned")
