"""Hand-written CUDA kernels for CB-SpMV (+ plain PyTorch oracles in ref.py)."""
from . import ref  # noqa: F401
from .ops import cb_spmv, cb_spmv_into  # noqa: F401
